"""The benchmark of ``cvm_tpu_torch`` on the card: ``python -m cvbench.run``.

Data-driven: ``BENCHMARK.json`` at the repository root names each cell's
configuration (``configs/<name>.json``), traffic mix (``traffic/<name>.json``,
read by the runner it names in ``runners/``) and per-layer metrics
(``metrics/<name>.py``); ``limits/<cell>.json`` holds the limits of the
comparison that decides ``correct``. Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of the program.
"""
