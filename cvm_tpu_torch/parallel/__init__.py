"""Counterpart of ``cvm_tpu.parallel``: multi-process training over
``torch.distributed`` (``mesh.py``: the process group and the (data, model)
grid; ``reduce.py``: the all-reduces of the global batch's losses and
BatchNorm statistics; ``sharding.py``: tensor parallelism on the stage-5
blocks). The reference's ``spatial.py`` (H-sharded convs) is not ported
(ROADMAP "Not to port")."""
