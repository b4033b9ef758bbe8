"""Counterpart of ``cvm_tpu.train``: optimizer, training loop, checkpoints,
metrics, evaluation and quantization-aware training, for every ported model
(the mesh is not ported yet: ROADMAP Queue 1 item 17)."""
