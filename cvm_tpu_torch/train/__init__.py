"""Counterpart of ``cvm_tpu.train``: optimizer, training loop, checkpoints,
metrics (CenterNet; evaluation, QAT and the mesh are not ported yet)."""
