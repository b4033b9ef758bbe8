"""Counterpart of ``cvm_tpu.models.centernet``: the 2D model, its processor,
loss and training entry point."""
