"""Counterpart of ``cvm_tpu.models.centernet`` (2D serving heads)."""
