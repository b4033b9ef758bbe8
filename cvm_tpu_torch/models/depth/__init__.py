"""Counterpart of ``cvm_tpu.models.depth``: the multi-scale monocular depth
model, its processor and losses."""
