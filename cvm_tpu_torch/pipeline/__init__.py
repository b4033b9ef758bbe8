"""Counterpart of ``cvm_tpu.pipeline``: device-side batch preprocessing."""
