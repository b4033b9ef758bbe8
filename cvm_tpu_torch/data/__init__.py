"""Counterpart of ``cvm_tpu.data``: synthetic scenes in the serving wire format."""
