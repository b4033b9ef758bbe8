"""Counterpart of ``cvm_tpu.utils``: device plumbing for the port."""
