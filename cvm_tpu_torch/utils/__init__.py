"""Counterpart of ``cvm_tpu.utils``: device plumbing, and the port's copies
of the batch padding and the typed config."""
