"""Counterpart of ``cvm_tpu.cli``: ``python -m cvm_tpu_torch.cli.train``."""
