"""The benchmark's plain reference: float32 PyTorch, imports nothing of the
program (``cvm_tpu_torch``) and nothing of JAX."""
