"""Hand-written Hopper kernels (``csrc/*.cu``) with their wrappers and plain
PyTorch versions; the counterpart of ``cvm_tpu.ops.pallas``."""
