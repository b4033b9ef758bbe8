"""cvm_tpu_torch: the PyTorch + CUDA port of cvm_tpu for an NVIDIA H100.

Mirrors ``cvm_tpu`` (the JAX reference, which stays as it is) module by
module: ``cvm_tpu_torch.X.Y`` is the counterpart of ``cvm_tpu.X.Y``. Plain
tensor code is PyTorch; every Pallas kernel on the ported path is a kernel
written by hand for Hopper under ``csrc/``, built at first use.

Public functions take NHWC tensors, as the reference does, and an explicit
``device``. This package imports no JAX.
"""

__version__ = "0.1.0"
