"""Counterpart of ``cvm_tpu.ops``: image ops, GT heatmap rendering and decoders
(``ops/cuda`` holds the hand-written kernels that replace
``cvm_tpu/ops/pallas``)."""
