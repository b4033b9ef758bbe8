"""cvm_tpu_torch: the PyTorch + CUDA port of cvm_tpu for an NVIDIA H100.

Mirrors ``cvm_tpu`` (the JAX reference, which stays as it is) module by
module: ``cvm_tpu_torch.X.Y`` is the counterpart of ``cvm_tpu.X.Y``. Plain
tensor code is PyTorch; every Pallas kernel on the ported path is a kernel
written by hand for Hopper under ``csrc/``, built at first use.

Public functions take NHWC tensors, as the reference does, and an explicit
``device``. This package imports no JAX.

Layout:
    ops/        image ops, GT renderers, decoders; ops/cuda the kernels
    models/     the zoo (centernet, semseg, depth, multitask, dmds), registry
    data/       records, dataset adapters, JPEG decoders, loader
    pipeline/   the batch preprocess shared by the processors
    parallel/   multi-process training: process groups, global reductions, TP
    train/      train loop, checkpoints, metrics, evaluation, QAT, LR finder
    infer/      inference pipelines, int8, export runtime, server, tiling
    cli/        the entry points (``python -m cvm_tpu_torch.cli.<name>``)
    utils/      config, device, profiling
"""

__version__ = "0.1.0"


def get_model(name: str):
    """The zoo's entry ``name`` (a ``ModelSpec``); the registry is imported
    on first use, so that a bare import stays cheap."""
    from cvm_tpu_torch.models.registry import get_model as _get

    return _get(name)


def create_model(name: str, params=None, device="cuda", generator=None, **overrides):
    """(model, params) of a zoo entry in one call: ``params``, or the entry's
    params class built from ``overrides``; the model on ``device`` (the card
    unless the caller asks for the CPU), its weights drawn from
    ``generator`` (seed 0 when None)."""
    spec = get_model(name)
    cfg = params if params is not None else spec.params_cls(**overrides)
    return spec.create_model(cfg, device, generator), cfg
