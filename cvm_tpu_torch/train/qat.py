"""Quantization-aware training: fake-quantized convs with a straight-through
estimator.

Mirrors ``cvm_tpu/train/qat.py`` (``fake_quant_act``, ``fake_quant_weight``,
``_fq_conv``, ``fake_quant_training``, ``maybe_fake_quant``). With
``qat=True`` every ``models/layers.py::Conv`` runs the numerics of the
dynamic int8 inference path (``infer/quantize.py`` ``Int8Conv``): a
per-tensor activation scale max|x|/127 + 1e-8, per-output-channel symmetric
weight scales, values snapped to the int8 grid. Each quantize-dequantize
pair is ``x + (qdq(x) - x).detach()``: the forward pass sees the
quantization noise, the backward pass is the identity.

Stateless, as the reference: the scales come from the live tensors in each
call, so a checkpoint gains no field. The reference swaps the convs at
trace time with a flax method interceptor; here ``fake_quant_training``
sets ``Conv.fake_quant`` for the duration of the block, so the modules, and
the checkpoint's keys, stay as they are. The conv itself runs in the
module's compute dtype (bf16), with the bias added in float32.

The scales are those of the whole tensors, as the reference's GSPMD takes
them. The activation scale is the max over the global batch: under data
parallelism (``reducer``, ``parallel/reduce.py``) each rank's max is
all-reduced over the data group. A row-split conv of tensor parallelism
(``parallel/sharding.py::RowConv``) holds a C_in slice of its input and of
its weight; its ``slices`` reducer (over the model group) takes the max of
the slices' activation maxima and, per output channel, of the slices'
weight maxima. A column-split conv needs neither: its input is whole and
its output channels are its own.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

from cvm_tpu_torch.infer.quantize import div127
from cvm_tpu_torch.models.layers import Conv, conv_nhwc
from cvm_tpu_torch.parallel.reduce import LOCAL, BatchReducer


def act_scale(x: torch.Tensor, reducer: BatchReducer = LOCAL,
              slices: BatchReducer = LOCAL) -> torch.Tensor:
    """The per-tensor activation scale max|x|/127 + 1e-8, the max over
    ``reducer``'s global batch and over ``slices``' C_in slices."""
    return div127(slices.all_max(reducer.max(x.detach().abs()))) + 1e-8


def weight_scale(w: torch.Tensor, slices: BatchReducer = LOCAL) -> torch.Tensor:
    """The per-output-channel (axis 0 of OIHW) weight scales amax/127 +
    1e-12, each max over ``slices``' C_in slices; shape (O, 1, 1, 1)."""
    amax = w.detach().abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    return div127(slices.all_max(amax)) + 1e-12


def fake_quant_act(x: torch.Tensor, reducer: BatchReducer = LOCAL,
                   slices: BatchReducer = LOCAL) -> torch.Tensor:
    """Per-tensor dynamic int8 quantize-dequantize with identity gradient,
    its scale from the max over ``reducer``'s global batch (and the C_in
    ``slices`` of a row-split conv); float32 out (the caller casts to the
    conv's compute dtype)."""
    xf = x.to(torch.float32)
    s = act_scale(xf, reducer, slices)
    q = torch.round(torch.clamp(xf.detach() / s, -127, 127)) * s
    return xf + (q - xf).detach()


def fake_quant_weight(w: torch.Tensor, slices: BatchReducer = LOCAL) -> torch.Tensor:
    """Per-output-channel (axis 0 of the OIHW weight; the reference's last
    axis of HWIO) symmetric int8 quantize-dequantize with identity
    gradient: the grid of ``quantize_params`` and ``Int8Conv``; each
    channel's max over the C_in ``slices`` of a row-split conv."""
    wf = w.to(torch.float32)
    s = weight_scale(wf, slices)
    q = torch.round(torch.clamp(wf.detach() / s, -127, 127)) * s
    return wf + (q - wf).detach()


def fq_conv(conv: Conv, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
            reducer: BatchReducer = LOCAL) -> torch.Tensor:
    """A Conv's forward on fake-quantized input and weight: the conv in the
    compute dtype, the bias added in float32, the result cast back. A conv
    with a ``slices`` reducer (``RowConv``) takes its scales over it too."""
    cdt = dtype or conv.dtype
    slices = getattr(conv, "slices", LOCAL)  # a row split's model group
    y = conv_nhwc(fake_quant_act(x, reducer, slices).to(cdt),
                  fake_quant_weight(conv.weight, slices).to(cdt), conv.stride[0])
    if conv.bias is not None:
        y = y.to(torch.float32) + conv.bias.to(torch.float32)
    return y.to(cdt)


@contextlib.contextmanager
def fake_quant_training(reducer: BatchReducer = LOCAL):
    """Every Conv inside the block runs ``fq_conv`` (activation scales over
    ``reducer``'s global batch)."""
    prev = Conv.fake_quant
    Conv.fake_quant = fq_conv if reducer is LOCAL else functools.partial(fq_conv,
                                                                         reducer=reducer)
    try:
        yield
    finally:
        Conv.fake_quant = prev


def maybe_fake_quant(params_cfg, reducer: BatchReducer = LOCAL):
    """The Trainer's gate: ``fake_quant_training(reducer)`` when
    ``params_cfg.qat``, else a context that does nothing."""
    if bool(getattr(params_cfg, "qat", False)):
        return fake_quant_training(reducer)
    return contextlib.nullcontext()
