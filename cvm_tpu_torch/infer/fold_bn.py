"""Deploy-time BatchNorm folding: the fp serving posture.

Mirrors ``cvm_tpu/infer/fold_bn.py``. At inference a BatchNorm is a fixed
per-channel affine whose scale folds into the conv kernel:

    y = (conv(x, W) - mean) * gamma / sqrt(var + eps) + beta
      =  conv(x, W * s) + (beta - mean * s)        with s = gamma/sqrt(var+eps)

The reference needs a flax interceptor to replace each BatchNorm by the
residual bias add; here the weight transform swaps the module itself
(``BatchNorm`` -> ``BiasAdd``), so no interceptor exists.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from cvm_tpu_torch.models.layers import BatchNorm, BiasAdd, ConvBN


@torch.no_grad()
def fold_batchnorm(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every ConvBN's BatchNorm folded into its conv
    kernel (in float64, as the reference) and replaced by a bias add in the
    conv's output dtype. Each BatchNorm's own ``eps`` is used."""
    folded = copy.deepcopy(model)
    for mod in folded.modules():
        if isinstance(mod, ConvBN) and isinstance(mod.bn, BatchNorm):
            bn, conv = mod.bn, mod.conv
            if conv.bias is not None or bn.weight.shape[0] != conv.weight.shape[0]:
                raise ValueError("fold_batchnorm: a ConvBN whose conv has a bias "
                                 "or whose BN width differs is not foldable")
            s = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
            conv.weight.copy_((conv.weight.double() * s[:, None, None, None]).float())
            bias = (bn.bias.double() - bn.running_mean.double() * s).float()
            mod.bn = BiasAdd(bias)
    return folded
