"""Counterpart of ``cvm_tpu.models``: layers, backbones, the zoo (CenterNet,
semseg, depth, multitask, DMDS) and its registry."""

from cvm_tpu_torch.models.registry import (ModelSpec, get_model, get_model_zoo,  # noqa: F401
                                           register_model)
