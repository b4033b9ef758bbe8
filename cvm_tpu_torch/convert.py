"""flax variables -> the port's ``state_dict``, and flax module paths -> the
port's module names.

The counterpart of loading a ``cvm_tpu`` checkpoint: ``variables`` is the
flax ``{"params": ..., "batch_stats": ...}`` tree as numpy arrays (e.g. from
``jax.device_get``). Conv kernels go from HWIO to OIHW and ``Dense``
kernels from (in, out) to ``nn.Linear``'s (out, in); BatchNorm maps
``scale -> weight``, ``bias``, ``mean -> running_mean``, ``var -> running_var``.
Flax auto-names the backbone ``Backbone_0``; the port calls it ``backbone``.
Every other module name is the same on both sides, so a path such as
``"Backbone_0/s2b0/c1/conv"`` (a calibration key) becomes
``"backbone.s2b0.c1.conv"``. A parameter that is a bare array rather than
a module's (multitask's ``task_log_vars``) keeps its path as its name.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_RENAMES = {"Backbone_0": "backbone"}


def flax_path_to_module_name(path: str) -> str:
    """``"Backbone_0/s2b0/c1/conv"`` -> ``"backbone.s2b0.c1.conv"``."""
    return ".".join(_RENAMES.get(p, p) for p in path.split("/") if p)


def convert_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` -> a ``state_dict`` for the port's
    model (fp32 tensors on the CPU; load with ``strict=True``)."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32))

    def visit_params(node, path):
        name = flax_path_to_module_name("/".join(path))
        if not isinstance(node, Mapping):         # a bare parameter (task_log_vars)
            sd[name] = t(node)
        elif "kernel" in node:
            k = t(node["kernel"])
            # nn.Dense (in, out) -> (out, in); nn.Conv HWIO -> OIHW
            k = k.t() if k.dim() == 2 else k.permute(3, 2, 0, 1)
            sd[f"{name}.weight"] = k.contiguous()
            if "bias" in node:
                sd[f"{name}.bias"] = t(node["bias"])
        elif "scale" in node:                     # nn.BatchNorm
            sd[f"{name}.weight"] = t(node["scale"])
            sd[f"{name}.bias"] = t(node["bias"])
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        else:
            for k, v in node.items():
                visit_params(v, path + (k,))

    def visit_stats(node, path):
        if "mean" in node:
            name = flax_path_to_module_name("/".join(path))
            sd[f"{name}.running_mean"] = t(node["mean"])
            sd[f"{name}.running_var"] = t(node["var"])
        else:
            for k, v in node.items():
                visit_stats(v, path + (k,))

    visit_params(variables["params"], ())
    visit_stats(variables.get("batch_stats", {}), ())
    return sd


def convert_scales(scales: Mapping[str, float]) -> Dict[str, float]:
    """A reference calibration table ``{flax conv path: sx}`` -> the port's
    ``{conv module name: sx}``."""
    return {flax_path_to_module_name(k): float(v) for k, v in scales.items()}
