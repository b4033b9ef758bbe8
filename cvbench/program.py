"""The program under test, as a configuration file names it: its params
class and model class (``"program": {"params": "module:Class", "model":
"module:Class"}``) and the params' fields (``"params"``)."""

from __future__ import annotations

import gc
import importlib
from typing import Dict, Tuple

import torch

from cvbench.weights import seeded_model


def _load(ref: str):
    mod, name = ref.split(":")
    return getattr(importlib.import_module(mod), name)


def params(cfg: dict):
    p = dict(cfg["params"])
    for k, v in p.items():
        if isinstance(v, list):
            p[k] = tuple(v)
    return _load(cfg["program"]["params"])(**p)


def build(cfg: dict, seed: int, device) -> Tuple[object, torch.nn.Module, Dict[str, torch.Tensor]]:
    """``(params, model, weights)``: the program's model with weights from
    ``seed`` on ``device``, and a copy of its ``state_dict`` for the
    reference."""
    p = params(cfg)
    w = cfg.get("weights", {})
    model = seeded_model(lambda: _load(cfg["program"]["model"])(p), seed, device,
                         w.get("gain"), w.get("shift"))
    for bias in w.get("balance", []):
        balance(model, bias, cfg, device)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return p, model, weights


@torch.no_grad()
def balance(model: torch.nn.Module, bias: str, cfg: dict, device) -> None:
    """Move the output bias ``bias`` so that each class's mean logit over a
    blank (mid-grey) input is 0: behind random weights one class would
    otherwise take nearly every pixel, where a trained segmenter draws
    boundaries. Computed by the plain reference, from the weights alone."""
    from cvbench.reference.model import forward

    state = model.state_dict()
    h, w = cfg["params"]["input_hw"]
    out = forward(state, torch.zeros(1, 3, h, w, device=device), ref_cfg(cfg))
    out = out if torch.is_tensor(out) else out["heatmap"]
    state[bias].sub_(out[0].mean(dim=(1, 2)).to(state[bias].dtype))


def cell_config(cfg: dict, mix: dict) -> dict:
    """The configuration as a cell runs it: the mix may shape the seeded
    weights further (``"weights"``: gains and shifts merged, balanced
    biases added), as a serving mix does to stand in for a trained model."""
    extra = mix.get("weights")
    if not extra:
        return cfg
    w = dict(cfg.get("weights", {}))
    for key in ("gain", "shift"):
        w[key] = {**w.get(key, {}), **extra.get(key, {})}
    w["balance"] = list(w.get("balance", [])) + list(extra.get("balance", []))
    return dict(cfg, weights=w)


def ref_cfg(cfg: dict) -> dict:
    """What the reference reads of a configuration."""
    return {"model": cfg["model"], **cfg["params"], **cfg.get("recipe", {})}


def settle(device) -> None:
    """The end of a set-up: the device idle, and every object set-up made
    moved out of the garbage collector's reach, so that no collection of
    them falls inside the window."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
