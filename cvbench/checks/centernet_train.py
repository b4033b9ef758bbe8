"""CenterNet training: the program's first three steps against the float32
reference's three steps from the same weights on the same records.

  * ``loss_gap``: the widest relative gap between the program's loss and
    the reference's, over steps 1-3.
  * ``grad_gap``: the first gradient as the optimizer got it (clipped), by
    the worst leaf: the gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger.
  * ``change_gap``: the parameters' change over the three steps, by the
    worst leaf, measured alike.

Leaves whose reference gradient is under a thousandth of the median leaf's
(nought to rounding, as a bias under a normalisation) are left out of both
leaf measures: Adam moves them by round-off alone.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from cvbench.reference.model import no_tf32
from cvbench.reference.train import Reference, batch_ids, step_generator
from cvbench.traffic.generator import stream
from cvbench.traffic.records import Shard, write_shard

STEPS = 3


def ref_cfg(cfg: dict) -> dict:
    """The recipe the reference reads: the params, the photometric ranges."""
    r = dict(cfg)
    r["aug"] = {"scale_range": cfg["aug_scale_range"], "shift_frac": cfg["aug_shift_frac"],
                "flip_prob": cfg["aug_flip_prob"], **cfg["photometric"]}
    return r


def reference_steps(samples: dict, weights, cfg: dict, device, quant=None, rows=None):
    """The reference's losses, first clipped gradient and parameters after
    ``STEPS`` steps (on the first ``rows`` of each batch when given)."""
    no_tf32()
    rc = ref_cfg(cfg)
    shard = Shard(samples["shard"])
    ref = Reference(weights, list(samples["p0"]), rc, device, quant, rows)
    losses, g1 = [], None
    for k, ids in enumerate(batch_ids(len(shard), samples["batch"], samples["seed"], STEPS,
                                      samples.get("ranks", 1))):
        x, t = ref.inputs(shard, ids, step_generator(device, samples["seed"], k))
        value, g = ref.step(x, t)
        losses.append(value)
        if k == 0:
            g1 = g
    return losses, g1, ref.p


def _leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep) -> float:
    gn = {n: float(got[n].double().norm()) for n in keep}
    wn = {n: float(want[n].double().norm()) for n in keep}
    med = float(torch.tensor(sorted(wn.values())).median())
    return max(abs(gn[n] - wn[n]) / max(wn[n], med) for n in keep)


def compare(samples: dict, weights, cfg: dict, device, quant=None) -> Dict[str, float]:
    losses, g1, p3 = reference_steps(samples, weights, cfg, device, quant)
    gnorm = {n: float(v.double().norm()) for n, v in g1.items()}
    med = float(torch.tensor(sorted(gnorm.values())).median())
    keep = [n for n, v in gnorm.items() if v >= 1e-3 * med]
    p0 = samples["p0"]
    d_prog = {n: samples["p3"][n].to(device) - p0[n].to(device) for n in keep}
    d_ref = {n: p3[n] - p0[n].to(device) for n in keep}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(samples["losses"], losses)),
        "grad_gap": _leaf_gap({n: samples["g1"][n].to(device) for n in keep}, g1, keep),
        "change_gap": _leaf_gap(d_prog, d_ref, keep),
        "leaves_left_out": float(len(gnorm) - len(keep)),
    }


def control(cfg: dict, mix: dict, seed: int, weights, device, quant, tmp: str, n: int,
            fault=None):
    """The control's samples: the shard a run of ``seed`` writes, trained
    three steps by the reference through ``quant``; or, with ``fault``
    "half_batch", in float32 on the first half of each batch."""
    path = os.path.join(tmp, "train.cvrec")
    write_shard(path, stream(seed, 1), mix, cfg["num_classes"])
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    p0 = {k: v for k, v in weights.items() if not k.endswith(buffers)}
    ranks = int(mix.get("ranks", 1))
    samples = {"shard": path, "seed": seed, "batch": cfg["batch_size"] * ranks, "ranks": ranks,
               "p0": p0}
    if fault == "half_batch":
        losses, g1, p3 = reference_steps(samples, weights, cfg, device, None,
                                         samples["batch"] // 2)
    else:
        losses, g1, p3 = reference_steps(samples, weights, cfg, device, quant)
    samples.update(losses=losses, g1=g1, p3=p3)
    return samples
