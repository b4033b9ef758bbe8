"""DMDS composite loss: photometric + edge-aware smoothness + motion-field
regularisation + forward/backward cycle consistency.

Mirrors ``cvm_tpu/models/dmds/loss.py`` (``photometric_loss``,
``edge_aware_smoothness``, ``motion_field_regularization``,
``cycle_consistency``, ``dmds_loss``): SSIM + L1 of each frame against the
other warped into it (``ops/warp.py``, ``ops/ssim.py``), symmetric in the
two frames. Every value is a 0-dim device tensor. Each batch-wide sum and
mean goes through ``red`` (``parallel/reduce.py``); the sparsity term's
``mean_mag`` is nonlinear, so under data parallelism it needs the global
mean, as every other term does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cvm_tpu_torch.models.dmds.params import DmdsParams
from cvm_tpu_torch.ops.ssim import ssim
from cvm_tpu_torch.ops.warp import euler_to_matrix, warp_frame
from cvm_tpu_torch.parallel.reduce import LOCAL, BatchReducer


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, red: BatchReducer = LOCAL
                 ) -> torch.Tensor:
    return red.sum(x * mask) / torch.clamp_min(red.sum(mask), 1.0)


def photometric_loss(target: torch.Tensor, warped: torch.Tensor, valid: torch.Tensor,
                     alpha: float, red: BatchReducer = LOCAL) -> torch.Tensor:
    """alpha SSIM + (1 - alpha) L1 on [0, 1] RGB, masked to valid pixels."""
    l1 = _masked_mean(torch.abs(target - warped), valid, red)
    s = _masked_mean(ssim(target, warped), valid[:, 1:-1, 1:-1, :], red)
    return alpha * s + (1.0 - alpha) * l1


def edge_aware_smoothness(depth: torch.Tensor, image: torch.Tensor,
                          red: BatchReducer = LOCAL) -> torch.Tensor:
    """Mean-normalised disparity gradients, weighted down at image edges."""
    disp = 1.0 / torch.clamp_min(depth, 1e-3)
    disp = disp / (disp.mean(dim=(1, 2, 3), keepdim=True) + 1e-7)
    dx_d = torch.abs(disp[:, :, 1:] - disp[:, :, :-1])
    dy_d = torch.abs(disp[:, 1:] - disp[:, :-1])
    dx_i = torch.abs(image[:, :, 1:] - image[:, :, :-1]).mean(-1, keepdim=True)
    dy_i = torch.abs(image[:, 1:] - image[:, :-1]).mean(-1, keepdim=True)
    return red.mean(dx_d * torch.exp(-dx_i)) + red.mean(dy_d * torch.exp(-dy_i))


def motion_field_regularization(res_trans: torch.Tensor, red: BatchReducer = LOCAL
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(group smoothness, sqrt sparsity) of the residual translation field."""
    dx = res_trans[:, :, 1:] - res_trans[:, :, :-1]
    dy = res_trans[:, 1:] - res_trans[:, :-1]
    smooth = red.mean(torch.abs(dx)) + red.mean(torch.abs(dy))
    mag = torch.sqrt((res_trans ** 2).sum(-1) + 1e-12)
    mean_mag = red.mean(mag) + 1e-12
    sparsity = red.mean(2.0 * mean_mag * torch.sqrt(mag / mean_mag + 1.0)) - 2.0 * mean_mag
    return smooth, sparsity


def cycle_consistency(rot_fwd: torch.Tensor, trans_fwd: torch.Tensor, rot_bwd: torch.Tensor,
                      trans_bwd: torch.Tensor, red: BatchReducer = LOCAL) -> torch.Tensor:
    """Forward then backward motion should be the identity."""
    Rf, Rb = euler_to_matrix(rot_fwd), euler_to_matrix(rot_bwd)
    eye = torch.eye(3, device=Rf.device)[None]
    rot_err = red.mean((Rf @ Rb - eye) ** 2)
    t_err = red.mean(((torch.einsum("bij,bj->bi", Rb, trans_fwd) + trans_bwd) ** 2).sum(-1))
    norm = red.mean((trans_fwd ** 2).sum(-1) + (trans_bwd ** 2).sum(-1)) + 1e-6
    return rot_err + t_err / norm


def dmds_loss(outputs: Dict, targets: Dict[str, torch.Tensor], params: DmdsParams,
              red: BatchReducer = LOCAL) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: the model's dict; targets: frames (B, H, W, 6) in [0, 1] and
    intrinsics (B, 4) -> (loss, {"loss", "loss_photo", "loss_smooth",
    "loss_cycle", "loss_msparse", "mean_depth"})."""
    frames, intr = targets["frames"], targets["intrinsics"]
    a, b = frames[..., :3], frames[..., 3:]
    fwd, bwd = outputs["motion_fwd"], outputs["motion_bwd"]
    res_f, res_b = fwd.get("residual_translation"), bwd.get("residual_translation")
    method = getattr(params, "warp_method", "auto")
    # b warped into a's frame with a's depth and the forward motion, and back.
    wa = warp_frame(b, outputs["depth_a"], fwd["rotation"], fwd["translation"], intr, res_f,
                    method=method)
    wb = warp_frame(a, outputs["depth_b"], bwd["rotation"], bwd["translation"], intr, res_b,
                    method=method)
    l_photo = (photometric_loss(a, wa.warped, wa.valid, params.ssim_weight, red)
               + photometric_loss(b, wb.warped, wb.valid, params.ssim_weight, red))
    l_smooth = (edge_aware_smoothness(outputs["depth_a"], a, red)
                + edge_aware_smoothness(outputs["depth_b"], b, red))
    l_cycle = cycle_consistency(fwd["rotation"], fwd["translation"], bwd["rotation"],
                                bwd["translation"], red)
    zero = torch.zeros((), device=frames.device)
    l_msmooth = l_msparse = zero
    if res_f is not None:
        sf, pf = motion_field_regularization(res_f, red)
        sb, pb = motion_field_regularization(res_b, red)
        l_msmooth, l_msparse = sf + sb, pf + pb
    total = (params.weight_photometric * l_photo + params.weight_smoothness * l_smooth
             + params.weight_motion_smoothness * l_msmooth
             + params.weight_motion_sparsity * l_msparse + params.weight_cycle * l_cycle)
    return total, {"loss": total, "loss_photo": l_photo, "loss_smooth": l_smooth,
                   "loss_cycle": l_cycle, "loss_msparse": l_msparse,
                   "mean_depth": red.mean(outputs["depth_a"])}
