"""DMDS networks: a monocular depth net and an ego/object motion net.

Mirrors ``cvm_tpu/models/dmds/model.py`` (``MotionNet``, ``DmdsModel``,
``create_model``). The depth net is the depth zoo's ``DepthNet`` built from
a ``DepthParams`` of the DMDS fields (``depth``); the motion net
(``motion``) takes both frames stacked on channels: five stride-2 ConvBNs
(``enc0`` .. ``enc4``), a global mean, ``fc1`` (in float32) and silu,
``fc2`` (zero-initialised, as the reference's ``nn.initializers.zeros``) to
6-DoF ego-motion, and, with ``predict_object_motion``, an ``UpBlock``
decoder (``dec{i}``) and a residual translation ``Head`` (``resmotion``)
upsampled to the input. ``forward(frames)`` runs the depth net on frame a,
then frame b, and the motion net forward, then backward: in training each
call moves the BatchNorm running statistics once, in the reference's order.

Each depth pass is the span ``cvm.dmds.depth`` and each motion pass the span
``cvm.dmds.motion`` (``utils/prof.py::span``: recorded only under a
recording profiler, on eager calls), and each adds one to the launch
counter ``DmdsModel.depth_passes`` or ``DmdsModel.motion_passes``
(``utils/prof.py::launch_counter``: a graph's replay adds what its capture
counted), so a call reads 2 + 2.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cvm_tpu_torch.models.backbones import validate_input_hw
from cvm_tpu_torch.models.depth.model import DepthNet
from cvm_tpu_torch.models.depth.params import DepthParams
from cvm_tpu_torch.models.dmds.params import DmdsParams
from cvm_tpu_torch.models.layers import ConvBN, Head, UpBlock, init_weights, upsample2x
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device
from cvm_tpu_torch.utils.prof import launch_counter, span

# Scales keep the raw head outputs O(1) while motions are centimetres-radians.
ROT_SCALE = 0.01
TRANS_SCALE = 0.1


class MotionNet(nn.Module):
    """(B, H, W, 6) stacked frame pair -> {"rotation" (B, 3), "translation"
    (B, 3)[, "residual_translation" (B, H, W, 3)]}, float32."""

    def __init__(self, params: DmdsParams):
        super().__init__()
        p = self.params = params
        f = p.motion_features
        widths = [f // 8, f // 4, f // 2, f, f]
        ch = 6
        for i, w in enumerate(widths):
            setattr(self, f"enc{i}", ConvBN(ch, w, 3, stride=2))
            ch = w
        self.fc1 = nn.Linear(f, f)
        self.fc2 = nn.Linear(f, 6)
        if p.predict_object_motion:
            for i, skip in enumerate(widths[-2::-1]):
                out = max(f // 2 ** (i + 1), 16)
                setattr(self, f"dec{i}", UpBlock(ch, skip, out))
                ch = out
            self.resmotion = Head(ch, 16, 3)

    def forward(self, pair: torch.Tensor) -> Dict[str, torch.Tensor]:
        h, enc = pair, []
        for i in range(5):
            h = getattr(self, f"enc{i}")(h)
            enc.append(h)
        g = torch.mean(h, dim=(1, 2))
        g = F.silu(self.fc1(g.to(torch.float32)))
        motion = self.fc2(g)
        out = {"rotation": motion[:, :3] * ROT_SCALE, "translation": motion[:, 3:] * TRANS_SCALE}
        if self.params.predict_object_motion:
            d = h
            for i, skip in enumerate(enc[-2::-1]):
                d = getattr(self, f"dec{i}")(d, skip)
            out["residual_translation"] = upsample2x(self.resmotion(d)) * TRANS_SCALE
        return out


class DmdsModel(nn.Module):
    """Depth + motion nets; ``forward(frames)`` is the two-frame forward:
    frames (B, H, W, 6) = [frame_t, frame_t1] on channels -> {"depth_a",
    "depth_b", "motion_fwd", "motion_bwd"}."""

    depth_passes = 0    # the depth net's passes, every instance's (module docstring)
    motion_passes = 0   # the motion net's passes

    def __init__(self, params: DmdsParams):
        super().__init__()
        p = self.params = params
        self.depth = DepthNet(DepthParams(input_hw=p.input_hw, backbone=p.backbone,
                                          decoder_features=p.decoder_features,
                                          num_scales=p.num_scales, max_depth=p.max_depth,
                                          min_depth=p.min_depth))
        self.motion = MotionNet(p)

    def forward(self, frames: torch.Tensor) -> Dict[str, object]:
        a, b = frames[..., :3], frames[..., 3:]
        depth_a = self._depth(a)
        depth_b = self._depth(b)
        fwd = self._motion(frames)
        bwd = self._motion(torch.cat([b, a], dim=-1))
        return {"depth_a": depth_a, "depth_b": depth_b, "motion_fwd": fwd, "motion_bwd": bwd}

    def _depth(self, x: torch.Tensor) -> torch.Tensor:
        with span("cvm.dmds.depth"):
            DmdsModel.depth_passes += 1
            return self.depth(x)["depth"]

    def _motion(self, pair: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("cvm.dmds.motion"):
            DmdsModel.motion_passes += 1
            return self.motion(pair)

    def params_unread_by_loss(self) -> List[nn.Parameter]:
        """The depth net's disp heads but the finest: the loss reads
        ``depth_a`` / ``depth_b``, which the finest scale makes (the train
        step gives the others a zero gradient, as JAX does)."""
        return [q for i in range(3) for q in getattr(self.depth, f"disp{i}").parameters()]


launch_counter(DmdsModel, "depth_passes", "motion_passes")


def create_model(params: DmdsParams, device: DeviceLike,
                 generator: Optional[torch.Generator] = None) -> DmdsModel:
    """Build DmdsModel on ``device`` in eval mode, its weights drawn from
    ``generator`` (seed 0 when None); ``fc2`` starts at zero."""
    validate_input_hw(params.input_hw)
    model = DmdsModel(params)
    init_weights(model, generator or torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.motion.fc2.weight.zero_()
    return model.to(resolve_device(device)).eval()
