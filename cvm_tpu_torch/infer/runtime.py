"""Standalone serving runtime: load an exported artifact and run it.

Mirrors ``cvm_tpu/infer/runtime.py`` (``_unflatten``, ``_dequantize``,
``ServingModel``). The counterpart of ``cli/export.py``: it loads the
``torch.export`` programs (``model.pt2``, and ``model_b{n}.pt2`` per batch
bucket) and the weights of ``weights.npz`` (weight-only int8 leaves
dequantized at load) and runs the whole device pipeline, preprocess,
forward and decode, with none of the model-zoo code: the programs need
only the op registrations of the fused int8 kernel
(``ops/cuda/fused_qconv.py``), of the folded conv's epilogue
(``ops/cuda/conv_epilogue.py``) and of the eval YUV420 letterbox
(``ops/cuda/yuv_letterbox.py``).
A program is read by the torch version that wrote it (``artifact.json``
records it).

Unlike the reference, ``ServingModel`` takes an explicit ``device`` and
every program takes any batch size: a request runs on the smallest bucket
that fits it (short batches pad by repeating the last row,
``utils/batch.py::pad_rows``), and a larger one in chunks of the largest.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

from cvm_tpu_torch.infer.pipeline import data_keys
from cvm_tpu_torch.utils.batch import pad_rows
from cvm_tpu_torch.utils.device import DeviceLike, resolve_device


def load_weights(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    """``weights.npz`` -> ``{name: tensor}`` on ``device``: a
    ``{name}/int8`` + ``{name}/scale`` pair (the format of
    ``infer/quantize.py::quantize_params``: per-output-channel scales on
    axis 0) becomes the float32 product, as ``dequantize_params`` makes it;
    ``{name}/bf16`` (bf16 bits as int16, or such a pair) becomes a bf16
    tensor."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    out = {}
    for key, a in flat.items():
        if key.endswith("/scale"):
            continue
        if key.endswith("/int8"):
            name = key[:-len("/int8")]
            q = torch.from_numpy(a).to(device).to(torch.float32)
            s = torch.from_numpy(flat[name + "/scale"]).to(device).to(torch.float32)
            t = q * s.view(-1, *([1] * (q.dim() - 1)))
        else:
            name, t = key, torch.from_numpy(a).to(device)
        if name.endswith("/bf16"):
            name = name[:-len("/bf16")]
            t = t.view(torch.bfloat16) if t.dtype == torch.int16 else t.to(torch.bfloat16)
        out[name] = t
    return out


def _load_program(path: str, device: torch.device, exported_on: str):
    from cvm_tpu_torch.ops.cuda import conv_epilogue, fused_qconv, yuv_letterbox  # noqa: F401

    ep = torch.export.load(path)
    if exported_on != device.type:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
    return ep.module()


class ServingModel:
    """Loads an artifact directory and exposes ``__call__(*data)``: device
    tensors out, in the export's argument order (``y, u, v, image_hw`` for
    yuv420, ``image, image_hw`` for rgb, with a dmds artifact's second
    frame and a ``with_3d`` artifact's intrinsics as
    ``infer/pipeline.py::data_keys`` orders them; numpy arrays or tensors
    in)."""

    def __init__(self, artifact_dir: str, device: DeviceLike):
        self.artifact_dir = artifact_dir
        self.device = resolve_device(device)
        with open(os.path.join(artifact_dir, "artifact.json")) as f:
            self.meta: Dict[str, Any] = json.load(f)
        self.input_format: str = self.meta.get("input_format", "rgb")
        self.keys = data_keys(self.meta.get("model", ""), self.input_format,
                              bool((self.meta.get("params_cfg") or {}).get("with_3d", False)))
        exported_on = self.meta.get("device", "cpu")
        primary = int(self.meta["batch_size"])
        self._programs = {primary: _load_program(os.path.join(artifact_dir, "model.pt2"),
                                                 self.device, exported_on)}
        for path in glob.glob(os.path.join(artifact_dir, "model_b*.pt2")):
            n = int(os.path.basename(path)[len("model_b"):-len(".pt2")])
            if n != primary:
                self._programs[n] = _load_program(path, self.device, exported_on)
        self.bucket_sizes: List[int] = sorted(self._programs)
        self.weights = load_weights(os.path.join(artifact_dir, "weights.npz"), self.device)

    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def __call__(self, *data) -> Dict[str, torch.Tensor]:
        B = int(data[0].shape[0])
        fit = [n for n in self.bucket_sizes if n >= B]
        if not fit:  # larger than the largest bucket: chunks of it
            n = self.bucket_sizes[-1]
            parts = [self(*(a[i:i + n] for a in data)) for i in range(0, B, n)]
            return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        n = fit[0]
        if n != B:
            data = pad_rows([a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                             for a in data], n)
        with torch.no_grad():
            out = self._programs[n](self.weights, *(self._to_device(a) for a in data))
        return {k: v[:B] for k, v in out.items()}

    def predict_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A dict batch through the artifact: the arguments in the export's
        order, the outputs as numpy arrays trimmed to the batch's rows. The
        one place the trace-argument contract lives on the consumer side
        (``cli.evaluate --artifact`` and ``cli.infer --artifact`` call it).
        A 3D artifact's batch without ``intrinsics`` (bare image files) is
        decoded against the identity camera [1, 1, 0, 0], as the
        reference's: centres and yaw stay meaningful, metric
        back-projection does not."""
        if "intrinsics" in self.keys and "intrinsics" not in batch:
            n = np.asarray(batch["image_hw"]).shape[0]
            batch = dict(batch, intrinsics=np.tile(np.float32([[1.0, 1.0, 0.0, 0.0]]), (n, 1)))
        dtypes = {"image_hw": np.int32, "intrinsics": np.float32}
        data = [np.ascontiguousarray(batch[k], dtype=dtypes.get(k, np.uint8))
                for k in self.keys]
        return {k: v.cpu().numpy() for k, v in self(*data).items()}

    def selftest(self, rtol: float = 0.05, atol: float = 1e-3) -> List[str]:
        """The artifact against the fingerprint its export recorded
        (``infer/selftest.py``): [] when verified, else the mismatches."""
        from cvm_tpu_torch.infer.selftest import run_selftest

        return run_selftest(self, rtol=rtol, atol=atol)
