"""Model export: ``python -m cvm_tpu_torch.cli.export --model M
--checkpoint_dir D --out ART [--quantize none|int8|w8a8|w8a8_fused|
w8a8_fused_chain] [--device cuda]``.

Mirrors ``cvm_tpu/cli/export.py`` (``export_model``, ``main``): the whole
serving pipeline (preprocess, forward, decode) in the posture asked for is
recorded as one program, next to its weights and its typed config, so that
a serving process (``infer/runtime.py::ServingModel``) runs it without the
model-zoo code. The reference serializes StableHLO through ``jax.export``;
here ``torch.export`` records ``InferencePipeline.run`` as a function of
the model's tensors and the data (``torch.func.functional_call``), so the
program files (``model.pt2``, ``model_b{n}.pt2`` per ``--batch_sizes``
bucket) hold no weights. The artifact directory:

  * ``model.pt2`` (the largest bucket) and ``model_b{n}.pt2`` per bucket
    when there are several;
  * ``weights.npz``: the served model's tensors by name, flat; with
    ``--quantize int8`` each eligible conv weight as ``{name}/int8`` and
    ``{name}/scale``; a bf16 tensor (a folded conv's, ``--fold_bn``) under
    ``{name}/bf16``, its bits as int16 (or its int8 pair under it,
    quantized from the float32 folded weight, as the reference's);
  * ``params.json``, the model's config;
  * ``artifact.json``: the reference's keys, a selftest fingerprint taken
    by running the artifact just written, ``torch_version``, ``device``
    and ``device_kind``.

A program's data arguments are ``infer/pipeline.py::data_keys``'s: a
``with_3d`` artifact takes the (B, 4) intrinsics after the images, a dmds
artifact both frames; dmds refuses the ``w8a8*`` postures, as the
reference does. A program is read back by the torch version that wrote it. The fused int8
postures record the kernel's custom op (``cvm_tpu_torch::fused_qconv``), a
``--fold_bn`` program (the default of ``--quantize none``) the folded conv's
(``cvm_tpu_torch::conv_epilogue``), and a yuv420 program, on either device,
the eval letterbox's (``cvm_tpu_torch::yuv_letterbox``), so loading them needs
``cvm_tpu_torch.ops.cuda.fused_qconv``, ``.conv_epilogue`` and
``.yuv_letterbox`` imported, and no other module of the package. ``--quantize w8a8`` is static-calibrated
W8A8, as the reference's: its program runs ``Int8Conv`` on calibrated
scales, and ``weights.npz`` holds the int8 weight matrices (the reference
ships the fp kernels and quantizes inside the program).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

QUANTIZE = ("none", "int8", "w8a8", "w8a8_fused", "w8a8_fused_chain")


class _Served(nn.Module):
    """``pipe.run`` as a module whose tensors are the served model's
    (under ``model.``)."""

    def __init__(self, pipe):
        super().__init__()
        self.model = pipe.model
        object.__setattr__(self, "_pipe", pipe)  # not a submodule

    def forward(self, *data):
        return self._pipe.run(*data)


class _Program(nn.Module):
    """What is exported: ``(weights, *data) -> outputs``, the weights an
    input, so the program file does not embed them."""

    def __init__(self, served: _Served):
        super().__init__()
        object.__setattr__(self, "_served", served)

    def forward(self, weights: Dict[str, torch.Tensor], *data):
        return torch.func.functional_call(
            self._served, {f"model.{k}": v for k, v in weights.items()}, data, strict=True)


def served_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors a program of ``model`` takes as ``weights``: every
    parameter and buffer, by name."""
    return {**{k: v.detach() for k, v in model.named_parameters()},
            **dict(model.named_buffers())}


def _trace_args(keys, bs: int, pad_hw, device):
    """Placeholder tensors for the program's data arguments ``keys``
    (``InferencePipeline.keys``)."""
    h, w = pad_hw
    shapes = {"y": (bs, h, w), "u": (bs, h // 2, w // 2), "v": (bs, h // 2, w // 2),
              "image": (bs, h, w, 3)}
    args = []
    for k in keys:
        if k == "image_hw":
            args.append(torch.ones((bs, 2), dtype=torch.int32, device=device))
        elif k == "intrinsics":  # [fx, fy, cx, cy] in source pixels
            args.append(torch.ones((bs, 4), dtype=torch.float32, device=device))
        else:
            args.append(torch.zeros(shapes[k.replace("_t1", "")], dtype=torch.uint8,
                                    device=device))
    return tuple(args)


def _flat_weights(model: nn.Module, quantize: str, float_weights=None):
    """``weights.npz``'s arrays and the quantization stats. With ``int8``, a
    folded conv's weight is quantized from its float32 value in
    ``float_weights`` (``infer/fold_bn.py::folded_float_weights``), not
    from its bf16 copy."""
    tensors = served_tensors(model)
    # A folded model's convs hold bf16 weights and biases (infer/fold_bn.py):
    # stored under "{name}/bf16", as their bits, or as an int8 pair.
    bf16 = {k for k, v in tensors.items() if v.dtype == torch.bfloat16}
    qstats = {}
    if quantize == "int8":
        from cvm_tpu_torch.infer.quantize import quantization_error, quantize_params

        float_weights = float_weights or {}
        missing = sorted(k for k in bf16 if k.endswith(".weight") and k not in float_weights)
        if missing:
            raise ValueError(f"export int8: no float32 weight for the folded {missing}")
        params = dict(model.named_parameters())
        params.update(float_weights)
        qparams, qstats = quantize_params(params)
        qstats["max_rel_error"] = quantization_error(params, qparams)
        tensors.update(qparams)
    flat = {}
    for name, v in tensors.items():
        key = f"{name}/bf16" if name in bf16 else name
        if isinstance(v, dict):  # {"int8", "scale"}
            flat[f"{key}/int8"] = v["int8"].cpu().numpy()
            flat[f"{key}/scale"] = v["scale"].cpu().numpy()
        elif name in bf16:
            flat[key] = v.detach().to(torch.bfloat16).view(torch.int16).cpu().numpy()
        else:
            flat[key] = v.detach().cpu().numpy()
    return flat, qstats


def calibration_scales(cfg, model: nn.Module, pad_hw, n_batches: int, batch_size: int,
                       device) -> Dict[str, float]:
    """The reference's calibration recipe (``cli.export``'s, which
    ``cli.evaluate`` repeats): ``n_batches`` synthetic RGB batches of
    ``max(batch_size, 2)`` scenes from ``default_rng(0)`` (at most 10
    classes) through the serving preprocess in float32, then
    ``calibrate_activation_scales``."""
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.infer.quantize import calibrate_activation_scales
    from cvm_tpu_torch.pipeline.preprocess import preprocess_image_batch

    rng = np.random.default_rng(0)
    nc = min(getattr(cfg, "num_classes", getattr(cfg, "num_det_classes", 3)), 10)
    procs = []
    for _ in range(max(n_batches, 1)):
        b = synthetic_batch(rng, max(batch_size, 2), pad_hw, num_classes=nc)
        procs.append(preprocess_image_batch(torch.from_numpy(b["image"]).to(device),
                                            torch.from_numpy(b["image_hw"]).to(device),
                                            cfg.input_hw)[0])
    return calibrate_activation_scales(model.to(device), procs)


def export_model(spec_name: str, checkpoint_dir: str, out_dir: str, batch_size: int = 1,
                 pad_hw=None, quantize: str = "none", input_format: str = "rgb",
                 fold_bn: bool = False, tta: str = "none", average_last: int = 0,
                 batch_sizes=None, device="cuda") -> dict:
    """Export the checkpoint of ``checkpoint_dir`` (its ``params.json``
    names the config) into ``out_dir``. ``batch_sizes`` (e.g. [1, 8])
    exports one program per size; the largest doubles as ``model.pt2``.
    Calibration (``w8a8*``) runs on 3 synthetic batches of ``max(batch_size,
    2)`` scenes from ``default_rng(0)``, as the reference's and
    ``cli.evaluate``'s. Returns the export's stats."""
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.infer.runtime import ServingModel
    from cvm_tpu_torch.infer.selftest import SELFTEST_SEED, fingerprint, synth_inputs
    from cvm_tpu_torch.models.registry import get_model
    from cvm_tpu_torch.train.checkpoints import load_params_cfg
    from cvm_tpu_torch.train.loop import Trainer

    if quantize not in QUANTIZE:
        raise ValueError(f"quantize must be one of {QUANTIZE}, got {quantize!r}")
    if quantize.startswith("w8a8") and spec_name == "dmds":
        raise ValueError("w8a8 export not supported for two-frame dmds")
    spec = get_model(spec_name)
    cfg = load_params_cfg(checkpoint_dir, spec.params_cls)
    trainer = Trainer(cfg, device, checkpoint_dir=checkpoint_dir)
    trainer.init_state()
    if trainer.state.step == 0:
        raise SystemExit(f"export: no checkpoint in {checkpoint_dir}")
    if average_last:
        from cvm_tpu_torch.train.average import average_checkpoints

        try:
            steps = average_checkpoints(trainer, average_last)
        except ValueError as e:
            raise SystemExit(f"--average_last: {e}")
        print(f"[export] shipping the mean of checkpoints {list(steps)}", file=sys.stderr)
    dev = trainer.device
    model = trainer.eval_model(use_ema=cfg.ema_decay > 0.0)
    pad_hw = tuple(pad_hw or (int(cfg.input_hw[0] * 1.5) // 2 * 2,
                              int(cfg.input_hw[1] * 1.5) // 2 * 2))

    scales = (calibration_scales(cfg, model, pad_hw, 3, batch_size, dev)
              if quantize.startswith("w8a8") else None)

    pipe = InferencePipeline(cfg, model, dev, input_format=input_format, tta=tta,
                             w8a8=scales, w8a8_fused=quantize.startswith("w8a8_fused"),
                             w8a8_chain=quantize == "w8a8_fused_chain", fold_bn=fold_bn)
    sizes = sorted({int(b) for b in batch_sizes}) if batch_sizes else [batch_size]
    if sizes[0] < 1:
        raise ValueError(f"batch sizes must be >= 1, got {sizes}")
    batch_size = sizes[-1]  # the primary program is the largest bucket

    program = _Program(_Served(pipe))
    weights = served_tensors(pipe.model)
    programs = {}
    with torch.no_grad():
        for bs in sizes:
            ep = torch.export.export(program, (weights, *_trace_args(pipe.keys, bs, pad_hw, dev)),
                                     strict=False)
            ep.example_inputs = None  # the program file keeps no tensors of its own
            programs[bs] = ep

    os.makedirs(out_dir, exist_ok=True)
    # A stale bucket from an earlier export into this directory would serve
    # an old program against the new weights: remove it first.
    keep = {f"model_b{bs}.pt2" for bs in sizes} if len(sizes) > 1 else set()
    for path in glob.glob(os.path.join(out_dir, "model_b*.pt2")):
        if os.path.basename(path) not in keep:
            os.remove(path)
    torch.export.save(programs[batch_size], os.path.join(out_dir, "model.pt2"))
    if len(sizes) > 1:
        for bs, ep in programs.items():
            torch.export.save(ep, os.path.join(out_dir, f"model_b{bs}.pt2"))
    with open(os.path.join(out_dir, "params.json"), "w") as f:
        f.write(cfg.to_json())
    floats = None
    if quantize == "int8" and pipe.folded_counts:
        from cvm_tpu_torch.infer.fold_bn import folded_float_weights

        floats = folded_float_weights(model, pipe.model)
    flat, qstats = _flat_weights(pipe.model, quantize, floats)
    if scales is not None:
        qstats["calibrated_convs"] = len(scales)
    np.savez(os.path.join(out_dir, "weights.npz"), **flat)
    meta = {
        "model": spec_name, "input_format": input_format, "batch_size": batch_size,
        "batch_sizes": sizes, "pad_hw": list(pad_hw), "quantize": quantize, "fold_bn": fold_bn,
        "tta": tta,
        # A qat config exported without --quantize records the fake-quant
        # program its evals scored.
        "qat": bool(getattr(cfg, "qat", False)),
        "params_cfg": cfg.to_dict(),
        "torch_version": torch.__version__,
        "device": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    with open(os.path.join(out_dir, "artifact.json"), "w") as f:
        json.dump(meta, f)
    # The integrity fingerprint: the artifact just written, loaded as a
    # server loads it, on the selftest's deterministic inputs.
    out = ServingModel(out_dir, device=dev)(*synth_inputs(meta))
    meta["selftest"] = {"seed": SELFTEST_SEED, "outputs": fingerprint(out)}
    with open(os.path.join(out_dir, "artifact.json"), "w") as f:
        json.dump(meta, f)
    return {
        "out_dir": out_dir,
        "program_bytes": os.path.getsize(os.path.join(out_dir, "model.pt2")),
        "num_weights": len(flat),
        "weights_bytes": os.path.getsize(os.path.join(out_dir, "weights.npz")),
        "input_format": input_format, "batch_sizes": sizes, "device": dev.type,
        **({"quantize": quantize, **qstats} if quantize != "none" else {}),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", required=True)
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--batch_sizes", default=None, metavar="B1,B2,...",
                        help="one program per batch size in the same artifact (e.g. '1,8'); "
                             "the runtime runs each request on the smallest that fits. "
                             "Overrides --batch_size (the primary program is the largest)")
    parser.add_argument("--quantize", choices=QUANTIZE, default="none",
                        help="int8 = weight-only (int8 weights in weights.npz); w8a8 = "
                             "calibrated static W8A8 convs (torch._int_mm on the card); "
                             "w8a8_fused = the same lattice through the fused int8 ConvBN "
                             "kernel; w8a8_fused_chain = + int8-resident ResBlocks")
    parser.add_argument("--input_format", choices=["rgb", "yuv420"], default="rgb",
                        help="yuv420 exports the planar 4:2:0 serving path")
    parser.add_argument("--pad_hw", default=None, metavar="H,W",
                        help="raw-input canvas the artifact takes (default: 1.5x input_hw)")
    parser.add_argument("--fold_bn", action="store_true", default=None,
                        help="fold BatchNorm into the conv kernels (default: on for "
                             "--quantize none only; folding coarsens the int8 grid)")
    parser.add_argument("--no_fold_bn", dest="fold_bn", action="store_false",
                        help="ship unfolded kernels and the BN normalize")
    parser.add_argument("--tta", default="none", choices=["none", "hflip"],
                        help="record horizontal-flip TTA in the program (2x compute)")
    parser.add_argument("--average_last", type=int, default=0, metavar="N",
                        help="ship the mean of the last N retained checkpoints")
    parser.add_argument("--device", default="cuda",
                        help="'cuda', 'cuda:N' or 'cpu': where the program is recorded and "
                             "its selftest fingerprint taken")
    args = parser.parse_args(argv)
    if args.fold_bn is None:
        args.fold_bn = args.quantize == "none"
    sizes = [int(s) for s in args.batch_sizes.split(",") if s] if args.batch_sizes else None
    pad_hw = None
    if args.pad_hw:
        from cvm_tpu_torch.utils.config import parse_hw

        pad_hw = parse_hw(args.pad_hw, "--pad_hw")
    stats = export_model(args.model, args.checkpoint_dir, args.out, args.batch_size,
                         pad_hw=pad_hw, quantize=args.quantize,
                         input_format=args.input_format, fold_bn=args.fold_bn, tta=args.tta,
                         average_last=args.average_last, batch_sizes=sizes, device=args.device)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
