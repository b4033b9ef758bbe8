"""Environment report: ``python -m cvm_tpu_torch.cli.doctor [--device cuda]``.

Mirrors ``cvm_tpu/cli/doctor.py::run_checks``: one JSON report that says
whether this machine can train and serve with the port, exiting 1 when a
required check fails (the device round trip, the registry forward, and on
a card the JPEG decoder's prerequisites). It reports the torch and CUDA
versions, the card's name and power limit (``nvidia-smi``), a timed device
round trip on distinct inputs, whether ``nvcc`` is found, one tiny
forward of a registry model, and the JPEG facts: ``jpeglib.h`` and
``libjpeg`` on the host, ``nvjpeg.h`` and ``libnvjpeg`` in the CUDA
toolkit, whether PIL imports, and which decoder ``data/jpeg.py`` uses for
each device; and whether OpenCV (``cv2``, which ``cli.video`` needs to
read and write clips) imports, with its version (``null`` when not: not a
failure, only ``cli.video`` needs it). There is no compilation-cache check:
nothing here compiles ahead of use.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

_INCLUDE_DIRS = ("/usr/include", "/usr/local/include")
_LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib", "/usr/local/lib",
             "/lib/x86_64-linux-gnu")


def _cuda_home() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            return os.environ[var]
    return "/usr/local/cuda"


def _first(patterns) -> str:
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return ""


def _libs(patterns) -> list:
    """The shared libraries matching ``patterns``, one path per file."""
    seen = {}
    for pat in patterns:
        for p in sorted(glob.glob(pat)):
            seen.setdefault(os.path.realpath(p), p)
    return sorted(seen.values())


def jpeg_facts() -> dict:
    """Where the decoders' headers and libraries are, PIL, and the decoder
    each device gets (``data/jpeg.py``)."""
    cuda = _cuda_home()
    facts = {
        "jpeglib_h": _first(f"{d}/jpeglib.h" for d in _INCLUDE_DIRS) or None,
        "libjpeg": _libs(f"{d}/libjpeg.so*" for d in _LIB_DIRS),
        "nvjpeg_h": _first([f"{cuda}/include/nvjpeg.h",
                            f"{cuda}/targets/x86_64-linux/include/nvjpeg.h"]) or None,
        "libnvjpeg": _libs([f"{cuda}/lib64/libnvjpeg.so*",
                            f"{cuda}/targets/x86_64-linux/lib/libnvjpeg.so*"]),
        "cxx": shutil.which(os.environ.get("CXX") or "g++"),
    }
    try:
        import PIL

        facts["pil"] = PIL.__version__
    except ImportError:
        facts["pil"] = None
    facts["decoder_cpu"] = ("libjpeg (csrc/jpeg_feeder.cc)"
                            if facts["jpeglib_h"] and facts["libjpeg"] and facts["cxx"]
                            else "none: needs a C++ compiler, jpeglib.h and libjpeg")
    facts["decoder_cuda"] = ("nvJPEG (csrc/jpeg_nvjpeg.cu)"
                             if facts["nvjpeg_h"] and facts["libnvjpeg"]
                             else "none: needs nvjpeg.h and libnvjpeg in the CUDA toolkit")
    return facts


def cv2_version():
    """OpenCV's version, or None when ``cv2`` does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2.__version__


def _nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "not available"
    except (OSError, subprocess.TimeoutExpired):
        return "not available"


def run_checks(device: str = "cuda", probe_iters: int = 8) -> dict:
    import torch

    from cvm_tpu_torch.utils.device import resolve_device

    report: dict = {"ok": True, "warnings": [], "torch": torch.__version__,
                    "cuda": torch.version.cuda}
    try:
        dev = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        report.update(ok=False, device_error=str(e))
        return report
    report["device"] = str(dev)
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(dev)
        report["nvidia_smi"] = _nvidia_smi()
    from cvm_tpu_torch.ops.cuda import _build

    try:
        report["nvcc"] = _build._nvcc()
    except RuntimeError:
        report["nvcc"] = None
        if dev.type == "cuda":
            report["ok"] = False
            report["warnings"].append("nvcc not found: the kernels cannot be built")

    # Timed device round trip on distinct inputs (each hop renormalised, so
    # no two calls see the same bytes), ending in a read back to the host.
    try:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(256, 256, generator=g).to(dev)
        y = (x @ x) * (1.0 / 16.0)
        float(y[0, 0])
        t0 = time.perf_counter()
        for _ in range(probe_iters):
            y = (y @ x) * (1.0 / 16.0)
        float(y[0, 0])
        report["dispatch_ms"] = round((time.perf_counter() - t0) / probe_iters * 1e3, 3)
    except RuntimeError as e:
        report.update(ok=False, device_op_error=f"{type(e).__name__}: {e}")

    try:
        from cvm_tpu_torch.models.registry import build_model, get_model, get_model_zoo

        report["models"] = sorted(get_model_zoo())
        spec = get_model("semseg")
        cfg = spec.params_cls(input_hw=(32, 32), num_classes=3, backbone="tiny",
                              decoder_features=16, class_weights=(1.0, 1.0, 1.0), batch_size=1)
        model = build_model(spec, cfg, dev, torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            out = model(torch.zeros(1, 32, 32, 3, device=dev))
        if tuple(out["logits"].shape) != (1, 32, 32, 3):
            raise RuntimeError(f"logits {tuple(out['logits'].shape)}")
        report["model_forward"] = "ok"
    except Exception as e:  # the report names any failure of the forward
        report.update(ok=False, model_forward_error=f"{type(e).__name__}: {e}")

    report["cv2"] = cv2_version()
    report["jpeg"] = facts = jpeg_facts()
    if facts[f"decoder_{dev.type}"].startswith("none"):
        report["ok"] = False
        report["warnings"].append(f"no JPEG decoder for {dev.type}: "
                                  f"{facts[f'decoder_{dev.type}']}")
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda", help="'cuda', 'cuda:N' or 'cpu'")
    parser.add_argument("--probe_iters", type=int, default=8)
    args = parser.parse_args(argv)
    report = run_checks(args.device, probe_iters=args.probe_iters)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
