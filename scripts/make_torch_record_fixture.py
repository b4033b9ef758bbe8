#!/usr/bin/env python3
"""Write the committed JPEG record fixture: ``python3
scripts/make_torch_record_fixture.py [--out tests/data/torch_records]``.

It makes 8 config-B synthetic scenes (``cvm_tpu_torch/data/synthetic.py``,
10 classes, seed 2024), one of them larger than the 768x768 pad so that
the 1/2 DCT scale runs, encodes each with PIL as a JPEG (quality
``--quality``) and packs them into ``scenes.cvrec`` (``jpeg`` blob; meta:
id, height, width, boxes, classes, intrinsics). Then it decodes the shard's
JPEGs with the reference decoder (``cvm_tpu/native``, libjpeg) and writes:

* ``manifest.json``: per frame the SHA-256 of the padded decoded buffer
  and its ``hw``, in RGB and planar YUV420, at the 768x768 pad with and
  without ``target_hw=(665, 665)``;
* ``decoded_rgb.xz`` and ``decoded_yuv420.xz``: the reference's decoded
  pixels (no target), each frame's valid extent in order (RGB h*w*3; Y h*w,
  then U and V (h/2)*(w/2)), for a card that has no libjpeg;
* the gap between the reference's own two decoders (its PIL fallback
  against libjpeg) on these frames: mean and max |difference| over the
  valid pixels, in RGB and in YUV420, over all frames and per frame. The
  frame decoded at 1/2 is held to its own reading on a card without
  libjpeg (``chip_smoke.py::fixture_decode_check``);
* ``subsamplings.cvrec``: one more synthetic scene (99x133, seed 2025)
  encoded as 4:4:4, 4:2:2 and grayscale JPEGs (quality 90), each with the
  reference decoder's RGB at the scales 1, 1/2, 1/4 and 1/8 (a pad of
  exactly the scaled extent): meta ``decoded`` maps num (of num/8) to the
  ``hw`` and SHA-256 of the padded buffer and the reference's fallback gap
  at that scale (its PIL path against libjpeg: at a reduced scale a
  bilinear resize of the full decode), blob ``rgb`` is the valid pixels of
  the four scales in that order, xz-compressed.

Run it where the reference, libjpeg and PIL are installed; the output is
committed and read by ``tests/test_torch_records.py``,
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import lzma
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

PAD = (768, 768)
TARGET = (665, 665)
# Frame sizes (H, W): even, so the reference's PIL 4:2:0 path crops
# nothing; the last is larger than the pad and decodes at 1/2.
SIZES = [(352, 480), (416, 544), (480, 480), (384, 576), (336, 448), (448, 608),
         (400, 512), (900, 1148)]
SEED = 2024
# The scene of subsamplings.cvrec: odd sizes, so that every scale rounds up.
OTHER_HW, OTHER_SEED = (99, 133), 2025
OTHER_SUBSAMPLINGS = {"444": 0, "422": 1, "gray": None}  # PIL's subsampling


def make_scenes(quality: int):
    from PIL import Image

    from cvm_tpu_torch.data.synthetic import synthetic_sample

    rng = np.random.default_rng(SEED)
    records = []
    for i, hw in enumerate(SIZES):
        s = synthetic_sample(rng, hw, num_classes=10)
        n = int(s["num_objects"])
        buf = io.BytesIO()
        Image.fromarray(s["image"]).save(buf, format="JPEG", quality=quality)
        H, W = hw
        meta = {"id": f"scene{i:02d}", "height": H, "width": W,
                "boxes": s["boxes"][:n].tolist(), "classes": s["classes"][:n].tolist(),
                "intrinsics": [0.9 * W, 0.9 * W, W / 2.0, H / 2.0]}
        records.append((meta, buf.getvalue()))
    return records


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _gap(d):
    return {"mean_abs": float(d.mean()), "max_abs": int(d.max())}


def _gaps(a_frames, b_frames):
    """The gap over all frames, and per frame."""
    ds = [np.abs(a.astype(np.int16) - b.astype(np.int16)).ravel()
          for a, b in zip(a_frames, b_frames)]
    return dict(_gap(np.concatenate(ds)), per_frame=[_gap(d) for d in ds])


def _valid_rgb(batch, hw):
    return [batch[i, :h, :w] for i, (h, w) in enumerate(hw)]


def _valid_yuv(Y, U, V, hw):
    return [np.concatenate([Y[i, :h, :w].ravel(), U[i, :(h + 1) // 2, :(w + 1) // 2].ravel(),
                            V[i, :(h + 1) // 2, :(w + 1) // 2].ravel()])
            for i, (h, w) in enumerate(hw)]


def write_other_subsamplings(path: str, ref) -> None:
    """subsamplings.cvrec (see the module docstring)."""
    from PIL import Image

    from cvm_tpu_torch.data.records import RecordWriter
    from cvm_tpu_torch.data.synthetic import synthetic_sample

    img = synthetic_sample(np.random.default_rng(OTHER_SEED), OTHER_HW, num_classes=10)["image"]
    H, W = OTHER_HW
    with RecordWriter(path) as w:
        for name, sub in OTHER_SUBSAMPLINGS.items():
            buf = io.BytesIO()
            if sub is None:
                Image.fromarray(img).convert("L").save(buf, format="JPEG", quality=90)
            else:
                Image.fromarray(img).save(buf, format="JPEG", quality=90, subsampling=sub)
            data = buf.getvalue()
            decoded, pixels = {}, []
            for num in (8, 4, 2, 1):
                oh, ow = -(-H * num // 8), -(-W * num // 8)
                out, hw = ref.decode_jpeg_batch([data], oh, ow)
                if hw.tolist() != [[oh, ow]]:
                    raise SystemExit(f"{name} at {num}/8 decoded to {hw.tolist()}")
                pil = np.zeros_like(out)
                pil_hw = np.ones((1, 2), np.int32)
                ref._decode_batch_pil([data], oh, ow, pil, pil_hw)
                if pil_hw.tolist() != hw.tolist():
                    raise SystemExit(f"{name} at {num}/8: the fallback decoded to {pil_hw}")
                decoded[str(num)] = {"hw": [oh, ow], "sha256": _sha(out[0]),
                                     "fallback_gap": _gap(np.abs(pil.astype(np.int16) - out))}
                pixels.append(out[0].ravel())
            rgb = lzma.compress(np.concatenate(pixels).tobytes(), preset=9 | lzma.PRESET_EXTREME)
            w.write({"id": name, "height": H, "width": W, "decoded": decoded},
                    {"jpeg": data, "rgb": rgb})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=os.path.join(_ROOT, "tests", "data", "torch_records"))
    parser.add_argument("--quality", type=int, default=50)
    args = parser.parse_args(argv)

    import cvm_tpu.native as ref

    from cvm_tpu_torch.data.records import RecordDataset, RecordWriter

    os.makedirs(args.out, exist_ok=True)
    shard = os.path.join(args.out, "scenes.cvrec")
    with RecordWriter(shard) as w:
        for meta, jpeg in make_scenes(args.quality):
            w.write(meta, {"jpeg": jpeg})
    ds = RecordDataset([shard])
    jpegs = [ds.get(i)[1]["jpeg"] for i in range(len(ds))]

    if not ref.native_available():
        raise SystemExit("the reference's libjpeg decoder is not available here")
    manifest = {"pad_hw": list(PAD), "target_hw": list(TARGET), "quality": args.quality,
                "seed": SEED, "frames": len(jpegs), "decoded": {}}
    for tag, target in (("no_target", (0, 0)), ("target", TARGET)):
        rgb, hw = ref.decode_jpeg_batch(jpegs, *PAD, target_hw=target)
        Y, U, V, yhw = ref.decode_jpeg_batch_yuv420(jpegs, *PAD, target_hw=target)
        manifest["decoded"][tag] = {
            "rgb": {"sha256": [_sha(f) for f in rgb], "hw": hw.tolist()},
            "yuv420": {"sha256": [_sha(np.concatenate([Y[i].ravel(), U[i].ravel(),
                                                        V[i].ravel()]))
                                  for i in range(len(jpegs))], "hw": yhw.tolist()}}
        if tag == "no_target":
            ref_rgb, ref_hw = _valid_rgb(rgb, hw), hw
            ref_yuv, ref_yhw = _valid_yuv(Y, U, V, yhw), yhw
            for name, frames in (("decoded_rgb.xz", ref_rgb), ("decoded_yuv420.xz", ref_yuv)):
                with open(os.path.join(args.out, name), "wb") as f:
                    f.write(lzma.compress(b"".join(a.tobytes() for a in frames),
                                          preset=9 | lzma.PRESET_EXTREME))

    # The reference's PIL fallback on the same frames: its RGB path
    # (_decode_batch_pil) and its YUV420 path (decode_jpeg_batch_yuv420
    # without the library).
    pil = np.zeros((len(jpegs), *PAD, 3), np.uint8)
    pil_hw = np.ones((len(jpegs), 2), np.int32)
    ref._decode_batch_pil(jpegs, *PAD, pil, pil_hw)
    real = ref.get_lib
    ref.get_lib = lambda: None
    try:
        pY, pU, pV, pil_yhw = ref.decode_jpeg_batch_yuv420(jpegs, *PAD)
    finally:
        ref.get_lib = real
    if pil_hw.tolist() != ref_hw.tolist() or pil_yhw.tolist() != ref_yhw.tolist():
        raise SystemExit(f"the reference's decoders disagree on sizes: {pil_hw.tolist()} "
                         f"{ref_hw.tolist()} {pil_yhw.tolist()} {ref_yhw.tolist()}")
    manifest["fallback_gap"] = {
        "rgb": _gaps(_valid_rgb(pil, pil_hw), ref_rgb),
        "yuv420": _gaps(_valid_yuv(pY, pU, pV, pil_yhw), ref_yuv)}
    write_other_subsamplings(os.path.join(args.out, "subsamplings.cvrec"), ref)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    sizes = {n: os.path.getsize(os.path.join(args.out, n)) for n in sorted(os.listdir(args.out))}
    print(json.dumps({"files": sizes, "total": sum(sizes.values()),
                      "fallback_gap": manifest["fallback_gap"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
