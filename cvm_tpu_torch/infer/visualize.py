"""Host-side result rendering (the reference's OpenCV drawing, SURVEY.md §1 L6).

The port's copy of ``cvm_tpu/infer/visualize.py`` (numpy and PIL there
too): ``render_sample`` draws a pipeline's outputs (boxes, 3D wireframes,
a class map, depth) on the source frame, ``render_record`` a record's
ground truth; the PNGs are the reference's, pixel for pixel
(``tests/test_torch_data_tools.py``). A raw-YUV record converts through
``data/jpeg.py::_yuv420_to_rgb_np``.

Only used by the --visualize CLI flag and ``cli.inspect``; the hot inference
path never touches this. PIL-based to avoid a hard cv2 dependency.
"""

from __future__ import annotations

import io
from typing import Dict, Optional, Sequence

import numpy as np

from cvm_tpu_torch.models.semseg.params import SEMSEG_PALETTE


def _class_color(c: int):
    return tuple(int(v) for v in SEMSEG_PALETTE[int(c) % len(SEMSEG_PALETTE)])


def _class_label(c: int, score: Optional[float],
                 names: Optional[Sequence[str]]) -> str:
    name = names[int(c)] if names and 0 <= int(c) < len(names) else str(int(c))
    return name if score is None else f"{name}:{score:.2f}"


def _draw_boxes(draw, boxes, scores, classes, score_threshold: float,
                names: Optional[Sequence[str]] = None) -> None:
    for b, s, c in zip(boxes, scores, classes):
        if s < score_threshold:
            continue
        x0, y0, x1, y1 = [float(v) for v in b]
        x0, x1 = sorted((x0, x1))  # tolerate degenerate/inverted boxes
        y0, y1 = sorted((y0, y1))
        color = _class_color(c)
        draw.rectangle([x0, y0, x1, y1], outline=color, width=2)
        label = _class_label(c, None if s >= 1.0 else float(s), names)
        draw.text((x0 + 2, max(y0 - 10, 0)), label, fill=color)


def _draw_wireframes(draw, centers3d, dims, yaw, intrinsics, classes, scores,
                     score_threshold: float) -> None:
    # Monocular 3D wireframes (reference: KITTI 3D drawing, SURVEY.md §2
    # "CenterNet processor" optional 3D targets). Camera frame: X right,
    # Y down, Z forward; yaw rotates about the vertical (Y) axis.
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
             (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
    for k in range(len(centers3d)):
        if float(scores[k]) < score_threshold:
            continue
        X, Y, Z = [float(v) for v in centers3d[k]]
        if Z <= 0.5:
            continue
        bh, bw, bl = [float(v) for v in dims[k]]
        cs, sn = np.cos(float(yaw[k])), np.sin(float(yaw[k]))
        corners = []
        for sx in (-0.5, 0.5):
            for sy in (-0.5, 0.5):
                for sz in (-0.5, 0.5):
                    # local (l, h, w) box, heading along local x
                    lx, ly, lz = sx * bl, sy * bh, sz * bw
                    wx = cs * lx + sn * lz + X
                    wz = -sn * lx + cs * lz + Z
                    corners.append((wx, ly + Y, wz))
        order = [0, 1, 3, 2, 4, 5, 7, 6]  # ring order per face
        corners = [corners[i] for i in order]
        pts = [((fx * x / z) + cx, (fy * y / z) + cy) for x, y, z in corners]
        cls = int(classes[min(k, len(classes) - 1)]) if len(classes) else 0
        color = _class_color(cls)
        for a, b in edges:
            draw.line([pts[a], pts[b]], fill=color, width=1)


def render_sample(out_path: Optional[str], image, image_hw,
                  outputs: Dict[str, np.ndarray],
                  score_threshold: float = 0.3,
                  class_names: Optional[Sequence[str]] = None
                  ) -> Optional[np.ndarray]:
    """Draw model *outputs* (pipeline predictions, original-pixel coords).
    out_path=None returns the rendered uint8 RGB array instead of saving
    (the TensorBoard image-summary path)."""
    from PIL import Image, ImageDraw

    h, w = int(image_hw[0]), int(image_hw[1])
    img = Image.fromarray(np.asarray(image)[:h, :w].copy())

    def _unletterbox(canvas: np.ndarray) -> np.ndarray:
        """Crop the letterbox content window out of a model-canvas map so
        the overlay aligns with the original image (mirrors letterbox_roi:
        scale = min(out/in), centered, pad bars outside the window). Boxes
        get the same inverse via map_boxes_to_input; stretching the WHOLE
        canvas (pad bars included) would land the overlay squashed/offset."""
        ch, cw = canvas.shape[:2]
        scale = min(ch / h, cw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        y0 = int(np.floor((ch - nh) * 0.5))
        x0 = int(np.floor((cw - nw) * 0.5))
        return canvas[y0 : y0 + max(nh, 1), x0 : x0 + max(nw, 1)]

    # Blend dense overlays FIRST so box/wireframe strokes stay full-strength.
    if "class_map" in outputs:
        cm = _unletterbox(np.asarray(outputs["class_map"]))
        pal = np.asarray(SEMSEG_PALETTE, np.uint8)
        overlay = pal[np.clip(cm, 0, len(pal) - 1)]
        ov = Image.fromarray(overlay).resize(img.size, Image.NEAREST)
        img = Image.blend(img.convert("RGB"), ov, 0.4)

    if "depth" in outputs and "class_map" not in outputs:
        d = _unletterbox(np.asarray(outputs["depth"])[..., 0])
        dn = (255 * (1.0 - (d - d.min()) / max(np.ptp(d), 1e-6))).astype(np.uint8)
        dm = Image.fromarray(dn).convert("RGB").resize(img.size)
        img = Image.blend(img.convert("RGB"), dm, 0.5)

    draw = ImageDraw.Draw(img)
    if "boxes" in outputs:
        _draw_boxes(draw, outputs["boxes"], outputs["scores"],
                    outputs["classes"], score_threshold, class_names)

    if "centers3d" in outputs and "intrinsics" in outputs:
        scores = outputs.get("scores", np.ones(len(outputs["centers3d"])))
        classes = np.asarray(outputs.get("classes", np.zeros(1)))
        _draw_wireframes(draw, outputs["centers3d"], outputs["dims"],
                         outputs["yaw"], outputs["intrinsics"], classes,
                         scores, score_threshold)

    if out_path is None:
        return np.asarray(img.convert("RGB"))
    img.save(out_path)
    return None


def _record_rgb(blobs: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
    """Decode a record's image blob to HxWx3 uint8 RGB (jpeg / raw-YUV / raw)."""
    if "jpeg" in blobs:
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(blobs["jpeg"])).convert("RGB"))
    if "y" in blobs:
        from cvm_tpu_torch.data.jpeg import _yuv420_to_rgb_np

        return _yuv420_to_rgb_np(blobs["y"], blobs["u"], blobs["v"])
    if "image" in blobs:
        return np.asarray(blobs["image"])
    return None


def render_record(out_path: str, meta: Dict, blobs: Dict,
                  class_names: Optional[Sequence[str]] = None) -> None:
    """Draw a record's GROUND TRUTH straight from the store (no model).

    The reference workflow this mirrors: pull one sample from MongoDB and
    visualize the uploaded labels to verify an upload script (SURVEY.md §4).
    Renders 2D boxes, 3D wireframes (when loc3d/dims3d/rot_y + intrinsics are
    present), the full-res semseg mask, and the (possibly sparse) depth map.
    """
    from PIL import Image, ImageDraw

    rgb = _record_rgb(blobs)
    if rgb is None:
        raise ValueError(f"record {meta.get('id')!r} has no image blob")
    rgb = np.ascontiguousarray(rgb)

    if "mask" in blobs:
        mask = np.asarray(blobs["mask"])
        pal = np.asarray(SEMSEG_PALETTE, np.uint8)
        valid = mask != 255  # IGNORE_INDEX stays un-tinted
        overlay = pal[np.clip(mask, 0, len(pal) - 1)]
        if overlay.shape[:2] != rgb.shape[:2]:  # tolerate scale mismatch
            overlay = np.asarray(Image.fromarray(overlay).resize(
                (rgb.shape[1], rgb.shape[0]), Image.NEAREST))
            valid = np.asarray(Image.fromarray(valid.astype(np.uint8)).resize(
                (rgb.shape[1], rgb.shape[0]), Image.NEAREST)).astype(bool)
        blend = (0.6 * rgb + 0.4 * overlay).astype(np.uint8)
        rgb = np.where(valid[..., None], blend, rgb)

    if "depth" in blobs:
        d = np.asarray(blobs["depth"]).astype(np.float32)
        if blobs["depth"].dtype == np.uint16:
            d = d / 256.0  # KITTI uint16 convention (label_spec)
        valid = d > 0
        if valid.any():
            lo, hi = d[valid].min(), d[valid].max()
            dn = np.clip(255 * (1.0 - (d - lo) / max(hi - lo, 1e-6)),
                         0, 255).astype(np.uint8)
            colored = np.stack([dn, dn // 2, 255 - dn], axis=-1)
            if colored.shape[:2] == rgb.shape[:2]:
                # Sparse GT: paint only valid pixels (blending zeros would
                # darken the whole frame).
                rgb = np.where(valid[..., None], colored, rgb)

    img = Image.fromarray(rgb)
    draw = ImageDraw.Draw(img)
    boxes = np.asarray(meta.get("boxes", []), np.float32).reshape(-1, 4)
    classes = np.asarray(meta.get("classes", []), np.int32)
    if len(boxes):
        _draw_boxes(draw, boxes, np.ones(len(boxes)), classes, 0.0, class_names)
    if meta.get("loc3d") and meta.get("intrinsics"):
        _draw_wireframes(draw, np.asarray(meta["loc3d"], np.float32),
                         np.asarray(meta["dims3d"], np.float32),
                         np.asarray(meta["rot_y"], np.float32),
                         meta["intrinsics"], classes,
                         np.ones(len(meta["loc3d"])), 0.0)
    img.save(out_path)
