"""Video inference (``cli/video.py``) against the reference's
(``cvm_tpu/cli/video.py``), on the CPU, with clips that ``cv2`` writes.

* ``read_frames`` (stride, limit, frame pairs, host downscale) and
  ``_pad_batch`` give the reference's frames and canvases exactly.
* ``run_video`` over the same clip through each side's fp pipeline of the
  same (converted) weights: the same frames in order, each frame's
  detections matched by ``test_torch_cli_infer.assert_jsonl_close`` (top
  scores within 0.01; every reference detection standing clear of the
  tail is one of the port's, class equal, box within 0.5 px, score within
  0.01: bf16 ties may add a neighbouring peak); an annotated mp4 of every
  frame at the clip's size.
* ``cli.video`` from a checkpoint writes the JSONL and the video, and
  keeps the reference's argument refusals.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cvm_tpu.cli import video as jvideo  # noqa: E402
from cvm_tpu.infer.pipeline import InferencePipeline as JPipeline  # noqa: E402
from cvm_tpu.models import get_model as j_get_model  # noqa: E402
from cvm_tpu_torch.cli import video  # noqa: E402
from cvm_tpu_torch.convert import convert_variables  # noqa: E402
from cvm_tpu_torch.infer.pipeline import InferencePipeline  # noqa: E402
from cvm_tpu_torch.models.centernet.params import CenternetParams  # noqa: E402
from test_torch_cli_infer import assert_jsonl_close  # noqa: E402
from test_torch_export import CFG, write_checkpoint  # noqa: E402
from test_torch_model import random_bn_stats  # noqa: E402


def write_clip(path, n=10, hw=(44, 60), fps=10):
    """An mp4 of synthetic scenes (the synthetic generator's, one per frame)."""
    from cvm_tpu_torch.data.synthetic import synthetic_sample

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (hw[1], hw[0]))
    assert w.isOpened()
    rng = np.random.default_rng(0)
    for _ in range(n):
        w.write(np.ascontiguousarray(
            synthetic_sample(rng, hw, num_classes=3, max_objects=4)["image"][..., ::-1]))
    w.release()
    return str(path)


def test_frames_and_canvases_are_the_references(tmp_path):
    clip = write_clip(tmp_path / "c.mp4", n=9, hw=(40, 72))
    for kw in (dict(stride=2, max_frames=3), dict(pairs=True, stride=3),
               dict(resize_long=36)):
        fps, got = video.read_frames(clip, **kw)
        rfps, want = jvideo.read_frames(clip, **kw)
        got, want = list(got), list(want)
        assert fps == rfps and len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g[0] == w[0]
            for a, b in zip(g[1:], w[1:]):
                np.testing.assert_array_equal(a, b)
    frames = [np.full((8, 10, 3), 7, np.uint8), np.full((6, 5, 3), 3, np.uint8)]
    for a, b in zip(video._pad_batch(frames, (8, 12)), jvideo._pad_batch(frames, (8, 12))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def weights():
    spec = j_get_model("centernet")
    jp = spec.params_cls(**CFG)
    variables = random_bn_stats(spec.create_model(jp).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False),
        np.random.default_rng(31))
    # a sharper heatmap head, as test_torch_cli_infer's, so that top scores
    # spread beyond the 0.01 the two sides may differ by
    hm = variables["params"]["hm"]["out"]
    hm["kernel"] = np.asarray(hm["kernel"]) * 6.0
    return spec, jp, variables


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_run_video_matches_reference(tmp_path, weights):
    spec, jp, variables = weights
    clip = write_clip(tmp_path / "c.mp4")
    cfg = CenternetParams(**CFG)
    model = get_port_model(cfg, variables)
    pipe = InferencePipeline(cfg, model, "cpu", input_format="rgb")
    fps, frames = video.read_frames(clip)
    n = video.run_video(lambda b: {k: v.numpy() for k, v in pipe(b).items()}, frames,
                        cfg.batch_size, (44, 60), fps, str(tmp_path / "out.mp4"),
                        str(tmp_path / "got.jsonl"), score_threshold=0.0)
    rpipe = JPipeline(spec, jp, {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items()})
    rfps, rframes = jvideo.read_frames(clip)
    rn = jvideo.run_video(rpipe, rframes, jp.batch_size, (44, 60), rfps, None,
                          str(tmp_path / "want.jsonl"), score_threshold=0.0)
    assert n == rn == 10
    got, want = _records(tmp_path / "got.jsonl"), _records(tmp_path / "want.jsonl")
    assert [g["frame"] for g in got] == [w["frame"] for w in want] == list(range(10))
    for rec in got + want:
        rec["input"] = rec.pop("frame")
    assert assert_jsonl_close(got, want) > 0
    cap = cv2.VideoCapture(str(tmp_path / "out.mp4"))
    count = 0
    while True:
        ok, f = cap.read()
        if not ok:
            break
        assert f.shape == (44, 60, 3)
        count += 1
    cap.release()
    assert count == 10


def get_port_model(cfg, variables):
    from cvm_tpu_torch.models.centernet.model import create_model

    m = create_model(cfg, "cpu")
    m.load_state_dict(convert_variables(variables), strict=True)
    return m.eval()


def test_cli_video_from_a_checkpoint(tmp_path, weights, capsys):
    _, _, variables = weights
    clip = write_clip(tmp_path / "c.mp4", n=5)
    ck = write_checkpoint(tmp_path / "ck", CenternetParams(**CFG), convert_variables(variables))
    assert video.main(["--model", "centernet", "--checkpoint_dir", ck, "--video", clip,
                       "--jsonl", str(tmp_path / "o.jsonl"), "--out", str(tmp_path / "o.mp4"),
                       "--batch_size", "2", "--stride", "2", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 3 and summary["fps_out"] == 5.0
    assert [r["frame"] for r in _records(tmp_path / "o.jsonl")] == [0, 2, 4]
    for argv in (["--video", clip], ["--video", clip, "--jsonl", "x", "--stride", "0"],
                 ["--video", clip, "--jsonl", "x"],
                 ["--video", clip, "--jsonl", "x", "--checkpoint_dir", ck]):
        with pytest.raises(SystemExit) as e:
            video.main(argv + ["--device", "cpu"])
        assert e.value.code == 2


def test_run_video_through_an_artifact_equals_cli_infer(tmp_path, weights):
    """The chip smoke's video check at a tiny size: an RGB export's
    ``predict`` under ``run_video`` gives, frame for frame, the lines
    ``cli.infer --artifact`` gives on the same decoded images (boxes and
    classes identical, scores equal after the JSONL's rounding to 4
    places)."""
    from PIL import Image

    from cvm_tpu_torch.cli.export import main as export_main
    from cvm_tpu_torch.cli.infer import main as infer_main
    from cvm_tpu_torch.data.images import read_image_as_jpeg
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch
    from cvm_tpu_torch.data.synthetic import synthetic_sample
    from cvm_tpu_torch.infer.runtime import ServingModel
    from test_torch_cli_infer import _run

    _, _, variables = weights
    ck = write_checkpoint(tmp_path / "ck", CenternetParams(**CFG), convert_variables(variables))
    art = str(tmp_path / "art")
    assert export_main(["--model", "centernet", "--checkpoint_dir", ck, "--out", art,
                        "--input_format", "rgb", "--batch_size", "2", "--pad_hw", "48,48",
                        "--device", "cpu"]) == 0
    rng = np.random.default_rng(3)
    (tmp_path / "im").mkdir()
    files = []
    for i, hw in enumerate([(40, 44), (30, 48), (48, 36)]):
        files.append(str(tmp_path / "im" / f"f{i}.jpg"))
        Image.fromarray(synthetic_sample(rng, hw, num_classes=3, max_objects=4)["image"]).save(
            files[-1], quality=90)
    rc, lines, err = _run(infer_main, ["--artifact", art, "--images",
                                       str(tmp_path / "im" / "*"), "--score_threshold", "0",
                                       "--device", "cpu"])
    assert rc == 0, err
    img, hw = decode_jpeg_batch([read_image_as_jpeg(f)[0] for f in files], 48, 48)
    frames = [(i, img[i, :hw[i, 0], :hw[i, 1]]) for i in range(len(files))]
    sm = ServingModel(art, device="cpu")
    assert video.run_video(video.artifact_predict(sm, (48, 48)), iter(frames), 2, (48, 48),
                           10.0, None, str(tmp_path / "v.jsonl"), score_threshold=0.0) == 3
    for got, want in zip(_records(tmp_path / "v.jsonl"), lines):
        assert got["boxes"] == want["boxes"] and got["classes"] == want["classes"]
        assert got["scores"] == np.round(np.float32(want["scores"]), 4).tolist()
