"""The port's copies of JAX-free reference modules against the originals.

The port imports nothing of the JAX package, so it carries its own
``pad_rows`` (``cvm_tpu/utils/batch.py``), ``BaseParams`` / ``parse_hw``
(``cvm_tpu/utils/config.py``), ``synthetic_batch`` with its two-frame, 3D
and 4:2:0 options (``cvm_tpu/data/synthetic.py``), the numpy evaluators
(``cvm_tpu/train/evaluate.py``) and ``EarlyStopper``
(``cvm_tpu/train/early_stop.py``). Each must give exactly what its original
gives: the same arrays from the same generator, the same config JSON; the
evaluators and ``EarlyStopper`` are verbatim copies, held to the original
source and run side by side.
"""

import inspect
import json

import numpy as np
import pytest

import cvm_tpu.train.evaluate as j_evaluate
from cvm_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from cvm_tpu.data.synthetic import synthetic_iterator as j_synthetic_iterator
from cvm_tpu.models.centernet.params import CenternetParams as JCenternetParams
from cvm_tpu.train.early_stop import EarlyStopper as JEarlyStopper
from cvm_tpu.utils.batch import pad_rows as j_pad_rows
from cvm_tpu.utils.config import parse_hw as j_parse_hw
from cvm_tpu_torch.data.synthetic import SyntheticIterator, synthetic_batch
import cvm_tpu_torch.train.evaluate as t_evaluate
from cvm_tpu_torch.models.centernet.params import CenternetParams
from cvm_tpu_torch.train.early_stop import EarlyStopper
from cvm_tpu_torch.utils.batch import pad_rows
from cvm_tpu_torch.utils.config import parse_hw


def _assert_batch_identical(seed, pad_hw, num_classes, max_objects, **kw):
    ref = j_synthetic_batch(np.random.default_rng(seed), 3, pad_hw, num_classes, max_objects,
                            **kw)
    rng = np.random.default_rng(seed)
    got = synthetic_batch(rng, 3, pad_hw, num_classes, max_objects, **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # The generator ends where the reference's does: the next draw agrees.
    j_rng = np.random.default_rng(seed)
    j_synthetic_batch(j_rng, 3, pad_hw, num_classes, max_objects, **kw)
    assert rng.integers(1 << 30) == j_rng.integers(1 << 30)


SIZES = [((80, 96), 3, 8), ((128, 128), 10, 16)]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("pad_hw,num_classes,max_objects", SIZES)
def test_synthetic_batch_identical(seed, pad_hw, num_classes, max_objects):
    _assert_batch_identical(seed, pad_hw, num_classes, max_objects)


# (two_frame, with_3d, yuv420): each option alone, then all three.
OPTIONS = [(True, False, False), (False, True, False), (False, False, True),
           (True, True, True)]


@pytest.mark.parametrize("options", OPTIONS, ids=lambda f: "-".join(
    n for n, on in zip(("two_frame", "with_3d", "yuv420"), f) if on))
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("pad_hw,num_classes,max_objects", SIZES)
def test_synthetic_batch_options_identical(seed, pad_hw, num_classes, max_objects, options):
    """Every array of the two-frame, 3D and 4:2:0 options, bit for bit:
    the generator's draws come in the reference's order."""
    _assert_batch_identical(seed, pad_hw, num_classes, max_objects,
                            **dict(zip(("two_frame", "with_3d", "yuv420"), options)))


def _assert_stream_identical(two_frame, with_3d):
    it = SyntheticIterator(5, 2, (64, 64), num_classes=3, max_objects=4, two_frame=two_frame,
                           with_3d=with_3d)
    ref_it = j_synthetic_iterator(5, 2, (64, 64), 3, 4, two_frame=two_frame, with_3d=with_3d)
    for _ in range(2):
        got, ref = next(it), next(ref_it)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_synthetic_iterator_is_the_reference_stream():
    _assert_stream_identical(False, False)


def test_synthetic_iterator_two_frame_3d_is_the_reference_stream():
    _assert_stream_identical(True, True)


CLI = ["--input_hw", "256,320", "--num_classes", "10", "--ema_decay", "0.999",
       "--aug_scale_range", "0.5,1.5", "--space_to_depth_stem", "false",
       "--optimizer", "sgd", "--warmup_steps", "7"]


@pytest.mark.parametrize("argv", [[], CLI], ids=["defaults", "overrides"])
def test_config_round_trips_like_the_reference(argv):
    got, ref = CenternetParams.from_cli(argv), JCenternetParams.from_cli(argv)
    assert got.to_json() == ref.to_json()
    d = json.loads(ref.to_json())
    assert CenternetParams.from_dict(d) == got
    assert JCenternetParams.from_dict(json.loads(got.to_json())) == ref
    assert got.replace(batch_size=3).to_dict() == ref.replace(batch_size=3).to_dict()


def test_parse_hw_identical():
    assert parse_hw("12,34", "--pad_hw") == j_parse_hw("12,34", "--pad_hw") == (12, 34)
    for bad in ("12", "a,b", "0,4"):
        with pytest.raises(SystemExit) as e1:
            parse_hw(bad, "--pad_hw")
        with pytest.raises(SystemExit) as e2:
            j_parse_hw(bad, "--pad_hw")
        assert str(e1.value) == str(e2.value)


def test_pad_rows_identical():
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(3, 4)).astype(np.float32),
              rng.integers(0, 9, (3, 2, 2)).astype(np.int32), [[1, 2], [3, 4], [5, 6]]]
    for total in (3, 5):
        for g, r in zip(pad_rows(arrays, total), j_pad_rows(arrays, total)):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="more than the static"):
        pad_rows(arrays, 2)


@pytest.mark.parametrize("name", ["box_iou_matrix", "DetectionEvaluator", "Detection3dEvaluator",
                                  "SemsegEvaluator", "DepthEvaluator"])
def test_evaluators_are_verbatim_copies(name):
    assert inspect.getsource(getattr(t_evaluate, name)) == \
        inspect.getsource(getattr(j_evaluate, name))
    assert t_evaluate.COCO_IOU_THRESHOLDS == j_evaluate.COCO_IOU_THRESHOLDS
    assert t_evaluate._COCO_AREA_BUCKETS == j_evaluate._COCO_AREA_BUCKETS


def test_numpy_evaluators_agree_with_the_originals():
    rng = np.random.default_rng(4)
    seg = (j_evaluate.SemsegEvaluator(5), t_evaluate.SemsegEvaluator(5))
    dep = (j_evaluate.DepthEvaluator(median_scale=True),
           t_evaluate.DepthEvaluator(median_scale=True))
    d3 = (j_evaluate.Detection3dEvaluator(), t_evaluate.Detection3dEvaluator())
    for _ in range(3):
        pred, label = rng.integers(0, 5, (8, 8)), rng.integers(0, 6, (8, 8))
        label[0] = 255
        gt, pd = rng.uniform(0, 40, (8, 8)), rng.uniform(1, 50, (8, 8))
        gt[gt < 5] = 0
        xy = rng.uniform(0, 50, (4, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (4, 2))], 1)
        loc = rng.uniform(1, 30, (4, 3))
        classes = rng.integers(0, 2, 4)
        scores = rng.uniform(0.2, 1, 4)
        for ev in seg:
            ev.add(pred, label)
        for ev in dep:
            ev.add(pd, gt)
        for ev in d3:
            ev.add_image(boxes + 0.5, scores, classes, loc + 0.3, boxes, classes, loc)
    assert seg[1].compute(per_class=True, confusion=True) == \
        seg[0].compute(per_class=True, confusion=True)
    assert dep[1].compute() == dep[0].compute()
    assert d3[1].compute() == d3[0].compute() and d3[1].n_matched > 0


def test_early_stopper_is_the_original():
    assert inspect.getsource(EarlyStopper) == inspect.getsource(JEarlyStopper)
    metrics = [0.1, 0.3, 0.3, 0.29, 0.5, 0.5, 0.5, 0.2]
    for mode, patience in (("max", 2), ("min", 1), ("max", 3)):
        ours, ref = EarlyStopper("mAP", patience, mode), JEarlyStopper("mAP", patience, mode)
        got = [ours.update({"mAP": m}) for m in metrics] + [ours.update({})]
        want = [ref.update({"mAP": m}) for m in metrics] + [ref.update({})]
        assert got == want and any(got) and (ours.best, ours.stale) == (ref.best, ref.stale)
    for bad in ((0, "max"), (1, "up")):
        with pytest.raises(ValueError):
            EarlyStopper("mAP", *bad)
