"""cvm_tpu_torch.ops.decode against the det_* goldens and cvm_tpu's decode.

Random continuous logits have no ties, so scores, boxes and classes must
agree slot by slot (scores to float32 rounding of the sigmoid, 1e-6; boxes
1e-4 px). Where the golden has two equal scores, the order of those two
slots is the top-k's choice, so those rows are compared as a set.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.ops.decode import decode_centernet as j_decode
from cvm_tpu_torch.ops.decode import decode_centernet

_G = np.load(os.path.join(os.path.dirname(__file__), "goldens", "ops_goldens.npz"))


def _rows_sorted(boxes, classes):
    rows = np.concatenate([classes[:, None].astype(np.float32), boxes], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_decode_matches_golden():
    det = decode_centernet(torch.from_numpy(_G["heatmap"])[None],
                           torch.from_numpy(_G["offset"])[None],
                           torch.from_numpy(_G["size"])[None], stride=4, top_k=5,
                           from_logits=False)
    np.testing.assert_allclose(det.scores.numpy(), _G["det_scores"], atol=1e-6)
    valid = _G["det_scores"][0] > 0
    np.testing.assert_allclose(
        _rows_sorted(det.boxes[0].numpy()[valid], det.classes[0].numpy()[valid]),
        _rows_sorted(_G["det_boxes"][0][valid], _G["det_classes"][0][valid]), atol=1e-4)


@pytest.mark.parametrize("B,Hs,Ws,C,top_k", [
    (2, 16, 12, 5, 20),
    (1, 32, 32, 80, 100),
    (2, 2, 2, 3, 20),      # top_k > Hs*Ws*C: zero-padded slots
])
def test_decode_matches_reference(B, Hs, Ws, C, top_k):
    rng = np.random.default_rng(Hs * 100 + C)
    hm = rng.normal(-2.0, 1.5, (B, Hs, Ws, C)).astype(np.float32)
    off = rng.uniform(0, 1, (B, Hs, Ws, 2)).astype(np.float32)
    size = rng.uniform(1, 8, (B, Hs, Ws, 2)).astype(np.float32)
    ref = j_decode(jnp.asarray(hm), jnp.asarray(off), jnp.asarray(size), stride=4,
                   top_k=top_k)
    got = decode_centernet(torch.from_numpy(hm), torch.from_numpy(off),
                           torch.from_numpy(size), stride=4, top_k=top_k)
    assert got.scores.shape == (B, top_k) and got.classes.dtype == torch.int32
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-6)
    valid = np.asarray(ref.scores) > 0
    np.testing.assert_array_equal(got.classes.numpy()[valid], np.asarray(ref.classes)[valid])
    np.testing.assert_allclose(got.boxes.numpy()[valid], np.asarray(ref.boxes)[valid],
                               atol=1e-4)


def test_decode_flattens_nhwc():
    """One peak per class at different pixels: the decoded class and box
    centre must follow the NHWC (pixel, class) layout."""
    hm = np.full((1, 8, 8, 3), -10.0, np.float32)
    hm[0, 1, 6, 2] = 3.0   # class 2 at (y=1, x=6)
    hm[0, 5, 2, 0] = 2.0   # class 0 at (y=5, x=2)
    zeros = np.zeros((1, 8, 8, 2), np.float32)
    det = decode_centernet(torch.from_numpy(hm), torch.from_numpy(zeros),
                           torch.from_numpy(zeros), stride=4, top_k=2)
    assert det.classes[0].tolist() == [2, 0]
    assert det.boxes[0, :, 0].tolist() == [24.0, 8.0]
    assert det.boxes[0, :, 1].tolist() == [4.0, 20.0]
