"""Every model of the registry trained by two gloo ranks against one process,
and tensor parallelism against the replicated port, on the CPU at a tiny
size (``tests/torch_dist_child.py``).

* Two ranks of 2 rows against one process of 4, for each model, 3 steps
  through ``Trainer.fit`` on the same global batches and the same draws
  (each rank draws for the global batch and keeps its rows): losses,
  metrics and the parameters' checksums exactly equal between the ranks;
  every step's loss within 5e-3 of the one process (the reference's bound
  for 2 processes against 1, ``tests/test_multiprocess.py``, which also
  holds the loss only), and every metric of the first step (the same
  weights on both sides) within 5e-3, ``grad_norm`` within 2e-2: the bf16
  convs' gradients differ by rounding alone by 5-9% of a leaf's norm
  between 2 ranks and 1 process (``test_torch_dist.py``), 0.59% in the
  norm of CenterNet's first step. After an Adam update the small terms
  move apart further (DMDS's ``loss_cycle`` by 8% at step 3: Adam turns
  bf16 noise in near-zero gradients into full-size steps). Each case
  fails when the losses reduce over each rank's rows alone; depth's berHu
  threshold (a global max) and DMDS's sparsity term (a nonlinear global
  mean) are terms that no sum of per-rank losses can give.
* Tensor parallelism over a model axis of 2: the ranks resume a
  one-process run's checkpoint (cut to their slices) and train 3 steps;
  their losses equal each other exactly and the one process's own
  continuation within 5e-3; each holds half of every ``s5b*.c1`` (C_out,
  with its BatchNorm) and ``s5b*.c2`` (C_in) and the rest whole; their
  checkpoint (gathered whole) loads in one process with the ranks' own
  checksum.
* Both at once, the mesh ``dryrun_multichip(4)`` builds: 4 ranks as 2
  data x 2 model; the four equal each other and the one process within
  5e-3.
"""

import shutil

import numpy as np
import pytest
import torch

import torch_dist_child as child
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.train.loop import Trainer

STEPS = 3


@pytest.mark.parametrize("name", ["centernet", "semseg", "depth", "multitask", "dmds"])
def test_two_ranks_equal_one_process(name, tmp_path):
    ranks = [r for r, _ in child.launch(2, ["train", "--model", name, "--steps", STEPS],
                                        str(tmp_path))]
    one = child.run_train(None, "cpu", name, "tiny", STEPS)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    assert ranks[0]["all_reduces"] == ranks[1]["all_reduces"] and min(ranks[0]["all_reduces"])
    assert one["all_reduces"] == [0] * STEPS
    assert len(set(one["losses"])) == STEPS and np.isfinite(one["losses"]).all()
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=5e-3)
    got, want = ranks[0]["metrics"][0], one["metrics"][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2 if k == "grad_norm" else 5e-3,
                                   err_msg=k)


def test_tensor_parallel_equals_the_replicated_port(tmp_path):
    one_dir, tp_dir = tmp_path / "one", tmp_path / "tp"
    child.run_train(None, "cpu", "centernet", "tiny", STEPS, ckdir=str(one_dir))
    shutil.copytree(one_dir, tp_dir)
    ranks = [r for r, _ in child.launch(
        2, ["train", "--model", "centernet", "--steps", STEPS, "--model_parallel", 2,
            "--tensor_parallel", "--ckdir", tp_dir], str(tmp_path))]
    one = child.run_train(None, "cpu", "centernet", "tiny", STEPS, ckdir=str(one_dir))
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=5e-3)

    full = one["shapes"]
    split = set(ranks[0]["split"])
    assert split == {f"backbone.s5b{b}.{p}" for b in (0, 1) for p in (
        "c1.conv.weight", "c1.bn.weight", "c1.bn.bias", "c1.bn.running_mean",
        "c1.bn.running_var", "c2.conv.weight")}
    for r in ranks:
        for name, shape in r["shapes"].items():
            want = list(full[name])
            if name in split:
                want[1 if ".c2." in name else 0] //= 2
            assert shape == want, name

    cfg = get_model("centernet").params_cls(**child.CONFIGS["tiny"]["centernet"][0],
                                            batch_size=4, tensor_parallel=True)
    back = Trainer(cfg, "cpu", checkpoint_dir=str(tp_dir))
    back.init_state()
    assert back.state.step == 2 * STEPS and not back.split
    got = float(sum(v.to(torch.float64).sum() for v in back.eval_params.values()))
    assert got == ranks[0]["checksum"]


def test_a_data_and_model_mesh_equals_one_process(tmp_path):
    ranks = [r for r, _ in child.launch(
        4, ["train", "--model", "centernet", "--steps", STEPS, "--model_parallel", 2,
            "--tensor_parallel"], str(tmp_path))]
    one = child.run_train(None, "cpu", "centernet", "tiny", STEPS)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert all(r["checksum"] == ranks[0]["checksum"] for r in ranks)
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=5e-3)
    assert ranks[0]["shapes"]["backbone.s5b0.c1.conv.weight"][0] * 2 == \
        one["shapes"]["backbone.s5b0.c1.conv.weight"][0]
