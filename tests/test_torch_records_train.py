"""Training and evaluation from ``.cvrec`` shards in cvm_tpu_torch, against the
reference, on the CPU at a tiny size (``backbone="tiny"``).

* Two training steps from a shard: the port's and the reference's
  ``RecordLoader`` give identical batches of the same shard; the port's
  training processor on ``jax.random``'s draws gives the reference's
  inputs (1e-6); two SGD steps from the same converted init, on both
  sides, agree within the
  two-step tests' bounds (``tests/test_torch_train.py``,
  ``tests/test_torch_zoo_train.py``: loss and metrics 1e-2 relative,
  ``grad_norm`` 5%): CenterNet on a shard of boxes, multitask on one with
  masks and KITTI uint16 depth.
* ``cli.train --data``: CenterNet (``--decode_target`` auto, evals on the
  val split, ``--keep_best``, the input pipeline's stage times, a resume),
  multitask, and DMDS from two-frame shards; ``--decode_target`` off and
  ``H,W``, and a shard too small for one batch is refused.
* ``cli.evaluate --data``: each ``--split``, in the fp, ``--fold_bn``,
  ``--tta hflip`` and ``w8a8_fused_chain`` postures and through an
  exported artifact (yuv420 planes), each equal to ``evaluate_model`` of
  the same posture on the same loader.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvm_tpu.data.loader import RecordLoader as RefLoader
from cvm_tpu.data.records import RecordDataset as RefDataset
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.train.loop import create_train_state as j_create_state
from cvm_tpu.train.loop import make_train_step as j_make_train_step
from cvm_tpu.train.optim import make_optimizer as j_make_optimizer
from cvm_tpu_torch.cli.evaluate import main as eval_main
from cvm_tpu_torch.cli.export import main as export_main
from cvm_tpu_torch.cli.train import main as train_main
from cvm_tpu_torch.convert import convert_variables
from cvm_tpu_torch.data.loader import RecordLoader
from cvm_tpu_torch.data.records import RecordDataset
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.train.checkpoints import load_params_cfg
from cvm_tpu_torch.train.evaluate import evaluate_model
from cvm_tpu_torch.train.loop import Trainer, create_train_state, make_train_step
from cvm_tpu_torch.train.optim import make_optimizer

from cvm_tpu_torch.pipeline.preprocess import aug_from_params

from test_torch_processor import jax_draws
from test_torch_records import load_reference_decoder, make_shard
from test_torch_zoo_train import _to_torch_targets

CASES = {
    "centernet": dict(cfg=dict(input_hw=(64, 64), num_classes=3, backbone="tiny",
                               neck_features=32, head_features=16, batch_size=2,
                               max_objects=8),
                      pad=(96, 96), shard=dict(sizes=[(80, 90), (160, 150), (70, 96)] * 3)),
    "multitask": dict(cfg=dict(input_hw=(64, 128), backbone="tiny", neck_features=32,
                               head_features=16, batch_size=2, num_det_classes=3,
                               max_objects=8),
                      pad=(80, 160), shard=dict(sizes=[(70, 150), (120, 300), (64, 140)] * 3,
                                                mask=True, depth="u16")),
}


@pytest.fixture(scope="module", autouse=True)
def reference_decoder():
    load_reference_decoder()  # the reference loader's, never its PIL fallback


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_train_steps_from_a_shard_match_reference(tmp_path, name):
    # Batches of 8 (config B's): the two sides round to bf16 in different
    # places, and the offset L1's sign at near-zero residuals and the argmax
    # ties of an untrained seg head turn that into discrete jumps of the
    # batch mean, which shrink with the batch (at 2 and 4: loss_off 1.07%,
    # pixel_acc 1.03-2.15%, grad_norm 9.2% with the eval letterbox's exactly
    # zero offsets; at 8 the largest gap is 2.1%, in grad_norm).
    B = 8
    case = CASES[name]
    path = make_shard(tmp_path / "s.cvrec", **case["shard"], seed=4)
    kw = dict(case["cfg"], batch_size=B, optimizer="sgd", lr_schedule="constant",
              warmup_steps=1, learning_rate=0.02, weight_decay=1e-3, ema_decay=0.9)
    jspec, tspec = j_get_model(name), get_model(name)
    jp, tp = jspec.params_cls(**kw), tspec.params_cls(**kw)
    lkw = dict(batch_size=B, pad_hw=case["pad"], max_objects=8, seed=1, target_hw=(83, 83))
    train_ids = RecordDataset([path]).split_ids()[0]
    port_it = iter(RecordLoader(RecordDataset([path]), ids=train_ids, **lkw))
    ref_it = iter(RefLoader(RefDataset([path]), ids=train_ids, **lkw))
    try:
        raw, ref_raw = next(port_it), next(ref_it)
    finally:
        port_it.close()
        ref_it.close()
    assert set(raw) == set(ref_raw)
    for k in raw:
        np.testing.assert_array_equal(raw[k], ref_raw[k], err_msg=k)
    if name == "multitask":
        assert {"mask", "depth"} <= set(raw) and raw["depth"].max() > 1.0

    # The training processor, as cli.train runs it, on jax.random's draws
    # (injected into the port's deterministic core).
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    key = jax.random.PRNGKey(3)
    inputs, targets = jax.jit(jspec.make_processor(jp, train=True))(key, jraw)
    t_in, _ = tspec.make_processor(tp, train=True)(
        None, {k: torch.from_numpy(v) for k, v in raw.items()},
        draws=jax_draws(key, B, tp.input_hw, aug_from_params(tp)))
    np.testing.assert_allclose(t_in.float().numpy(), np.asarray(inputs, np.float32), atol=1e-6)

    jmodel = jspec.create_model(jp)
    tx = j_make_optimizer(jp.learning_rate, jp.total_steps, jp.warmup_steps, jp.weight_decay,
                          lr_schedule="constant", optimizer="sgd")
    state = jax.jit(lambda: j_create_state(jmodel, jp, tx,
                                           jnp.zeros((1, *jp.input_hw, 3)),
                                           {"params": jax.random.PRNGKey(1)}))()
    v0 = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    step = jax.jit(j_make_train_step(jmodel, jspec.loss_fn, jp, tx,
                                     lambda key, r: (inputs, targets)))
    jmetrics = []
    for _ in range(2):
        state, m = step(state, jraw, jax.random.PRNGKey(0))
        jmetrics.append(jax.device_get(m))

    model = tspec.create_model(tp, "cpu")
    model.load_state_dict(convert_variables(v0), strict=True)
    opt = make_optimizer(list(model.parameters()), tp.learning_rate, tp.total_steps,
                         tp.warmup_steps, tp.weight_decay, lr_schedule="constant",
                         optimizer="sgd")
    tstate = create_train_state(model, tp, opt)
    t_targets = _to_torch_targets(targets)
    tstep = make_train_step(tspec.loss_fn, tp,
                            lambda gen, r, rows: (torch.from_numpy(np.array(inputs)), t_targets))
    for jm in jmetrics:
        tstate, m = tstep(tstate, None, None)
        tm = {k: float(v) for k, v in m.items()}
        assert set(tm) == set(jm)
        for k in jm:
            rtol = 5e-2 if k == "grad_norm" else 1e-2
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol, atol=1e-6, err_msg=k)
    assert tstate.step == 2


def _metrics(wd):
    return [json.loads(line) for line in open(wd / "metrics.jsonl")]


CENTERNET_FLAGS = ["--model", "centernet", "--device", "cpu", "--pad_hw", "96,96",
                   "--input_hw", "64,64", "--backbone", "tiny", "--neck_features", "32",
                   "--head_features", "16", "--num_classes", "3", "--batch_size", "2",
                   "--max_objects", "8", "--warmup_steps", "2", "--log_every", "1"]


@pytest.fixture(scope="module")
def centernet_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("rec_train")
    shard = make_shard(root / "s.cvrec", [(80, 90), (160, 150), (70, 96), (90, 90)] * 5,
                       seed=6)  # 20 records: 18 train, 2 val
    wd = root / "w"
    argv = CENTERNET_FLAGS + ["--data", shard, "--workdir", str(wd), "--steps", "6",
                              "--checkpoint_every", "3", "--eval_every", "3",
                              "--eval_batches", "1", "--keep_best", "mAP"]
    return dict(root=root, shard=shard, wd=wd, argv=argv)


def test_cli_train_from_records(centernet_run, capsys):
    r = centernet_run
    assert train_main(r["argv"]) == 0
    out = capsys.readouterr().out
    assert "input pipeline: {'read_ms_per_batch'" in out and "'decode_ms_per_batch'" in out
    rows = _metrics(r["wd"])
    assert [x["step"] for x in rows if "loss" in x] == list(range(1, 7))
    assert all(np.isfinite(x["loss"]) for x in rows if "loss" in x)
    evals = [x for x in rows if "val_mAP" in x]
    assert [x["step"] for x in evals] == [3, 6]
    assert (r["wd"] / "best" / "best.json").exists()
    assert load_params_cfg(str(r["wd"] / "checkpoints"),
                           get_model("centernet").params_cls).input_hw == (64, 64)
    # a resume continues toward the total; the record stream restarts
    assert train_main(r["argv"][:-8] + ["--steps", "8", "--checkpoint_every", "4"]) == 0
    assert "2 of the --steps total remain" in capsys.readouterr().out
    for target in ("off", "100,100"):
        wd = r["root"] / f"w_{target.replace(',', '_')}"
        assert train_main(CENTERNET_FLAGS + ["--data", r["shard"], "--workdir", str(wd),
                                             "--steps", "1", "--decode_target", target]) == 0
    with pytest.raises(ValueError, match="cannot fill one batch"):
        train_main(CENTERNET_FLAGS + ["--data", r["shard"], "--workdir",
                                      str(r["root"] / "w_big"), "--steps", "1",
                                      "--batch_size", "32"])


def test_cli_train_multitask_and_dmds_from_records(tmp_path):
    mt = make_shard(tmp_path / "mt.cvrec", [(70, 150), (120, 300), (64, 140)] * 2, seed=2,
                    mask=True, depth="u16")
    assert train_main(["--model", "multitask", "--data", mt, "--device", "cpu", "--workdir",
                       str(tmp_path / "mt"), "--steps", "2", "--pad_hw", "80,160",
                       "--input_hw", "64,128", "--backbone", "tiny", "--neck_features", "32",
                       "--head_features", "16", "--num_det_classes", "3", "--batch_size",
                       "2", "--warmup_steps", "1", "--log_every", "1", "--eval_every", "2",
                       "--eval_batches", "1"]) == 0
    rows = _metrics(tmp_path / "mt")
    assert rows[-1]["step"] == 2 and "val_miou" in rows[-1]
    dm = make_shard(tmp_path / "dm.cvrec", [(70, 150), (64, 140)] * 2, seed=3, two_frame=True)
    assert train_main(["--model", "dmds", "--data", dm, "--device", "cpu", "--workdir",
                       str(tmp_path / "dm"), "--steps", "2", "--pad_hw", "80,160",
                       "--input_hw", "64,128", "--backbone", "tiny", "--decoder_features",
                       "16", "--motion_features", "32", "--batch_size", "2",
                       "--warmup_steps", "1", "--log_every", "1"]) == 0
    assert all(np.isfinite(x["loss"]) for x in _metrics(tmp_path / "dm"))


POSTURES = {"fp": [], "fold_bn": ["--fold_bn"], "hflip": ["--tta", "hflip"],
            "chain": ["--quantize", "w8a8_fused_chain", "--calib_batches", "1"]}


@pytest.mark.parametrize("posture", sorted(POSTURES))
def test_cli_evaluate_from_records_equals_evaluate_model(centernet_run, tmp_path, posture):
    r = centernet_run
    if not (r["wd"] / "checkpoints").exists():
        assert train_main(r["argv"]) == 0
    cfg = load_params_cfg(str(r["wd"] / "checkpoints"), get_model("centernet").params_cls)
    tr = Trainer(cfg, "cpu", checkpoint_dir=str(r["wd"] / "checkpoints"))
    tr.init_state()
    ds = RecordDataset([r["shard"]])
    train_ids, val_ids = ds.split_ids()
    for split, ids in (("val", val_ids), ("train", train_ids), ("all", None)):
        if posture != "fp" and split != "val":
            continue
        out = tmp_path / f"{split}.json"
        assert eval_main(["--model", "centernet", "--workdir", str(r["wd"]), "--device", "cpu",
                          "--pad_hw", "96,96", "--data", r["shard"], "--split", split,
                          "--json_out", str(out)] + POSTURES[posture]) == 0
        got = json.loads(out.read_text())
        kw = {"fold_bn": dict(fold_bn=True), "hflip": dict(tta="hflip")}.get(posture, {})
        if posture == "chain":
            from cvm_tpu_torch.cli.export import calibration_scales

            kw = dict(w8a8=calibration_scales(cfg, tr.eval_model(), (96, 96), 1, 2, "cpu"),
                      w8a8_fused=True, w8a8_chain=True)
        val = RecordLoader(ds, cfg.batch_size, (96, 96), ids=ids, shuffle=False, loop=False,
                           max_objects=cfg.max_objects)
        want = evaluate_model("centernet", cfg, tr.eval_model(), val, max_batches=50,
                              device="cpu", **kw)
        assert {k: got[k] for k in want} == want, (split, posture)


def test_cli_evaluate_artifact_from_records(centernet_run, tmp_path):
    r = centernet_run
    if not (r["wd"] / "checkpoints").exists():
        assert train_main(r["argv"]) == 0
    art = str(tmp_path / "art")
    assert export_main(["--model", "centernet", "--checkpoint_dir", str(r["wd"] / "checkpoints"),
                        "--out", art, "--pad_hw", "96,96", "--batch_size", "2",
                        "--input_format", "yuv420", "--device", "cpu"]) == 0
    out = tmp_path / "m.json"
    assert eval_main(["--artifact", art, "--device", "cpu", "--data", r["shard"], "--split",
                      "all", "--json_out", str(out)]) == 0
    got = json.loads(out.read_text())
    from cvm_tpu_torch.infer.runtime import ServingModel

    sm = ServingModel(art, device="cpu")
    cfg = get_model("centernet").params_cls.from_dict(sm.meta["params_cfg"])
    val = RecordLoader(RecordDataset([r["shard"]]), 2, (96, 96), shuffle=False, loop=False,
                       max_objects=cfg.max_objects, output_format="yuv420")
    want = evaluate_model("centernet", cfg, None, val, max_batches=50, device="cpu",
                          predict_fn=sm.predict_batch)
    assert {k: got[k] for k in want} == want
