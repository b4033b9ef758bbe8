"""Data-parallel training of the port (``cvm_tpu_torch/parallel``) on the CPU:
two gloo ranks (``tests/torch_dist_child.py``) against the reference's
sharded step and against one process, at a tiny size.

* Two steps of the tiny CenterNet, global batch 4: the reference's
  ``Trainer`` on 4 devices of the conftest's 8-device CPU mesh, its batch sharded
  as it trains (GSPMD makes BatchNorm's statistics and the loss's counts
  global), against two ranks of 2 rows each from the same converted weights
  and processed inputs; and the port in one process on the same inputs.
  Loss and metrics within 5e-3 of the one process (the reference's own
  bound for 2 processes against 1, ``tests/test_multiprocess.py``) and
  within 2e-2 of the reference: on this batch the one-process port is
  already 1.02% off the reference in ``loss_off`` (``tests/test_torch_train.py``
  holds 1e-2 on its own batch). The first step's gradients within the bounds
  ``tests/test_torch_train.py`` sets for one process (30% of each leaf's
  norm, 15% over all leaves); between the ranks exact.
* The same with every conv in float32 on both sides (the reference's
  layers built with float32 for the test's duration): the two ranks and
  one process within 1e-4 of the reference in every metric and 1e-3 of
  each leaf's gradient norm (measured on the CPU: 1.6e-6 and 2.5e-5).
  So the 1.02% is the two sides' bf16 rounding: the reference's bf16 step
  is 0.87% off its own float32 step in ``loss_off``, the port's 0.15%.
* A batch whose objects all sit in rank 0's rows (rank 1's local count of
  positives is 0), every conv in float32: the two ranks' gradients equal
  one process's within 1e-4 of each leaf's norm (in bf16 the two differ
  by 5-9% of a leaf's norm from rounding alone, as ``test_torch_train.py``
  finds bf16 against float32), where a per-rank loss (each half trained
  alone, the gradients averaged) is off by more than half the norm.
* ``BatchNorm`` under a group of two: output, input gradient and running
  statistics equal one process's on the whole batch within 1e-5.
* A stop asked on one rank stops both after the same step.
* The reference's tensor-parallel rules select the same parameters, on
  the same dimensions, as the port's; the mesh's argument checks; a group
  that cannot form raises within its timeout.
"""

import contextlib
import inspect
import json
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_child as child
from cvm_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.models.centernet.processor import make_processor as j_make_processor
from cvm_tpu.parallel.mesh import make_mesh as j_make_mesh
from cvm_tpu.parallel.sharding import tp_rules_for as j_tp_rules_for
from cvm_tpu.train.loop import make_train_step as j_make_train_step
from cvm_tpu.train.loop import Trainer as JTrainer
from cvm_tpu_torch.convert import convert_variables, flax_path_to_module_name
from cvm_tpu_torch.models import get_model
from cvm_tpu_torch.parallel.mesh import free_port, init_distributed, make_mesh, single_mesh
from cvm_tpu_torch.parallel.sharding import match_rules, tp_rules_for

KW = dict(child.CONFIGS["tiny"]["centernet"][0], batch_size=4, optimizer="sgd",
          lr_schedule="constant", warmup_steps=1, learning_rate=0.05, weight_decay=1e-3)
TARGET_FIELDS = ("heatmap", "offset", "size", "mask", "indices", "valid")


def _leaf_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want)
    assert err <= tol * max(np.linalg.norm(want), 1e-8), (what, err, np.linalg.norm(want))


def _write_npz(path, name, cfg, sd, inputs, targets, float32=False):
    arrays = {f"sd/{k}": v.numpy() for k, v in sd.items()}
    arrays.update({f"t/{f}": np.asarray(getattr(targets, f)) for f in TARGET_FIELDS})
    np.savez(path, name=json.dumps(name), cfg=cfg.to_json(), inputs=np.asarray(inputs),
             float32=float32, **arrays)


@contextlib.contextmanager
def _reference_in_float32():
    """The reference's layers (``cvm_tpu/models/layers.py``, its backbone)
    built with float32 where their default compute dtype is bfloat16: their
    constructors' defaults are swapped for the duration, and nothing of
    the package's code changes."""
    import flax.linen as nn

    from cvm_tpu.models import backbones, layers

    with contextlib.ExitStack() as stack:
        for mod in (layers, backbones):
            for cls in vars(mod).values():
                if not (inspect.isclass(cls) and issubclass(cls, nn.Module)):
                    continue
                init = inspect.unwrap(cls.__init__)
                if init.__defaults__ and any(d is jnp.bfloat16 for d in init.__defaults__):
                    stack.enter_context(mock.patch.object(init, "__defaults__", tuple(
                        jnp.float32 if d is jnp.bfloat16 else d for d in init.__defaults__)))
        assert layers.ConvBN(4).dtype is jnp.float32
        yield


def _reference_and_ranks(tmp, float32: bool):
    """The reference's two sharded steps, its first step's gradients, and
    the two ranks' and one process's on the same weights and processed
    inputs; every conv in float32 on both sides with ``float32``."""
    with _reference_in_float32() if float32 else contextlib.nullcontext():
        return _reference_steps_and_ranks(tmp, float32)


def _reference_steps_and_ranks(tmp, float32):
    spec = j_get_model("centernet")
    jp = spec.params_cls(**KW)
    trainer = JTrainer(spec, jp, mesh=j_make_mesh(jax.devices()[:4]))
    trainer.init_state()
    raw = j_synthetic_batch(np.random.default_rng(0), 4, (80, 96), num_classes=3,
                            max_objects=8)
    raw = {k: jnp.asarray(raw[k]) for k in ("image", "image_hw", "boxes", "classes",
                                            "num_objects")}
    inputs, targets = jax.jit(j_make_processor(jp, train=True))(jax.random.PRNGKey(3), raw)
    state = trainer.state
    v0 = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    batch = jax.device_put((inputs, targets), trainer._batch_sh)

    def loss_fn(p):
        out, _ = trainer.model.apply({"params": p, "batch_stats": state.batch_stats},
                                     batch[0], train=True, mutable=["batch_stats"])
        return spec.loss_fn(out, batch[1], jp)[0]

    jgrads = jax.device_get(jax.jit(jax.grad(loss_fn))(state.params))
    trainer._step_fn = j_make_train_step(trainer.model, spec.loss_fn, jp, trainer.tx,
                                         lambda key, b: b)
    step = trainer._jit_step(trainer._repl)
    jmetrics = []
    for _ in range(2):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        jmetrics.append({k: float(v) for k, v in jax.device_get(m).items()})

    tp = get_model("centernet").params_cls(**KW)
    _write_npz(tmp / "in.npz", "centernet", tp, convert_variables(v0), inputs, targets,
               float32=float32)
    ranks = child.launch(2, ["grads", "--npz", tmp / "in.npz", "--steps", "2"], str(tmp))
    one, one_grads = child.run_grads(None, "cpu", str(tmp / "in.npz"), 2)
    return dict(jgrads=jgrads, jmetrics=jmetrics, ranks=ranks, one=one["metrics"],
                one_grads=one_grads)


@pytest.fixture(scope="module")
def reference_and_ranks(tmp_path_factory):
    return _reference_and_ranks(tmp_path_factory.mktemp("dist_ref"), float32=False)


def test_two_ranks_equal_each_other_exactly(reference_and_ranks):
    (r0, g0), (r1, g1) = reference_and_ranks["ranks"]
    assert r0["metrics"] == r1["metrics"]
    assert sorted(g0) == sorted(g1)
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)


def test_two_ranks_match_the_sharded_reference_step(reference_and_ranks):
    (r0, _), _ = reference_and_ranks["ranks"]
    for jm, om, tm in zip(reference_and_ranks["jmetrics"], reference_and_ranks["one"],
                          r0["metrics"]):
        assert set(tm) == set(jm) == set(om)
        for k in jm:
            np.testing.assert_allclose(tm[k], om[k], rtol=5e-3, err_msg=k)
            np.testing.assert_allclose(tm[k], jm[k], rtol=2e-2, err_msg=k)


def test_two_ranks_gradients_match_the_reference_per_leaf(reference_and_ranks):
    want = convert_variables({"params": reference_and_ranks["jgrads"]})
    (_, got), _ = reference_and_ranks["ranks"]
    names = [k for k in want if not k.endswith("num_batches_tracked")]
    assert sorted(names) == sorted(got)
    for k in names:
        _leaf_close(got[k], want[k].numpy(), 0.3, k)
    _leaf_close(np.concatenate([got[k].ravel() for k in names]),
                np.concatenate([want[k].numpy().ravel() for k in names]), 0.15, "all leaves")


def test_in_float32_the_ranks_and_one_process_match_the_reference(tmp_path):
    """Both sides' convs in float32: the 1.02% by which the bf16 port is
    off the reference in ``loss_off`` is the two sides' bf16 rounding, not
    a difference of formula. The two ranks and one process are then within
    1e-4 of the sharded reference in every metric and within 1e-3 of each
    leaf's gradient norm."""
    res = _reference_and_ranks(tmp_path, float32=True)
    want = convert_variables({"params": res["jgrads"]})
    names = [k for k in want if not k.endswith("num_batches_tracked")]
    (r0, g0), (r1, g1) = res["ranks"]
    assert r0["metrics"] == r1["metrics"]
    for jm, om, tm in zip(res["jmetrics"], res["one"], r0["metrics"]):
        assert set(tm) == set(jm) == set(om)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(om[k], jm[k], rtol=1e-4, err_msg=k)
    for got in (g0, g1, res["one_grads"]):
        for k in names:
            _leaf_close(got[k], want[k].numpy(), 1e-3, k)


def test_objects_in_one_ranks_rows_only(tmp_path):
    """Rank 1's rows hold no object: its local count of positives is 0, and
    the heatmap loss's normalizer must still be the global count."""
    from cvm_tpu_torch.models.centernet.model import create_model
    from cvm_tpu_torch.models.centernet.processor import make_processor

    cfg = get_model("centernet").params_cls(**KW)
    raw = child.global_batch(0, "centernet", "tiny", 4)
    raw["num_objects"][2:] = 0
    batch = {k: torch.from_numpy(v) for k, v in raw.items()
             if k in ("image", "image_hw", "boxes", "classes", "num_objects")}
    inputs, targets = make_processor(cfg, train=False)(None, batch)
    assert float(targets.mask[2:].sum()) == 0 and float(targets.mask[:2].sum()) > 0
    sd = create_model(cfg, "cpu", torch.Generator().manual_seed(0)).state_dict()
    _write_npz(tmp_path / "in.npz", "centernet", cfg, sd, inputs, targets, float32=True)
    ranks = child.launch(2, ["grads", "--npz", tmp_path / "in.npz", "--steps", "1"],
                         str(tmp_path))
    _, want = child.run_grads(None, "cpu", str(tmp_path / "in.npz"), 1)
    for _, got in ranks:
        for k in want:
            _leaf_close(got[k], want[k], 1e-4, k)
    assert ranks[0][0]["metrics"] == ranks[1][0]["metrics"]
    # what a per-rank loss gives: each half alone (rank 1's normalizer 1,
    # not the global count), the gradients averaged
    halves = []
    for rows in (slice(0, 2), slice(2, 4)):
        half = cfg.replace(batch_size=2)
        _write_npz(tmp_path / "half.npz", "centernet", half, sd, inputs[rows],
                   targets._replace(**{f: getattr(targets, f)[rows] for f in TARGET_FIELDS}),
                   float32=True)
        halves.append(child.run_grads(None, "cpu", str(tmp_path / "half.npz"), 1)[1])
    wrong = np.concatenate([(halves[0][k] + halves[1][k]).ravel() / 2 for k in want])
    right = np.concatenate([want[k].ravel() for k in want])
    assert np.linalg.norm(wrong - right) > 0.5 * np.linalg.norm(right)


def test_batchnorm_under_a_group_equals_one_process_on_the_whole_batch(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "in.npz", x=rng.normal(0.5, 2.0, (4, 5, 6, 8)).astype(np.float32),
             w=rng.normal(0, 1, (4, 5, 6, 8)).astype(np.float32),
             scale=rng.uniform(0.5, 1.5, 8).astype(np.float32),
             bias=rng.normal(0, 0.3, 8).astype(np.float32))
    ranks = child.launch(2, ["bn", "--npz", tmp_path / "in.npz"], str(tmp_path))
    _, want = child.run_bn(None, "cpu", str(tmp_path / "in.npz"))
    for r, (_, got) in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(got["y"], want["y"][rows], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["dx"], want["dx"][rows], atol=1e-5, rtol=0)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


def test_tensor_parallel_rules_select_what_the_references_do():
    model = j_get_model("centernet").create_model(
        j_get_model("centernet").params_cls(**child.CONFIGS["tiny"]["centernet"][0]))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 64, 64, 3)), train=False))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes["params"])
    paths = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat]
    hwio_to_oihw = {3: 0, 2: 1}
    want = {}
    for path in paths:
        for pat, spec in j_tp_rules_for("centernet"):
            if re.search(pat, path):
                module, leaf = path.rsplit("/", 1)
                assert leaf == "kernel", path
                dim = [i for i, s in enumerate(spec) if s == "model"][0]
                want[f"{flax_path_to_module_name(module)}.weight"] = hwio_to_oihw[dim]
                break
    names = list(convert_variables(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), {"params": shapes["params"]})))
    got = match_rules(names, tp_rules_for("centernet"))
    assert got == want and len(got) == 4
    assert set(got.values()) == {0, 1}


def test_a_stop_on_one_rank_stops_every_rank_after_the_same_step(tmp_path):
    """The last rank alone asks to stop while taking its third batch; the
    flag all-reduced with each step stops both ranks at one step, well
    before the 8 asked for, and both report the stop."""
    ranks = [r for r, _ in child.launch(2, ["stop", "--steps", 8], str(tmp_path))]
    assert ranks[0]["step"] == ranks[1]["step"] < 8
    assert ranks[0]["stop_requested"] and ranks[1]["stop_requested"]


def test_mesh_argument_checks_and_a_group_that_cannot_form():
    mesh = single_mesh("cpu")
    assert (mesh.world, mesh.data_index, mesh.model_index) == (1, 0, 0)
    assert tuple(mesh.batch_rows(4)) == (0, 4, 4)
    with pytest.raises(ValueError, match="not divisible by model_axis=2"):
        make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="device is required"):
        make_mesh(1, None)  # the platform is never picked silently
    with pytest.raises(ValueError, match="not a rank of 2"):
        init_distributed("127.0.0.1:1", 2, 2, "cpu")
    with pytest.raises(ValueError, match="host:port"):
        init_distributed("localhost", 2, 0, "cpu")
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        init_distributed("127.0.0.1:1", 2, 0, "cpu", backend="nccl")
    # rank 1 of 2 with no rank 0 serving the rendezvous: an error naming
    # it within the timeout, not a hang
    port = free_port()
    with pytest.raises(RuntimeError, match=f"did not form .rank 1 of 2 at 127.0.0.1:{port}"):
        init_distributed(f"127.0.0.1:{port}", 2, 1, "cpu", timeout_s=2.0)
