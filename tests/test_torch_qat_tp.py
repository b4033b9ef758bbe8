"""QAT under tensor parallelism (``train/qat.py``, ``parallel/sharding.py``)
on the CPU at a tiny size: two gloo ranks on a model axis of 2 with
``qat=True`` against one process, two CenterNet train steps on the same
global batches (``tests/torch_dist_child.py``), every conv in float32.

The reference's fake quant takes the activation scale over the whole
tensor and each output channel's weight scale over all of (kh, kw, C_in);
GSPMD keeps both global when the stage-5 ``c2`` convs are split on C_in.
Each rank's ``RowConv`` holds a C_in slice, so both scales are maxima over
the model group of the slices' maxima. The test holds every ``s5b*.c2``
activation and weight scale of every forward to the one process's exactly
(a max is exact) but the ``s5b1.c2`` activation's, whose input has passed
through ``s5b0.c2``'s sum of two partial convs (within 1e-6: float32
rounding), equal between the ranks, and the losses and gradient norms
within float32 rounding. Scales taken per slice differ between the ranks
and from the one process's.

Against the reference: its QAT step (``cvm_tpu/train/loop.py``'s
``make_train_step`` under ``train/qat.py``'s interceptor) on a (data 1,
model 2) mesh of the conftest's CPU devices, its stage-5 blocks split by
its own tensor-parallel rules, every conv in float32, two SGD steps from
the same weights and processed inputs as two port ranks
(``torch_dist_child.py``'s ``grads`` mode with the config's
``tensor_parallel`` and ``qat``). The reference's amax of each
``s5b*.c2`` fake quant is read inside its jitted step (its ``jnp.max``
calls there, through ``jax.debug.callback``) and made a scale by its own
formula, amax / 127 + 1e-8 (activation) or + 1e-12 (weights), in float32.
The weight scales equal the ranks' exactly (the weights are the same and a
max is exact); the activation scales agree within 2e-3 (measured on the
CPU: 3.1e-4 and 8.3e-4: the fake quant of every earlier conv rounds to
its int8 grid, so the two sides' float32 differences flip a value across
a rounding boundary now and then); the losses within 1e-2 and the
gradient norms within 5e-2 (measured: 0.74% in ``loss_off``, 1.2% in the
gradient norm), the bounds of ``test_torch_qat.py``'s one-process QAT
steps against the reference. Scales taken per slice miss the reference's
by far more.
"""

import contextlib
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_child as child
from cvm_tpu.data.synthetic import synthetic_batch as j_synthetic_batch
from cvm_tpu.models import get_model as j_get_model
from cvm_tpu.models.centernet.processor import make_processor as j_make_processor
from cvm_tpu.parallel.mesh import make_mesh as j_make_mesh
from cvm_tpu.train import qat as j_qat
from cvm_tpu.train.loop import Trainer as JTrainer
from cvm_tpu.train.loop import make_train_step as j_make_train_step
from cvm_tpu_torch.convert import convert_variables, flax_path_to_module_name
from cvm_tpu_torch.models import get_model
from test_torch_dist import KW, _reference_in_float32, _write_npz

STEPS = 2


def test_qat_scales_under_tensor_parallelism_are_the_whole_tensors(tmp_path):
    ranks = [r for r, _ in child.launch(
        2, ["train", "--model", "centernet", "--steps", STEPS, "--model_parallel", 2,
            "--tensor_parallel", "--qat", "--float32"], str(tmp_path))]
    one = child.run_train(None, "cpu", "centernet", "tiny", STEPS, qat=True, float32=True)
    assert ranks[0]["split"] and not one["split"]
    convs = sorted(one["scales"])
    assert convs == ["backbone.s5b0.c2.conv", "backbone.s5b1.c2.conv"]
    for r in ranks:
        assert sorted(r["scales"]) == convs
        for name in convs:
            got, want = np.asarray(r["scales"][name]), np.asarray(one["scales"][name])
            # one forward per step; the activation scale, then 256 weight scales
            assert got.shape == want.shape == (STEPS, 1 + 256), name
            assert np.max(np.abs(got[:, 1:] - want[:, 1:])) == 0, name
            if name == "backbone.s5b0.c2.conv":
                assert np.max(np.abs(got[:, 0] - want[:, 0])) == 0, name
            else:
                # its input passed through s5b0.c2's sum of two partial
                # convs, which rounds otherwise than one whole conv
                np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6, atol=0)
            assert r["scales"][name] == ranks[0]["scales"][name]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-5)
    for got, want in zip(ranks[0]["metrics"], one["metrics"]):
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)


@contextlib.contextmanager
def _reference_amax():
    """``{(conv name, "act" | "weight"): [amax of each forward]}`` of the
    reference's fake quant of the ``s5b*.c2`` convs while open: the values
    of its own ``jnp.max`` calls in ``fake_quant_act`` (a scalar) and
    ``fake_quant_weight`` (one per output channel), read in the jitted step
    through ``jax.debug.callback``."""
    got, current, real_fq = {}, [None], j_qat._fq_conv

    def fq(mod, x):
        name = flax_path_to_module_name("/".join(mod.path))
        current[0] = name if re.search(r"s5b\d+\.c2\.conv$", name) else None
        try:
            return real_fq(mod, x)
        finally:
            current[0] = None

    class Recording:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def max(self, a, *args, **kwargs):
            m = jnp.max(a, *args, **kwargs)
            if current[0]:
                key = (current[0], "act" if kwargs.get("axis") is None else "weight")
                jax.debug.callback(lambda v, key=key: got.setdefault(key, []).append(
                    np.asarray(v, np.float32).reshape(-1)), m)
            return m

    with mock.patch.object(j_qat, "_fq_conv", fq), mock.patch.object(j_qat, "jnp", Recording()):
        yield got


def test_qat_tensor_parallel_ranks_match_the_sharded_reference_step(tmp_path):
    kw = dict(KW, qat=True, tensor_parallel=True)
    with _reference_in_float32():
        spec = j_get_model("centernet")
        jp = spec.params_cls(**kw)
        trainer = JTrainer(spec, jp, mesh=j_make_mesh(jax.devices()[:2], model_axis=2))
        trainer.init_state()
        raw = j_synthetic_batch(np.random.default_rng(0), 4, (80, 96), num_classes=3,
                                max_objects=8)
        raw = {k: jnp.asarray(raw[k]) for k in ("image", "image_hw", "boxes", "classes",
                                                "num_objects")}
        inputs, targets = jax.jit(j_make_processor(jp, train=True))(jax.random.PRNGKey(3), raw)
        state = trainer.state
        v0 = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        batch = jax.device_put((inputs, targets), trainer._batch_sh)
        trainer._step_fn = j_make_train_step(trainer.model, spec.loss_fn, jp, trainer.tx,
                                             lambda key, b: b)
        step = trainer._jit_step(trainer._state_sh)
        jmetrics = []
        with _reference_amax() as amax:
            for _ in range(STEPS):
                state, m = step(state, batch, jax.random.PRNGKey(0))
                jmetrics.append({k: float(v) for k, v in jax.device_get(m).items()})
            jax.effects_barrier()
    _write_npz(tmp_path / "in.npz", "centernet", get_model("centernet").params_cls(**kw),
               convert_variables(v0), inputs, targets, float32=True)
    ranks = [r for r, _ in child.launch(2, ["grads", "--npz", tmp_path / "in.npz", "--steps",
                                            STEPS, "--model_parallel", 2], str(tmp_path))]
    convs = ["backbone.s5b0.c2.conv", "backbone.s5b1.c2.conv"]
    assert sorted({name for name, _ in amax}) == convs
    assert all(f"{c}.weight" in ranks[0]["split"] for c in convs)
    for name in convs:
        act = np.float32(1e-8) + np.stack(amax[name, "act"])[:, 0] / np.float32(127.0)
        weight = np.float32(1e-12) + np.stack(amax[name, "weight"]) / np.float32(127.0)
        assert act.shape == (STEPS,) and weight.shape == (STEPS, 256), name
        for r in ranks:
            got = np.asarray(r["scales"][name], np.float32)
            assert np.max(np.abs(got[:, 1:] - weight)) == 0, name
            np.testing.assert_allclose(got[:, 0], act, rtol=2e-3, atol=0, err_msg=name)
    for r in ranks:
        for got, want in zip(r["metrics"], jmetrics):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=5e-2 if k == "grad_norm"
                                           else 1e-2, err_msg=k)
