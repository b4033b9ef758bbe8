"""cvm_tpu_torch imports, module by module, with JAX, flax and the JAX
package blocked; and the contracts of its entry points.

The card's machine has no JAX, so the port must never reach it: not
directly, and not through the reference package, not even a module there
that imports no JAX. The port keeps its own copies of what it needs. A
served artifact's program loads with the kernel's op registration and
none of the model-zoo modules. Every CLI runs on the card unless asked for
the CPU, and ``chip_smoke.py`` ends with its contract's line.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import cvm_tpu_torch

_CODE = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["cvm_tpu"] = None
import importlib, pkgutil
import cvm_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(cvm_tpu_torch.__path__, "cvm_tpu_torch."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "cvm_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print(len(names))
"""


def _module_names():
    return sorted(m.name for m in pkgutil.walk_packages(cvm_tpu_torch.__path__,
                                                        "cvm_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    repo = Path(cvm_tpu_torch.__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _CODE], cwd=repo, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == len(_module_names()) >= 40
    assert {"cvm_tpu_torch.cli.train", "cvm_tpu_torch.train.loop", "cvm_tpu_torch.ops.heatmap",
            "cvm_tpu_torch.ops.cuda.gaussian_splat", "cvm_tpu_torch.ops.cuda.yuv_letterbox",
            "cvm_tpu_torch.cli.evaluate",
            "cvm_tpu_torch.train.evaluate", "cvm_tpu_torch.train.early_stop",
            "cvm_tpu_torch.train.average", "cvm_tpu_torch.models.centernet.evaluate",
            "cvm_tpu_torch.infer.quantize", "cvm_tpu_torch.models.registry",
            "cvm_tpu_torch.cli.benchmark", "cvm_tpu_torch.cli.export",
            "cvm_tpu_torch.cli.serve", "cvm_tpu_torch.infer.runtime",
            "cvm_tpu_torch.infer.selftest", "cvm_tpu_torch.train.qat"} | {
                f"cvm_tpu_torch.models.{m}.{part}" for m in ("semseg", "depth", "multitask")
                for part in ("params", "model", "loss", "processor")} | {
                "cvm_tpu_torch.ops.warp", "cvm_tpu_torch.ops.ssim"} | {
                f"cvm_tpu_torch.data.{m}" for m in (
                    "jpeg", "records", "label_spec", "images", "loader")} | {
                "cvm_tpu_torch.cli.doctor", "cvm_tpu_torch.infer.server"} | {
                f"cvm_tpu_torch.models.dmds.{part}" for part in (
                    "params", "model", "loss", "processor", "train", "evaluate",
                    "inference")} | {
                "cvm_tpu_torch.cli.video", "cvm_tpu_torch.cli.lr_find",
                "cvm_tpu_torch.infer.tiled", "cvm_tpu_torch.train.lr_find",
                "cvm_tpu_torch.train.tensorboard", "cvm_tpu_torch.utils.prof"} <= set(_module_names())


def test_no_source_file_imports_jax_flax_or_the_jax_package():
    pkg = Path(cvm_tpu_torch.__file__).resolve().parent
    for f in sorted(pkg.rglob("*.py")) + [pkg.parent / "chip_smoke.py"]:
        for line in f.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                roots = {w.split(".")[0] for w in words[1:2]}
                assert not roots & {"jax", "jaxlib", "flax", "cvm_tpu"}, f"{f}: {line}"


_LOAD = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["cvm_tpu"] = None
import cvm_tpu_torch.infer.runtime
assert not [m for m in sys.modules if m.startswith("cvm_tpu_torch.models")], sorted(sys.modules)
print("ok")
"""


def test_the_runtime_loads_without_the_model_zoo():
    repo = Path(cvm_tpu_torch.__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _LOAD], cwd=repo, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr[-3000:]


def test_cli_entry_points_default_to_the_card(tmp_path):
    import pytest
    import torch

    from cvm_tpu_torch.cli import evaluate, export, serve, train

    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without a card")
    calls = [
        lambda: train.main(["--model", "centernet", "--workdir", str(tmp_path / "t"),
                            "--steps", "1"]),
        lambda: evaluate.main(["--model", "centernet", "--workdir", str(tmp_path / "e")]),
        lambda: export.main(["--model", "centernet", "--checkpoint_dir", str(tmp_path / "e"),
                             "--out", str(tmp_path / "a")]),
        lambda: serve.main(["--artifact", str(tmp_path / "a"), "--selftest"]),
    ]
    (tmp_path / "e").mkdir()
    (tmp_path / "e" / "params.json").write_text("{}")
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "artifact.json").write_text('{"batch_size": 1}')
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_ends_with_the_contract_line_and_refuses_without_a_card(tmp_path):
    import ast
    import shutil

    import torch

    src = Path(cvm_tpu_torch.__file__).resolve().parents[1] / "chip_smoke.py"
    main = next(n for n in ast.parse(src.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    prints = [n for n in ast.walk(main) if isinstance(n, ast.Call)
              and getattr(n.func, "id", None) == "print"]
    last = ast.unparse(max(prints, key=lambda n: n.lineno))
    assert "'ok': True" in last and "'platform': 'gpu'" in last
    assert "get_device_name(0)" in last and "device_count()" in last
    if torch.cuda.is_available():
        return
    shutil.copy(src, tmp_path / "chip_smoke.py")  # the script alone, without the package
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
