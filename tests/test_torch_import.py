"""cvm_tpu_torch imports, module by module, with JAX, flax and the JAX
package blocked.

The card's machine has no JAX, so the port must never reach it: not
directly, and not through the reference package, not even a module there
that imports no JAX. The port keeps its own copies of what it needs.
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
            "cvm_tpu_torch.ops.cuda.gaussian_splat", "cvm_tpu_torch.cli.evaluate",
            "cvm_tpu_torch.train.evaluate", "cvm_tpu_torch.train.early_stop",
            "cvm_tpu_torch.train.average", "cvm_tpu_torch.models.centernet.evaluate",
            "cvm_tpu_torch.infer.quantize", "cvm_tpu_torch.models.registry",
            "cvm_tpu_torch.cli.benchmark"} | {
                f"cvm_tpu_torch.models.{m}.{part}" for m in ("semseg", "depth", "multitask")
                for part in ("params", "model", "loss", "processor")} <= set(_module_names())


def test_no_source_file_imports_jax_flax_or_the_jax_package():
    pkg = Path(cvm_tpu_torch.__file__).resolve().parent
    for f in sorted(pkg.rglob("*.py")) + [pkg.parent / "chip_smoke.py"]:
        for line in f.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                roots = {w.split(".")[0] for w in words[1:2]}
                assert not roots & {"jax", "jaxlib", "flax", "cvm_tpu"}, f"{f}: {line}"
