"""Nothing of the benchmark imports JAX or the JAX package, and the reference
imports nothing of the program: top-level module names compared whole
(``cvm_tpu_torch`` begins with ``cvm_tpu``)."""

import ast
import pathlib

HERE = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cvm_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert FORBIDDEN.isdisjoint(_imports(f)), f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert "cvm_tpu_torch" not in set(_imports(f)), f


def test_the_guard_compares_whole_names(monkeypatch):
    import sys
    import types

    from cvbench import guard

    monkeypatch.setitem(sys.modules, "cvm_tpu_torch_fake", types.ModuleType("x"))
    assert "cvm_tpu" not in guard.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cvm_tpu.sub", types.ModuleType("y"))
    assert guard.forbidden_modules() == ["cvm_tpu"]
