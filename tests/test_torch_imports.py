"""The port's import rule, read from the sources with `ast`: no module of
frtm_tpu_torch, not chip_smoke.py and none of the scripts that run on the
card (scripts/bench_torch_*.py, scripts/torch_demo_synthetic.py,
scripts/torch_train_eval_synthetic.py) imports
jax, cv2, PIL or anything of frtm_tpu, with no exception: JPEG and PNG go
through the port's own host library and codec. The machine with the card
has none of these packages."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = (sorted((ROOT / "frtm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "scripts").glob("bench_torch_*.py"))
           + [ROOT / "scripts" / "torch_demo_synthetic.py",
              ROOT / "scripts" / "torch_train_eval_synthetic.py"])
FORBIDDEN = {"jax", "jaxlib", "flax", "cv2", "PIL", "frtm_tpu"}


def _imports(tree):
    """(top-level package, enclosing function names, line) of every import."""
    found = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            inner = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                inner = scope + (child.name,)
            if isinstance(child, ast.Import):
                found.extend((a.name.split(".")[0], scope, child.lineno) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module.split(".")[0], scope, child.lineno))
            visit(child, inner)

    visit(tree, ())
    return found


def _dynamic_imports(tree):
    """Names given as string literals to __import__ / import_module."""
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", "")
            if name in ("__import__", "import_module"):
                names.append(node.args[0].value.split(".")[0])
    return names


def test_the_walk_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"chip_smoke.py", "frtm_tpu_torch/evaluate.py", "frtm_tpu_torch/data/image.py",
            "frtm_tpu_torch/ops/kernels/build.py", "frtm_tpu_torch/parallel/distributed.py",
            "frtm_tpu_torch/parallel/multi_sequence.py"} <= names and len(names) > 30


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_module_imports_nothing_it_must_not(path):
    tree = ast.parse(path.read_text())
    rel = path.relative_to(ROOT).as_posix()
    for package, scope, line in _imports(tree):
        assert package not in FORBIDDEN, f"{rel}:{line} imports {package}"
    for package in _dynamic_imports(tree):
        assert package not in FORBIDDEN, f"{rel} imports {package} by name"


def test_pil_is_named_once():
    """PIL was once imported inside data/image.py::imread; now nowhere."""
    hits = [(p.relative_to(ROOT).as_posix(), line) for p in SOURCES
            for package, _, line in _imports(ast.parse(p.read_text())) if package == "PIL"]
    assert hits == [], hits


def test_the_check_sees_a_forbidden_import():
    bad = ast.parse("import torch\ndef f():\n    from jax import numpy\n    import cv2.dnn\n"
                    "    from PIL import Image\nx = __import__('frtm_tpu.config')\n")
    assert [(p, s) for p, s, _ in _imports(bad)] == [("torch", ()), ("jax", ("f",)),
                                                    ("cv2", ("f",)), ("PIL", ("f",))]
    assert _dynamic_imports(bad) == ["frtm_tpu"]
