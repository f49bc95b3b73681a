"""No file of the benchmark imports JAX or the JAX package (each imported
module's top-level name compared whole: frtm_tpu_torch is not frtm_tpu),
and the reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not {"jax", "jaxlib", "flax", "frtm_tpu"} & set(top_level_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "frtm_tpu_torch" not in set(top_level_imports(path))
    assert "benchmark" not in set(top_level_imports(path))


def test_the_rule_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import frtm_tpu_torch.ops\nfrom frtm_tpu_torchx import y\n")
    assert set(top_level_imports(f)) == {"frtm_tpu_torch", "frtm_tpu_torchx"}
    f.write_text("from frtm_tpu.models import z\n")
    assert set(top_level_imports(f)) == {"frtm_tpu"}
