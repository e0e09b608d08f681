"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program: top-level module names
(the part before the first dot) compared whole, so that
stringdecomposer_tpu_torch is not taken for stringdecomposer_tpu."""

import ast
from pathlib import Path

import pytest
from harness.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "stringdecomposer_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "os", "numpy", "torch"}
    assert top_level_imports(path) <= allowed, top_level_imports(path) - allowed


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import stringdecomposer_tpu_torch.pipeline\nfrom jaxtyping import x\n")
    assert not top_level_imports(f) & FORBIDDEN
    f.write_text("from stringdecomposer_tpu.ops import oracle\n")
    assert top_level_imports(f) & FORBIDDEN == {"stringdecomposer_tpu"}
    f.write_text("import importlib\nimportlib.import_module('jax.numpy')\n")
    assert top_level_imports(f) & FORBIDDEN == {"jax"}
