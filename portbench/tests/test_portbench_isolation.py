"""No module of the benchmark imports JAX, Flax or the JAX package, and
the reference imports nothing of the program (top-level names compared
whole: `butterfly_tpu_torch` begins with `butterfly_tpu`)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import harness

PKG = harness.PKG_DIR
FILES = sorted(PKG.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((PKG / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = top_level_imports(path)
    assert "butterfly_tpu_torch" not in tops
    assert tops <= {"__future__", "dataclasses", "math", "numpy", "torch",
                    "portbench"}
    # within the benchmark, only the reference itself
    text = path.read_text()
    for line in text.splitlines():
        if line.startswith(("from portbench", "import portbench")):
            assert line.startswith("from portbench.reference")


def test_the_scan_sees_what_it_must(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom butterfly_tpu.ops import x\n"
                 "import butterfly_tpu_torch\n"
                 "importlib.import_module('flax.linen')\n")
    assert top_level_imports(f) & set(harness.FORBIDDEN) == {
        "jax", "butterfly_tpu", "flax"}
