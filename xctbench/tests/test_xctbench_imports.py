"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""
import ast

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in (ROOT / "xctbench").rglob("*.py")
               if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_is_plain(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "dataclasses", "math", "warnings",
                    "numpy", "scipy", "torch"}, tops
