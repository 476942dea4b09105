"""Nothing under perfbench/ imports JAX, the JAX package or the JAX
package's benchmarks (top-level names compared whole: ``repro_torch`` is
not ``repro``), and the yardstick (reference and its modules, weights,
work, traffic) imports nothing of the program."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
YARDSTICK = ("reference.py", "weights.py", "work.py", "traffic.py",
             "check.py", "readers.py", "devtrace.py", "family.py") + tuple(
    str(p.relative_to(ROOT)) for p in sorted((ROOT / "refs").glob("*.py")))


def _tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not set(_tops(path)) & BANNED


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_no_program(name):
    tops = set(_tops(ROOT / name))
    assert "repro_torch" not in tops, tops
    assert tops <= {"perfbench", "torch", "numpy", "math", "bisect",
                    "contextlib", "typing", "__future__", "time",
                    "functools", "importlib", "pathlib", "types"}, tops


def test_the_check_compares_names_whole():
    assert "repro_torch".split(".")[0] not in BANNED
