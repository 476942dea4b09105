"""Each configuration's plain reference: a module found by file, as the
metric readers are (``harness.read_metric``).

A configuration file names it under ``model.reference``; ``dense`` (the
GQA decoder, ``refs/dense.py``) when the key is absent.  The module
``refs/<name>.py`` knows one family of layers and provides:

  leaf_shapes(spec, i)   (name, shape, kind, fan_in) of layer ``i``'s
                         leaves, the top leaves for ``i = -1`` (names are
                         the program's attribute names; ``kind``: matrix |
                         bias | norm)
  block(spec, w, x, low) layer ``w`` over x (S, D) at positions 0..S-1 in
                         fp32; ``low``: the fp8 control (``reference.mm``)
  IN_DIMS                {matrix name: its input dims} (fp8's per-column
                         scales)
  layer_flops(spec, i)   FLOPs of layer ``i`` a token, outside attention's
                         (query, key) pairs
  pair_flops(spec, i)    FLOPs a visible (query, key) pair in layer ``i``
                         (0 for a layer without attention)
  query_bytes(spec, i)   attention bytes a query in layer ``i`` (its q read,
                         its output written)
  key_bytes(spec, i)     attention bytes a visible key in layer ``i``

``REFS`` is where the modules lie; tests point it at a root of their own.
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from types import ModuleType

REFS = Path(__file__).resolve().parent / "refs"
PROVIDES = ("leaf_shapes", "block", "IN_DIMS", "layer_flops", "pair_flops",
            "query_bytes", "key_bytes")


def module(name: str) -> ModuleType:
    """``REFS/<name>.py``, loaded once per path."""
    return _load(REFS / f"{name}.py")


@functools.cache
def _load(path: Path) -> ModuleType:
    if not path.is_file():
        raise SystemExit(f"no reference module {path.stem!r}: {path} is "
                         "missing")
    spec = importlib.util.spec_from_file_location(
        "perfbench_ref_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [n for n in PROVIDES if not hasattr(mod, n)]
    if missing:
        raise SystemExit(f"reference module {path.stem!r} ({path}) lacks "
                         f"{missing}")
    return mod


def of(spec: dict) -> ModuleType:
    """The reference module of a configuration's ``model`` spec."""
    return module(spec.get("reference", "dense"))
