"""Collective bytes of one step — the counterpart of
``repro/launch/hloparse.py``.

The reference parses XLA's compiled HLO for its collectives and resolves
while-loop trip counts.  PyTorch compiles no program and has no HLO to
parse: the port runs the step eagerly and records each collective as it
is issued (``parallel/collectives.py::record_collectives``), so every
record ran exactly once and no trip count is needed.  ``summarize`` turns
the record into ``parse_collectives``'s structure, with the reference's
ring-algorithm wire factors.
"""
from __future__ import annotations

from typing import Iterable

import torch

# bytes per element, the reference's table under torch's dtypes
_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.bfloat16: 2, torch.float16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the function of ``parallel/collectives.py`` that issues each kind the
# port issues
_ISSUER = {"all-gather": "gather_stack", "all-reduce": "all_reduce"}


def shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def _wire_factor(kind: str, group: int) -> float:
    """Ring-algorithm bytes on the wire per participating device, as a
    factor of the op's whole (gathered or reduced) tensor size."""
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (group - 1) / group
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (group - 1) / group
    return 1.0


def summarize(records: Iterable) -> dict:
    """``parse_collectives``'s structure from a record of (kind, bytes,
    group) entries: ``per_kind`` {count, exec, bytes_raw, bytes_wire},
    ``total_wire_bytes`` and ``schedule`` (the first 200 in issue order;
    ``comp`` names the port's function that issued it)."""
    out = {k: {"count": 0, "exec": 0.0, "bytes_raw": 0.0, "bytes_wire": 0.0}
           for k in _COLLECTIVES}
    schedule = []
    for kind, nbytes, group in records:
        wire = nbytes * _wire_factor(kind, group)
        row = out[kind]
        row["count"] += 1
        row["exec"] += 1.0
        row["bytes_raw"] += float(nbytes)
        row["bytes_wire"] += wire
        if len(schedule) < 200:
            schedule.append({"kind": kind, "bytes": nbytes, "group": group,
                             "mult": 1.0, "comp": _ISSUER.get(kind, "")})
    total = sum(v["bytes_wire"] for v in out.values())
    return {"per_kind": out, "total_wire_bytes": total, "schedule": schedule}

