"""Shared ``stats()`` assembly — one formatter for both engines.

``CoICEngine.stats()`` and ``ServingEngine.stats()`` used to each re-derive
the same three blocks: the cache-org block (federation / multi-node
cluster / flat solo-shard shape), the uniform per-tier ``"ladder"`` dict,
and the ``"digest"`` dict (federation digest stats, or the uniform empty
shape for configs without a federation tier).  Both engines now call the
two helpers here; the dict shapes are unchanged — every key the seed's
stats() exposed still appears, bit-for-bit, because the underlying numbers
live in the same ``MetricsRegistry`` counters either way.

This module is duck-typed on purpose (no ``repro.core`` imports):
``obs`` sits below the core layers in the import graph, so the formatter
cannot pull ``coic.py``/``federation.py`` in without a cycle.
"""
from __future__ import annotations

from typing import Optional

# the uniform digest-stats shape for configs without a federation tier
# (moved here from core/coic.py, which re-exports it for back-compat)
EMPTY_DIGEST_STATS = {"mode": "off", "size": 0, "bytes_shipped": 0,
                      "rows_shipped": 0, "updates_applied": 0,
                      "refreshes": 0, "false_hits": 0, "interval": 0}


def org_stats(federation, cluster, cache) -> dict:
    """The engines' shared cache-org stats block: federation stats when
    federated, cluster stats for a multi-node cluster, and the flat
    per-shard shape for the solo (1-node) cache — the three cases both
    engines used to switch over inline."""
    if federation is not None:
        return federation.stats()
    if cluster.cfg.num_nodes > 1:
        return cluster.stats()
    return cache.stats(cluster.states[0])


def ladder_block(org, engine_ladder=None) -> dict:
    """The uniform per-tier ``stats()["ladder"]`` dict: the org ladder's
    counters, with the engine-level ladder's cloud-rung dispatches merged
    in when the caller composes the org with a ``CloudRung``
    (``CoICEngine``)."""
    lad = org.ladder.stats()
    if engine_ladder is not None:
        lad["rung_dispatches"]["cloud"] = \
            engine_ladder.rung_dispatches.get("cloud", 0)
    return lad


def digest_block(federation: Optional[object]) -> dict:
    """``stats()["digest"]`` — federation digest stats, or the uniform
    empty shape when no federation tier exists."""
    if federation is not None:
        return federation.digest_stats()
    return dict(EMPTY_DIGEST_STATS)
