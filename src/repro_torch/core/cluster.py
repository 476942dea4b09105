"""Cooperative edge cache tier — the port of ``repro/core/cluster.py``.

``CooperativeEdgeCluster`` owns one ``SemanticCache`` shard per edge node
behind the unified ladder (``core/tiers.py``): local shard, then peer
shards, then the caller's cloud.  This slice builds the one-node cluster —
the paper's single edge cache — which the serving engine and
``CoICEngine`` front their model with.  More than one node (the peer
probe, admission filters, peer-aware bookkeeping) is ROADMAP.md Queue 1
item 9 (slice 2) and raises here.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.policies import EvictionPolicy
from repro_torch.core.semantic_cache import SemanticCache, SemanticCacheState
from repro_torch.core.tiers import (TIER_LOCAL, LocalRung, PeerRung,
                                    TierLadder, TierProbeResult,
                                    build_probe_context)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    num_nodes: int = 4
    node_capacity: int = 1024
    key_dim: int = 256
    payload_dim: int = 64
    threshold: float = 0.85
    payload_dtype: str = "float32"
    policy: EvictionPolicy = EvictionPolicy("lru")
    lookup_impl: str = "auto"
    # peer-hit re-admission into the serving node's shard (slice 2)
    admission: str = "always"
    share: bool = True               # False: isolated nodes (no peer tier)

    def __post_init__(self):
        assert self.admission in ("always", "never", "second_hit",
                                  "freq_weighted"), self.admission
        assert self.num_nodes >= 1, self.num_nodes


class CooperativeEdgeCluster:
    """Edge nodes with one ``SemanticCache`` shard each (one node in this
    slice).  Itself a ``CacheTier``, so an engine composes it directly
    with a cloud tier in one ladder."""

    name, code = "edge", TIER_LOCAL      # CacheTier identity (org-level)

    def __init__(self, cfg: ClusterConfig, metrics=None, tracer=None,
                 device="cuda"):
        if cfg.num_nodes > 1:
            raise NotImplementedError(
                "a cooperative cluster of num_nodes > 1 is not ported yet "
                "(ROADMAP.md Queue 1 item 10, slice 2)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cache = SemanticCache(
            capacity=cfg.node_capacity, key_dim=cfg.key_dim,
            payload_dim=cfg.payload_dim, threshold=cfg.threshold,
            payload_dtype=cfg.payload_dtype, policy=cfg.policy,
            lookup_impl=cfg.lookup_impl)
        self.states: List[SemanticCacheState] = [
            self.cache.init(self.device) for _ in range(cfg.num_nodes)]
        self._keys_stack = None      # cached (N, C, D) stack; None = dirty
        self.ladder = TierLadder([LocalRung(), PeerRung()],
                                 metrics=metrics, tracer=tracer)
        self.metrics = self.ladder.metrics

    def _stacks(self):
        """(keys (N, C, D), valid (N, C), per-node alive masks).  Keys are
        cached across probes and invalidated on insert; the valid stack is
        rebuilt each time so TTL expiry stays correct."""
        if self._keys_stack is None:
            self._keys_stack = torch.stack([s.keys for s in self.states])
        alive = [self.cache.policy.expire(s, s.clock) for s in self.states]
        return self._keys_stack, torch.stack(alive), alive

    # ------------------------------------------------------------------
    def probe(self, queries: np.ndarray, mask: np.ndarray, ctx=None):
        """CacheTier protocol: one grouped ladder walk over (1, N, B, D).
        Accepts (N, B, D) and broadcasts."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 3:
            queries = queries[None]
            mask = None if mask is None else np.asarray(mask, bool)[None]
        if mask is None:
            mask = np.ones(queries.shape[:3], bool)
        pctx = build_probe_context([self])
        res = self.ladder.probe(queries, mask, pctx,
                                self.cfg.payload_dim,
                                self.cfg.payload_dtype)
        return TierProbeResult(*res, dispatches=self.ladder.last_dispatches)

    # ------------------------------------------------------------------
    def insert(self, node: int, keys, values) -> None:
        """Insert cloud results into the serving node's shard."""
        dev = self.device
        self.states[node] = self.cache.insert(
            self.states[node], torch.as_tensor(keys, device=dev),
            torch.as_tensor(values, device=dev))
        self._keys_stack = None

    def insert_home(self, cluster_id: int, node: int, keys, values) -> None:
        """Org-generic insert (cluster orgs ignore ``cluster_id``; a
        degenerate node axis ignores ``node``)."""
        self.insert(0 if self.cfg.num_nodes == 1 else node, keys, values)
