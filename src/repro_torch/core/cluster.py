"""Cooperative multi-node edge cache tier — the port of
``repro/core/cluster.py`` (see it for the full design).

``CooperativeEdgeCluster`` runs N edge nodes, each owning one
``SemanticCache`` shard, behind the unified ladder (``core/tiers.py``):

  1. local  — the serving node's own shard (``LocalRung``, one batched
              launch over every node's shard)
  2. peer   — a local miss probes the other shards (``PeerRung``, one
              pooled launch for the whole cluster)
  3. cloud  — the caller forwards the remaining misses and inserts results
              back into the serving node's shard

Peer hits refresh the owning shard's LRU/LFU state (``SemanticCache.touch``)
and are optionally re-admitted into the serving node's shard (the
``admission`` policy).  A 1-node cluster is the paper's single edge cache.

With a ``mesh`` whose ``cache`` axis has ``num_nodes`` ranks, the peer
rung runs as a collective (``parallel/sharding.py::sharded_topk_lookup``):
every rank keeps the whole (N, C, D) stack and runs the same cluster on
the same requests, as the reference's single controller does, and only
the peer probe is split, rank r scanning shard r.  Results are the same on
every rank and the same as without the mesh.

Shard state lives on the cluster's device; the admission bookkeeping reads
it on the host, as the reference does with numpy (a device-to-host copy
per read in the port).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policies import EvictionPolicy
from repro_torch.core.semantic_cache import SemanticCache, SemanticCacheState
from repro_torch.core.tiers import (TIER_LOCAL, TIER_MISS, TIER_NAMES,
                                    TIER_PEER, LocalRung, PeerRung,
                                    TierLadder, TierProbeResult,
                                    build_probe_context, pow2, route_flat)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_shape

__all__ = ["TIER_LOCAL", "TIER_PEER", "TIER_MISS", "TIER_NAMES",
           "ClusterConfig", "ClusterLookupResult", "CooperativeEdgeCluster",
           "admission_filter", "pow2"]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def admission_filter(kind: str, slots: np.ndarray, owner_state,
                     node_state, policy, seen: Dict[tuple, int],
                     key_prefix: tuple) -> np.ndarray:
    """Which remotely-served cache ``slots`` (entries of ``owner_state`` just
    served to another node or cluster) get re-admitted into the requester's
    shard (``node_state``).  Shared by the peer tier and the federation
    tier's remote rung:

      never         — none
      always        — all
      second_hit    — on the 2nd remote hit of the same entry incarnation,
                      tracked in ``seen`` under ``key_prefix + (slot,
                      inserted_at)``
      freq_weighted — only when the entry's hit count at its owner (as of
                      the probe snapshot) strictly beats the requester
                      shard's coldest victim's count (free slots count 0)
    """
    n = len(slots)
    if kind == "never":
        return np.zeros((n,), bool)
    if kind == "always":
        return np.ones((n,), bool)
    if kind == "second_hit":
        ins = _np(owner_state.inserted_at)
        admit = np.zeros((n,), bool)
        for i, slot in enumerate(np.asarray(slots)):
            key = key_prefix + (int(slot), int(ins[slot]))
            seen[key] = seen.get(key, 0) + 1
            admit[i] = seen[key] >= 2
        return admit
    assert kind == "freq_weighted", kind
    # argmin ties to the lower slot, matching insert()'s stable victim order
    pri = _np(policy.priority(node_state))
    victim = int(np.argmin(pri))
    vfreq = (int(_np(node_state.freq)[victim])
             if bool(_np(node_state.valid)[victim]) else 0)
    owner_freq = _np(owner_state.freq)[np.asarray(slots)]
    return owner_freq > vfreq


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
    # peer-hit re-admission into the serving node's shard:
    # always | never | second_hit | freq_weighted (see admission_filter)
    admission: str = "always"
    share: bool = True               # False: isolated nodes (no peer tier)

    def __post_init__(self):
        assert self.admission in ("always", "never", "second_hit",
                                  "freq_weighted"), self.admission
        assert self.num_nodes >= 1, self.num_nodes


class ClusterLookupResult(NamedTuple):
    hit: np.ndarray          # (...,) bool — local or peer
    tier: np.ndarray         # (...,) int8 — TIER_LOCAL | TIER_PEER | TIER_MISS
    owner: np.ndarray        # (...,) int32 — serving node, -1 on miss
    score: np.ndarray        # (...,) f32 — best score at the serving tier
    value: np.ndarray        # (..., P) payload (zeros on miss)


class CooperativeEdgeCluster:
    """N cooperating edge nodes, one ``SemanticCache`` shard each.  Itself
    a ``CacheTier``, so an engine composes it directly with a cloud tier in
    one ladder.

    ``mesh`` (optional): a ``DeviceMesh`` with a ``cache_axis`` dimension of
    ``num_nodes`` ranks; with it the peer rung is the collective lookup
    (one all-gather of (idx, score) per shard), without it one pooled
    launch over the stacked shards: the same results."""

    name, code = "edge", TIER_LOCAL      # CacheTier identity (org-level)

    def __init__(self, cfg: ClusterConfig, mesh=None,
                 cache_axis: str = "cache", metrics=None, tracer=None,
                 device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.cache_axis = cache_axis
        if mesh is not None:
            assert mesh_shape(mesh)[cache_axis] == cfg.num_nodes, (
                mesh_shape(mesh), cfg.num_nodes)
        self.device = resolve_device(device)
        self.cache = SemanticCache(
            capacity=cfg.node_capacity, key_dim=cfg.key_dim,
            payload_dim=cfg.payload_dim, threshold=cfg.threshold,
            payload_dtype=cfg.payload_dtype, policy=cfg.policy,
            lookup_impl=cfg.lookup_impl)
        self.states: List[SemanticCacheState] = [
            self.cache.init(self.device) for _ in range(cfg.num_nodes)]
        self.peer_hits = np.zeros((cfg.num_nodes,), np.int64)   # served-for-others
        self.peer_fills = np.zeros((cfg.num_nodes,), np.int64)  # admitted-from-peer
        self.node_alive = np.ones((cfg.num_nodes,), bool)       # membership view
        self._keys_stack = None      # cached (N, C, D) stack; None = dirty
        # second-hit admission: per-node count of peer hits per cached entry
        # incarnation (owner, slot, inserted_at)
        self._peer_seen: List[Dict[Tuple[int, int, int], int]] = [
            {} for _ in range(cfg.num_nodes)]
        self.ladder = TierLadder([LocalRung(), PeerRung()],
                                 metrics=metrics, tracer=tracer)
        self.metrics = self.ladder.metrics

    # ------------------------------------------------------------------
    @property
    def probe_dispatches(self) -> int:
        """Similarity probes sent to the device (ladder-counted)."""
        return self.ladder.probe_dispatches

    # ------------------------------------------------------------------
    def _stacks(self):
        """(keys (N, C, D), valid (N, C), per-node alive masks).  Keys are
        cached across probes and invalidated on insert; the valid stack is
        rebuilt each time so TTL expiry stays correct.  Dead nodes
        (``node_alive`` False) are masked out wholesale: a crashed shard's
        data is lost, never phantom-served."""
        if self._keys_stack is None:
            self._keys_stack = torch.stack([s.keys for s in self.states])
        C = self.cfg.node_capacity
        alive = [self.cache.policy.expire(s, s.clock)
                 if self.node_alive[g] else
                 torch.zeros((C,), dtype=torch.bool, device=self.device)
                 for g, s in enumerate(self.states)]
        return self._keys_stack, torch.stack(alive), alive

    # ------------------------------------------------------------------
    def kill_node(self, node: int) -> None:
        """Membership: node ``node`` crashed.  Its shard resets cold (a
        revive starts empty) and admission bookkeeping pointing at the dead
        incarnation is dropped."""
        if not self.node_alive[node]:
            return
        self.node_alive[node] = False
        self.states[node] = self.cache.init(self.device)
        self._keys_stack = None
        self._peer_seen[node] = {}
        for seen in self._peer_seen:     # counters keyed by the dead owner
            for k in [k for k in seen if k[0] == node]:
                del seen[k]

    def revive_node(self, node: int) -> None:
        """Membership: node ``node`` rejoined — cold."""
        self.node_alive[node] = True

    def wipe(self) -> None:
        """Membership: the whole cluster crashed.  Every shard restarts
        cold; cumulative counters survive (they are observability)."""
        self.states = [self.cache.init(self.device)
                       for _ in range(self.cfg.num_nodes)]
        self._keys_stack = None
        self._peer_seen = [{} for _ in range(self.cfg.num_nodes)]

    # ------------------------------------------------------------------
    def _admission_filter(self, node: int, owner: int, slots: np.ndarray,
                          owner_state: SemanticCacheState) -> np.ndarray:
        """Which of ``slots`` (peer hits served by ``owner`` for ``node``)
        get re-admitted into ``node``'s shard, per ``cfg.admission``."""
        admit = admission_filter(
            self.cfg.admission, slots, owner_state, self.states[node],
            self.cache.policy, self._peer_seen[node], (owner,))
        if (len(self._peer_seen[node])
                > 4 * self.cfg.num_nodes * self.cfg.node_capacity):
            self._prune_peer_seen(node)
        return admit

    def _prune_peer_seen(self, node: int) -> None:
        """Drop counters whose entry incarnation was evicted (its slot's
        inserted_at no longer matches) — bounds host memory under churn."""
        ins = {p: _np(s.inserted_at) for p, s in enumerate(self.states)}
        self._peer_seen[node] = {
            k: v for k, v in self._peer_seen[node].items()
            if int(ins[k[0]][k[1]]) == k[2]}

    # ------------------------------------------------------------------
    def serve_peer_hits(self, node: int, queries: torch.Tensor,
                        miss_rows: np.ndarray, g_idx: np.ndarray,
                        g_score: np.ndarray, hit, tier, owner, score, value,
                        snapshot: Optional[List[SemanticCacheState]] = None
                        ) -> int:
        """Fold a cluster-wide probe of ``node``'s local misses into the
        result arrays: serve rows whose best pooled match is an
        above-threshold peer entry, touch the owners, apply admission.
        Returns the number of peer-served rows (for the miss rebate).

        ``queries`` holds ``node``'s (B, D) query rows on the device;
        ``miss_rows`` indexes the result arrays and ``queries``;
        ``g_idx``/``g_score`` are the pooled top-1 per miss row.
        ``snapshot``: the shard states the probe ran against — payloads come
        from it, touches and admissions apply to the live states."""
        cfg = self.cfg
        dev = self.device
        probed = self.states if snapshot is None else snapshot
        peer_hit = g_score >= cfg.threshold
        owners = (g_idx // cfg.node_capacity).astype(np.int32)
        slots = (g_idx % cfg.node_capacity).astype(np.int32)
        n_peer_served = 0
        for p in range(cfg.num_nodes):
            sel = peer_hit & (owners == p)
            if not sel.any() or p == node:
                continue
            rows = miss_rows[sel]
            n_sel = int(sel.sum())
            slots_t = torch.as_tensor(slots[sel], dtype=torch.long,
                                      device=dev)
            vals = _np(probed[p].values[slots_t])
            value[rows] = vals
            score[rows] = g_score[sel]
            tier[rows] = TIER_PEER
            owner[rows] = p
            hit[rows] = True
            n_peer_served += n_sel
            self.peer_hits[p] += n_sel
            self.states[p] = self.cache.touch(
                self.states[p], slots_t,
                torch.ones((n_sel,), dtype=torch.bool, device=dev))
            admit = self._admission_filter(node, p, slots[sel], probed[p])
            if admit.any():
                # one admission per distinct cached entry in the batch
                _, first = np.unique(slots[sel][admit], return_index=True)
                arows = rows[admit][np.sort(first)]
                avals = vals[admit][np.sort(first)]
                self.states[node] = self.cache.insert(
                    self.states[node],
                    queries[torch.as_tensor(arows, dtype=torch.long,
                                            device=queries.device)],
                    torch.as_tensor(avals, device=dev))
                self.peer_fills[node] += len(arows)
                self._keys_stack = None
        return n_peer_served

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
    def lookup_grouped(self, queries, mask: Optional[np.ndarray] = None
                       ) -> ClusterLookupResult:
        """The batched engine step's ladder: queries (num_nodes, B, D) —
        group g holds the batch that arrived at edge node g; mask
        (num_nodes, B) selects real rows.  One local + at most one peer
        launch per call."""
        res = self.probe(np.asarray(queries, np.float32), mask)
        return ClusterLookupResult(hit=res.hit[0], tier=res.tier[0],
                                   owner=res.owner[0], score=res.score[0],
                                   value=res.value[0])

    def lookup(self, node: int, queries) -> ClusterLookupResult:
        """queries: (Q, D) unit descriptors arriving at ``node``, routed
        through the same grouped ladder with a single-group mask (a ladder
        walk advances every shard's clock by one)."""
        res = route_flat(self, np.asarray(queries, np.float32), node, 0)
        return ClusterLookupResult(hit=res.hit, tier=res.tier,
                                   owner=res.owner, score=res.score,
                                   value=res.value)

    # ------------------------------------------------------------------
    def insert(self, node: int, keys, values) -> None:
        """Insert cloud results into the serving node's shard.  Inserts to
        a dead node are dropped (callers route around dead nodes first)."""
        if not self.node_alive[node]:
            return
        dev = self.device
        self.states[node] = self.cache.insert(
            self.states[node], torch.as_tensor(keys, device=dev),
            torch.as_tensor(values, device=dev))
        self._keys_stack = None

    def insert_home(self, cluster_id: int, node: int, keys, values) -> None:
        """Org-generic insert (cluster orgs ignore ``cluster_id``; a
        degenerate node axis ignores ``node``)."""
        self.insert(0 if self.cfg.num_nodes == 1 else node, keys, values)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        per_node = [self.cache.stats(s) for s in self.states]
        for p, s in enumerate(per_node):
            s["peer_hits_served"] = int(self.peer_hits[p])
            s["peer_fills"] = int(self.peer_fills[p])
        # per-node misses exclude peer-served requests (the peer rung
        # rebates them), so hits + misses == requests
        total_hits = sum(s["hits"] for s in per_node)
        total_misses = sum(s["misses"] for s in per_node)
        tot = total_hits + total_misses
        return {
            "nodes": per_node,
            "capacity": self.cfg.num_nodes * self.cfg.node_capacity,
            "occupancy": sum(s["occupancy"] for s in per_node),
            "hits": total_hits,
            "misses": total_misses,
            "hit_rate": (total_hits / tot) if tot else 0.0,
            "probe_dispatches": self.probe_dispatches,
            "ladder": self.ladder.stats(),
        }
