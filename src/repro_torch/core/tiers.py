"""Unified tier-ladder protocol — ONE rung-walking loop for every cache tier.

The port of ``repro/core/tiers.py`` (see it for the full design):

* ``CacheTier`` — the probe protocol: ``probe(queries, mask, ctx) ->
  TierProbeResult`` over the step's grouped ``(K, N, B, D)`` query tensor.
* ``TierLadder`` — the generic walker: probes rungs in order over the
  shrinking miss mask, folds each rung's hits into one ``LadderResult``,
  and owns the dispatch counters that pin the batched bounds.
* ``route_flat`` / ``pack_flat`` / ``unpack_flat`` — the engines' one
  code path from a flat request batch onto a ladder org.

Tier codes are canonical across every layer (``local=0, peer=1,
remote=2, miss=3``).  Host-side arrays stay numpy; the rungs move them to
the cache's device for the probe launch.  ``LocalRung`` and ``PeerRung``
live here; the federation's ``RemoteDigestRung`` lives in
``core/federation.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, NamedTuple, Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch.kernels.similarity import similarity_topk_batched
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER

TIER_LOCAL, TIER_PEER, TIER_REMOTE, TIER_MISS = 0, 1, 2, 3
TIER_NAMES = ("local", "peer", "remote", "miss")


def pow2(n: int, lo: int = 1) -> int:
    """Next power of two >= max(n, lo) — the shared pad-bucket policy."""
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class TierProbeResult(NamedTuple):
    """One rung's answer for the rows it was asked about (all arrays
    ``(K, N, B)``-leading; ``value`` adds the payload dim)."""

    hit: np.ndarray
    tier: np.ndarray         # canonical code per served row
    cluster: np.ndarray      # serving cluster, -1 where not served
    owner: np.ndarray        # serving node, -1 where not served
    score: np.ndarray
    value: np.ndarray
    dispatches: int


class LadderResult(NamedTuple):
    """The folded walk: per-row serving tier (``TIER_MISS`` when no rung
    served it), serving (cluster, node), score and payload."""

    hit: np.ndarray          # (K, N, B) bool — served by any probed tier
    tier: np.ndarray         # (K, N, B) int8 canonical codes
    cluster: np.ndarray      # (K, N, B) int32, -1 on miss
    owner: np.ndarray        # (K, N, B) int32, -1 on miss
    score: np.ndarray        # (K, N, B) f32
    value: np.ndarray        # (K, N, B, P)


class CacheTier(Protocol):
    """The probe protocol every rung/org/cloud tier implements."""

    name: str
    code: int

    def probe(self, queries: np.ndarray, mask: np.ndarray,
              ctx: Any) -> Optional[TierProbeResult]:
        """Serve what this tier can of the ``mask``-selected rows; None is
        "nothing to do, zero dispatches"."""
        ...


@dataclasses.dataclass
class ProbeContext:
    """Per-step shared state for the intra-org rungs: the pre-step shard
    snapshot every rung's probe and payload read resolves against (so an
    earlier rung's admissions never change what a later rung serves —
    ``SemanticCache`` ops build new tensors, so a snapshot is a list of
    references), plus the stacked key/valid tensors the kernels scan."""

    clusters: List                  # CooperativeEdgeCluster per cluster
    pre_states: List[List]          # (K, N) SemanticCacheState snapshot
    keys: torch.Tensor              # (K, N, C, D)
    valid: torch.Tensor             # (K, N, C)
    alive: List[List]               # (K, N) TTL-expiry masks


def build_probe_context(clusters: Sequence) -> ProbeContext:
    stacks = [cl._stacks() for cl in clusters]
    return ProbeContext(
        clusters=list(clusters),
        pre_states=[list(cl.states) for cl in clusters],
        keys=torch.stack([s[0] for s in stacks]),
        valid=torch.stack([s[1] for s in stacks]),
        alive=[s[2] for s in stacks])


def empty_probe_arrays(queries: np.ndarray, payload_dim: int,
                       payload_dtype) -> tuple:
    """All-miss (hit, tier, cluster, owner, score, value) arrays for a
    (K, N, B, D) query tensor."""
    K, N, B, _ = queries.shape
    return (np.zeros((K, N, B), bool),
            np.full((K, N, B), TIER_MISS, np.int8),
            np.full((K, N, B), -1, np.int32),
            np.full((K, N, B), -1, np.int32),
            np.zeros((K, N, B), np.float32),
            np.zeros((K, N, B, payload_dim), np.dtype(payload_dtype)))


class LocalRung:
    """Rung 1: every node's own shard, ONE batched launch across all
    ``K * N`` shards (``similarity_topk_batched``).  Applies the probe
    through ``SemanticCache.apply_probe`` so counters, LRU/LFU touches and
    the TTL clock advance exactly as a standalone lookup would."""

    name, code = "local", TIER_LOCAL

    def probe(self, queries, mask, ctx: ProbeContext):
        clusters = ctx.clusters
        cfg = clusters[0].cfg
        K, N, B, D = queries.shape
        C = cfg.node_capacity
        dev = ctx.keys.device
        l_idx, l_score = similarity_topk_batched(
            torch.as_tensor(queries, device=dev).reshape(K * N, B, D),
            ctx.keys.reshape(K * N, C, D),
            ctx.valid.reshape(K * N, C), 1, impl=cfg.lookup_impl)
        l_idx = l_idx[..., 0].reshape(K, N, B)
        l_score = l_score[..., 0].reshape(K, N, B)
        mask_t = torch.as_tensor(mask, device=dev)

        hit, tier, cluster, owner, score, value = empty_probe_arrays(
            queries, cfg.payload_dim, cfg.payload_dtype)
        for k, cl in enumerate(clusters):
            for g in range(N):
                cl.states[g], res = cl.cache.apply_probe(
                    cl.states[g], l_idx[k, g], l_score[k, g],
                    mask=mask_t[k, g], alive=ctx.alive[k][g])
                hit[k, g] = _np(res.hit)
                score[k, g] = _np(res.score)
                value[k, g] = _np(res.value)
            owner[k][hit[k]] = np.nonzero(hit[k])[0].astype(np.int32)
            cluster[k][hit[k]] = k
        tier[hit] = self.code
        return TierProbeResult(hit, tier, cluster, owner, score, value,
                               dispatches=1)


class PeerRung:
    """Rung 2: each cluster's pooled shards, ONE batched launch spanning
    every shard of every cluster.  Serves from the pre-step snapshot (an
    earlier group's admission must not change a later group's payload),
    touches the owning shard, applies the admission policy, and rebates the
    home shard's miss counter for served rows so hits + misses ==
    requests.  (A cluster on a real cache-axis mesh — the reference's
    collective branch — cannot be built yet: ROADMAP.md Queue 1 item 12.)"""

    name, code = "peer", TIER_PEER

    def probe(self, queries, mask, ctx: ProbeContext):
        clusters = ctx.clusters
        cfg = clusters[0].cfg
        K, N, B, D = queries.shape
        C = cfg.node_capacity
        if not (cfg.share and N > 1 and mask.any()):
            return None
        dev = ctx.keys.device
        q_dev = torch.as_tensor(queries, device=dev)
        g_idx, g_score = similarity_topk_batched(
            q_dev.reshape(K, N * B, D), ctx.keys.reshape(K, N * C, D),
            ctx.valid.reshape(K, N * C), 1, impl=cfg.lookup_impl)
        g_idx = _np(g_idx)[..., 0].reshape(K, N, B)
        g_score = _np(g_score)[..., 0].reshape(K, N, B)

        hit, tier, cluster, owner, score, value = empty_probe_arrays(
            queries, cfg.payload_dim, cfg.payload_dtype)
        for k, cl in enumerate(clusters):
            for g in range(N):
                miss_rows = np.nonzero(mask[k, g])[0]
                if not miss_rows.size:
                    continue
                n_served = cl.serve_peer_hits(
                    g, q_dev[k, g], miss_rows, g_idx[k, g][miss_rows],
                    g_score[k, g][miss_rows], hit[k, g], tier[k, g],
                    owner[k, g], score[k, g], value[k, g],
                    snapshot=ctx.pre_states[k])
                if n_served:
                    cl.states[g] = dataclasses.replace(
                        cl.states[g],
                        misses=cl.states[g].misses - n_served)
            cluster[k][hit[k]] = k
        return TierProbeResult(hit, tier, cluster, owner, score, value,
                               dispatches=1)


class TierLadder:
    """The generic rung walker + the dispatch-bound counters (all in a
    ``MetricsRegistry`` under ``prefix``; the attribute names are
    read-only views).  ``tracer`` gets one ``probe:<rung>`` span per probed
    rung."""

    def __init__(self, rungs: Sequence[CacheTier],
                 metrics: Optional[MetricsRegistry] = None,
                 prefix: str = "ladder", tracer=None):
        self.rungs = list(rungs)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.prefix = prefix
        self.trace = tracer if tracer is not None else NULL_TRACER
        m, p = self.metrics, prefix
        self._tier_counts = {n: m.counter(f"{p}/tier_counts/{n}")
                             for n in TIER_NAMES}
        self._rung_dispatches = {
            r.name: m.counter(f"{p}/rung_dispatches/{r.name}")
            for r in self.rungs}
        self._probe_dispatches = m.counter(f"{p}/probe_dispatches")
        self._last_dispatches = m.gauge(f"{p}/last_ladder_dispatches")
        self._max_dispatches = m.gauge(f"{p}/max_ladder_dispatches")
        self._probe_ms = {r.name: m.histogram(f"{p}/probe_ms/{r.name}")
                          for r in self.rungs}
        self.last_probe_ms = {r.name: 0.0 for r in self.rungs}

    @property
    def tier_counts(self) -> dict:
        return {n: c.value for n, c in self._tier_counts.items()}

    @property
    def rung_dispatches(self) -> dict:
        return {n: c.value for n, c in self._rung_dispatches.items()}

    @property
    def probe_dispatches(self) -> int:
        return self._probe_dispatches.value

    @property
    def last_dispatches(self) -> int:
        return self._last_dispatches.value

    @property
    def max_dispatches(self) -> int:
        return self._max_dispatches.value

    # ------------------------------------------------------------------
    def probe(self, queries: np.ndarray, mask: np.ndarray, ctx: Any,
              payload_dim: int, payload_dtype) -> LadderResult:
        queries = np.asarray(queries, np.float32)
        hit, tier, cluster, owner, score, value = empty_probe_arrays(
            queries, payload_dim, payload_dtype)
        remaining = np.asarray(mask, bool).copy()
        trace = self.trace
        last = 0
        for rung in self.rungs:
            self.last_probe_ms[rung.name] = 0.0
            if not remaining.any():
                break
            if trace.enabled:
                trace.begin(f"probe:{rung.name}", cat="ladder",
                            args={"tier_code": rung.code,
                                  "dispatch_id":
                                      self._probe_dispatches.value + last})
            t0 = time.perf_counter()
            res = rung.probe(queries, remaining, ctx)
            dt = (time.perf_counter() - t0) * 1e3
            if trace.enabled:
                trace.end()
            self.last_probe_ms[rung.name] = dt
            if res is None:
                continue
            self._probe_ms[rung.name].observe(dt)
            self._rung_dispatches[rung.name].inc(res.dispatches)
            last += res.dispatches
            served = res.hit & remaining
            if served.any():
                hit[served] = True
                tier[served] = res.tier[served]
                cluster[served] = res.cluster[served]
                owner[served] = res.owner[served]
                score[served] = res.score[served]
                value[served] = res.value[served]
                remaining &= ~served
        self._last_dispatches.set(last)
        self._probe_dispatches.inc(last)
        self._max_dispatches.max(last)
        mask_np = np.asarray(mask, bool)
        for code, name in enumerate(TIER_NAMES):
            n = int(((tier == code) & mask_np).sum())
            if n:
                self._tier_counts[name].inc(n)
        return LadderResult(hit, tier, cluster, owner, score, value)

    def stats(self) -> dict:
        """The uniform per-tier stats shape every layer exposes."""
        return {
            "tier_counts": dict(self.tier_counts),
            "rung_dispatches": dict(self.rung_dispatches),
            "probe_dispatches": self.probe_dispatches,
            "last_ladder_dispatches": self.last_dispatches,
            "max_ladder_dispatches": self.max_dispatches,
        }


# ---------------------------------------------------------------------------
# Flat-batch routing: the engines' one code path onto any ladder org
# ---------------------------------------------------------------------------


def org_grid(org) -> tuple:
    """(K clusters, N nodes) of a ladder org (cluster orgs are K=1)."""
    cfg = org.cfg
    if hasattr(cfg, "num_clusters"):
        return cfg.num_clusters, cfg.cluster.num_nodes
    return 1, cfg.num_nodes


def pack_flat(desc: np.ndarray, nodes, clusters, K: int, N: int):
    """Scatter a flat (n, D) descriptor batch into the grouped
    (K, N, Bmax, D) tensor + mask the ladder probes, group widths padded to
    a shared power of two.  Returns (queries, mask, rows_of) where
    ``rows_of[k][g]`` lists the flat rows routed to (cluster k, node g).
    A degenerate axis ignores its ids; otherwise out-of-range ids are an
    error."""
    n, D = desc.shape
    nodes = [0] * n if N == 1 else [int(g) for g in nodes]
    clusters = [0] * n if K == 1 else [int(k) for k in clusters]
    assert all(0 <= g < N for g in nodes), (nodes, N)
    assert all(0 <= k < K for k in clusters), (clusters, K)
    rows_of = [[[] for _ in range(N)] for _ in range(K)]
    for i, (g, k) in enumerate(zip(nodes, clusters)):
        rows_of[k][g].append(i)
    Bmax = pow2(max(len(r) for kr in rows_of for r in kr))
    queries = np.zeros((K, N, Bmax, D), np.float32)
    mask = np.zeros((K, N, Bmax), bool)
    for k in range(K):
        for g in range(N):
            rows = rows_of[k][g]
            queries[k, g, :len(rows)] = desc[rows]
            mask[k, g, :len(rows)] = True
    return queries, mask, rows_of


def unpack_flat(res: LadderResult, rows_of, n: int) -> LadderResult:
    """Gather a grouped LadderResult back to flat (n,)-leading arrays in
    the original submission order."""
    out = [np.zeros((n,) + f.shape[3:], f.dtype) for f in res]
    for k, kr in enumerate(rows_of):
        for g, rows in enumerate(kr):
            if rows:
                for o, f in zip(out, res):
                    o[rows] = f[k, g, :len(rows)]
    return LadderResult(*out)


def route_flat(org, desc: np.ndarray, nodes, clusters) -> LadderResult:
    """One flat request batch through an org's grouped ladder: pack, probe,
    unpack.  ``nodes``/``clusters`` may be scalars or per-row sequences."""
    desc = np.asarray(desc, np.float32)
    n = desc.shape[0]
    if np.ndim(nodes) == 0:
        nodes = [int(nodes)] * n
    if np.ndim(clusters) == 0:
        clusters = [int(clusters)] * n
    K, N = org_grid(org)
    queries, mask, rows_of = pack_flat(desc, nodes, clusters, K, N)
    res = org.probe(queries, mask, None)
    return unpack_flat(LadderResult(res.hit, res.tier, res.cluster,
                                    res.owner, res.score, res.value),
                       rows_of, n)
