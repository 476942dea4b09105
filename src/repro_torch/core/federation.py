"""Cross-cluster federation tier — metro -> region digest probes over
federated edge clusters.  The port of ``repro/core/federation.py``.

One ``CooperativeEdgeCluster`` shares IC results inside a metro; a user
roaming to another metro recomputes everything.  ``FederatedEdgeTier`` owns
K clusters and composes the unified ladder (``core/tiers.py``) with a
*remote-cluster* rung:

  1. local   — the serving node's own shard          (``LocalRung``)
  2. peer    — the home cluster's other shards        (``PeerRung``)
  3. remote  — a compact per-cluster DIGEST (top-M hottest entry keys,
               refreshed every ``digest_interval`` steps, deliberately
               stale) is probed for the step's whole miss batch in ONE
               grouped dispatch; digest hits are confirmed against the
               candidate cluster's authoritative shards in ONE more
               dispatch, and the payload travels metro -> region -> metro
               (``RemoteDigestRung``, this module)
  4. cloud   — the caller forwards confirmed misses

Digests bound inter-cluster traffic: instead of broadcasting every miss to
every cluster (eCAR/CloudAR's full-broadcast strawman), each cluster ships
a digest refresh and misses probe the digests region-side.  The digest
control plane lives in ``core/digest.py``: keys optionally ship as int8
codes + per-row scales (~3.9x fewer bytes at D=128, probed by the
quantized batched lookup), refreshes optionally ship only the rows that
changed since the last publish (push-on-delta; exact reconstruction), and
``digest_bytes_shipped`` prices the metro -> region link.

At board scale the remote rung swaps the brute digest scan for the packed
two-stage IVF-PQ sidecar (``kernels/ivf_pq``, K6, selected per probe by live
advertised rows vs ``ann_min_rows`` or forced with ``ann_mode="ivfpq"``):
still ONE probe dispatch, but ``ann_sub + 2`` bytes scanned per advertised
slot instead of a full key row.  PQ-approximated candidates are admitted
at the looser ``ann_admission`` floor (approximate scores sit below the
exact cosine) and every candidate still passes the same full-precision
confirm, so the ANN path inherits the under-report-only contract verbatim.

Staleness/quantization semantics, stated once: digests may UNDER-report
(an entry admitted since the last refresh — or whose quantized score dips
below threshold — is a recoverable miss) and may point at dead entries
(evicted since the refresh — the authoritative confirm rejects them as
``digest_false_hit`` and the request falls through to the cloud).  They
never over-report: no request is ever served a payload that the
full-precision confirm probe did not find live in the owning cluster at
serve time.

Dispatch accounting — the reason this tier is viable at engine scale: the
shared ``TierLadder`` walks federation-wide rungs, each ONE batched
dispatch over all K x N shards (local, peer) plus at most two more for the
remote rung (digest probe + authoritative confirm) **regardless of K** —
at most 4 device dispatches per engine step, counter-verified by
``TierLadder.max_dispatches``.

Region-aware eviction: when the cluster eviction policy is
``EvictionPolicy(region_aware=True)``, each digest refresh also marks the
region's *last protected authoritative copy* of every region-hot entry
(``core/digest.py::region_pin_mask`` — hot == it served remote/peer
consumers; last == no duplicate is already PINNED at a lower-id cluster,
the tie-break that guarantees the lowest-id hot holder keeps a pin) in
``SemanticCacheState.region_pin``, and eviction protects those slots, so a
region-hot entry cannot vanish from every cluster at once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cluster import (ClusterConfig, CooperativeEdgeCluster,
                                      _np, admission_filter,
                                      pow2 as _pow2)
from repro_torch.core.digest import (AnnConfig, DigestConfig,
                                     DigestPublisher, RegionDigestBoard,
                                     region_pin_mask)
from repro_torch.core.tiers import (TIER_LOCAL, TIER_MISS, TIER_NAMES,
                                    TIER_PEER, TIER_REMOTE, LocalRung,
                                    PeerRung, TierLadder, TierProbeResult,
                                    build_probe_context, empty_probe_arrays,
                                    route_flat)
from repro_torch.device import resolve_device
from repro_torch.kernels.similarity import similarity_topk_batched
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.parallel.sharding import (federated_digest_lookup,
                                           federated_digest_lookup_ivfpq,
                                           federated_digest_lookup_quantized)

__all__ = ["TIER_LOCAL", "TIER_PEER", "TIER_REMOTE", "TIER_MISS",
           "TIER_NAMES", "FederationConfig", "FederatedLookupResult",
           "FederatedEdgeTier", "RemoteDigestRung"]


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    num_clusters: int = 2
    cluster: ClusterConfig = ClusterConfig()
    digest_size: int = 128           # top-M hottest keys shipped per cluster
    digest_interval: int = 4         # steps between digest refreshes
    digest_quant: str = "fp32"       # fp32 | int8 wire/probe format
    digest_refresh: str = "full"     # full | delta (push-on-delta)
    share: bool = True               # False: isolated clusters (no remote rung)
    # remote-hit re-admission into the home node's shard; "inherit" uses the
    # cluster admission policy (same options: always/never/second_hit/
    # freq_weighted)
    remote_admission: str = "inherit"
    region_hot_min: int = 1          # peer_served floor for region pinning
    # IVF-PQ ANN sidecar for the digest probe (core/digest.py::AnnConfig):
    # "auto" keeps the brute int8/fp32 scan while the board is small and
    # switches to the two-stage kernel at ann_min_rows live rows; "ivfpq"
    # forces ANN; "off" never builds the index
    ann_mode: str = "auto"
    ann_min_rows: int = 4096
    ann_lists: int = 64              # coarse centroids / inverted lists
    ann_sub: int = 8                 # PQ subspaces (code bytes per row)
    ann_probe: int = 8               # lists scanned per query
    ann_seed: int = 0                # codebook-training determinism
    ann_train_iters: int = 8
    ann_cap_slack: float = 1.5
    # candidate-admission score floor for the ANN probe.  PQ-approximated
    # scores sit well below the exact cosine (the residual quantizer eats
    # a chunk of the dot product), so gating ANN candidates at the serve
    # threshold would starve the confirm; a looser floor is SAFE — every
    # candidate still passes the authoritative full-precision confirm at
    # ``cluster.threshold``, so the floor only trades wasted confirms
    # against recall, never correctness
    ann_admission: float = 0.5

    def __post_init__(self):
        assert self.num_clusters >= 1, self.num_clusters
        assert self.digest_size >= 1, self.digest_size
        assert self.digest_interval >= 1, self.digest_interval
        assert self.remote_admission in ("inherit", "always", "never",
                                         "second_hit", "freq_weighted")
        assert -1.0 <= self.ann_admission <= 1.0, self.ann_admission
        self.digest                  # validates quant/refresh
        self.ann                     # validates the ANN knobs

    @property
    def digest(self) -> DigestConfig:
        return DigestConfig(size=self.digest_size, quant=self.digest_quant,
                            refresh=self.digest_refresh)

    @property
    def ann(self) -> AnnConfig:
        return AnnConfig(mode=self.ann_mode, min_rows=self.ann_min_rows,
                         n_lists=self.ann_lists, n_sub=self.ann_sub,
                         n_probe=self.ann_probe, seed=self.ann_seed,
                         train_iters=self.ann_train_iters,
                         cap_slack=self.ann_cap_slack)

    @property
    def admission(self) -> str:
        return (self.cluster.admission
                if self.remote_admission == "inherit"
                else self.remote_admission)


class FederatedLookupResult(NamedTuple):
    hit: np.ndarray          # (K, N, B) bool — served at any edge tier
    tier: np.ndarray         # (K, N, B) int8 — TIER_LOCAL..TIER_MISS
    cluster: np.ndarray      # (K, N, B) int32 — serving cluster, -1 on miss
    owner: np.ndarray        # (K, N, B) int32 — serving node, -1 on miss
    score: np.ndarray        # (K, N, B) f32 — best score at the serving tier
    value: np.ndarray        # (K, N, B, P) payload (zeros on miss)


class RemoteDigestRung:
    """Rung 3: ONE grouped digest probe (every home cluster's miss batch vs
    every OTHER cluster's digest) + ONE authoritative confirm against the
    candidate clusters' full-precision shards.  Payloads read the pre-step
    snapshot; served rows touch the owner, apply the remote-admission
    policy, and rebate the home shard's miss counter."""

    name, code = "remote", TIER_REMOTE

    def __init__(self, fed: "FederatedEdgeTier"):
        self.fed = fed
        self._index = None           # (board index, its copy on the device)

    def _device_index(self, index):
        """The board's IVF-PQ index with its arrays on the federation's
        device, copied once per index build (the board returns the same
        object until a rebuild)."""
        if self._index is None or self._index[0] is not index:
            on_dev = index._replace(**{
                f: torch.as_tensor(getattr(index, f), device=self.fed.device)
                for f in ("centroids", "cent_valid", "codes", "slot_valid",
                          "slot_owner", "slot_rid", "codebook")})
            self._index = (index, on_dev)
        return self._index[1]

    # ------------------------------------------------------------------
    def _use_ann(self) -> bool:
        """Probe-format selection by board size: brute stays while the
        board is small (one cheap matmul), IVF-PQ takes over once the
        advertised row count crosses ``ann_min_rows`` (or is forced)."""
        fed = self.fed
        ann = fed.cfg.ann
        if ann.mode == "off" or fed.board.ann_codebook is None:
            return False
        if ann.mode == "ivfpq":
            return True
        return int(fed.board.valid.sum()) >= ann.min_rows

    def _digest_probe(self, dq: np.ndarray):
        """One dispatch over the region digest board, in its wire format.

        Returns (idx, score, admit): ``admit`` is the candidate-admission
        score floor matched to the probe's score scale — the serve
        threshold for the exact brute probes, the looser
        ``cfg.ann_admission`` for PQ-approximated ANN scores (safe: the
        confirm is authoritative either way)."""
        fed = self.fed
        board = fed.board
        impl = fed.cfg.cluster.lookup_impl
        dev = fed.device
        dq = torch.as_tensor(dq, device=dev)
        if self._use_ann():
            index = board.ann_index(fed.cfg.ann)
            if index is not None:
                d_idx, d_score = federated_digest_lookup_ivfpq(
                    dq, self._device_index(index), 1,
                    n_probe=fed.cfg.ann.n_probe, impl=impl)
                return d_idx, d_score, fed.cfg.ann_admission
        threshold = fed.cfg.cluster.threshold
        valid = torch.as_tensor(board.valid, device=dev)
        if board.cfg.quant == "int8":
            d_idx, d_score = federated_digest_lookup_quantized(
                dq, torch.as_tensor(board.codes, device=dev),
                torch.as_tensor(board.scales, device=dev), valid, 1,
                impl=impl)
            return d_idx, d_score, threshold
        d_idx, d_score = federated_digest_lookup(
            dq, torch.as_tensor(board.keys, device=dev), valid, 1, impl=impl)
        return d_idx, d_score, threshold

    # ------------------------------------------------------------------
    def probe(self, queries: np.ndarray, mask: np.ndarray,
              ctx) -> Optional[TierProbeResult]:
        fed = self.fed
        ccfg = fed.cfg.cluster
        K, N, B, D = queries.shape
        M = fed.cfg.digest_size
        C = ccfg.node_capacity
        if not fed.board.valid.any():
            return None                  # nothing advertised anywhere (e.g.
                                         # warmup): the probe cannot hit

        # flatten each home cluster's misses into one padded digest batch
        rows_of = [list(zip(*np.nonzero(mask[k]))) for k in range(K)]
        Bm = _pow2(max(len(r) for r in rows_of))
        dq = np.zeros((K, Bm, D), np.float32)
        for k, rows in enumerate(rows_of):
            for i, (n, b) in enumerate(rows):
                dq[k, i] = queries[k, n, b]

        d_idx, d_score, admit = self._digest_probe(dq)
        dispatches = 1
        d_idx = _np(d_idx)[..., 0]
        d_score = _np(d_score)[..., 0]
        cand = (d_idx // M).astype(np.int32)

        hit, tier, cluster, owner, score, value = empty_probe_arrays(
            queries, ccfg.payload_dim, ccfg.payload_dtype)

        # group digest hits by candidate cluster for the confirm probe
        cand_rows: List[List[Tuple[int, int, int]]] = [[] for _ in range(K)]
        for k, rows in enumerate(rows_of):
            for i, (n, b) in enumerate(rows):
                if d_score[k, i] >= admit:
                    c = int(cand[k, i])
                    if not fed.cluster_is_alive(c):
                        # the advertised cluster died mid-window (board
                        # not yet tombstoned): the probe connection is
                        # refused — count it and fall through to cloud,
                        # never serve the dead copy
                        fed.remote_dead += 1
                        continue
                    cand_rows[c].append((k, n, b))
        if not sum(len(r) for r in cand_rows):
            return TierProbeResult(hit, tier, cluster, owner, score, value,
                                   dispatches)

        Ba = _pow2(max(len(r) for r in cand_rows))
        aq = np.zeros((K, Ba, D), np.float32)
        for c, rows in enumerate(cand_rows):
            for i, (k, n, b) in enumerate(rows):
                aq[c, i] = queries[k, n, b]

        a_idx, a_score = similarity_topk_batched(
            torch.as_tensor(aq, device=ctx.keys.device),
            ctx.keys.reshape(K, N * C, D), ctx.valid.reshape(K, N * C), 1,
            impl=ccfg.lookup_impl)
        dispatches += 1
        a_idx = _np(a_idx)[..., 0]
        a_score = _np(a_score)[..., 0]

        rebate = np.zeros((K, N), np.int64)
        values_of: Dict[Tuple[int, int], np.ndarray] = {}  # one pull per shard
        serve_groups: Dict[Tuple[int, int, int, int], List[Tuple[int, int]]] \
            = {}                         # (k, n, c, p) -> [(slot, b)]
        for c, rows in enumerate(cand_rows):
            if not rows:
                continue
            cl_c = fed.clusters[c]
            touch_of: Dict[int, List[int]] = {}
            for i, (k, n, b) in enumerate(rows):
                if a_score[c, i] < ccfg.threshold:
                    # stale digest: the advertised entry is gone (or drifted
                    # below threshold) — wasted probe, fall through to cloud
                    fed.digest_false_hits += 1
                    continue
                p = int(a_idx[c, i]) // C
                slot = int(a_idx[c, i]) % C
                if (c, p) not in values_of:
                    values_of[(c, p)] = _np(ctx.pre_states[c][p].values)
                hit[k, n, b] = True
                tier[k, n, b] = TIER_REMOTE
                cluster[k, n, b] = c
                owner[k, n, b] = p
                score[k, n, b] = a_score[c, i]
                value[k, n, b] = values_of[(c, p)][slot]
                fed.remote_hits[c] += 1
                rebate[k, n] += 1
                touch_of.setdefault(p, []).append(slot)
                serve_groups.setdefault((k, n, c, p), []).append((slot, b))
            # one touch per owner shard: LRU/LFU refresh + peer_served
            for p, slots in touch_of.items():
                cl_c.states[p] = cl_c.cache.touch(
                    cl_c.states[p],
                    torch.as_tensor(slots, dtype=torch.long,
                                    device=fed.device),
                    torch.ones((len(slots),), dtype=torch.bool,
                               device=fed.device))
        fed._admit_remote(queries, serve_groups, values_of, ctx.pre_states)

        # the home shard counted these as misses; the owner counted the
        # served hit (touch) — rebate so hits + misses == requests
        for k in range(K):
            for n in range(N):
                if rebate[k, n]:
                    st = fed.clusters[k].states[n]
                    fed.clusters[k].states[n] = dataclasses.replace(
                        st, misses=st.misses - int(rebate[k, n]))
        return TierProbeResult(hit, tier, cluster, owner, score, value,
                               dispatches)


class FederatedEdgeTier:
    """K federated ``CooperativeEdgeCluster``s behind one shared ladder.

    All request paths are batched: ``lookup_grouped`` takes the engine
    step's full (K, N, B, D) request tensor; ``lookup`` is a convenience
    wrapper for one (cluster, node) batch through the same ladder.  This
    class is itself a ``CacheTier`` (org-level ``probe``), so an engine can
    compose it directly with a cloud tier.
    """

    name, code = "edge", TIER_LOCAL      # CacheTier identity (org-level)

    def __init__(self, cfg: FederationConfig, metrics=None, tracer=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # one registry for the ladder + digest control plane (a private one
        # when the owning engine plumbs none); member clusters keep their
        # own — their standalone ladders are bypassed by the federated walk
        self.metrics = (metrics if metrics is not None
                        else MetricsRegistry())
        self.clusters = [CooperativeEdgeCluster(cfg.cluster,
                                                device=self.device)
                         for _ in range(cfg.num_clusters)]
        K = cfg.num_clusters
        D = cfg.cluster.key_dim
        dcfg = cfg.digest
        self.publishers = [DigestPublisher(dcfg, D) for _ in range(K)]
        self.board = RegionDigestBoard(dcfg, K, D, metrics=self.metrics)
        self.step_count = 0
        self._digest_refreshes = self.metrics.counter("digest/refreshes")
        self._digest_false_hits = self.metrics.counter("digest/false_hits")
        self._remote_dead = self.metrics.counter("membership/remote_dead")
        self.membership = None           # attach_membership() plumbs one
        self.remote_hits = np.zeros((K,), np.int64)    # served BY cluster k
        self.remote_fills = np.zeros((K,), np.int64)   # admitted INTO cluster k
        # second-hit remote admission: per home cluster, count of remote
        # hits per (home_node, owner_cluster, owner_node, slot, inserted_at)
        self._remote_seen: List[Dict[Tuple, int]] = [
            {} for _ in range(K)]
        self._federating = cfg.share and K > 1
        rungs = [LocalRung(), PeerRung()]
        if self._federating:
            rungs.append(RemoteDigestRung(self))
        self.ladder = TierLadder(rungs, metrics=self.metrics,
                                 tracer=tracer)

    # registry-backed legacy counters; the setters keep the seed's
    # ``fed.digest_false_hits += 1`` call sites working verbatim
    @property
    def digest_refreshes(self) -> int:
        return self._digest_refreshes.value

    @digest_refreshes.setter
    def digest_refreshes(self, v: int) -> None:
        self._digest_refreshes.set(v)

    @property
    def digest_false_hits(self) -> int:
        return self._digest_false_hits.value

    @digest_false_hits.setter
    def digest_false_hits(self, v: int) -> None:
        self._digest_false_hits.set(v)

    @property
    def remote_dead(self) -> int:
        """Digest candidates refused because the advertised cluster was
        dead (ground truth) at serve time — each fell through to cloud."""
        return self._remote_dead.value

    @remote_dead.setter
    def remote_dead(self, v: int) -> None:
        self._remote_dead.set(v)

    # ------------------------------------------------------------------
    # membership control plane
    def attach_membership(self, membership) -> None:
        """Wire a ``core/membership.py::ClusterMembership`` control plane
        into the federation: detected deaths tombstone the digest board,
        wipe the dead cluster's shards (lost-not-phantom), reset its
        publisher's delta memory, and re-elect region pins over the
        survivors; the remote rung starts refusing serves from
        ground-truth-dead clusters (counted ``remote_dead``)."""
        assert membership.num_clusters == self.cfg.num_clusters, (
            membership.num_clusters, self.cfg.num_clusters)
        assert membership.nodes_per_cluster == self.cfg.cluster.num_nodes, (
            membership.nodes_per_cluster, self.cfg.cluster.num_nodes)
        self.membership = membership
        membership.add_listener(self._on_membership_event)

    def cluster_is_alive(self, cluster: int) -> bool:
        """GROUND-TRUTH liveness (not detection): a probe to a dead
        cluster gets no response even before the heartbeat expires.
        Always True without an attached membership plane."""
        return (self.membership is None
                or bool(self.membership.alive_clusters()[cluster]))

    def _on_membership_event(self, ev) -> None:
        cl = self.clusters[ev.cluster]
        if ev.kind == "cluster_dead":
            # tombstone: the replica stops attracting probes; the crash
            # lost the cache, so the shards wipe and the publisher's delta
            # memory resets (next publish ships a full frame)
            self.board.tombstone(ev.cluster)
            self.publishers[ev.cluster].reset()
            cl.wipe()
            cl.node_alive[:] = False     # drops any straggler insert too
            self._prune_dead_owner(ev.cluster)
        elif ev.kind == "cluster_alive":
            # revive is COLD.  A crash that was revived before any sweep
            # detected it never tombstoned — its pre-crash advert is still
            # on the board pointing into a cache that died; clear it now.
            if self.board.valid[ev.cluster].any():
                self.board.tombstone(ev.cluster)
                self._prune_dead_owner(ev.cluster)
            self.publishers[ev.cluster].reset()
            cl.wipe()
            cl.node_alive[:] = True
        elif ev.kind == "node_dead":
            cl.kill_node(ev.node)
        elif ev.kind == "node_alive":
            cl.revive_node(ev.node)
        if self._federating and self.cfg.cluster.policy.region_aware:
            # re-elect: pins at the dead cluster are gone (wiped); the
            # next-hottest holder (lowest-id alive) pins on this pass
            self._refresh_region_pins()

    def _prune_dead_owner(self, cluster: int) -> None:
        """Drop second-hit admission counters pointing at a dead owner
        cluster — its entry incarnations no longer exist."""
        for k in range(self.cfg.num_clusters):
            self._remote_seen[k] = {
                key: v for key, v in self._remote_seen[k].items()
                if key[1] != cluster}

    # ------------------------------------------------------------------
    # ladder-counter views (the bound the tests/benchmarks pin)
    @property
    def probe_dispatches(self) -> int:
        return self.ladder.probe_dispatches

    @property
    def last_ladder_dispatches(self) -> int:
        return self.ladder.last_dispatches

    @property
    def max_ladder_dispatches(self) -> int:
        return self.ladder.max_dispatches

    @property
    def tier_counts(self) -> dict:
        # the ladder's counters are keyed by the fixed tier names; the
        # membership-refused digest candidates ride along as remote_dead
        # (they are not a tier — each one fell through and was counted at
        # whatever tier finally served it)
        tc = dict(self.ladder.tier_counts)
        if self.membership is not None or self.remote_dead:
            tc["remote_dead"] = self.remote_dead
        return tc

    @property
    def digest_bytes_shipped(self) -> int:
        return self.board.bytes_shipped

    # ------------------------------------------------------------------
    def refresh_digests(self) -> None:
        """Rebuild every cluster's digest — the top-M hottest live entries
        (hit count, recency tie-break) across its shards — and ship it
        metro -> region through the configured wire format (``DigestConfig``:
        full/delta refresh, fp32/int8 keys).  Host-side — the refresh rides
        the control plane, not the per-step ladder.  With a region-aware
        eviction policy, also refreshes the ``region_pin`` masks."""
        M = self.cfg.digest_size
        D = self.cfg.cluster.key_dim
        for k, cl in enumerate(self.clusters):
            if not self.cluster_is_alive(k):
                continue             # a dead metro publishes nothing; its
                                     # replica keeps its last advert until
                                     # detection tombstones it
            # one device-to-host copy per field (the reference reads numpy)
            keys = _np(torch.cat([s.keys for s in cl.states]))
            valid = _np(torch.cat([cl.cache.policy.expire(s, s.clock)
                                   for s in cl.states]))
            freq = _np(torch.cat([s.freq for s in cl.states]))
            lu = _np(torch.cat([s.last_used for s in cl.states]))
            # hottest-first: hit count, recency tie-break, invalid last —
            # exact integer ordering at any clock value (lexsort keys are
            # least-significant first)
            order = np.lexsort((-lu, -freq, ~valid))[:M]
            order = order[valid[order]]
            dig_keys = np.zeros((M, D), np.float32)
            dig_valid = np.zeros((M,), bool)
            dig_keys[:len(order)] = keys[order]
            dig_valid[:len(order)] = True
            # first publisher with enough live rows trains the region's
            # shared ANN codebook (deterministic under ann_seed); the board
            # adopts it (one-time codebook ship on the byte ledger) and
            # every publisher — including this one, BEFORE its publish —
            # starts shipping IVF list assignments with its refreshes
            if (self.cfg.ann_mode != "off"
                    and self.board.ann_codebook is None
                    and int(dig_valid.sum()) >= self.cfg.ann.n_lists):
                cb = self.publishers[k].train_codebook(
                    dig_keys, dig_valid, self.cfg.ann)
                self.board.adopt_codebook(cb)
                for pub in self.publishers:
                    pub.attach_codebook(cb)
            self.board.apply(k, self.publishers[k].publish(dig_keys,
                                                           dig_valid))
        self.digest_refreshes += 1
        if self.cfg.cluster.policy.region_aware:
            self._refresh_region_pins()

    # ------------------------------------------------------------------
    def _refresh_region_pins(self) -> None:
        """Mark each cluster's last-protected-copy region-hot entries
        (``core/digest.py::region_pin_mask``) so eviction protects them.

        Tie-break for multiply-held entries: clusters are processed in id
        order and each defers only to copies ALREADY PINNED at lower-id
        clusters — never to a mere (possibly unprotected) replica — so
        the lowest-id region-hot holder of every entry keeps a pin and at
        least one copy stays protected.  Deferring to any advertiser
        would let a hot copy unpin against a cold one that itself never
        pins, leaving the entry protected nowhere."""
        ccfg = self.cfg.cluster
        pinned_keys: List[np.ndarray] = []   # keys pinned at lower clusters
        for c, cl in enumerate(self.clusters):
            if not self.cluster_is_alive(c):
                # a dead cluster holds no pins (its copies are gone) and
                # contributes nothing to protect against — survivors that
                # previously deferred to it re-elect on this pass
                for p, st in enumerate(cl.states):
                    if bool(st.region_pin.any()):
                        cl.states[p] = dataclasses.replace(
                            st, region_pin=torch.zeros_like(st.region_pin))
                continue
            adv = (np.concatenate(pinned_keys) if pinned_keys
                   else np.zeros((0, ccfg.key_dim), np.float32))
            for p, st in enumerate(cl.states):
                keys = _np(st.keys)
                pin = region_pin_mask(
                    keys, _np(st.valid), _np(st.peer_served), adv,
                    ccfg.threshold, self.cfg.region_hot_min)
                cl.states[p] = dataclasses.replace(
                    st, region_pin=torch.as_tensor(pin, device=self.device))
                if pin.any():
                    pinned_keys.append(keys[pin])

    # ------------------------------------------------------------------
    def probe(self, queries: np.ndarray, mask: np.ndarray = None,
              ctx=None) -> TierProbeResult:
        """CacheTier protocol: one engine step's full ladder over
        (K, N, B, D).  At most 4 device dispatches per step regardless of
        K: local rung, peer rung, digest probe, authoritative confirm."""
        queries = np.asarray(queries, np.float32)
        K, N, B, D = queries.shape
        assert K == self.cfg.num_clusters, (K, self.cfg.num_clusters)
        assert N == self.cfg.cluster.num_nodes, (N,
                                                 self.cfg.cluster.num_nodes)
        if mask is None:
            mask = np.ones((K, N, B), bool)
        if self._federating and \
                self.step_count % self.cfg.digest_interval == 0:
            self.refresh_digests()
        self.step_count += 1
        if self.membership is not None:
            # stamp membership events with the serving step they land on
            self.membership.step = self.step_count
        pctx = build_probe_context(self.clusters)
        res = self.ladder.probe(queries, mask, pctx,
                                self.cfg.cluster.payload_dim,
                                self.cfg.cluster.payload_dtype)
        return TierProbeResult(*res, dispatches=self.ladder.last_dispatches)

    # ------------------------------------------------------------------
    def lookup_grouped(self, queries: np.ndarray,
                       mask: Optional[np.ndarray] = None
                       ) -> FederatedLookupResult:
        """One engine step's full ladder: queries (K, N, B, D) — group
        (k, n) holds the batch that arrived at cluster k, node n; mask
        (K, N, B) selects real rows."""
        res = self.probe(queries, mask)
        return FederatedLookupResult(hit=res.hit, tier=res.tier,
                                     cluster=res.cluster, owner=res.owner,
                                     score=res.score, value=res.value)

    # ------------------------------------------------------------------
    def _admit_remote(self, queries, serve_groups, values_of, pre_states
                      ) -> None:
        """Apply the remote-admission policy for the step's served rows:
        one ``admission_filter`` call per (home node, owner shard) group —
        evaluated against the pre-admission home state, like the peer
        path's per-serve batching — one de-duplicated batched insert per
        home node, ``remote_fills`` per home cluster."""
        inserts: Dict[Tuple[int, int], Tuple[List, List]] = {}
        for (k, n, c, p), rows in serve_groups.items():
            slots = np.array([s for s, _ in rows], np.int32)
            seen = self._remote_seen[k]
            ok = admission_filter(
                self.cfg.admission, slots, pre_states[c][p],
                self.clusters[k].states[n], self.clusters[k].cache.policy,
                seen, (n, c, p))
            if len(seen) > 4 * self.cfg.num_clusters * \
                    self.cfg.cluster.num_nodes \
                    * self.cfg.cluster.node_capacity:
                self._prune_remote_seen(k)
            if not ok.any():
                continue
            # de-duplicate entries within the step: one admission per
            # distinct cached entry per home node
            done = set()
            qs, vs = inserts.setdefault((k, n), ([], []))
            for (slot, b), admit in zip(rows, ok):
                if not admit or slot in done:
                    continue
                done.add(slot)
                qs.append(queries[k, n, b])
                vs.append(values_of[(c, p)][slot])
        for (k, n), (qs, vs) in inserts.items():
            if not qs:
                continue
            cl = self.clusters[k]
            cl.states[n] = cl.cache.insert(
                cl.states[n], torch.as_tensor(np.stack(qs), device=self.device),
                torch.as_tensor(np.stack(vs), device=self.device))
            cl._keys_stack = None
            self.remote_fills[k] += len(qs)

    def _prune_remote_seen(self, k: int) -> None:
        """Drop counters whose entry incarnation was evicted — bounds host
        memory under churn (keys are (node, owner_c, owner_p, slot, ins))."""
        ins = {c: [_np(s.inserted_at) for s in cl.states]
               for c, cl in enumerate(self.clusters)}
        self._remote_seen[k] = {
            key: v for key, v in self._remote_seen[k].items()
            if int(ins[key[1]][key[2]][key[3]]) == key[4]}

    # ------------------------------------------------------------------
    def lookup(self, cluster_id: int, node: int, queries: np.ndarray
               ) -> FederatedLookupResult:
        """One (cluster, node) batch through the grouped ladder.  Returns a
        FederatedLookupResult sliced to (Q,) leading dims (the batch is
        zero-padded to the next power of two, as in the reference)."""
        res = route_flat(self, np.asarray(queries, np.float32), node,
                         cluster_id)
        return FederatedLookupResult(hit=res.hit, tier=res.tier,
                                     cluster=res.cluster, owner=res.owner,
                                     score=res.score, value=res.value)

    # ------------------------------------------------------------------
    def insert(self, cluster_id: int, node: int, keys, values) -> None:
        """Insert cloud results into the home node's shard."""
        self.clusters[cluster_id].insert(node, keys, values)

    def insert_home(self, cluster_id: int, node: int, keys, values) -> None:
        """Org-generic insert (same as ``insert``, with ``pack_flat``'s
        degenerate-axis rule: a 1-wide cluster/node axis ignores its id)."""
        if self.cfg.num_clusters == 1:
            cluster_id = 0
        if self.cfg.cluster.num_nodes == 1:
            node = 0
        self.insert(cluster_id, node, keys, values)

    # ------------------------------------------------------------------
    def digest_stats(self) -> dict:
        s = self.board.stats()
        s.update(refreshes=self.digest_refreshes,
                 false_hits=self.digest_false_hits,
                 interval=self.cfg.digest_interval)
        return s

    def stats(self) -> dict:
        per_cluster = [cl.stats() for cl in self.clusters]
        for c, s in enumerate(per_cluster):
            s["remote_hits_served"] = int(self.remote_hits[c])
            s["remote_fills"] = int(self.remote_fills[c])
        hits = sum(s["hits"] for s in per_cluster)
        misses = sum(s["misses"] for s in per_cluster)
        tot = hits + misses
        return {
            "clusters": per_cluster,
            "capacity": (self.cfg.num_clusters * self.cfg.cluster.num_nodes
                         * self.cfg.cluster.node_capacity),
            "occupancy": sum(s["occupancy"] for s in per_cluster),
            "hits": hits,
            "misses": misses,
            "hit_rate": (hits / tot) if tot else 0.0,
            "tier_counts": dict(self.tier_counts),
            "digest_false_hits": self.digest_false_hits,
            "digest_refreshes": self.digest_refreshes,
            "probe_dispatches": self.probe_dispatches,
            "max_ladder_dispatches": self.max_ladder_dispatches,
            "remote_dead": self.remote_dead,
            "ladder": self.ladder.stats(),
            "digest": self.digest_stats(),
            **({"membership": self.membership.stats()}
               if self.membership is not None else {}),
        }
