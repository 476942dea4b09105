"""CoICEngine — descriptor + semantic cache + hash cache + two-tier router
around a cloud model.  The port of ``repro/core/coic.py``.

Workflow per batch of requests (paper §2, Figure 1):

  1. client pre-processes the request -> feature descriptor
  2. edge lookup: descriptor vs cached keys (threshold tau)
  3. hit  -> cached result returns immediately
  4. miss -> forward to cloud, compute, insert into the edge cache

The serving path is ONE ``TierLadder`` composing two org-level
``CacheTier``s: the edge org — a ``CooperativeEdgeCluster``
(``num_nodes >= 1``; a 1-node cluster IS the paper's single edge cache) or
a ``FederatedEdgeTier`` (``num_clusters > 1``) — and ``CloudRung``, which
serves whatever the edge rungs left, inserting results back into the home
shard.  A ``ClusterMembership`` control plane reroutes requests aimed at
dead targets.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.cluster import ClusterConfig, CooperativeEdgeCluster
from repro_torch.core.descriptor import NgramSketchDescriptor, PrefixDescriptor
from repro_torch.core.federation import FederatedEdgeTier, FederationConfig
from repro_torch.core.hash_cache import HashCache, content_hash
from repro_torch.core.network import NetworkModel
from repro_torch.core.policies import EvictionPolicy
from repro_torch.core.router import (DeadlineStats, LatencyBreakdown,
                                     PayloadSizes, TwoTierRouter, pad_rows)
from repro_torch.core.tiers import (TIER_LOCAL, TIER_MISS, TIER_NAMES,
                                    TIER_PEER, TIER_REMOTE, TierLadder,
                                    TierProbeResult, empty_probe_arrays,
                                    org_grid, pack_flat)
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.obs.views import digest_block, ladder_block, org_stats

__all__ = ["CoICConfig", "CoICEngine", "RequestResult", "SOURCE_OF",
           "recognition_cloud_fn", "generation_cloud_fn"]


@dataclasses.dataclass(frozen=True)
class CoICConfig:
    capacity: int = 4096             # per-node when num_nodes > 1
    threshold: float = 0.85
    payload_dim: int = 64
    payload_dtype: str = "float32"
    descriptor: str = "prefix"       # prefix | sketch
    descriptor_dim: int = 256        # sketch dim (prefix uses d_model)
    k_layers: int = 2                # prefix descriptor depth
    policy: EvictionPolicy = EvictionPolicy("lru")
    lookup_impl: str = "auto"
    insert_on_miss: bool = True
    # cooperative cluster tier (core/cluster.py); 1 == single isolated cache
    num_nodes: int = 1
    share: bool = True               # peer tier on local miss
    admission: str = "always"        # always | never | second_hit |
                                     # freq_weighted
    # cross-cluster federation tier (core/federation.py); 1 == one cluster
    num_clusters: int = 1
    federate: bool = True            # remote rung on local+peer miss
    digest_size: int = 128           # top-M hottest keys per cluster digest
    digest_interval: int = 4         # steps between digest refreshes
    digest_quant: str = "fp32"       # fp32 | int8 digest wire format
    digest_refresh: str = "full"     # full | delta (push-on-delta)
    # ANN digest probing (kernels/ivf_pq): "auto" swaps the brute board
    # scan for the two-stage IVF-PQ probe once the board passes
    # digest_ann_min_rows live rows; "ivfpq" forces it, "off" disables
    digest_ann: str = "auto"
    digest_ann_min_rows: int = 4096
    digest_ann_lists: int = 64       # coarse inverted lists
    digest_ann_sub: int = 8          # PQ subspaces (key_dim % sub == 0)
    digest_ann_probe: int = 8        # lists scanned per query


def build_edge_org(c: CoICConfig, cluster_cfg: ClusterConfig, metrics,
                   tracer, device):
    """(cluster, federation) for a CoIC config: a cross-cluster federation
    when ``num_clusters > 1``, else one cooperative cluster; the other is
    None."""
    if c.num_clusters > 1:
        return None, FederatedEdgeTier(FederationConfig(
            num_clusters=c.num_clusters, cluster=cluster_cfg,
            digest_size=c.digest_size, digest_interval=c.digest_interval,
            digest_quant=c.digest_quant, digest_refresh=c.digest_refresh,
            share=c.federate, ann_mode=c.digest_ann,
            ann_min_rows=c.digest_ann_min_rows, ann_lists=c.digest_ann_lists,
            ann_sub=c.digest_ann_sub, ann_probe=c.digest_ann_probe),
            metrics=metrics, tracer=tracer, device=device)
    return CooperativeEdgeCluster(cluster_cfg, metrics=metrics,
                                  tracer=tracer, device=device), None


def wire_membership(membership, cluster, federation) -> None:
    """Attach a ``ClusterMembership`` control plane to an edge org: the
    federation listens itself (tombstones, wipes, pin re-election); a
    single cluster wires node churn straight to its shard masks."""
    if membership is None:
        return
    if federation is not None:
        federation.attach_membership(membership)
        return

    def on_event(ev) -> None:
        if ev.kind == "node_dead":
            cluster.kill_node(ev.node)
        elif ev.kind == "node_alive":
            cluster.revive_node(ev.node)
        elif ev.kind in ("cluster_dead", "cluster_alive"):
            cluster.wipe()
            if ev.kind == "cluster_alive":
                cluster.node_alive[:] = True

    membership.add_listener(on_event)


@dataclasses.dataclass
class RequestResult:
    payload: np.ndarray
    source: str                      # "edge" | "peer" | "remote" | "cloud"
    score: float
    coic: LatencyBreakdown
    origin: LatencyBreakdown


# canonical tier name -> user-facing source label
SOURCE_OF = {"local": "edge", "peer": "peer", "remote": "remote",
             "miss": "cloud"}


@dataclasses.dataclass
class _CloudCtx:
    """Per-batch context the engine ladder threads to ``CloudRung``."""

    tokens: np.ndarray               # (B, S) raw requests
    desc: np.ndarray                 # (B, D) descriptors (edge-cache keys)
    flat_row: np.ndarray             # (K, N, Bp) -> flat row index, -1 pad
    cloud_ms: np.ndarray             # (K, N, Bp) per-request amortized ms


class CloudRung:
    """The terminal ladder tier: computes every remaining row on the cloud
    model and (optionally) inserts the results into the home shard.  Rows
    it serves keep the canonical ``TIER_MISS`` code."""

    name, code = "cloud", TIER_MISS

    def __init__(self, engine: "CoICEngine"):
        self.eng = engine

    def probe(self, queries, mask, ctx: _CloudCtx
              ) -> Optional[TierProbeResult]:
        eng = self.eng
        K, N, B, _ = queries.shape
        kk, nn, bb = np.nonzero(mask)
        flat = ctx.flat_row[kk, nn, bb]
        padded, n_real = pad_rows(ctx.tokens, flat, eng.miss_bucket)
        t0 = time.perf_counter()
        out = _to_numpy(eng.cloud_fn(padded))[:n_real]
        dt = (time.perf_counter() - t0) * 1e3
        eng._timings["cloud_ms"].append(dt)
        eng._timing_hist["cloud_ms"].observe(dt)
        ctx.cloud_ms[kk, nn, bb] = dt / max(1, n_real)

        hit, tier, cluster, owner, score, value = empty_probe_arrays(
            queries, eng.cfg.payload_dim, eng.cfg.payload_dtype)
        value[kk, nn, bb] = out.astype(eng.cfg.payload_dtype)
        if eng.cfg.insert_on_miss:
            for k in range(K):
                for g in range(N):
                    sel = (kk == k) & (nn == g)
                    if sel.any():
                        eng.edge.insert_home(
                            k, g, ctx.desc[flat[sel]],
                            out[sel].astype(eng.cfg.payload_dtype))
        return TierProbeResult(hit=mask.copy(), tier=tier,
                               cluster=cluster, owner=owner, score=score,
                               value=value, dispatches=1)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CoICEngine:
    def __init__(self, model, cfg: CoICConfig,
                 cloud_fn: Callable[[np.ndarray], object],
                 network: Optional[NetworkModel] = None,
                 sizes: Optional[PayloadSizes] = None,
                 miss_bucket: Optional[int] = None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None,
                 membership=None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.cloud_fn = cloud_fn
        self.network = network or NetworkModel()
        self.miss_bucket = miss_bucket
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = tracer if tracer is not None else NULL_TRACER

        if cfg.descriptor == "prefix":
            self._descriptor = PrefixDescriptor(model, k_layers=cfg.k_layers)
            key_dim = model.cfg.d_model
        else:
            self._descriptor = NgramSketchDescriptor(dim=cfg.descriptor_dim)
            key_dim = cfg.descriptor_dim

        self.sizes = sizes or PayloadSizes(
            input_bytes=256 * 1024,                       # a camera frame
            descriptor_bytes=key_dim * 4,
            result_bytes=cfg.payload_dim * 4)
        self.router = TwoTierRouter(self.network, self.sizes)

        cluster_cfg = ClusterConfig(
            num_nodes=cfg.num_nodes, node_capacity=cfg.capacity,
            key_dim=key_dim, payload_dim=cfg.payload_dim,
            threshold=cfg.threshold, payload_dtype=cfg.payload_dtype,
            policy=cfg.policy, lookup_impl=cfg.lookup_impl,
            admission=cfg.admission, share=cfg.share)
        self.cluster, self.federation = build_edge_org(
            cfg, cluster_cfg, self.metrics, self.trace, self.device)
        self.edge = self.federation or self.cluster
        self.cache = (self.federation.clusters[0] if self.federation
                      else self.cluster).cache
        # the serve ladder gets its own registry prefix so its counters
        # (edge-org rung + cloud rung) don't collide with the org ladder's
        self.ladder = TierLadder([self.edge, CloudRung(self)],
                                 metrics=self.metrics,
                                 prefix="engine_ladder", tracer=self.trace)
        # membership control plane (core/membership.py): requests aimed at
        # a dead cluster/node reroute deterministically; the federation
        # tombstones/re-elects on detected deaths.  None == static grid.
        self.membership = membership
        wire_membership(membership, self.cluster, self.federation)
        self.asset_cache = HashCache()
        self.deadline = DeadlineStats(self.metrics)
        self._timings = {"descriptor_ms": [], "lookup_ms": [], "cloud_ms": []}
        self._timing_hist = {k: self.metrics.histogram(f"timings/{k}")
                             for k in self._timings}

    # ------------------------------------------------------------------
    def _descriptors(self, tokens: np.ndarray) -> np.ndarray:
        tr = self.trace
        if tr.enabled:
            tr.begin("descriptor", cat="engine",
                     args={"batch": int(tokens.shape[0])})
        t0 = time.perf_counter()
        d = self._descriptor(torch.as_tensor(tokens, device=self.device))
        d = d.cpu().numpy()                  # waits for the device
        dt = (time.perf_counter() - t0) * 1e3
        if tr.enabled:
            tr.end()
        self._timings["descriptor_ms"].append(dt)
        self._timing_hist["descriptor_ms"].observe(dt)
        return d

    # ------------------------------------------------------------------
    def process_batch(self, tokens: np.ndarray, node_id: int = 0,
                      cluster_id: int = 0,
                      deadline_ms=None) -> List[RequestResult]:
        """tokens: (B, S) int32 request batch arriving at edge ``node_id``
        of cluster ``cluster_id``.  Returns per-request results with CoIC
        and origin-baseline latency breakdowns; ``deadline_ms`` (scalar or
        (B,), None/NaN == bulk) stamps each breakdown and accumulates in
        ``self.deadline``."""
        tokens = np.asarray(tokens)
        B = tokens.shape[0]
        if deadline_ms is None:
            deadlines = [None] * B
        elif np.ndim(deadline_ms) == 0:           # scalar or 0-d array
            d = float(deadline_ms)
            deadlines = [None if np.isnan(d) else d] * B
        else:
            deadlines = [None if d is None or np.isnan(d) else float(d)
                         for d in np.asarray(deadline_ms, object)]
        if self.membership is not None:
            # degraded routing: a dead target remaps to the nearest alive
            # (cluster, node) before packing
            cluster_id, node_id = self.membership.route(cluster_id, node_id)
        desc_np = self._descriptors(tokens)
        per_req_desc_ms = self._timings["descriptor_ms"][-1] / B

        # one ladder walk: edge org (local -> peer -> remote) then cloud
        K, N = org_grid(self.edge)
        queries, mask, rows_of = pack_flat(
            desc_np, [node_id] * B, [cluster_id] * B, K, N)
        flat_row = np.full(mask.shape, -1, np.int64)
        for k, kr in enumerate(rows_of):
            for g, rows in enumerate(kr):
                flat_row[k, g, :len(rows)] = rows
        ctx = _CloudCtx(tokens=tokens, desc=desc_np, flat_row=flat_row,
                        cloud_ms=np.zeros(mask.shape))
        res = self.ladder.probe(queries, mask, ctx, self.cfg.payload_dim,
                                self.cfg.payload_dtype)
        lookup_ms = self.ladder.last_probe_ms.get(self.edge.name, 0.0) / B
        self._timings["lookup_ms"].append(lookup_ms * B)
        self._timing_hist["lookup_ms"].observe(lookup_ms * B)

        # gather back to flat submission order
        kk, nn, bb = np.nonzero(mask)
        order = flat_row[kk, nn, bb]
        tier = np.empty((B,), np.int8)
        score = np.empty((B,), np.float32)
        payloads = np.empty((B, self.cfg.payload_dim),
                            np.dtype(self.cfg.payload_dtype))
        cloud_ms = np.empty((B,))
        tier[order] = res.tier[kk, nn, bb]
        score[order] = res.score[kk, nn, bb]
        payloads[order] = res.value[kk, nn, bb]
        cloud_ms[order] = ctx.cloud_ms[kk, nn, bb]
        edge_hit = tier != TIER_MISS

        # per-tier amortization: the batch shares one descriptor extraction
        # and one probe dispatch; local misses share ONE peer broadcast, and
        # everything escalating past the peer tier shares ONE metro->region
        # digest probe — each request's breakdown carries its share
        n_local_miss = int((tier != TIER_LOCAL).sum())
        peer_on = self.cfg.share and self.cfg.num_nodes > 1
        peer_share_ms = (self.router.peer_broadcast_ms(n_local_miss)
                         if peer_on else 0.0)
        region_on = (self.federation is not None and self.cfg.federate
                     and self.cfg.num_clusters > 1)
        n_escalated = int((tier >= TIER_REMOTE).sum()) if region_on else 0
        region_share_ms = (self.router.region_broadcast_ms(n_escalated)
                           if region_on else 0.0)
        batch_of = {TIER_LOCAL: B, TIER_PEER: max(1, n_local_miss),
                    TIER_REMOTE: max(1, n_escalated), TIER_MISS: B}

        results = []
        for b in range(B):
            t = int(tier[b])
            name = TIER_NAMES[t]
            src = SOURCE_OF[name]
            lat = self.router.tier_latency(
                name, per_req_desc_ms, lookup_ms, batch=batch_of[t],
                peer_net_ms=(peer_share_ms if t >= TIER_REMOTE else 0.0),
                remote_net_ms=(region_share_ms if t == TIER_MISS else 0.0),
                cloud_compute_ms=float(cloud_ms[b]))
            lat.deadline_ms = deadlines[b]
            self.deadline.observe(src, lat.total_ms, deadlines[b])
            origin = self.router.origin_latency(
                float(cloud_ms[b]) if not edge_hit[b]
                else self._mean_cloud_ms())
            results.append(RequestResult(payload=payloads[b], source=src,
                                         score=float(score[b]), coic=lat,
                                         origin=origin))
        return results

    # ------------------------------------------------------------------
    def _mean_cloud_ms(self) -> float:
        t = self._timings["cloud_ms"]
        if not t:
            return 0.0
        return float(np.mean(t)) / max(1, self.miss_bucket or 1)

    def load_asset(self, content, loader_fn: Callable[[], object]):
        """Hash-keyed asset load (3D model / panorama analogue).  Returns
        (value, load_ms, source)."""
        key = "asset:" + content_hash(content)
        cached = self.asset_cache.get(key)
        if cached is not None:
            return cached, 0.0, "edge"
        t0 = time.perf_counter()
        value = loader_fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        load_ms = (time.perf_counter() - t0) * 1e3
        self.asset_cache.put(key, value)
        return value, load_ms, "cloud"

    def stats(self) -> dict:
        s = org_stats(self.federation, self.cluster, self.cache)
        s["ladder"] = ladder_block(self.edge, engine_ladder=self.ladder)
        s["digest"] = digest_block(self.federation)
        s["asset_cache"] = self.asset_cache.stats()
        s["deadline"] = self.deadline.as_dict()
        if self.membership is not None:
            s["membership"] = self.membership.stats()
        return s


# ---------------------------------------------------------------------------
# Cloud executors
# ---------------------------------------------------------------------------


def recognition_cloud_fn(model, num_classes: int):
    """The paper's task: DNN object recognition.  Final-position logits ->
    the first ``num_classes`` (payload), as float32."""

    def fn(tokens):
        t = torch.as_tensor(np.asarray(tokens), device=model.device)
        return model.forward(t)[:, -1, :num_classes].float()

    return fn


def generation_cloud_fn(model, max_new_tokens: int):
    """LM serving task: greedy-decode ``max_new_tokens``; payload is the
    generated token ids (int32)."""

    def fn(tokens):
        t = torch.as_tensor(np.asarray(tokens), device=model.device)
        B, S = t.shape
        logits, cache, lengths = model.prefill(t, max_len=S + max_new_tokens)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache, lengths = model.decode_step(cache, tok, lengths)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1)                    # (B, max_new)

    return fn
