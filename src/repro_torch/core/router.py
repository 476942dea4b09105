"""Two-tier (edge/cloud) request routing — host-side scheduling.

Mobile RPC semantics don't exist inside a jitted program, so the hit/miss
split happens on the host between device steps (the same place a vLLM-class
scheduler lives).  Descriptor extraction and cache lookup are device code;
re-batching misses for the cloud model is host logic.

Latency accounting mirrors the paper's flow:

  CoIC hit : t_desc + M->E(desc) + t_lookup + E->M(result)
  CoIC miss: t_desc + M->E(desc) + t_lookup + M->E(input) + E->C(input)
             + t_cloud + C->E(result) + E->M(result)   [+ edge insert]
  Origin   : M->E(input) + E->C(input) + t_cloud + C->E(result) + E->M(result)

(the origin baseline offloads the complete task to the cloud, no cache.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.network import NetworkModel
from repro_torch.obs.metrics import LazyCounterGroup, MetricsRegistry


@dataclasses.dataclass
class LatencyBreakdown:
    """Per-request latency terms, in ms.

    All components are *per-request amortized*: when a batched engine step
    shares one descriptor extraction, one cluster probe, or one peer
    broadcast across many requests, each request's breakdown carries its
    share of the dispatch and ``amortized_over`` records how many requests
    split it (1 == unbatched, the sequential path).

    ``deadline_ms`` is the request's motion-to-photon budget relative to
    submission (``None``: bulk traffic, no deadline).  ``deadline_miss``
    compares the modeled total against it; callers that also pay queueing
    delay (the serving engine) evaluate the miss against their completion
    time instead and record it through ``DeadlineStats``.
    """

    descriptor_ms: float = 0.0
    uplink_ms: float = 0.0
    lookup_ms: float = 0.0
    peer_net_ms: float = 0.0         # peer tier: descriptor out + result back
    remote_net_ms: float = 0.0       # federation tier: metro<->region hops
    cloud_net_ms: float = 0.0
    cloud_compute_ms: float = 0.0
    downlink_ms: float = 0.0
    amortized_over: int = 1          # requests sharing the batched dispatch
    deadline_ms: Optional[float] = None   # frame budget; None == bulk

    @property
    def total_ms(self) -> float:
        return (self.descriptor_ms + self.uplink_ms + self.lookup_ms
                + self.peer_net_ms + self.remote_net_ms + self.cloud_net_ms
                + self.cloud_compute_ms + self.downlink_ms)

    @property
    def deadline_miss(self) -> Optional[bool]:
        """None for bulk requests; otherwise whether the modeled latency
        alone blows the budget."""
        if self.deadline_ms is None:
            return None
        return self.total_ms > self.deadline_ms


class DeadlineStats:
    """Per-tier deadline bookkeeping for frame-paced (immersive) traffic.

    ``observe`` is called once per completed deadline-bearing request with
    the tier that served it (``edge``/``peer``/``remote``/``cloud``) and the
    request's completion time — queueing delay included, which is what
    distinguishes this from ``LatencyBreakdown.deadline_miss``.  Bulk
    requests (``deadline_ms=None``) are ignored, so ``miss_rate`` is over
    deadline-bearing traffic only.

    Counters live in a ``MetricsRegistry`` under ``<prefix>/met/<tier>`` /
    ``<prefix>/missed/<tier>`` (a private registry when none is plumbed);
    ``met``/``missed`` remain the per-tier dicts of OBSERVED tiers, as the
    seed's dataclass fields were (absent tier == zero, not a 0 entry).
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 prefix: str = "deadline"):
        m = metrics if metrics is not None else MetricsRegistry()
        self._met = LazyCounterGroup(m, f"{prefix}/met")
        self._missed = LazyCounterGroup(m, f"{prefix}/missed")

    @property
    def met(self) -> Dict[str, int]:
        return self._met.as_dict()

    @property
    def missed(self) -> Dict[str, int]:
        return self._missed.as_dict()

    def observe(self, tier: str, completion_ms: float,
                deadline_ms: Optional[float]) -> bool:
        """Record one completion; returns True iff the deadline was missed
        (always False for bulk requests)."""
        if deadline_ms is None:
            return False
        miss = completion_ms > deadline_ms
        (self._missed if miss else self._met).inc(tier)
        return miss

    @property
    def observed(self) -> int:
        return self._met.total() + self._missed.total()

    def miss_rate(self) -> float:
        n = self.observed
        return (sum(self.missed.values()) / n) if n else 0.0

    def as_dict(self) -> dict:
        return {"met": dict(self.met), "missed": dict(self.missed),
                "observed": self.observed, "miss_rate": self.miss_rate()}


@dataclasses.dataclass(frozen=True)
class PayloadSizes:
    """Wire sizes in bytes."""

    input_bytes: int          # the raw request (image / prompt / pano)
    descriptor_bytes: int     # the feature descriptor
    result_bytes: int         # the returned result


class TwoTierRouter:
    """Computes per-request latency for CoIC and the origin baseline."""

    def __init__(self, network: NetworkModel, sizes: PayloadSizes):
        self.net = network
        self.sizes = sizes

    def peer_broadcast_ms(self, n_requests: int) -> float:
        """Per-request share of ONE peer descriptor broadcast carrying
        ``n_requests`` descriptors: the RTT is paid once for the batched
        message, the bytes scale — the batching win on the wire."""
        n = max(1, n_requests)
        return self.net.edge_to_edge_ms(self.sizes.descriptor_bytes * n) / n

    def region_broadcast_ms(self, n_requests: int) -> float:
        """Per-request share of ONE metro->region digest probe carrying
        ``n_requests`` descriptors — the federation tier amortizes the
        region hop over the whole engine step's miss batch the same way the
        peer tier amortizes the LAN broadcast."""
        n = max(1, n_requests)
        return self.net.edge_to_region_ms(self.sizes.descriptor_bytes * n) / n

    def hit_latency(self, descriptor_ms: float, lookup_ms: float,
                    batch: int = 1) -> LatencyBreakdown:
        """``batch``: requests sharing the descriptor-extraction + lookup
        dispatch (``descriptor_ms``/``lookup_ms`` are already per-request
        amortized by the caller)."""
        return LatencyBreakdown(
            descriptor_ms=descriptor_ms,
            uplink_ms=self.net.client_to_edge_ms(self.sizes.descriptor_bytes),
            lookup_ms=lookup_ms,
            downlink_ms=self.net.edge_to_client_ms(self.sizes.result_bytes),
            amortized_over=batch,
        )

    def peer_hit_latency(self, descriptor_ms: float, lookup_ms: float,
                         peer_lookup_ms: float = 0.0,
                         batch: int = 1) -> LatencyBreakdown:
        """Local miss, peer hit: the descriptor is broadcast to the peer
        shards over the edge<->edge link and the winning peer ships the
        result back — no WAN round-trip, no cloud compute.  With ``batch``
        > 1 the broadcast carries the whole miss batch's descriptors and
        each request pays its share (one LAN RTT split ``batch`` ways)."""
        s = self.sizes
        n = max(1, batch)
        return LatencyBreakdown(
            descriptor_ms=descriptor_ms,
            uplink_ms=self.net.client_to_edge_ms(s.descriptor_bytes),
            lookup_ms=lookup_ms + peer_lookup_ms,
            peer_net_ms=(self.net.edge_to_edge_ms(s.descriptor_bytes * n) / n
                         + self.net.edge_to_edge_ms(s.result_bytes * n) / n),
            downlink_ms=self.net.edge_to_client_ms(s.result_bytes),
            amortized_over=n,
        )

    def remote_hit_latency(self, descriptor_ms: float, lookup_ms: float,
                           peer_net_ms: float = 0.0,
                           batch: int = 1) -> LatencyBreakdown:
        """Local + peer miss, remote-cluster hit: the descriptor travels
        metro -> region in the step's ONE batched digest probe and the
        winning cluster ships the payload back region -> metro — still no
        WAN round-trip, no cloud compute.  ``peer_net_ms`` carries the
        (fruitless) within-cluster peer broadcast share the request paid
        before escalating; with ``batch`` > 1 the region hops carry the
        whole miss batch and each request pays its share."""
        s = self.sizes
        n = max(1, batch)
        return LatencyBreakdown(
            descriptor_ms=descriptor_ms,
            uplink_ms=self.net.client_to_edge_ms(s.descriptor_bytes),
            lookup_ms=lookup_ms,
            peer_net_ms=peer_net_ms,
            remote_net_ms=(self.net.edge_to_region_ms(s.descriptor_bytes * n) / n
                           + self.net.region_to_edge_ms(s.result_bytes * n) / n),
            downlink_ms=self.net.edge_to_client_ms(s.result_bytes),
            amortized_over=n,
        )

    def miss_latency(self, descriptor_ms: float, lookup_ms: float,
                     cloud_compute_ms: float,
                     peer_net_ms: float = 0.0,
                     remote_net_ms: float = 0.0,
                     batch: int = 1) -> LatencyBreakdown:
        """``peer_net_ms``: per-request share of the (fruitless) peer
        broadcast a cooperative cluster pays before falling through to the
        cloud (compute it with ``peer_broadcast_ms`` when batching).
        ``remote_net_ms``: likewise for the federation tier's (fruitless)
        metro->region digest probe (``region_broadcast_ms``)."""
        s = self.sizes
        return LatencyBreakdown(
            descriptor_ms=descriptor_ms,
            uplink_ms=(self.net.client_to_edge_ms(s.descriptor_bytes)
                       + self.net.client_to_edge_ms(s.input_bytes)),
            lookup_ms=lookup_ms,
            peer_net_ms=peer_net_ms,
            remote_net_ms=remote_net_ms,
            cloud_net_ms=(self.net.edge_to_cloud_ms(s.input_bytes)
                          + self.net.cloud_to_edge_ms(s.result_bytes)),
            cloud_compute_ms=cloud_compute_ms,
            downlink_ms=self.net.edge_to_client_ms(s.result_bytes),
            amortized_over=batch,
        )

    def digest_ship_ms(self, payload_bytes: float) -> float:
        """Price of shipping a digest refresh metro -> region on the region
        link — the control-plane cost ``core/digest.py`` accounts in bytes
        (``digest_bytes_shipped``); benchmarks report both."""
        return self.net.edge_to_region_ms(payload_bytes)

    def tier_latency(self, tier: str, descriptor_ms: float, lookup_ms: float,
                     *, batch: int = 1, peer_net_ms: float = 0.0,
                     remote_net_ms: float = 0.0,
                     cloud_compute_ms: float = 0.0) -> LatencyBreakdown:
        """The one data-driven entry the engines charge every request
        through: ``tier`` is a canonical ladder tier name
        (``core/tiers.py::TIER_NAMES``; ``edge`` aliases ``local`` and
        ``cloud`` aliases ``miss``).  Replaces the per-engine if/elif
        chains over tier codes — adding a rung means adding a row here, not
        editing every engine."""
        if tier in ("local", "edge"):
            return self.hit_latency(descriptor_ms, lookup_ms, batch=batch)
        if tier == "peer":
            return self.peer_hit_latency(descriptor_ms, lookup_ms,
                                         batch=batch)
        if tier == "remote":
            return self.remote_hit_latency(descriptor_ms, lookup_ms,
                                           peer_net_ms=peer_net_ms,
                                           batch=batch)
        assert tier in ("miss", "cloud"), tier
        return self.miss_latency(descriptor_ms, lookup_ms, cloud_compute_ms,
                                 peer_net_ms=peer_net_ms,
                                 remote_net_ms=remote_net_ms, batch=batch)

    def origin_latency(self, cloud_compute_ms: float) -> LatencyBreakdown:
        s = self.sizes
        return LatencyBreakdown(
            uplink_ms=self.net.client_to_edge_ms(s.input_bytes),
            cloud_net_ms=(self.net.edge_to_cloud_ms(s.input_bytes)
                          + self.net.cloud_to_edge_ms(s.result_bytes)),
            cloud_compute_ms=cloud_compute_ms,
            downlink_ms=self.net.edge_to_client_ms(s.result_bytes),
        )


def pad_rows(arr: np.ndarray, rows: np.ndarray, bucket: Optional[int] = None):
    """Gather ``rows`` and zero-pad the batch dim to ``bucket`` (static shapes
    for jit).  Returns (padded, n_real)."""
    sub = arr[rows]
    n = sub.shape[0]
    if bucket is None or n == bucket:
        return sub, n
    pad = bucket - n
    pad_block = np.zeros((pad,) + sub.shape[1:], sub.dtype)
    return np.concatenate([sub, pad_block], axis=0), n
