"""Elastic membership control plane — cluster/node liveness under churn.
The port of ``repro/core/membership.py`` (host-side, unchanged).

Production edge federations churn: a node crashes, a whole metro site
drops, a pinned authoritative copy vanishes mid-serve.  This module owns
the GROUND TRUTH of who is alive and the DETECTION machinery that turns
silence into membership events, shared by the serving stack
(``core/federation.py`` / the engines) and the trainer
(``train/elastic.py`` re-exports ``HeartbeatMonitor`` /
``SimulatedFailure`` from here — extracted so the serving control plane
never drags trainer deps).

Failure semantics, stated once:

* **Death is instantaneous; detection is not.**  ``kill_cluster`` /
  ``kill_node`` flip ground truth immediately (the machine is off — a
  probe gets no response), but listeners fire only when the death is
  *detected*: immediately for an announced kill (graceful leave), or at
  the next ``sweep()`` after the heartbeat timeout for a silent crash.
  In the window between death and detection the region digest board
  still advertises the dead cluster — the federation's remote rung
  checks ground truth at serve time, counts the refused serve as
  ``remote_dead``, and falls through to the cloud.  A dead copy is never
  served (lost-not-phantom), and nothing raises.

* **Detection tombstones and re-elects.**  On detection the federation
  listener zeroes the dead cluster's digest rows on the
  ``RegionDigestBoard`` (they stop attracting probes), wipes its shard
  states (crash == cache contents lost; revival starts cold), resets its
  ``DigestPublisher`` delta memory (the next publish ships a full
  frame), and re-runs the ``region_pin`` election over the survivors —
  pins held at the dead cluster are released and the next-hottest
  advertiser (lowest-id alive hot holder) pins instead.

* **Routing is deterministic.**  ``route`` remaps a request targeting a
  dead cluster/node to the nearest alive one by upward id scan — the
  same inputs under the same liveness always route the same way, which
  is what makes the chaos tests' "bit-identical tokens for unaffected
  requests" assertion meaningful.

Every mutation is counted under ``membership/`` in the shared
``MetricsRegistry`` and emitted as an ``instant`` chaos-event span on the
tracer, so a Chrome trace of a churn run shows kill/revive markers on
the engine track.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER

__all__ = ["SimulatedFailure", "HeartbeatMonitor", "MembershipEvent",
           "ClusterMembership"]


class SimulatedFailure(Exception):
    """Injected node failure (tests/trainer): the job must continue on
    ``surviving_data_shards`` shards."""

    def __init__(self, surviving_data_shards: int):
        self.surviving_data_shards = surviving_data_shards
        super().__init__(
            f"node failure: {surviving_data_shards} data shards survive")


class HeartbeatMonitor:
    """Declares hosts dead after ``timeout_s`` of silence.

    Time is ``time.monotonic()`` by default; every method takes an
    explicit ``at``/``now`` so tests and paced simulations drive a
    logical clock instead."""

    def __init__(self, hosts: List[str], timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        now = time.monotonic()
        self.last: Dict[str, float] = {h: now for h in hosts}

    def beat(self, host: str, at: Optional[float] = None) -> None:
        self.last[host] = time.monotonic() if at is None else at

    def dead(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last.items() if now - t > self.timeout_s]

    def alive(self, now: Optional[float] = None) -> List[str]:
        dead = set(self.dead(now))
        return [h for h in self.last if h not in dead]


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One detected membership change, delivered to listeners in order."""

    kind: str                        # cluster_dead | cluster_alive |
                                     # node_dead | node_alive
    cluster: int
    node: int = -1                   # -1 for cluster-level events
    step: int = 0                    # caller's logical step at detection


def _host(cluster: int, node: int = -1) -> str:
    return f"c{cluster}" if node < 0 else f"c{cluster}/n{node}"


class ClusterMembership:
    """Ground-truth liveness + heartbeat detection for a fixed
    (K clusters x N nodes) federation grid.

    The grid itself is static (tensor shapes never change); membership is
    mask-based: a dead cluster/node stays addressable but unroutable, and
    its cache contents are lost on detection.  ``join``/``leave`` are
    ``revive_*``/``kill_*`` with announce=True (graceful, detected
    immediately); a crash is ``kill_*`` with announce=False — ground truth
    flips now, listeners fire at the ``sweep()`` after ``timeout_s`` of
    heartbeat silence.
    """

    def __init__(self, num_clusters: int, nodes_per_cluster: int = 1,
                 timeout_s: float = 2.0,
                 metrics: Optional[MetricsRegistry] = None, tracer=None):
        assert num_clusters >= 1 and nodes_per_cluster >= 1
        self.num_clusters = num_clusters
        self.nodes_per_cluster = nodes_per_cluster
        self.cluster_alive = np.ones((num_clusters,), bool)
        self.node_alive = np.ones((num_clusters, nodes_per_cluster), bool)
        # detected liveness lags ground truth by the detection window
        self.detected_alive = self.cluster_alive.copy()
        self.monitor = HeartbeatMonitor(
            [_host(k) for k in range(num_clusters)], timeout_s=timeout_s)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = tracer if tracer is not None else NULL_TRACER
        m = self.metrics
        self._kills = m.counter("membership/cluster_kills")
        self._revives = m.counter("membership/cluster_revives")
        self._node_kills = m.counter("membership/node_kills")
        self._node_revives = m.counter("membership/node_revives")
        self._expiries = m.counter("membership/heartbeat_expiries")
        self._rerouted = m.counter("membership/requests_rerouted")
        self._alive_clusters = m.gauge("membership/alive_clusters")
        self._alive_nodes = m.gauge("membership/alive_nodes")
        self._alive_clusters.set(num_clusters)
        self._alive_nodes.set(num_clusters * nodes_per_cluster)
        self.events: List[MembershipEvent] = []
        self._listeners: List[Callable[[MembershipEvent], None]] = []
        self.step = 0                # caller-advanced logical step

    # ------------------------------------------------------------------
    def add_listener(self, fn: Callable[[MembershipEvent], None]) -> None:
        self._listeners.append(fn)

    def _emit(self, ev: MembershipEvent) -> None:
        self.events.append(ev)
        self._alive_clusters.set(int(self.alive_clusters().sum()))
        self._alive_nodes.set(int((self.node_alive
                                   & self.cluster_alive[:, None]).sum()))
        if self.trace.enabled:
            self.trace.instant(f"membership:{ev.kind}", cat="membership",
                               args={"cluster": ev.cluster, "node": ev.node,
                                     "step": ev.step})
        for fn in self._listeners:
            fn(ev)

    # ------------------------------------------------------------------
    # liveness views
    def alive_clusters(self) -> np.ndarray:
        """(K,) ground-truth mask: a cluster with every node dead is as
        dead as an explicitly killed one."""
        return self.cluster_alive & self.node_alive.any(axis=1)

    def is_alive(self, cluster: int, node: int = -1) -> bool:
        if not self.alive_clusters()[cluster]:
            return False
        return True if node < 0 else bool(self.node_alive[cluster, node])

    # ------------------------------------------------------------------
    # kills / revives (join == revive, leave == announced kill)
    def kill_cluster(self, cluster: int, announce: bool = True,
                     now: Optional[float] = None) -> bool:
        """Flip ground truth dead.  ``announce=True`` (graceful leave)
        notifies listeners now; ``announce=False`` (crash) leaves
        detection to the heartbeat sweep.  Idempotent: killing a dead
        cluster is a no-op returning False."""
        if not self.cluster_alive[cluster]:
            return False
        self.cluster_alive[cluster] = False
        # a dead host stops beating: pin its last beat far enough back
        # that any future sweep sees it expired
        t = time.monotonic() if now is None else now
        self.monitor.beat(_host(cluster), at=t - 2 * self.monitor.timeout_s)
        self._kills.inc()
        if announce:
            self._detect_cluster_death(cluster)
        return True

    def revive_cluster(self, cluster: int, now: Optional[float] = None
                       ) -> bool:
        """Bring a dead cluster back (cold — its cache died with it).
        All its nodes revive with it.  Idempotent."""
        if self.cluster_alive[cluster]:
            return False
        self.cluster_alive[cluster] = True
        self.node_alive[cluster, :] = True
        self.detected_alive[cluster] = True
        self.monitor.beat(_host(cluster), at=now)
        self._revives.inc()
        self._emit(MembershipEvent("cluster_alive", cluster, step=self.step))
        return True

    def kill_node(self, cluster: int, node: int, announce: bool = True
                  ) -> bool:
        """One node's shard dies (entries lost).  Idempotent."""
        if not self.node_alive[cluster, node]:
            return False
        was_cluster_alive = bool(self.alive_clusters()[cluster])
        self.node_alive[cluster, node] = False
        self._node_kills.inc()
        if announce:
            self._emit(MembershipEvent("node_dead", cluster, node,
                                       step=self.step))
            if was_cluster_alive and not self.alive_clusters()[cluster]:
                # last node down takes the whole cluster with it
                self._detect_cluster_death(cluster)
        return True

    def revive_node(self, cluster: int, node: int) -> bool:
        if self.node_alive[cluster, node]:
            return False
        self.node_alive[cluster, node] = True
        self._node_revives.inc()
        self._emit(MembershipEvent("node_alive", cluster, node,
                                   step=self.step))
        if self.cluster_alive[cluster] and not self.detected_alive[cluster]:
            # first node back re-animates a cluster that died by attrition
            self.detected_alive[cluster] = True
            self.monitor.beat(_host(cluster))
            self._emit(MembershipEvent("cluster_alive", cluster,
                                       step=self.step))
        return True

    # ------------------------------------------------------------------
    # heartbeat detection
    def beat(self, cluster: int, at: Optional[float] = None) -> None:
        """One liveness heartbeat from a cluster's control agent.  Dead
        clusters don't beat (their agent is off) — ignored if ground
        truth says dead, so a sweep still expires them."""
        if self.cluster_alive[cluster]:
            self.monitor.beat(_host(cluster), at=at)

    def sweep(self, now: Optional[float] = None) -> List[int]:
        """Detect silent deaths: every cluster whose heartbeat expired and
        whose death hasn't been announced yet fires its listeners now.
        Returns the newly-detected cluster ids."""
        detected = []
        for h in self.monitor.dead(now):
            k = int(h[1:])
            if self.detected_alive[k]:
                # an expired heartbeat IS death as far as the control
                # plane can tell — a partitioned-but-running cluster is
                # treated exactly like a crashed one (it can rejoin via
                # revive_cluster, cold)
                self.cluster_alive[k] = False
                self._expiries.inc()
                self._detect_cluster_death(k)
                detected.append(k)
        return detected

    def _detect_cluster_death(self, cluster: int) -> None:
        if not self.detected_alive[cluster]:
            return                    # double-kill: already tombstoned
        self.detected_alive[cluster] = False
        self._emit(MembershipEvent("cluster_dead", cluster, step=self.step))

    # ------------------------------------------------------------------
    # deterministic degraded routing
    def route(self, cluster: int, node: int = 0) -> Tuple[int, int]:
        """Remap a request target to an alive (cluster, node) by upward id
        scan — deterministic under fixed liveness, so two runs that kill
        the same clusters route the same requests the same way.  With no
        cluster alive the target is returned unchanged (every request
        then misses to the cloud against wiped state — degraded, never
        raising)."""
        alive = self.alive_clusters()
        if not alive.any():
            return cluster, node
        K = self.num_clusters
        if not alive[cluster]:
            for i in range(1, K + 1):
                c = (cluster + i) % K
                if alive[c]:
                    self._rerouted.inc()
                    cluster = c
                    break
        N = self.nodes_per_cluster
        if not self.node_alive[cluster, node]:
            for i in range(1, N + 1):
                g = (node + i) % N
                if self.node_alive[cluster, g]:
                    self._rerouted.inc()
                    node = g
                    break
        return cluster, node

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "alive_clusters": int(self.alive_clusters().sum()),
            "alive_nodes": int((self.node_alive
                                & self.cluster_alive[:, None]).sum()),
            "cluster_kills": self._kills.value,
            "cluster_revives": self._revives.value,
            "node_kills": self._node_kills.value,
            "node_revives": self._node_revives.value,
            "heartbeat_expiries": self._expiries.value,
            "requests_rerouted": self._rerouted.value,
            "events": len(self.events),
        }
