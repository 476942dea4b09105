"""Multi-user Zipf workload over a shared scene pool — the traffic shape the
cooperative edge tier is built for.

Each edge node fronts a crowd of users looking at the *same world* (the
paper's "two users seeing the same stop sign"): requests are Zipf-popular
scenes from one global pool, perturbed per view (cos ~ 1 - noise^2*dim/2 of
their scene, far above cross-scene similarity for unit Gaussians at the
dims used here).  Per-node popularity is the global ranking *rotated* by
node, so every node has a different hot head but the heads overlap across
the cluster — node A's tail is node B's head, which is exactly the regime
where peer sharing converts compulsory misses into LAN hits.

The port's own copy of ``repro/data/workload.py`` (numpy only): equal
seeds give equal streams in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _unit_scene_pool(rng: np.random.Generator, pool_size: int, dim: int,
                     payload_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Shared scene-pool construction: unit-norm scene descriptors plus a
    deterministic ground-truth payload per scene (class-logits analogue).
    All workloads draw from the SAME rng call sequence, so seeds stay
    comparable across workload classes."""
    scenes = rng.standard_normal((pool_size, dim)).astype(np.float32)
    scenes /= np.linalg.norm(scenes, axis=1, keepdims=True)
    payloads = rng.standard_normal((pool_size, payload_dim)).astype(np.float32)
    return scenes, payloads


def _rotated_zipf(pool_size: int, zipf_s: float, groups: int,
                  rotate: bool = True) -> np.ndarray:
    """(groups, pool_size) Zipf(s) popularity rows, the ranking rotated per
    group so every group has a different hot head but the heads overlap —
    group A's tail is group B's head, the regime where sharing converts
    compulsory misses into peer/remote hits."""
    ranks = np.arange(1, pool_size + 1, dtype=np.float64)
    base = ranks ** (-zipf_s)
    probs = np.stack([
        np.roll(base, (g * pool_size) // groups if rotate else 0)
        for g in range(groups)])
    return probs / probs.sum(axis=1, keepdims=True)


def _migrate_users(current: np.ndarray, num_clusters: int, mobility: float,
                   rng: np.random.Generator) -> int:
    """One mobility tick shared by the roaming workloads: each user moves
    to a uniformly-random OTHER cluster with probability ``mobility``
    (``current`` is mutated in place).  Returns the number of movers."""
    if num_clusters < 2 or mobility <= 0.0:
        return 0
    movers = rng.random(len(current)) < mobility
    if not movers.any():
        return 0
    hops = rng.integers(1, num_clusters, size=int(movers.sum()))
    current[movers] = (current[movers] + hops) % num_clusters
    return int(movers.sum())


@dataclasses.dataclass
class ZipfWorkload:
    """Generator of (node, scene_ids, descriptors) request batches."""

    num_nodes: int = 4
    pool_size: int = 96
    dim: int = 128
    payload_dim: int = 8
    zipf_s: float = 1.1
    noise: float = 0.02
    rotate_popularity: bool = True   # per-node rotated Zipf heads
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.scenes, self.payloads = _unit_scene_pool(
            rng, self.pool_size, self.dim, self.payload_dim)
        self._probs = _rotated_zipf(self.pool_size, self.zipf_s,
                                    self.num_nodes, self.rotate_popularity)

    # ------------------------------------------------------------------
    def sample(self, rng: np.random.Generator, node: int, batch: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """One batch for ``node``: (scene_ids (B,), descriptors (B, dim))."""
        ids = rng.choice(self.pool_size, size=batch, p=self._probs[node])
        desc = (self.scenes[ids]
                + self.noise * rng.standard_normal(
                    (batch, self.dim)).astype(np.float32))
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        return ids, desc.astype(np.float32)

    def stream(self, steps: int, batch: int, seed: int = 1
               ) -> Iterator[List[Tuple[int, np.ndarray, np.ndarray]]]:
        """Yields ``steps`` rounds; each round is one batch per node."""
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            yield [(n, *self.sample(rng, n, batch))
                   for n in range(self.num_nodes)]

    # ------------------------------------------------------------------
    def token_prompts(self, vocab_size: int, prompt_len: int) -> np.ndarray:
        """(pool_size, prompt_len) int32 — one deterministic token prompt
        per scene, for driving the serving engine with this workload (the
        scene id is the request content; the engine's descriptor replaces
        ``self.scenes``)."""
        rng = np.random.default_rng(self.seed + 0x9E3779B9)
        return rng.integers(0, vocab_size, size=(self.pool_size, prompt_len)
                            ).astype(np.int32)

    def stream_ids(self, steps: int, batch: int, seed: int = 1
                   ) -> Iterator[List[Tuple[int, np.ndarray]]]:
        """Like ``stream`` but scene ids only (no descriptors) — for
        engine-level benchmarks that derive their own descriptors from
        token prompts.  Same node/id sequence as ``stream`` under the same
        seed."""
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            round_ = []
            for n in range(self.num_nodes):
                ids, _ = self.sample(rng, n, batch)
                round_.append((n, ids))
            yield round_


@dataclasses.dataclass
class RoamingWorkload:
    """Roaming multi-cluster Zipf workload — the traffic shape the
    cross-cluster federation tier is built for.

    Each user belongs to a *home* metro cluster whose rotated-Zipf head
    defines their interests (the scenes of the world they inhabit).  Every
    step, each user migrates to a uniformly-random OTHER cluster with
    probability ``mobility`` — but keeps requesting from their home-cluster
    distribution, so a migrated user shifts the visited cluster's effective
    popularity toward a head that is cached back home.  At ``mobility=0``
    clusters are self-contained (within-cluster sharing suffices); at
    ``mobility>0`` an increasing share of each cluster's traffic is
    compulsory-miss locally but warm in a remote cluster — exactly the
    redundancy the digest-probe remote rung converts into region-hop hits.
    """

    num_clusters: int = 3
    nodes_per_cluster: int = 2
    users_per_node: int = 8
    pool_size: int = 96
    dim: int = 128
    payload_dim: int = 8
    zipf_s: float = 1.1
    noise: float = 0.02
    mobility: float = 0.1            # per-step cluster-migration probability
    seed: int = 0

    def __post_init__(self):
        assert 0.0 <= self.mobility <= 1.0, self.mobility
        rng = np.random.default_rng(self.seed)
        self.scenes, self.payloads = _unit_scene_pool(
            rng, self.pool_size, self.dim, self.payload_dim)
        # per-HOME-cluster rotated heads: cluster A's tail is cluster B's
        # head, so roamers carry demand for remotely-cached scenes
        self._probs = _rotated_zipf(self.pool_size, self.zipf_s,
                                    self.num_clusters)
        n_users = (self.num_clusters * self.nodes_per_cluster
                   * self.users_per_node)
        self.home = np.repeat(np.arange(self.num_clusters),
                              self.nodes_per_cluster * self.users_per_node)
        self.current = self.home.copy()                  # everyone starts home
        self._n_users = n_users

    # ------------------------------------------------------------------
    def migrate(self, rng: np.random.Generator) -> int:
        """One mobility tick: each user moves to a random other cluster
        with probability ``mobility``.  Returns the number of movers."""
        return _migrate_users(self.current, self.num_clusters, self.mobility,
                              rng)

    # ------------------------------------------------------------------
    def step_requests(self, rng: np.random.Generator
                      ) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
        """One request round AFTER migration: every user issues one request
        from their HOME distribution at their CURRENT cluster.  Users at a
        cluster are spread over its nodes round-robin.  Returns a list of
        (cluster, node, scene_ids (B,), descriptors (B, dim)) batches."""
        batches = []
        for k in range(self.num_clusters):
            users = np.nonzero(self.current == k)[0]
            if not users.size:
                continue
            ids = np.concatenate([
                rng.choice(self.pool_size, size=1, p=self._probs[self.home[u]])
                for u in users])
            desc = (self.scenes[ids]
                    + self.noise * rng.standard_normal(
                        (len(ids), self.dim)).astype(np.float32))
            desc /= np.linalg.norm(desc, axis=1, keepdims=True)
            for node in range(self.nodes_per_cluster):
                sel = np.arange(len(users)) % self.nodes_per_cluster == node
                if sel.any():
                    batches.append((k, node, ids[sel],
                                    desc[sel].astype(np.float32)))
        return batches

    def stream(self, steps: int, seed: int = 1
               ) -> Iterator[List[Tuple[int, int, np.ndarray, np.ndarray]]]:
        """Yields ``steps`` rounds of (cluster, node, ids, descriptors)
        batches, with one migration tick before each round."""
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            self.migrate(rng)
            yield self.step_requests(rng)


@dataclasses.dataclass
class SharedPrefixWorkload:
    """Token-level multi-user workload with shared prompt HEADS — the
    traffic shape paged prefix sharing is built for.

    Co-located AR users ground their requests in the same scene context
    (eCAR: one physical space, many headsets), so at the token level their
    prompts share a long session prefix — the serialized scene/context
    block — followed by a short per-request suffix (the user's own query).
    Sessions are Zipf-popular: a hot session's prefix KV is admitted once
    and then MAPPED by every follow-up request (``PagedKVCache``), so the
    cacheable fraction of prefill compute is roughly
    ``prefix_len / (prefix_len + E[suffix])`` times the repeat rate.

    Prompts are deterministic in ``seed``; the request stream in the
    ``stream``'s own seed — same split as the other workloads here.
    """

    num_sessions: int = 8
    prefix_len: int = 64             # shared head tokens per session
    suffix_min: int = 4              # per-request private tail (inclusive)
    suffix_max: int = 24
    vocab_size: int = 256
    zipf_s: float = 1.1
    seed: int = 0

    def __post_init__(self):
        assert 1 <= self.suffix_min <= self.suffix_max
        rng = np.random.default_rng(self.seed)
        self.prefixes = rng.integers(
            0, self.vocab_size,
            size=(self.num_sessions, self.prefix_len)).astype(np.int32)
        self._probs = _rotated_zipf(self.num_sessions, self.zipf_s, 1)[0]

    # ------------------------------------------------------------------
    def sample(self, rng: np.random.Generator) -> Tuple[int, np.ndarray]:
        """One request: (session id, prompt (prefix_len + suffix,) int32)."""
        sess = int(rng.choice(self.num_sessions, p=self._probs))
        n = int(rng.integers(self.suffix_min, self.suffix_max + 1))
        suffix = rng.integers(0, self.vocab_size, size=(n,)).astype(np.int32)
        return sess, np.concatenate([self.prefixes[sess], suffix])

    def stream(self, n_requests: int, seed: int = 1
               ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yields ``n_requests`` (session, prompt) pairs."""
        rng = np.random.default_rng(seed)
        for _ in range(n_requests):
            yield self.sample(rng)


@dataclasses.dataclass(frozen=True)
class FrameRequest:
    """One request of a frame-paced stream round.

    ``deadline_ms`` is the motion-to-photon budget relative to emission
    (``None`` for background bulk traffic); ``bulk`` requests carry long
    prompts in engine-level benchmarks (the chunked-prefill stressor)."""

    cluster: int
    node: int
    user: int
    scene: int
    deadline_ms: Optional[float]
    priority: int
    bulk: bool


@dataclasses.dataclass
class FramePacedWorkload:
    """Frame-paced immersive streams mixed with background bulk traffic —
    the traffic shape deadline-aware scheduling is built for.

    Each *frame user* renders at a fixed FPS (drawn round-robin from
    ``fps_choices``): every ``1000/fps`` ms of simulated time (advanced
    ``step_ms`` per engine step, with per-user phase offsets so frames
    don't all land on the same step) they emit one recognition request
    whose deadline is ``deadline_frames`` frame intervals — the
    motion-to-photon budget of an AR/VR overlay.  Each *bulk user* emits a
    request with probability ``bulk_rate`` per step, with no deadline —
    the batch-analytics traffic that causes head-of-line blocking under
    FIFO admission.

    Scenes are Zipf-popular from one pool with per-home-cluster rotated
    heads (the ``RoamingWorkload`` regime); users optionally roam between
    clusters at ``mobility`` per step, so the stream exercises the full
    local -> peer -> remote-cluster -> cloud ladder.  Bulk users draw from
    the same pool but a flattened (less cacheable) distribution.
    """

    num_clusters: int = 1
    nodes_per_cluster: int = 2
    frame_users_per_node: int = 4
    fps_choices: Tuple[int, ...] = (30, 60)
    deadline_frames: float = 1.0     # budget = deadline_frames / fps
    bulk_users_per_node: int = 2
    bulk_rate: float = 0.5           # per-step per-bulk-user emission prob
    step_ms: float = 2.0             # simulated wall time of one engine step
    pool_size: int = 96
    dim: int = 128
    payload_dim: int = 8
    zipf_s: float = 1.1
    bulk_zipf_s: float = 0.4         # flatter: bulk traffic caches poorly
    noise: float = 0.02
    mobility: float = 0.0            # per-step cluster-migration probability
    seed: int = 0

    def __post_init__(self):
        assert 0.0 <= self.mobility <= 1.0, self.mobility
        assert self.step_ms > 0, self.step_ms
        rng = np.random.default_rng(self.seed)
        self.scenes, self.payloads = _unit_scene_pool(
            rng, self.pool_size, self.dim, self.payload_dim)
        self._probs = _rotated_zipf(self.pool_size, self.zipf_s,
                                    self.num_clusters)
        self._bulk_probs = _rotated_zipf(self.pool_size, self.bulk_zipf_s,
                                         1)[0]

        per_node = self.frame_users_per_node + self.bulk_users_per_node
        n_users = self.num_clusters * self.nodes_per_cluster * per_node
        self._n_users = n_users
        self.home = np.repeat(np.arange(self.num_clusters),
                              self.nodes_per_cluster * per_node)
        self.current = self.home.copy()
        self.node_of = np.tile(np.repeat(np.arange(self.nodes_per_cluster),
                                         per_node), self.num_clusters)
        # within each node: first frame_users_per_node are frame-paced
        within = np.tile(np.arange(per_node),
                         self.num_clusters * self.nodes_per_cluster)
        self.is_frame = within < self.frame_users_per_node
        fps = np.zeros((n_users,), np.float64)
        fps[self.is_frame] = [
            self.fps_choices[i % len(self.fps_choices)]
            for i in range(int(self.is_frame.sum()))]
        self.fps = fps
        # phase-offset accumulators: user u's next frame is due when
        # _acc[u] >= 1000/fps[u]; staggered starts avoid lockstep emission
        self._acc = np.zeros((n_users,), np.float64)
        with np.errstate(divide="ignore"):
            interval = np.where(self.is_frame, 1000.0 / np.maximum(fps, 1e-9),
                                np.inf)
        self._interval = interval
        self._acc[self.is_frame] = (
            rng.random(int(self.is_frame.sum())) * interval[self.is_frame])

    # ------------------------------------------------------------------
    def migrate(self, rng: np.random.Generator) -> int:
        """One mobility tick (see ``RoamingWorkload.migrate``)."""
        return _migrate_users(self.current, self.num_clusters, self.mobility,
                              rng)

    # ------------------------------------------------------------------
    def step_requests(self, rng: np.random.Generator) -> List[FrameRequest]:
        """Advance simulated time by ``step_ms`` and emit this step's
        requests, frame streams first within a (cluster, node) — FIFO
        admission therefore sees bulk arrivals from PREVIOUS steps ahead
        of this step's frames, which is exactly the head-of-line blocking
        EDF removes."""
        out: List[FrameRequest] = []
        self._acc[self.is_frame] += self.step_ms
        for u in range(self._n_users):
            k = int(self.current[u])
            node = int(self.node_of[u])
            if self.is_frame[u]:
                while self._acc[u] >= self._interval[u]:
                    self._acc[u] -= self._interval[u]
                    scene = int(rng.choice(self.pool_size,
                                           p=self._probs[self.home[u]]))
                    out.append(FrameRequest(
                        cluster=k, node=node, user=u, scene=scene,
                        deadline_ms=self.deadline_frames * self._interval[u],
                        priority=1, bulk=False))
            elif rng.random() < self.bulk_rate:
                scene = int(rng.choice(self.pool_size, p=self._bulk_probs))
                out.append(FrameRequest(
                    cluster=k, node=node, user=u, scene=scene,
                    deadline_ms=None, priority=0, bulk=True))
        return out

    def stream(self, steps: int, seed: int = 1
               ) -> Iterator[List[FrameRequest]]:
        """Yields ``steps`` rounds of requests, one migration tick before
        each round."""
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            self.migrate(rng)
            yield self.step_requests(rng)

    # ------------------------------------------------------------------
    def descriptor(self, rng: np.random.Generator, scene: int) -> np.ndarray:
        """One noisy unit-norm view descriptor of ``scene`` (tier-level
        driving; engine-level benchmarks derive their own from prompts)."""
        d = (self.scenes[scene]
             + self.noise * rng.standard_normal(self.dim).astype(np.float32))
        return (d / np.linalg.norm(d)).astype(np.float32)

    def token_prompts(self, vocab_size: int, frame_len: int, bulk_len: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic token prompts per scene for engine-level driving:
        (frame (pool, frame_len), bulk (pool, bulk_len)) int32.  Bulk
        prompts are long — the chunked-prefill stressor."""
        rng = np.random.default_rng(self.seed + 0x9E3779B9)
        frame = rng.integers(0, vocab_size,
                             size=(self.pool_size, frame_len))
        bulk = rng.integers(0, vocab_size, size=(self.pool_size, bulk_len))
        return frame.astype(np.int32), bulk.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled membership mutation."""

    kind: str                        # kill_cluster | revive_cluster |
                                     # kill_node | revive_node
    cluster: int
    node: int = -1                   # -1 for cluster-level events
    step: int = 0


@dataclasses.dataclass
class ChaosSchedule:
    """Seeded chaos schedule: kill or revive a random cluster or node every
    ``every`` steps — the churn source behind ``tests/test_chaos.py`` and
    ``benchmarks/churn.py``.

    The whole event list is PRE-DRAWN at construction against the
    schedule's own simulated liveness masks, so a schedule is a pure
    function of its parameters: two runs with the same seed inject
    byte-identical churn whatever the system under test does.  Invariants
    the draw enforces: the last alive cluster is never killed (the
    federation must always have somewhere to route), and a node kill never
    takes a cluster's last alive node (cluster-level death is exercised by
    the explicit cluster kills, not by attrition surprise).

    ``apply(membership, step)`` replays the step's events onto a
    ``core/membership.py::ClusterMembership`` (``announce=False`` models
    silent crashes detected by heartbeat sweep instead of graceful
    leaves).
    """

    num_clusters: int
    nodes_per_cluster: int = 1
    every: int = 4                   # steps between chaos actions
    steps: int = 64                  # horizon to pre-draw events for
    node_prob: float = 0.0           # P(action targets a node, not a cluster)
    revive_prob: float = 0.5         # P(prefer reviving when something is dead)
    announce: bool = True            # graceful leave vs silent crash
    seed: int = 0

    def __post_init__(self):
        assert self.num_clusters >= 1 and self.nodes_per_cluster >= 1
        assert self.every >= 1, self.every
        assert 0.0 <= self.node_prob <= 1.0, self.node_prob
        rng = np.random.default_rng(self.seed)
        K, N = self.num_clusters, self.nodes_per_cluster
        alive_c = np.ones((K,), bool)
        alive_n = np.ones((K, N), bool)
        self.events: List[ChaosEvent] = []
        for step in range(self.every, self.steps + 1, self.every):
            ev = self._draw(rng, alive_c, alive_n, step)
            if ev is None:
                continue
            self.events.append(ev)
            if ev.kind == "kill_cluster":
                alive_c[ev.cluster] = False
            elif ev.kind == "revive_cluster":
                alive_c[ev.cluster] = True
                alive_n[ev.cluster] = True
            elif ev.kind == "kill_node":
                alive_n[ev.cluster, ev.node] = False
            else:
                alive_n[ev.cluster, ev.node] = True
        self.by_step = {}
        for ev in self.events:
            self.by_step.setdefault(ev.step, []).append(ev)

    # ------------------------------------------------------------------
    def _draw(self, rng, alive_c, alive_n, step):
        K, N = self.num_clusters, self.nodes_per_cluster
        if rng.random() < self.node_prob and N > 1:
            dead = [(k, g) for k in range(K) if alive_c[k]
                    for g in np.nonzero(~alive_n[k])[0]]
            if dead and rng.random() < self.revive_prob:
                k, g = dead[int(rng.integers(len(dead)))]
                return ChaosEvent("revive_node", k, int(g), step)
            # only nodes whose cluster keeps >= 1 alive node afterwards
            cand = [(k, g) for k in range(K)
                    if alive_c[k] and alive_n[k].sum() > 1
                    for g in np.nonzero(alive_n[k])[0]]
            if cand:
                k, g = cand[int(rng.integers(len(cand)))]
                return ChaosEvent("kill_node", k, int(g), step)
            return None
        dead = np.nonzero(~alive_c)[0]
        if dead.size and rng.random() < self.revive_prob:
            return ChaosEvent("revive_cluster", int(rng.choice(dead)),
                              step=step)
        cand = np.nonzero(alive_c)[0]
        if cand.size > 1:                # never kill the last alive cluster
            return ChaosEvent("kill_cluster", int(rng.choice(cand)),
                              step=step)
        return None

    # ------------------------------------------------------------------
    @property
    def touched_clusters(self) -> set:
        """Clusters any event ever touched — requests homed elsewhere are
        the "unaffected" set the bit-identity chaos assertion compares."""
        return {ev.cluster for ev in self.events}

    def apply(self, membership, step: int) -> List[ChaosEvent]:
        """Replay this step's events onto ``membership``; returns them."""
        evs = self.by_step.get(step, [])
        for ev in evs:
            if ev.kind == "kill_cluster":
                membership.kill_cluster(ev.cluster, announce=self.announce)
            elif ev.kind == "revive_cluster":
                membership.revive_cluster(ev.cluster)
            elif ev.kind == "kill_node":
                membership.kill_node(ev.cluster, ev.node,
                                     announce=self.announce)
            else:
                membership.revive_node(ev.cluster, ev.node)
        return list(evs)
