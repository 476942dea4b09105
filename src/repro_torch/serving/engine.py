"""Batched serving engine with continuous batching and the CoIC edge cache
in front of the model — the port of ``repro/serving/engine.py``.

Request lifecycle (one lookup ladder per engine STEP, not per request):

  submit  -> enqueue only (no device work); optional ``priority`` and
             frame ``deadline_ms``
  step:
    schedule — drain pending requests into ONE descriptor extraction over
               length-bucketed prompt pads and ONE grouped lookup
               (``route_flat``): a hit returns at once, charged the modeled
               network + probe latency; a miss joins the admission queue
    admit    — EDF (or FIFO) order.  Slotted cache (``kv_page == 0``):
               queued requests with free slots prefill in ONE bucketed
               (pow2 batch, pow2 length) ``prefill`` call per step — for a
               sliding-window or recurrent model only an equal-length
               front run, at its exact length, since a ring rotates by the
               padded length and a recurrent state absorbs the pads —
               and prompts longer than ``prefill_chunk`` reserve a slot and
               trickle one ``prefill_chunk`` call per step (linear caches
               only).  Paged cache (``kv_page > 0``): every queued request
               with a free slot maps its index-resident prompt-prefix pages
               (cross-user KV sharing) and joins the chunking set; ONE
               batched ``prefill_chunk`` call advances every mid-prefill row
    decode   — one ``decode_step`` over the whole batch; in the paged pool
               idle and mid-prefill rows ride it with an all-INVALID table
               row
    retire   — ``max_new_tokens`` / EOS -> result + insert of the
               schedule-time descriptor into the edge cache

The model runs eagerly: where the reference jitted its prefill and decode
with donated caches, the port calls the model, which writes the cache in
place; ``engine/dispatches/*`` still counts one per call, so the per-step
ladder bound (``max_step_ladder <= 2``) stays checkable.

The port serves both cache layouts behind any CoIC org: a cooperative
cluster of one or more nodes, or a cross-cluster federation, with an
optional ``ClusterMembership`` control plane that reroutes requests aimed
at dead targets.  A sliding-window model and a recurrent (SSM or
hybrid) one need the slotted cache and exact-length prefill runs: paged
KV raises ``ValueError``, as in the reference, and ``prefill_chunk`` is
ignored for them.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cluster import ClusterConfig
from repro_torch.core.coic import (SOURCE_OF, CoICConfig, build_edge_org,
                                   wire_membership)
from repro_torch.core.descriptor import NgramSketchDescriptor, PrefixDescriptor
from repro_torch.core.network import NetworkModel
from repro_torch.core.router import (DeadlineStats, LatencyBreakdown,
                                     PayloadSizes, TwoTierRouter)
from repro_torch.core.tiers import (TIER_LOCAL, TIER_MISS, TIER_NAMES,
                                    TIER_PEER, TIER_REMOTE, pow2 as _pow2,
                                    route_flat)
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import CounterDict, LazyCounterGroup, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.obs.views import digest_block, ladder_block, org_stats
from repro_torch.serving.kv_cache import (PagedKVCache, batch_cache_scatter,
                                          init_batch_cache, init_paged_pool)

# modeled-latency term names for the trace's request track, in the same
# order LatencyBreakdown.total_ms sums them
_TERM_FIELDS = ("descriptor_ms", "uplink_ms", "lookup_ms", "peer_net_ms",
                "remote_net_ms", "cloud_net_ms", "cloud_compute_ms",
                "downlink_ms")

# the serving-level attention knob -> the model's attn_impl
_ATTN_IMPL = {"gather": "gather", "paged": "auto"}


def _latency_terms(lat: LatencyBreakdown, skip=()):
    """(name, ms) pairs of a breakdown's terms — the child spans of one
    request's modeled timeline."""
    return [(f[:-3], getattr(lat, f)) for f in _TERM_FIELDS if f not in skip]


class PromptTooLongError(ValueError):
    """Raised by ``submit()`` when a prompt exceeds ``max_len`` and
    ``on_overflow="reject"``."""


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Every field and default of the reference's ``ServingConfig``."""

    max_batch: int = 8
    max_len: int = 512               # cache capacity per slot
    max_new_tokens: int = 32
    eos_id: int = -1                 # -1: no EOS, always run to max_new
    coic: Optional[CoICConfig] = None
    scheduling: str = "batched"      # batched | sequential (one req/step)
    min_bucket: int = 8              # smallest length/width pad bucket
    queue_policy: str = "edf"        # edf | fifo
    # chunked-prefill width (slotted path: prompts longer than this trickle
    # one chunk per step, 0 == off); in the paged path 0 means one
    # max_len-wide chunk per step
    prefill_chunk: int = 0
    # idle-step pacing: extra batched chunk advances per step when no
    # admission or decode slot is waiting (1 == one chunk per step)
    chunk_pacing: int = 1
    # modeled wall-clock duration of one engine step (paced simulations)
    step_ms: float = 0.0
    kv_page: int = 0                 # page size in tokens (0 = slotted)
    kv_pages: int = 0                # pool size (0 = 2x max_batch span)
    # attention read over the paged pool: "gather" materializes the dense
    # per-row view, "paged" reads pages in place through the paged-
    # attention kernel; "paged_interpret" (the reference's Pallas
    # interpreter) has no CUDA counterpart
    attn_impl: str = "gather"        # gather | paged | paged_interpret
    prefix_share: bool = True        # probe/publish the prefix index
    prefix_mode: str = "exact"       # exact | semantic (n-gram sketch)
    on_overflow: str = "reject"      # reject | truncate

    def __post_init__(self):
        assert self.scheduling in ("batched", "sequential"), self.scheduling
        assert self.queue_policy in ("edf", "fifo"), self.queue_policy
        assert self.prefill_chunk >= 0, self.prefill_chunk
        assert self.chunk_pacing >= 1, self.chunk_pacing
        assert self.on_overflow in ("reject", "truncate"), self.on_overflow
        assert self.kv_page >= 0, self.kv_page
        assert self.attn_impl in ("gather", "paged", "paged_interpret"), \
            self.attn_impl
        if self.attn_impl != "gather":
            assert self.kv_page > 0, \
                "attn_impl=%r needs a paged cache (kv_page > 0)" % self.attn_impl
        if self.kv_page:
            assert self.max_len % self.kv_page == 0, \
                (self.max_len, self.kv_page)
            assert self.prefix_mode in ("exact", "semantic"), self.prefix_mode


@dataclasses.dataclass
class _Active:
    req_id: int
    slot: int
    generated: list
    t_admit: float


@dataclasses.dataclass
class _Chunking:
    """A prompt mid chunked prefill.  Slotted path: owns a reserved slot
    and a B=1 prefill ``cache`` scattered into the batch cache once the
    last chunk lands.  Paged path: ``cache`` is None (chunks write the
    shared pool through the slot's block table) and ``filled`` starts at
    the prefix-shared token count (mapped pages are prefill the row never
    runs)."""
    req_id: int
    slot: int
    prompt: np.ndarray
    cache: Optional[dict] = None     # slotted path's B=1 prefill cache
    filled: int = 0                  # prompt tokens consumed so far
    shared_pages: int = 0            # prefix pages mapped, not computed


@dataclasses.dataclass
class ServedResult:
    req_id: int
    tokens: np.ndarray
    source: str                      # edge | peer | remote | cloud
    latency_s: float                 # hits: modeled; cloud: submit->retire
    decode_steps: int
    breakdown: Optional[LatencyBreakdown] = None   # modeled terms (hits)
    priority: int = 0
    deadline_ms: Optional[float] = None   # budget relative to submission
    completion_ms: float = 0.0       # queueing delay + modeled/measured ms
    deadline_miss: bool = False      # completion_ms > deadline_ms (if set)
    submit_step: int = 0             # engine step count at submit()
    finish_step: int = 0             # engine step count at completion
    truncated: bool = False          # prompt cut to max_len (on_overflow)


class ServingEngine:
    def __init__(self, model, cfg: ServingConfig,
                 network: Optional[NetworkModel] = None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None,
                 membership=None, device="cuda"):
        self.device = resolve_device(device)
        if model.cfg.family == "encdec":
            raise ValueError(
                f"{model.cfg.name} is an encoder-decoder model: the serving "
                "engine does not serve it (nor does the reference's, which "
                "asks cache_specs(1, max_len)); drive EncDecLM.prefill and "
                "decode_step directly")
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine asked "
                             f"for {self.device}")
        if cfg.attn_impl == "paged_interpret":
            raise NotImplementedError(
                "attn_impl='paged_interpret' runs the Pallas interpreter; "
                "the CUDA kernel has none — use 'paged' (or 'gather')")
        self.model = model
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.pending: deque = deque()    # (rid, prompt, node, cluster)
        self.queue: deque = deque()      # (rid, prompt) — lookup missed
        self.active: Dict[int, _Active] = {}
        self.chunking: Dict[int, _Chunking] = {}      # mid chunked prefill
        self.free_slots = list(range(cfg.max_batch))
        self.results: List[ServedResult] = []
        self._req_counter = 0
        self._prompts: Dict[int, np.ndarray] = {}
        self._desc_of: Dict[int, np.ndarray] = {}     # schedule-time reuse
        self._t_submit: Dict[int, float] = {}
        self._priority: Dict[int, int] = {}
        self._n_priority = 0             # in-flight nonzero-priority count
        self._deadline: Dict[int, Optional[float]] = {}   # relative budget
        self._abs_deadline: Dict[int, float] = {}     # EDF sort key (paced)
        self._submit_step: Dict[int, int] = {}
        self.step_count = 0
        self.deadline = DeadlineStats(self.metrics)
        self.dispatches = CounterDict(self.metrics, "engine/dispatches",
                                      ("descriptor", "lookup", "prefill",
                                       "prefill_chunk", "decode"))
        self._completed = self.metrics.counter("engine/completed")
        self._hits = LazyCounterGroup(self.metrics, "engine/hits")
        self._decode_ms = self.metrics.histogram("engine/decode_ms")
        self._last_step_ladder = self.metrics.gauge("engine/last_step_ladder")
        self._max_step_ladder = self.metrics.gauge("engine/max_step_ladder")

        B = cfg.max_batch
        # recurrent (SSM/conv) prefill states absorb right-pad tokens, and
        # sliding-window ring caches rotate by the PADDED length, so those
        # models only batch admissions of identical prompt length with no
        # length padding, never chunk, and never page
        self._exact_prefill = (
            model.cfg.sliding_window > 0
            or any(k.endswith(("/conv", "/state"))
                   for k in model.cache_specs(1, cfg.max_len)))
        self._paged = cfg.kv_page > 0
        if self._paged and self._exact_prefill:
            raise ValueError("kv_page > 0 needs linear attention caches "
                             "(no SWA ring / recurrent state) and a model "
                             "with paged_cache_specs")
        self.kv: Optional[PagedKVCache] = None
        if self._paged:
            self.kv = PagedKVCache(model, B, cfg.max_len, cfg.kv_page,
                                   num_pages=cfg.kv_pages,
                                   prefix_share=cfg.prefix_share,
                                   prefix_mode=cfg.prefix_mode,
                                   metrics=self.metrics)
            self.cache = init_paged_pool(model, self.kv.num_pages,
                                         cfg.kv_page)
            # every paged admission is chunked; without an explicit chunk
            # width one max_len-wide chunk covers any prompt in one step
            self._chunk_width = cfg.prefill_chunk or cfg.max_len
        else:
            self.cache = init_batch_cache(model, B, cfg.max_len)
        self._can_chunk = cfg.prefill_chunk > 0 and not self._exact_prefill
        self._attn_impl = _ATTN_IMPL[cfg.attn_impl]
        self.lengths = torch.zeros((B,), dtype=torch.int32,
                                   device=self.device)
        self.tokens = torch.zeros((B,), dtype=torch.int32, device=self.device)
        self.row_active = np.zeros((B,), bool)
        self._prefill_computed = self.metrics.counter(
            "engine/prefill_tokens_computed")
        self._prefill_shared = self.metrics.counter(
            "engine/prefill_tokens_shared")
        self._truncated: set = set()

        # CoIC front: one ladder org — a cooperative cluster (1-node for the
        # solo cache) or a cross-cluster federation when coic.num_clusters
        # > 1; the engine's own prefill/decode path is the ladder's cloud
        # fall-through
        self.coic_cfg = cfg.coic
        self.semantic = None
        self.sem_org = None
        self.sem_cluster = None
        self.sem_fed = None
        self._req_node: Dict[int, int] = {}
        self._req_cluster: Dict[int, int] = {}
        if cfg.coic is not None:
            c = cfg.coic
            if c.descriptor == "prefix":
                self._desc_fn = PrefixDescriptor(model, k_layers=c.k_layers)
                key_dim = model.cfg.d_model
            else:
                self._desc_fn = NgramSketchDescriptor(dim=c.descriptor_dim)
                key_dim = c.descriptor_dim
            self.key_dim = key_dim
            cluster_cfg = ClusterConfig(
                num_nodes=c.num_nodes, node_capacity=c.capacity,
                key_dim=key_dim, payload_dim=cfg.max_new_tokens,
                threshold=c.threshold, payload_dtype="int32",
                policy=c.policy, lookup_impl=c.lookup_impl,
                admission=c.admission, share=c.share)
            self.sem_cluster, self.sem_fed = build_edge_org(
                c, cluster_cfg, self.metrics, self.trace, self.device)
            self.sem_org = self.sem_fed or self.sem_cluster
            self.semantic = (self.sem_fed.clusters[0] if self.sem_fed
                             else self.sem_cluster).cache
            self._peer_on = c.share and c.num_nodes > 1
            self._region_on = (self.sem_fed is not None and c.federate
                               and c.num_clusters > 1)
            self.network = network or NetworkModel()
            self.router = TwoTierRouter(self.network, PayloadSizes(
                input_bytes=cfg.max_len * 4,
                descriptor_bytes=key_dim * 4,
                result_bytes=cfg.max_new_tokens * 4))

        # membership control plane (core/membership.py): requests whose
        # target died reroute at schedule time and at retire; the
        # federation tombstones digests and re-elects pins on detected
        # deaths.  None == static grid.
        self.membership = membership
        wire_membership(membership, self.sem_cluster, self.sem_fed)

    # ------------------------------------------------------------------
    # registry-backed attribute API
    @property
    def prefill_tokens_computed(self) -> int:
        return self._prefill_computed.value

    @prefill_tokens_computed.setter
    def prefill_tokens_computed(self, v: int) -> None:
        self._prefill_computed.set(int(v))

    @property
    def prefill_tokens_shared(self) -> int:
        return self._prefill_shared.value

    @prefill_tokens_shared.setter
    def prefill_tokens_shared(self, v: int) -> None:
        self._prefill_shared.set(int(v))

    @property
    def last_step_ladder(self) -> int:
        return self._last_step_ladder.value

    @last_step_ladder.setter
    def last_step_ladder(self, v: int) -> None:
        self._last_step_ladder.set(int(v))

    @property
    def max_step_ladder(self) -> int:
        return self._max_step_ladder.value

    @max_step_ladder.setter
    def max_step_ladder(self, v: int) -> None:
        self._max_step_ladder.set(int(v))

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, node_id: int = 0,
               cluster_id: int = 0, priority: int = 0,
               deadline_ms: Optional[float] = None) -> int:
        """prompt: (S,) int32 arriving at edge ``node_id``.  Enqueue-only:
        the lookup ladder runs at the next ``step()``.  Returns the request
        id (the result arrives in ``self.results``).  ``deadline_ms``:
        motion-to-photon budget relative to now (None == bulk).  Prompts
        longer than ``max_len`` raise ``PromptTooLongError``
        (``on_overflow="reject"``) or are cut and flagged ("truncate")."""
        prompt = np.asarray(prompt, np.int32)
        truncated = False
        if len(prompt) > self.cfg.max_len:
            if self.cfg.on_overflow == "reject":
                raise PromptTooLongError(
                    f"prompt length {len(prompt)} exceeds max_len "
                    f"{self.cfg.max_len}; truncating would silently change "
                    "the request (set on_overflow='truncate' to opt in)")
            prompt = prompt[:self.cfg.max_len]
            truncated = True
        rid = self._req_counter
        self._req_counter += 1
        if truncated:
            self._truncated.add(rid)
        self._t_submit[rid] = time.perf_counter()
        self._priority[rid] = priority
        if priority:
            self._n_priority += 1
        self._deadline[rid] = deadline_ms
        self._submit_step[rid] = self.step_count
        if deadline_ms is not None:
            self._abs_deadline[rid] = (self.step_count * self.cfg.step_ms
                                       + deadline_ms)
        self.pending.append((rid, prompt, node_id, cluster_id))
        return rid

    # ------------------------------------------------------------------
    def _queue_key(self, entry):
        """Admission order: EDF over absolute deadlines (bulk == +inf), then
        priority (higher first), then FIFO (rid is submission order)."""
        rid = entry[0]
        if self.cfg.queue_policy == "fifo":
            return (rid,)
        dl = self._abs_deadline.get(rid, np.inf)
        return (dl, -self._priority.get(rid, 0), rid)

    def _order_queue(self) -> None:
        if (self.cfg.queue_policy == "fifo" or len(self.queue) < 2
                or (not self._abs_deadline and not self._n_priority)):
            return
        self.queue = deque(sorted(self.queue, key=self._queue_key))

    # ------------------------------------------------------------------
    def _complete(self, rid: int, source: str, modeled_ms: float,
                  wall_s: float, waited: int) -> Tuple[float, bool]:
        """Completion accounting: queueing delay plus the modeled per-tier
        terms; records the per-tier deadline outcome."""
        if self.cfg.step_ms > 0:
            completion_ms = waited * self.cfg.step_ms + modeled_ms
        elif modeled_ms > 0:
            completion_ms = modeled_ms
        else:
            completion_ms = wall_s * 1e3
        miss = self.deadline.observe(source, completion_ms,
                                     self._deadline.get(rid))
        return completion_ms, miss

    def _finalize(self, rid: int, *, tokens: np.ndarray, source: str,
                  latency_s: float, decode_steps: int,
                  breakdown: Optional[LatencyBreakdown] = None,
                  modeled_ms: float = 0.0, wall_s: float = 0.0,
                  terms: Optional[list] = None) -> None:
        """Shared completion bookkeeping for the hit path and ``_retire``."""
        sub_step = self._submit_step.pop(rid, self.step_count)
        completion_ms, missed = self._complete(rid, source, modeled_ms,
                                               wall_s,
                                               self.step_count - sub_step)
        prio = self._priority.pop(rid, 0)
        if prio:
            self._n_priority -= 1
        self._completed.inc()
        self._hits.inc(source)
        self.results.append(ServedResult(
            req_id=rid, tokens=tokens, source=source, latency_s=latency_s,
            decode_steps=decode_steps, breakdown=breakdown, priority=prio,
            deadline_ms=self._deadline.pop(rid, None),
            completion_ms=completion_ms, deadline_miss=missed,
            submit_step=sub_step, finish_step=self.step_count,
            truncated=rid in self._truncated))
        self._truncated.discard(rid)
        self._abs_deadline.pop(rid, None)
        tr = self.trace
        if tr.enabled:
            tr.begin(f"request:{rid}", cat="request",
                     args={"tier": source, "completion_ms": completion_ms,
                           "decode_steps": decode_steps})
            tr.end()
            tl = list(terms or [])
            wait_ms = ((self.step_count - sub_step) * self.cfg.step_ms
                       if self.cfg.step_ms > 0 else 0.0)
            if wait_ms > 0:
                tl.insert(0, ("engine_steps" if source == "cloud"
                              else "queue_wait", wait_ms))
            resid = completion_ms - sum(t[1] for t in tl)
            if resid > 1e-9:
                tl.append(("serve_wall", resid))
            tr.request_timeline(rid, ts_ms=sub_step * self.cfg.step_ms,
                                tier=source, terms=tl,
                                completion_ms=completion_ms,
                                args={"deadline_miss": missed})

    # ------------------------------------------------------------------
    def _pad_prompts(self, prompts: List[np.ndarray], fill: int,
                     exact: bool = False):
        """Right-pad ``prompts`` with ``fill`` into a (pow2-B, pow2-S)
        bucket (``exact``: no length padding — sliding-window and
        recurrent prefill).
        Returns (tokens (Bb, Sb) int32, lengths (n,) int32)."""
        n = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        Sb = (int(lens.max()) if exact else
              min(_pow2(int(lens.max()), self.cfg.min_bucket),
                  self.cfg.max_len))
        Bb = _pow2(n)
        toks = np.full((Bb, Sb), fill, np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p[:Sb]
        return toks, np.minimum(lens, Sb)

    def _extract_descriptors(self, prompts: List[np.ndarray]):
        """ONE descriptor extraction over the length-bucketed pad.
        Returns (n, D) numpy descriptors and the wall ms of the call."""
        toks, _ = self._pad_prompts(prompts, fill=-1)
        tr = self.trace
        if tr.enabled:
            tr.begin("descriptor", cat="engine",
                     args={"batch": len(prompts)})
        t0 = time.perf_counter()
        desc = self._desc_fn(torch.as_tensor(toks, device=self.device))
        desc = desc.cpu().numpy()              # waits for the device
        if tr.enabled:
            tr.end()
        self.dispatches["descriptor"] += 1
        return desc[:len(prompts)], (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------------------------
    def _schedule(self) -> None:
        """Drain pending requests through the batched lookup ladder: one
        descriptor extraction + one grouped lookup for ALL pending requests
        (or one request in sequential mode)."""
        if not self.pending:
            return
        n_drain = 1 if self.cfg.scheduling == "sequential" else len(self.pending)
        batch = [self.pending.popleft() for _ in range(n_drain)]
        if self.membership is not None:
            # degraded routing against CURRENT liveness: a dead target
            # remaps to the nearest alive (cluster, node), so the ladder
            # only sees live targets
            rerouted = []
            for rid, prompt, node, clu in batch:
                clu, node = self.membership.route(clu, node)
                rerouted.append((rid, prompt, node, clu))
            batch = rerouted
        prompts = [b[1] for b in batch]
        nodes = [b[2] for b in batch]
        clusters = [b[3] for b in batch]

        if self.semantic is None:                 # no CoIC front
            for rid, prompt, node, clu in batch:
                self._req_node[rid] = node
                self._req_cluster[rid] = clu
                self.queue.append((rid, prompt))
            return

        desc, desc_ms = self._extract_descriptors(prompts)
        n = len(batch)
        tr = self.trace
        if tr.enabled:
            tr.begin("lookup", cat="engine", args={"batch": n})
        t0 = time.perf_counter()
        res = route_flat(self.sem_org, desc, nodes, clusters)
        self.dispatches["lookup"] += 1
        lookup_ms = (time.perf_counter() - t0) * 1e3
        if tr.enabled:
            tr.end()
        tier, value = res.tier, res.value
        hit = tier != TIER_MISS

        # every local miss shares ONE peer broadcast per cluster; what
        # escalates past the peer tier shares that home cluster's ONE
        # metro->region digest message; local hits share the step's
        # descriptor + lookup dispatch
        clus_np = np.asarray(clusters)
        lm = {k: int(((tier != TIER_LOCAL) & (clus_np == k)).sum())
              for k in set(clusters)}
        esc = {k: int(((tier >= TIER_REMOTE) & (clus_np == k)).sum())
               for k in set(clusters)} if self._region_on else {}
        for i, (rid, prompt, node, clu) in enumerate(batch):
            if hit[i]:
                toks = np.asarray(value[i], np.int32)
                t = int(tier[i])
                name = TIER_NAMES[t]
                src = SOURCE_OF[name]
                amort = {TIER_LOCAL: n, TIER_PEER: max(1, lm[clu]),
                         TIER_REMOTE: max(1, esc.get(clu, 0))}[t]
                lat = self.router.tier_latency(
                    name, desc_ms / n, lookup_ms / n, batch=amort,
                    peer_net_ms=(self.router.peer_broadcast_ms(lm[clu])
                                 if t == TIER_REMOTE and self._peer_on
                                 else 0.0))
                self._t_submit.pop(rid, None)
                lat.deadline_ms = self._deadline.get(rid)
                modeled_ms = lat.total_ms
                skip = ()
                if self.cfg.step_ms > 0:
                    # paced simulation: device compute rides the step
                    # clock; keep only the modeled network terms
                    modeled_ms -= lat.descriptor_ms + lat.lookup_ms
                    skip = ("descriptor_ms", "lookup_ms")
                self._finalize(rid, tokens=toks, source=src,
                               latency_s=lat.total_ms / 1e3, decode_steps=0,
                               breakdown=lat, modeled_ms=modeled_ms,
                               wall_s=lat.total_ms / 1e3,
                               terms=(_latency_terms(lat, skip)
                                      if tr.enabled else None))
            else:
                self._req_node[rid] = node
                self._req_cluster[rid] = clu
                self._desc_of[rid] = desc[i]
                self.queue.append((rid, prompt))

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Deadline-ordered admission into the slotted cache: the queue is
        sorted by the EDF key (FIFO under ``queue_policy="fifo"`` or when
        nothing carries a deadline), then drained front to back — long
        prompts peel off into the chunked path (one reserved slot, one
        ``prefill_chunk``-token call per step), everything else joins ONE
        bucketed batched ``prefill`` per step (sequential mode: one
        request per step; sliding window: an equal-length front run).
        The paged pool admits by ``_admit_paged`` instead."""
        if self._paged:
            self._admit_paged()
            return
        self._advance_chunks()
        self._order_queue()
        # sequential mode is the per-request one-shot baseline: chunking
        # stays out of it, as in the reference
        chunking_on = self._can_chunk and self.cfg.scheduling != "sequential"
        while self.queue and self.free_slots:
            if chunking_on and \
                    len(self.queue[0][1]) > self.cfg.prefill_chunk:
                rid, prompt = self.queue.popleft()
                slot = self.free_slots.pop()
                st = _Chunking(req_id=rid, slot=slot,
                               prompt=prompt[:self.cfg.max_len],
                               cache=init_batch_cache(self.model, 1,
                                                      self.cfg.max_len))
                self.chunking[rid] = st
                self._advance_chunk(st)       # first chunk rides this step
                continue
            m = min(len(self.queue), len(self.free_slots))
            if self.cfg.scheduling == "sequential":
                m = 1
            elif self._exact_prefill:
                # equal-length front run only: no right-pad for SWA rings
                # or recurrent states
                L0 = len(self.queue[0][1])
                run = 1
                while run < m and len(self.queue[run][1]) == L0:
                    run += 1
                m = run
            if chunking_on:
                # only the front run of short prompts: a long prompt
                # mid-queue must not inflate the shared pad bucket
                run = 1
                while run < m and \
                        len(self.queue[run][1]) <= self.cfg.prefill_chunk:
                    run += 1
                m = run
            self._prefill_run([self.queue.popleft() for _ in range(m)])

    def _prefill_run(self, taken) -> None:
        """ONE bucketed ``prefill`` call over the (rid, prompt) run
        ``taken``; its rows are scattered into free slots and activated."""
        m = len(taken)
        toks, lens = self._pad_prompts([p for _, p in taken], fill=0,
                                       exact=self._exact_prefill)
        lens_pad = np.zeros((toks.shape[0],), np.int32)
        lens_pad[:m] = lens
        tr = self.trace
        if tr.enabled:
            tr.begin("prefill", cat="engine",
                     args={"rows": m, "bucket": int(toks.shape[1])})
        dev = self.device
        logits, many_cache, _ = self.model.prefill(
            torch.as_tensor(toks, device=dev), max_len=self.cfg.max_len,
            lengths=torch.as_tensor(lens_pad, device=dev))
        if tr.enabled:
            tr.end()
        self.dispatches["prefill"] += 1
        self.prefill_tokens_computed += int(lens.sum())
        slots = [self.free_slots.pop() for _ in range(m)]
        batch_cache_scatter(self.cache,
                            {k: v[:, :m] for k, v in many_cache.items()},
                            slots)
        del many_cache
        nxt_t = torch.argmax(logits[:m], -1).to(torch.int32)
        idx = torch.as_tensor(slots, device=dev)
        self.lengths[idx] = torch.as_tensor(lens, device=dev)
        self.tokens[idx] = nxt_t
        nxt = nxt_t.cpu().numpy()
        now = time.perf_counter()
        for i, ((rid, prompt), slot) in enumerate(zip(taken, slots)):
            self.row_active[slot] = True
            self.active[slot] = _Active(req_id=rid, slot=slot,
                                        generated=[int(nxt[i])],
                                        t_admit=now)
            self._prompts[rid] = prompt

    def _advance_chunks(self) -> None:
        """One ``prefill_chunk``-token call per in-flight long prompt per
        step (slotted path).  With ``chunk_pacing > 1`` and an otherwise
        idle engine (free slots, empty queue) each prompt may advance up to
        ``chunk_pacing`` chunks this step, most urgent (EDF key) first."""
        sts = sorted(self.chunking.values(),
                     key=lambda st: self._queue_key((st.req_id,)))
        for st in sts:
            self._advance_chunk(st)
        if self.cfg.chunk_pacing <= 1:
            return
        for st in sts:
            for _ in range(self.cfg.chunk_pacing - 1):
                if (st.req_id not in self.chunking or self.queue
                        or not self.free_slots):
                    break
                self._advance_chunk(st)

    def _advance_chunk(self, st: _Chunking) -> None:
        """Feed the next chunk of ``st``'s prompt through
        ``model.prefill_chunk`` at the static (1, prefill_chunk) shape (a
        short tail is zero-padded, its true width passed as data); on the
        last chunk scatter the B=1 cache into the reserved slot and
        activate the row."""
        C = self.cfg.prefill_chunk
        n = min(C, len(st.prompt) - st.filled)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = st.prompt[st.filled:st.filled + n]
        tr = self.trace
        if tr.enabled:
            tr.begin("prefill_chunk", cat="engine",
                     args={"rid": st.req_id, "width": n})
        dev = self.device
        logits, st.cache, _ = self.model.prefill_chunk(
            torch.as_tensor(chunk, device=dev), st.cache,
            torch.tensor([st.filled], dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev))
        if tr.enabled:
            tr.end()
        self.dispatches["prefill_chunk"] += 1
        self.prefill_tokens_computed += n
        st.filled += n
        if st.filled < len(st.prompt):
            return
        rid, slot = st.req_id, st.slot
        del self.chunking[rid]
        batch_cache_scatter(self.cache, st.cache, [slot])
        nxt = int(torch.argmax(logits[0]))
        self.lengths[slot] = len(st.prompt)
        self.tokens[slot] = nxt
        self.row_active[slot] = True
        self.active[slot] = _Active(req_id=rid, slot=slot, generated=[nxt],
                                    t_admit=time.perf_counter())
        self._prompts[rid] = st.prompt

    # ------------------------------------------------------------------
    def _admit_paged(self) -> None:
        """Continuous-batching admission against the page pool: EDF-drain
        the queue into the chunking set (each admission probes the prefix
        index — mapped pages start ``filled`` past zero), then advance
        every mid-prefill row in ONE batched chunk launch.  Admitting
        before advancing means a request's first chunk rides the step it
        was admitted on."""
        self._order_queue()
        while self.queue and self.free_slots:
            rid, prompt = self.queue.popleft()
            slot = self.free_slots.pop()
            shared_tok = self.kv.admit(slot, prompt)
            self.prefill_tokens_shared += shared_tok
            self.chunking[rid] = _Chunking(
                req_id=rid, slot=slot, prompt=prompt, filled=shared_tok,
                shared_pages=shared_tok // self.cfg.kv_page)
        self._advance_chunks_paged()
        for _ in range(self.cfg.chunk_pacing - 1):
            # idle pacing: extra batched advances only when no admission
            # or decode slot is waiting on us
            if not self.chunking or self.queue or not self.free_slots:
                break
            self._advance_chunks_paged()

    def _advance_chunks_paged(self) -> None:
        """ONE (pow2 rows, chunk_width) ``prefill_chunk`` call over every
        mid-prefill row: per-row lengths, true widths and block-table rows;
        pad rows carry width 0 and an all-INVALID table, so their writes
        drop.  Rows whose last chunk lands activate for decode and publish
        their computed full pages to the prefix index."""
        if not self.chunking:
            return
        sts = sorted(self.chunking.values(),
                     key=lambda st: self._queue_key((st.req_id,)))
        C = self._chunk_width
        Bb = _pow2(len(sts))
        toks = np.zeros((Bb, C), np.int32)
        lens = np.zeros((Bb,), np.int32)
        widths = np.zeros((Bb,), np.int32)
        bt = np.full((Bb, self.kv.pages_per_slot), PagedKVCache.INVALID,
                     np.int32)
        for i, st in enumerate(sts):
            n = min(C, len(st.prompt) - st.filled)
            toks[i, :n] = st.prompt[st.filled:st.filled + n]
            lens[i] = st.filled
            widths[i] = n
            bt[i] = self.kv.block_table[st.slot]
        tr = self.trace
        if tr.enabled:
            tr.begin("prefill_chunk", cat="engine",
                     args={"rows": len(sts), "width": C})
        dev = self.device
        logits, self.cache, _ = self.model.prefill_chunk(
            torch.as_tensor(toks, device=dev), self.cache,
            torch.as_tensor(lens, device=dev),
            torch.as_tensor(widths, device=dev),
            block_table=torch.as_tensor(bt, device=dev),
            attn_impl=self._attn_impl)
        if tr.enabled:
            tr.end()
        self.dispatches["prefill_chunk"] += 1
        self.prefill_tokens_computed += int(widths.sum())
        nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        now = time.perf_counter()
        for i, st in enumerate(sts):
            st.filled += int(widths[i])
            if st.filled < len(st.prompt):
                continue
            rid, slot = st.req_id, st.slot
            del self.chunking[rid]
            self.kv.register(slot, st.prompt, from_page=st.shared_pages)
            self.lengths[slot] = len(st.prompt)
            self.tokens[slot] = int(nxt[i])
            self.row_active[slot] = True
            self.active[slot] = _Active(req_id=rid, slot=slot,
                                        generated=[int(nxt[i])],
                                        t_admit=now)
            self._prompts[rid] = st.prompt

    # ------------------------------------------------------------------
    def _retire(self, slot: int) -> None:
        a = self.active.pop(slot)
        tr = self.trace
        if tr.enabled:
            tr.begin("retire", cat="engine",
                     args={"rid": a.req_id, "slot": slot})
        toks = np.asarray(a.generated[:self.cfg.max_new_tokens], np.int32)
        t_sub = self._t_submit.pop(a.req_id, a.t_admit)
        wall_s = time.perf_counter() - t_sub
        modeled_ms = 0.0
        terms = None
        if self.cfg.step_ms > 0 and self.semantic is not None:
            # paced simulation: the engine's own compute is counted in
            # steps; add only the modeled network terms around it
            lat = self.router.miss_latency(0.0, 0.0, 0.0)
            modeled_ms = lat.total_ms
            if tr.enabled:
                terms = _latency_terms(lat)
        self._finalize(a.req_id, tokens=toks, source="cloud",
                       latency_s=wall_s, decode_steps=len(a.generated),
                       modeled_ms=modeled_ms, wall_s=wall_s, terms=terms)
        self.row_active[slot] = False
        self.free_slots.append(slot)
        if self._paged:
            # refcount-- on every mapped page; pages at zero stay
            # probe-able until recycled, so this request's prefix keeps
            # serving
            self.kv.free_slot(slot)
        node = self._req_node.pop(a.req_id, 0)
        clu = self._req_cluster.pop(a.req_id, 0)
        if self.membership is not None:
            # the home shard may have died while this request computed:
            # insert into the live reroute target instead
            clu, node = self.membership.route(clu, node)
        prompt = self._prompts.pop(a.req_id, None)
        if self.semantic is not None and prompt is not None:
            # reuse the schedule-time descriptor: no extra extraction
            desc = self._desc_of.pop(a.req_id)
            pad = np.zeros((self.cfg.max_new_tokens,), np.int32)
            pad[:len(toks)] = toks
            self.sem_org.insert_home(clu, node, desc[None, :], pad[None, :])
        if tr.enabled:
            tr.end()

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine iteration: schedule (batched lookup ladder) + admit
        (EDF-ordered chunked prefill) + one batched decode step."""
        self.step_count += 1
        tr = self.trace
        if not tr.enabled:                  # the untraced hot path
            self._step_inner()
            return
        tr.begin("step", cat="engine", args={"step": self.step_count})
        try:
            self._step_inner()
        finally:
            tr.end()

    def _step_inner(self) -> None:
        tr = self.trace
        ladder0 = self.dispatches["descriptor"] + self.dispatches["lookup"]
        if tr.enabled:
            tr.begin("schedule", cat="engine",
                     args={"pending": len(self.pending)})
        self._schedule()
        if tr.enabled:
            tr.end()
        self.last_step_ladder = (self.dispatches["descriptor"]
                                 + self.dispatches["lookup"] - ladder0)
        self.max_step_ladder = max(self.max_step_ladder,
                                   self.last_step_ladder)
        if tr.enabled:
            tr.begin("admit", cat="engine", args={"queued": len(self.queue)})
        self._admit()
        if tr.enabled:
            tr.end()
        if not self.active:
            return
        if tr.enabled:
            tr.begin("decode", cat="engine",
                     args={"active": int(self.row_active.sum())})
        t0 = time.perf_counter()
        if self._paged:
            # mid-prefill and free rows ride the batched decode with an
            # all-INVALID table row: their junk write drops
            bt = torch.as_tensor(self.kv.decode_table(self.row_active),
                                 device=self.device)
            logits, self.cache, self.lengths = self.model.decode_step(
                self.cache, self.tokens, self.lengths, block_table=bt,
                attn_impl=self._attn_impl)
        else:
            # free rows write junk into their own slots, which the next
            # admission's scatter overwrites whole
            logits, self.cache, self.lengths = self.model.decode_step(
                self.cache, self.tokens, self.lengths)
        self.dispatches["decode"] += 1
        nxt_t = torch.argmax(logits, -1).to(torch.int32)
        nxt = nxt_t.cpu().numpy()
        lengths = self.lengths.cpu().numpy()
        self._decode_ms.observe((time.perf_counter() - t0) * 1e3)
        if tr.enabled:
            tr.end()
        for slot in list(self.active):
            a = self.active[slot]
            a.generated.append(int(nxt[slot]))
            done = (len(a.generated) >= self.cfg.max_new_tokens
                    or (self.cfg.eos_id >= 0 and nxt[slot] == self.cfg.eos_id)
                    or int(lengths[slot]) >= self.cfg.max_len - 1)
            if done:
                self._retire(slot)
        self.tokens = nxt_t

    def run_until_drained(self, max_steps: int = 10_000) -> List[ServedResult]:
        steps = 0
        while (self.pending or self.queue or self.chunking
               or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.results

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        # every number here is a view over self.metrics
        out = {
            "completed": self._completed.value,
            "edge_hits": self._hits.get("edge"),
            "peer_hits": self._hits.get("peer"),
            "remote_hits": self._hits.get("remote"),
            "cloud": self._hits.get("cloud"),
            "dispatches": dict(self.dispatches),
            "max_step_ladder": self.max_step_ladder,
            "deadline": self.deadline.as_dict(),
            "prefill_tokens": {"computed": self.prefill_tokens_computed,
                               "shared": self.prefill_tokens_shared},
        }
        if self._paged:
            out["kv"] = self.kv.stats_dict()
        if self.sem_org is not None:
            out["semantic"] = org_stats(self.sem_fed, self.sem_cluster,
                                        self.semantic)
            out["ladder"] = ladder_block(self.sem_org)
            out["digest"] = digest_block(self.sem_fed)
        if self.membership is not None:
            out["membership"] = self.membership.stats()
        return out
