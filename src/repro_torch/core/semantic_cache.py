"""Device-resident semantic cache — the CoIC edge tier.

The port of ``repro/core/semantic_cache.py``: a fixed-capacity tensor
store of (descriptor key, payload value) pairs with a batched lookup,

  hit(q)  <=>  max_c cos(q, key_c) >= tau.

Operations stay functional (state in, new state out), as in the
reference: the tier ladder snapshots shard states before a step and must
see them unchanged.  Each op builds its new tensors out of place.  JAX
drops out-of-range scatters (``mode="drop"`` to slot ``capacity``);
PyTorch raises, so masked rows scatter a neutral value (INT32_MIN into a
max, 0 into an add) or are left out of the index.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.policies import EvictionPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels.similarity import (similarity_lookup,
                                            similarity_topk_touch)

_INT32_MIN = -(2 ** 31)


@dataclasses.dataclass
class SemanticCacheState:
    keys: torch.Tensor          # (C, D) fp32 unit descriptors
    values: torch.Tensor        # (C, P) payload
    valid: torch.Tensor         # (C,) bool
    last_used: torch.Tensor     # (C,) int32 — logical clock of last hit/insert
    inserted_at: torch.Tensor   # (C,) int32
    freq: torch.Tensor          # (C,) int32 — hit count (LFU)
    peer_served: torch.Tensor   # (C,) int32 — hits served for OTHER nodes
    region_pin: torch.Tensor    # (C,) bool — region's last copy of a hot entry
    clock: torch.Tensor         # () int32 — logical time
    hits: torch.Tensor          # () int32 — stats
    misses: torch.Tensor        # () int32


class LookupResult(NamedTuple):
    hit: torch.Tensor           # (Q,) bool
    index: torch.Tensor         # (Q,) int32
    score: torch.Tensor         # (Q,) fp32
    value: torch.Tensor         # (Q, P) payload (zeros when miss)


def _touch_max(last_used, idx, hit, clock):
    """``last_used.at[where(hit, idx, C)].max(clock, mode="drop")``."""
    src = torch.where(hit, clock, _INT32_MIN).to(torch.int32)
    return last_used.scatter_reduce(0, idx.long(), src, reduce="amax",
                                    include_self=True)


def _touch_add(counter, idx, hit):
    """``counter.at[where(hit, idx, C)].add(1, mode="drop")``."""
    return counter.index_add(0, idx.long(), hit.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class SemanticCache:
    capacity: int
    key_dim: int
    payload_dim: int
    threshold: float = 0.85
    payload_dtype: str = "float32"
    policy: EvictionPolicy = EvictionPolicy("lru")
    lookup_impl: str = "auto"        # kernels/similarity impl switch
    # fold the LRU touch into the lookup kernel's epilogue; the unfused
    # apply_probe path stays as the oracle
    fuse_touch: bool = False

    # ------------------------------------------------------------------
    def init(self, device="cuda") -> SemanticCacheState:
        dev = resolve_device(device)
        C, D, P = self.capacity, self.key_dim, self.payload_dim
        i32 = dict(dtype=torch.int32, device=dev)
        return SemanticCacheState(
            keys=torch.zeros((C, D), dtype=torch.float32, device=dev),
            values=torch.zeros((C, P), dtype=getattr(torch,
                                                     self.payload_dtype),
                               device=dev),
            valid=torch.zeros((C,), dtype=torch.bool, device=dev),
            last_used=torch.zeros((C,), **i32),
            inserted_at=torch.zeros((C,), **i32),
            freq=torch.zeros((C,), **i32),
            peer_served=torch.zeros((C,), **i32),
            region_pin=torch.zeros((C,), dtype=torch.bool, device=dev),
            clock=torch.zeros((), **i32),
            hits=torch.zeros((), **i32),
            misses=torch.zeros((), **i32),
        )

    # ------------------------------------------------------------------
    def lookup(self, state: SemanticCacheState, queries: torch.Tensor,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[SemanticCacheState, LookupResult]:
        """queries: (Q, D) unit descriptors.  Updates LRU/LFU/stat fields.
        ``mask`` (Q,) bool selects real rows — padding rows never hit,
        touch, or count in stats.

        ``fuse_touch=True`` routes through ``similarity_topk_touch``: the
        kernel's epilogue writes the LRU touch in the same launch.  Same
        state transition as the unfused path (an all-expired cache reports
        score -1e30 instead of -inf)."""
        alive = self.policy.expire(state, state.clock)
        if self.fuse_touch:
            Q = queries.shape[0]
            m = (torch.ones((Q,), dtype=torch.bool, device=queries.device)
                 if mask is None else mask.bool())
            idx, score, last_used, freq = similarity_topk_touch(
                queries, state.keys, alive, 1, state.last_used, state.freq,
                state.clock, threshold=self.threshold, mask=m,
                impl=self.lookup_impl)
            idx, score = idx[:, 0], score[:, 0]
            hit = (score >= self.threshold) & alive[idx.long()] & m
            value = torch.where(hit[:, None], state.values[idx.long()], 0)
            nhit = hit.sum(dtype=torch.int32)
            nreal = m.sum(dtype=torch.int32)
            new_state = dataclasses.replace(
                state, valid=alive, last_used=last_used, freq=freq,
                clock=state.clock + 1,
                hits=state.hits + nhit,
                misses=state.misses + (nreal - nhit))
            return new_state, LookupResult(hit, idx, score, value)
        idx, score = similarity_lookup(queries, state.keys, alive,
                                       impl=self.lookup_impl)
        return self.apply_probe(state, idx, score, mask=mask, alive=alive)

    # ------------------------------------------------------------------
    def apply_probe(self, state: SemanticCacheState, idx: torch.Tensor,
                    score: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    alive: Optional[torch.Tensor] = None
                    ) -> Tuple[SemanticCacheState, LookupResult]:
        """Fold externally computed best-match probe results (one row of
        the grouped ``similarity_topk_batched`` launch) into this shard
        exactly as ``lookup`` would: hit thresholding, LRU/LFU touches,
        hit/miss counters, one clock tick.  ``mask`` rows that are False
        are padding; ``alive`` is the TTL-expiry mask the probe used."""
        Q = idx.shape[0]
        mask = (torch.ones((Q,), dtype=torch.bool, device=idx.device)
                if mask is None else mask.bool())
        if alive is None:
            alive = self.policy.expire(state, state.clock)
        il = idx.long()
        hit = (score >= self.threshold) & alive[il] & mask
        value = torch.where(hit[:, None], state.values[il], 0)
        nhit = hit.sum(dtype=torch.int32)
        nreal = mask.sum(dtype=torch.int32)
        new_state = dataclasses.replace(
            state, valid=alive,
            last_used=_touch_max(state.last_used, idx, hit, state.clock),
            freq=_touch_add(state.freq, idx, hit),
            clock=state.clock + 1,
            hits=state.hits + nhit,
            misses=state.misses + (nreal - nhit))
        return new_state, LookupResult(hit, idx, score, value)

    # ------------------------------------------------------------------
    def touch(self, state: SemanticCacheState, idx: torch.Tensor,
              mask: torch.Tensor) -> SemanticCacheState:
        """Record remote (peer/cluster-served) hits on this shard: LRU/LFU
        state, the hit counter and the per-slot ``peer_served`` counter for
        ``idx`` rows where ``mask`` is True; the clock advances."""
        mask = mask.bool()
        return dataclasses.replace(
            state,
            last_used=_touch_max(state.last_used, idx, mask, state.clock),
            freq=_touch_add(state.freq, idx, mask),
            peer_served=_touch_add(state.peer_served, idx, mask),
            clock=state.clock + 1,
            hits=state.hits + mask.sum(dtype=torch.int32))

    # ------------------------------------------------------------------
    def insert(self, state: SemanticCacheState, keys: torch.Tensor,
               values: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> SemanticCacheState:
        """Insert up to Q entries (mask selects which rows are real).
        Victims: the Q lowest-priority slots (invalid first, then the
        policy order, ties to the lower slot as ``lax.top_k(-pri, Q)``
        picks them), so a batch insert never overwrites itself."""
        Q = keys.shape[0]
        dev = state.keys.device
        mask = (torch.ones((Q,), dtype=torch.bool, device=dev)
                if mask is None else mask.to(dev).bool())
        pri = self.policy.priority(state)
        victims = torch.sort(-pri, descending=True, stable=True).indices[:Q]
        rows = mask.nonzero().squeeze(1)
        v = victims[rows]
        new = {f.name: getattr(state, f.name).clone()
               for f in dataclasses.fields(state)
               if f.name not in ("hits", "misses")}
        new["keys"][v] = keys.to(dev).float()[rows]
        new["values"][v] = values.to(dev).to(state.values.dtype)[rows]
        new["valid"][v] = True
        new["last_used"][v] = state.clock
        new["inserted_at"][v] = state.clock
        new["freq"][v] = 1
        new["peer_served"][v] = 0
        new["region_pin"][v] = False
        new["clock"] = state.clock + 1
        return dataclasses.replace(state, **new)

    # ------------------------------------------------------------------
    def stats(self, state: SemanticCacheState) -> dict:
        total = int(state.hits) + int(state.misses)
        return {
            "capacity": self.capacity,
            "occupancy": int(state.valid.sum()),
            "hits": int(state.hits),
            "misses": int(state.misses),
            "hit_rate": (int(state.hits) / total) if total else 0.0,
        }
