"""Cache eviction policies as priority functions over the cache state.

The port of ``repro/core/policies.py``: eviction removes the
minimum-priority slot, insertion prefers invalid slots (priority NEG).
See the reference for the ``peer_aware`` / ``region_aware`` rationale;
the arithmetic here is the same, in float32.
"""
from __future__ import annotations

import dataclasses

import torch

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class EvictionPolicy:
    """kind: lru | lfu | fifo | lru_ttl.  ttl in engine time units (ladder
    steps: every lookup/insert advances a shard's logical clock by one).

    ``peer_aware``: among equal base priorities, keep the entry with more
    ``peer_served`` hits (a sub-integer bias, so it only breaks ties).

    ``region_aware``: lift pinned-and-valid slots above every unpinned one
    through a stable rank transform of the base priority (ties to the lower
    slot, exact in fp32 for any capacity < 2^23)."""

    kind: str = "lru"
    ttl: int = 0
    peer_aware: bool = False
    region_aware: bool = False

    def priority(self, state) -> torch.Tensor:
        """(C,) fp32 — higher means keep longer.  Invalid slots get NEG so
        they are always chosen first as insertion victims."""
        if self.kind == "lru" or self.kind == "lru_ttl":
            pri = state.last_used.float()
        elif self.kind == "lfu":
            # tie-break equal frequencies by recency
            pri = state.freq.float() * 1e6 + state.last_used.float()
        elif self.kind == "fifo":
            pri = state.inserted_at.float()
        else:
            raise ValueError(f"unknown eviction policy {self.kind}")
        if self.peer_aware:
            pri = pri + state.peer_served.clamp(0, 1023).float() / 1024.0
        if self.region_aware:
            C = pri.shape[0]
            rank = torch.argsort(torch.argsort(pri, stable=True),
                                 stable=True).float()
            pri = rank + torch.where(state.region_pin & state.valid,
                                     float(C), 0.0)
        return torch.where(state.valid, pri, NEG)

    def expire(self, state, now: torch.Tensor) -> torch.Tensor:
        """(C,) bool — slots still alive after TTL expiry."""
        if self.ttl <= 0:
            return state.valid
        return state.valid & ((now - state.inserted_at) < self.ttl)
