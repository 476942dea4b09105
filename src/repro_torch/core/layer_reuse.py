"""Fine-grained per-layer KV reuse — the paper's §4 future work (the port
of ``repro/core/layer_reuse.py``).

CoIC §4: "we are exploring the improvement that can efficiently and
accurately identify reusable IC workload in fine-grained (e.g., the result
of a specific DNN layer)."  For an LM, the per-layer intermediate result of
a prompt block is its KV-cache block; two requests sharing a (near-)
identical block at the same offset can share every layer's KV for it.

Mechanics (the paper's two lookup paths):

  * exact: content hash of (offset, block tokens) — the 3D-model/panorama
    path; splice is bit-exact.
  * approximate: n-gram sketch descriptor at threshold tau — the DNN-feature
    path; splice is approximate in exactly the way the paper's recognition
    reuse is.

Reuse is offset-aligned (RoPE bakes absolute positions into cached K) and
restricted to attention-family blocks; the final block is always computed
so next-token logits reflect the true suffix.  Misses run the model's
``prefill_chunk``, which writes the request's cache in place: a computed
block is copied out (``_extract_block``) before the next chunk runs, and
inserted for future requests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.descriptor import NgramSketchDescriptor
from repro_torch.core.hash_cache import HashCache, content_hash
from repro_torch.core.policies import EvictionPolicy
from repro_torch.core.semantic_cache import SemanticCache


@dataclasses.dataclass
class SemOffsetEntry:
    """One per-offset approximate index: a ``SemanticCache`` and its
    current state, updated together in a single read-modify-write
    (``lookup``/``insert`` reassign ``state`` before returning, so no
    caller ever holds a stale state alongside a fresh one).  Shared by
    ``BlockReuseCache`` and the paged KV prefix index
    (``serving/kv_cache.py``)."""

    cache: SemanticCache
    state: object

    def lookup(self, desc: torch.Tensor):
        self.state, res = self.cache.lookup(self.state, desc)
        return res

    def insert(self, desc: torch.Tensor, payload: torch.Tensor) -> None:
        self.state = self.cache.insert(self.state, desc, payload)


@dataclasses.dataclass
class BlockReuseStats:
    blocks_exact: int = 0
    blocks_semantic: int = 0
    blocks_computed: int = 0

    @property
    def reuse_rate(self) -> float:
        total = self.blocks_exact + self.blocks_semantic + self.blocks_computed
        return (self.blocks_exact + self.blocks_semantic) / total if total else 0.0


class BlockReuseCache:
    """Per-offset block KV store with exact + approximate lookup, on the
    model's device (the reference's ``params`` live in the port's model)."""

    def __init__(self, model, *, block_size: int = 64,
                 threshold: float = 0.98, capacity_per_offset: int = 256,
                 descriptor_dim: int = 128, max_offsets: int = 64,
                 semantic: bool = True):
        if model.cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError("block KV reuse needs attention-family caches "
                             f"(got {model.cfg.family})")
        if model.cfg.sliding_window:
            raise ValueError("block KV reuse needs linear caches (no SWA ring)")
        self.model = model
        self.device = model.device
        self.block_size = block_size
        self.threshold = threshold
        self.semantic_enabled = semantic
        self.sketch = NgramSketchDescriptor(dim=descriptor_dim)
        self.exact = HashCache(capacity_bytes=2 << 30)
        self._values: List[dict] = []                 # handle -> KV block
        self._sem: Dict[int, SemOffsetEntry] = {}
        self._sem_capacity = capacity_per_offset
        self._descriptor_dim = descriptor_dim
        self.stats = BlockReuseStats()

    # ------------------------------------------------------------------
    def _sem_cache(self, offset: int) -> SemOffsetEntry:
        if offset not in self._sem:
            cache = SemanticCache(capacity=self._sem_capacity,
                                  key_dim=self._descriptor_dim, payload_dim=1,
                                  threshold=self.threshold,
                                  payload_dtype="int32",
                                  policy=EvictionPolicy("lru"))
            self._sem[offset] = SemOffsetEntry(cache,
                                               cache.init(self.device))
        return self._sem[offset]

    def _desc(self, block_toks: np.ndarray) -> torch.Tensor:
        return self.sketch(torch.as_tensor(block_toks[None, :],
                                           device=self.device))

    # ------------------------------------------------------------------
    def _extract_block(self, cache: dict, offset: int) -> dict:
        """A copy of positions [offset*Bk, (offset+1)*Bk) of every leaf
        (layers, B, S, K, Dh): the next chunk writes the cache in place."""
        Bk = self.block_size
        return {k: v[:, :, offset * Bk:(offset + 1) * Bk].clone()
                for k, v in cache.items()}

    def _splice_block(self, cache: dict, block: dict, offset: int) -> None:
        Bk = self.block_size
        for k, v in block.items():
            cache[k][:, :, offset * Bk:(offset + 1) * Bk] = v.to(
                cache[k].dtype)

    # ------------------------------------------------------------------
    def prefill(self, tokens: np.ndarray, max_len: Optional[int] = None):
        """tokens: (S,) single-request prompt.  Returns (logits (V,), cache,
        lengths (1,), per-request stats dict)."""
        Bk = self.block_size
        S = len(tokens)
        n_blocks = S // Bk
        assert n_blocks * Bk == S, f"prompt length {S} % block {Bk} != 0"
        max_len = max_len or S
        cache = self.model.init_cache(1, max_len)
        lengths = torch.zeros((1,), dtype=torch.int32, device=self.device)
        logits = None
        req = BlockReuseStats()

        for i in range(n_blocks):
            block_toks = tokens[i * Bk:(i + 1) * Bk]
            last = i == n_blocks - 1
            reused = None
            if not last:
                key = content_hash((i, block_toks.tobytes()))
                reused = self.exact.get(key)
                if reused is not None:
                    req.blocks_exact += 1
                elif self.semantic_enabled:
                    res = self._sem_cache(i).lookup(self._desc(block_toks))
                    if bool(res.hit[0]):
                        handle = int(res.value[0, 0])
                        reused = self._values[handle]
                        req.blocks_semantic += 1
            if reused is not None:
                self._splice_block(cache, reused, i)
                lengths = lengths + Bk
                logits = None                          # stale; recomputed later
            else:
                req.blocks_computed += 1
                logits, cache, lengths = self.model.prefill_chunk(
                    torch.as_tensor(block_toks[None, :], device=self.device),
                    cache, lengths)
                if not last:
                    block_kv = self._extract_block(cache, i)
                    key = content_hash((i, block_toks.tobytes()))
                    self.exact.put(key, block_kv)
                    if self.semantic_enabled:
                        handle = len(self._values)
                        self._values.append(block_kv)
                        self._sem_cache(i).insert(
                            self._desc(block_toks),
                            torch.full((1, 1), handle, dtype=torch.int32,
                                       device=self.device))

        self.stats.blocks_exact += req.blocks_exact
        self.stats.blocks_semantic += req.blocks_semantic
        self.stats.blocks_computed += req.blocks_computed
        return logits[0], cache, lengths, dataclasses.asdict(req)
