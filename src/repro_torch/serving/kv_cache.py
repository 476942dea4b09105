"""KV-cache management for continuous batching.

The port of ``repro/serving/kv_cache.py``.  The slotted batch cache
(``kv_page == 0``) is one row of ``(layers, B, ...)`` leaves per slot,
filled by ``batch_cache_insert`` / ``batch_cache_scatter`` (in place),
which overwrite a row whole (an SSM layer's conv and state too).
In the paged layout every seq-indexed leaf is a physical page pool
``(layers, P, page, ...)``
shared by all slots through per-slot block tables (the vLLM layout).
Pages are REFCOUNTED, and a per-offset prefix index (exact content hash,
plus an optional n-gram-sketch approximate path) lets a newly admitted
prompt map the already computed KV pages of a shared head instead of
recomputing its prefill.  See the reference for the safety invariants;
they hold unchanged: sharing is page-granular and capped so every request
computes at least its last prompt token, ``ensure_private`` is the
copy-on-write guard, the index holds no references, and block-table entry
``INVALID`` is the out-of-bounds sink.  All bookkeeping is numpy.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.descriptor import NgramSketchDescriptor
from repro_torch.core.hash_cache import content_hash
from repro_torch.core.layer_reuse import SemOffsetEntry
from repro_torch.core.policies import EvictionPolicy
from repro_torch.core.semantic_cache import SemanticCache
from repro_torch.obs.metrics import MetricsRegistry


def init_batch_cache(model, batch: int, max_len: int
                     ) -> Dict[str, torch.Tensor]:
    """Zero slotted cache leaves on the model's device, one row per slot
    along axis 1 (``model.cache_specs``: attention ``(R, batch, Sk, K,
    Dh)`` with Sk = max_len or the sliding window's ring, MLA's latent
    ``(R, batch, max_len, r)``, SSM ``conv`` / fp32 ``state``)."""
    return {k: torch.zeros(shape, dtype=dtype, device=model.device)
            for k, (shape, dtype) in model.cache_specs(batch,
                                                       max_len).items()}


def _write_rows(dst: torch.Tensor, src: torch.Tensor, slots) -> None:
    """``dst[:, slots] = src`` in place, src zero-padded along its trailing
    dims (a prefill cache may hold fewer positions than the batch cache:
    the tail stays zero, masked out by per-row lengths)."""
    idx = torch.as_tensor(slots, dtype=torch.long, device=dst.device)
    if tuple(src.shape[2:]) != tuple(dst.shape[2:]):
        dst[:, idx] = 0
    region = (slice(None), idx) + tuple(slice(0, n) for n in src.shape[2:])
    dst[region] = src.to(dst.dtype)


def batch_cache_insert(batch_cache: Dict[str, torch.Tensor],
                       one_cache: Dict[str, torch.Tensor], slot: int
                       ) -> Dict[str, torch.Tensor]:
    """Write a B=1 prefill cache into slot ``slot`` of the batch cache, in
    place (the reference returns a new cache); returns ``batch_cache``."""
    for k, dst in batch_cache.items():
        _write_rows(dst, one_cache[k], [int(slot)])
    return batch_cache


def batch_cache_scatter(batch_cache: Dict[str, torch.Tensor],
                        many_cache: Dict[str, torch.Tensor], slots
                        ) -> Dict[str, torch.Tensor]:
    """Scatter rows of a B=R bucketed prefill cache into ``slots`` (R,) of
    the batch cache, in place (the reference returns a new cache); returns
    ``batch_cache``.  Slots must be UNIQUE: the reference's scatter keeps
    an arbitrary one of colliding rows, so duplicates raise, as there."""
    slots_np = np.asarray(slots, np.int32)
    uniq, counts = np.unique(slots_np, return_counts=True)
    if (counts > 1).any():
        raise ValueError("batch_cache_scatter: duplicate target slots "
                         f"{uniq[counts > 1].tolist()} in {slots_np.tolist()}"
                         " — colliding rows would silently overwrite each "
                         "other")
    for k, dst in batch_cache.items():
        _write_rows(dst, many_cache[k], slots_np)
    return batch_cache


def init_paged_pool(model, num_pages: int, page_size: int
                    ) -> Dict[str, torch.Tensor]:
    """Zero-initialized physical page pools for every seq-indexed leaf, on
    the model's device."""
    return {k: torch.zeros(shape, dtype=dtype, device=model.device)
            for k, (shape, dtype)
            in model.paged_cache_specs(num_pages, page_size).items()}


class PagedStats:
    """Paged-KV sharing counters, registry-backed: ``stats.pages_shared
    += n`` routes into the ``kv/pages_shared`` counter."""

    FIELDS = ("shared_maps",        # admissions that mapped >= 1 page
              "pages_shared",       # total pages mapped instead of computed
              "tokens_shared",      # page-aligned prompt tokens not computed
              "pages_registered",   # full pages published to the index
              "cow_copies",         # copy-on-write page duplications
              "sem_maps")           # pages mapped via the sketch path

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 prefix: str = "kv"):
        m = metrics if metrics is not None else MetricsRegistry()
        object.__setattr__(self, "_counters",
                           {f: m.counter(f"{prefix}/{f}")
                            for f in self.FIELDS})

    def __getattr__(self, name):
        try:
            return self._counters[name].value
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        c = self._counters.get(name)
        if c is None:
            raise AttributeError(f"PagedStats has no counter {name!r}")
        c.set(int(value))

    def as_dict(self) -> dict:
        return {f: c.value for f, c in self._counters.items()}


class PagedKVCache:
    """Host-side manager of the paged KV pool: block tables, page
    refcounts, the free list, and the per-offset prefix index.  The pool
    tensors are owned by the engine; this class decides WHICH physical
    page every (slot, logical page) maps to.

    ``prefix_mode``: ``"exact"`` probes a content hash of the FULL prefix
    through each page boundary; ``"semantic"`` additionally probes a
    per-offset n-gram sketch at ``threshold`` (on ``device``), fenced by a
    per-page generation counter so a recycled page never serves old
    content."""

    INVALID = np.int32(2 ** 30)      # out-of-bounds sink (drop/clamp)

    def __init__(self, model, max_batch: int, max_len: int, page_size: int,
                 *, num_pages: int = 0, prefix_share: bool = True,
                 prefix_mode: str = "exact", threshold: float = 0.98,
                 descriptor_dim: int = 64, sem_capacity_per_offset: int = 128,
                 metrics: Optional[MetricsRegistry] = None):
        assert max_len % page_size == 0, (max_len, page_size)
        assert prefix_mode in ("exact", "semantic"), prefix_mode
        self.page = page_size
        self.pages_per_slot = max_len // page_size
        need = max_batch * self.pages_per_slot
        # headroom so freed prefix pages linger in the index before recycle
        self.num_pages = num_pages or 2 * need
        assert self.num_pages >= need, (self.num_pages, need)
        self.max_batch = max_batch
        self.prefix_share = prefix_share
        self.prefix_mode = prefix_mode
        self.device = model.device

        self.block_table = np.full((max_batch, self.pages_per_slot),
                                   self.INVALID, np.int32)
        self.refcount = np.zeros((self.num_pages,), np.int32)
        self._free: deque = deque(range(self.num_pages))
        self._in_free = np.ones((self.num_pages,), bool)
        self._gen = np.zeros((self.num_pages,), np.int64)

        # exact per-offset prefix index: (logical page, hash of the FULL
        # prefix through the page's end) -> physical page; reverse map for
        # lazy invalidation on recycle
        self._exact: Dict[Tuple[int, str], int] = {}
        self._keys_of: Dict[int, List[Tuple[int, str]]] = {}
        self._sem: Dict[int, SemOffsetEntry] = {}
        self._sketch = None
        if prefix_mode == "semantic":
            self._sketch = NgramSketchDescriptor(dim=descriptor_dim)
            self._sem_capacity = sem_capacity_per_offset
            self._descriptor_dim = descriptor_dim
            self._threshold = threshold
        self.stats = PagedStats(metrics)

    # ------------------------------------------------------------------
    # free-list plumbing
    # ------------------------------------------------------------------
    def _release(self, pid: int) -> None:
        if not self._in_free[pid]:
            self._free.append(pid)
            self._in_free[pid] = True

    def _acquire(self) -> int:
        while self._free:
            pid = self._free.popleft()
            self._in_free[pid] = False
            if self.refcount[pid] == 0:
                self._invalidate(pid)
                return pid
            # page was re-shared out of the free list; drop the stale entry
        raise RuntimeError("paged KV pool exhausted — size the pool at "
                           ">= max_batch * pages_per_slot physical pages")

    def _invalidate(self, pid: int) -> None:
        """Forget every exact index entry naming ``pid``; semantic entries
        are fenced by the generation bump."""
        for key in self._keys_of.pop(pid, ()):
            if self._exact.get(key) == pid:
                del self._exact[key]
        self._gen[pid] += 1

    # ------------------------------------------------------------------
    # admission / retirement
    # ------------------------------------------------------------------
    def admit(self, slot: int, prompt: np.ndarray) -> int:
        """Build ``slot``'s block table for ``prompt``: map index-resident
        shareable full pages (refcount bump), then allocate private pages
        for the rest of the slot's span.  Returns the prompt tokens covered
        by shared pages — the prefill the engine skips."""
        assert (self.block_table[slot] == self.INVALID).all(), \
            f"slot {slot} already mapped"
        shared = self._probe(prompt) if self.prefix_share else []
        for j, pid in enumerate(shared):
            self.block_table[slot, j] = pid
            self.refcount[pid] += 1
        for j in range(len(shared), self.pages_per_slot):
            pid = self._acquire()
            self.block_table[slot, j] = pid
            self.refcount[pid] += 1
        if shared:
            self.stats.shared_maps += 1
            self.stats.pages_shared += len(shared)
            self.stats.tokens_shared += len(shared) * self.page
        return len(shared) * self.page

    def free_slot(self, slot: int) -> None:
        """Drop ``slot``'s references; pages at refcount 0 join the free
        list but stay probe-able until recycled."""
        for pid in self.block_table[slot]:
            if pid == self.INVALID:
                continue
            pid = int(pid)
            self.refcount[pid] -= 1
            assert self.refcount[pid] >= 0, pid
            if self.refcount[pid] == 0:
                self._release(pid)
        self.block_table[slot, :] = self.INVALID

    # ------------------------------------------------------------------
    # prefix index
    # ------------------------------------------------------------------
    def _max_shareable(self, prompt_len: int) -> int:
        """Full pages a prompt may map: the last token is always computed."""
        return max(0, (prompt_len - 1) // self.page)

    def _probe(self, prompt: np.ndarray) -> List[int]:
        """Longest run of index-resident full pages from offset 0."""
        out: List[int] = []
        for j in range(self._max_shareable(len(prompt))):
            end = (j + 1) * self.page
            pid = self._exact.get((j, content_hash(prompt[:end].tobytes())))
            if pid is None and self._sketch is not None:
                pid = self._probe_semantic(j, prompt[:end])
                if pid is not None:
                    self.stats.sem_maps += 1
            if pid is None:
                break
            out.append(pid)
        return out

    def _sem_entry(self, offset: int) -> SemOffsetEntry:
        if offset not in self._sem:
            cache = SemanticCache(capacity=self._sem_capacity,
                                  key_dim=self._descriptor_dim,
                                  payload_dim=2, threshold=self._threshold,
                                  payload_dtype="int32",
                                  policy=EvictionPolicy("lru"))
            self._sem[offset] = SemOffsetEntry(cache,
                                               cache.init(self.device))
        return self._sem[offset]

    def _sketch_of(self, prefix: np.ndarray) -> torch.Tensor:
        return self._sketch(torch.as_tensor(prefix[None, :],
                                            device=self.device))

    def _probe_semantic(self, offset: int, prefix: np.ndarray
                        ) -> Optional[int]:
        res = self._sem_entry(offset).lookup(self._sketch_of(prefix))
        if not bool(res.hit[0]):
            return None
        pid, gen = (int(v) for v in res.value[0].tolist())
        # generation fence: a recycled page must never serve old content
        if self._gen[pid] != gen:
            return None
        return pid

    def register(self, slot: int, prompt: np.ndarray, from_page: int = 0
                 ) -> int:
        """Publish ``slot``'s COMPUTED full pages (logical pages
        ``from_page``..) to the prefix index.  Holds no refcount."""
        n = 0
        for j in range(from_page, len(prompt) // self.page):
            pid = int(self.block_table[slot, j])
            key = (j, content_hash(prompt[:(j + 1) * self.page].tobytes()))
            if key in self._exact:
                continue
            self._exact[key] = pid
            self._keys_of.setdefault(pid, []).append(key)
            if self._sketch is not None:
                self._sem_entry(j).insert(
                    self._sketch_of(prompt[:(j + 1) * self.page]),
                    torch.tensor([[pid, int(self._gen[pid])]],
                                 dtype=torch.int32, device=self.device))
            n += 1
        self.stats.pages_registered += n
        return n

    # ------------------------------------------------------------------
    # copy-on-write
    # ------------------------------------------------------------------
    def ensure_private(self, pool: Dict[str, torch.Tensor], slot: int,
                       logical_page: int) -> Dict[str, torch.Tensor]:
        """Copy-on-write guard: if ``slot``'s ``logical_page`` maps a page
        other slots also reference, remap it to a fresh copy.  The copy is
        written into ``pool`` IN PLACE (the reference returned a new pool);
        the same dict comes back."""
        pid = int(self.block_table[slot, logical_page])
        if pid == self.INVALID or self.refcount[pid] <= 1:
            return pool
        new = self._acquire()
        for v in pool.values():
            v[:, new] = v[:, pid]
        self.refcount[pid] -= 1
        self.refcount[new] += 1
        self.block_table[slot, logical_page] = new
        self.stats.cow_copies += 1
        return pool

    # ------------------------------------------------------------------
    # dispatch views
    # ------------------------------------------------------------------
    def table_rows(self, slots: List[int]) -> np.ndarray:
        """(len(slots), pages_per_slot) block-table rows for a dispatch: a
        copy, int32 ``np.ndarray`` as the reference's (the table lives on
        the host here too)."""
        return self.block_table[np.asarray(slots, np.int32)].copy()

    def decode_table(self, row_active: np.ndarray) -> np.ndarray:
        """(B, pages_per_slot) table for the batched decode: inactive rows
        are masked INVALID so their junk decode write drops."""
        bt = self.block_table.copy()
        bt[~np.asarray(row_active, bool), :] = self.INVALID
        return bt

    # ------------------------------------------------------------------
    def stats_dict(self) -> dict:
        out = self.stats.as_dict()
        out.update(num_pages=int(self.num_pages), page_size=int(self.page),
                   pages_in_use=int((self.refcount > 0).sum()),
                   refcount_max=int(self.refcount.max(initial=0)),
                   index_entries=len(self._exact))
        return out
