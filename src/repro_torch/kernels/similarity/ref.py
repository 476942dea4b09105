"""Plain PyTorch versions of the edge-cache similarity ops.

Each mirrors ``repro/kernels/similarity/ref.py``: the CPU tests hold it
against the JAX oracle, and ``chip_smoke.py`` holds the CUDA kernel
against it.  The top-k order is ``lax.top_k``'s — descending score, ties
to the lower cache index — taken with a stable descending sort, since
``torch.topk`` promises no order among ties.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30          # score of an invalid slot (finite, as in the kernels)
_INT32_MIN = -(2 ** 31)


def similarity_lookup_ref(queries: torch.Tensor, keys: torch.Tensor,
                          valid: torch.Tensor):
    """queries: (Q, D); keys: (C, D); valid: (C,) bool.

    Returns (best_idx (Q,) int32, best_score (Q,) f32) — the argmax cosine
    similarity over valid cache slots (first occurrence on ties).  Invalid
    slots score -inf; if no slot is valid the score is -inf and idx is 0
    (the CUDA kernel reports -1e30 there; callers threshold either away)."""
    scores = torch.einsum("qd,cd->qc", queries.float(), keys.float())
    scores = torch.where(valid.bool()[None, :], scores, float("-inf"))
    best_idx = torch.argmax(scores, dim=1).to(torch.int32)
    best_score = scores.max(dim=1).values
    return best_idx, best_score


def _topk_desc(scores: torch.Tensor, k: int):
    """``lax.top_k`` along the last dim: (values, int32 indices)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def similarity_topk_ref(queries: torch.Tensor, keys: torch.Tensor,
                        valid: torch.Tensor, k: int):
    """Top-k.  queries: (Q, D); keys: (C, D); valid: (C,) bool.

    Returns (idx (Q, k) int32, score (Q, k) f32), scores descending, ties
    toward the lower cache index.  Invalid slots score ``NEG_INF``, so an
    all-invalid row returns indices 0..k-1."""
    scores = torch.einsum("qd,cd->qc", queries.float(), keys.float())
    scores = torch.where(valid.bool()[None, :], scores, NEG_INF)
    vals, idx = _topk_desc(scores, k)
    return idx, vals


def similarity_topk_touch_ref(queries: torch.Tensor, keys: torch.Tensor,
                              valid: torch.Tensor, k: int,
                              last_used: torch.Tensor, freq: torch.Tensor,
                              clock, threshold: float, mask=None):
    """Unfused top-k + LRU touch: ``similarity_topk_ref``, then every query
    whose top-1 score clears ``threshold`` (and whose ``mask`` row is True)
    raises its winning slot's ``last_used`` to ``clock`` and adds 1 to its
    ``freq`` (duplicate winners accumulate).  Returns new (idx, score,
    last_used, freq); the inputs are left as they were."""
    idx, score = similarity_topk_ref(queries, keys, valid, k)
    hit = score[:, 0] >= threshold
    if mask is not None:
        hit = hit & mask.bool()
    win = idx[:, 0].long()
    clock = torch.as_tensor(clock, dtype=torch.int32, device=hit.device)
    # a masked-out row scatters INT32_MIN / 0: the JAX ref's dropped write
    last_used = last_used.to(torch.int32).scatter_reduce(
        0, win, torch.where(hit, clock, _INT32_MIN).to(torch.int32),
        reduce="amax", include_self=True)
    freq = freq.to(torch.int32).index_add(0, win, hit.to(torch.int32))
    return idx, score, last_used, freq


def similarity_topk_batched_ref(queries: torch.Tensor, keys: torch.Tensor,
                                valid: torch.Tensor, k: int):
    """Grouped top-k: queries (N, Q, D), keys (N, C, D), valid (N, C) —
    group ``n`` is scored against key matrix ``n`` only (keys (C, D): one
    matrix shared by every group).  Returns (idx (N, Q, k) int32, score
    (N, Q, k) f32) with ``similarity_topk_ref`` semantics per group."""
    eq = "nqd,cd->nqc" if keys.dim() == 2 else "nqd,ncd->nqc"
    scores = torch.einsum(eq, queries.float(), keys.float())
    scores = torch.where(valid.bool()[:, None, :], scores, NEG_INF)
    vals, idx = _topk_desc(scores, k)
    return idx, vals
