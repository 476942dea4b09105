"""Plain PyTorch paged attention: the gathered-view path the kernel replaces.

Mirrors ``repro/kernels/paged_attention/ref.py``: gather ``pool[block_table]``
into a dense per-row ``(B, n_pages * page)`` copy, mask by absolute
position, softmax in fp32.  JAX clamps an out-of-bounds gather; PyTorch
raises, so INVALID entries (>= P) are clamped to the last page explicitly
— junk the position mask hides (a row that sees no key at all averages it,
where the kernel gives zeros; such rows are idle slots whose output is
discarded).
"""
from __future__ import annotations

import numpy as np
import torch


def paged_gather_view(pool: torch.Tensor, block_table: torch.Tensor
                      ) -> torch.Tensor:
    """pool (P, page, ...) gathered through block_table (B, n_pages) into
    (B, n_pages * page, ...); entries >= P clamp to page P - 1."""
    P = pool.shape[0]
    view = pool[block_table.clamp(max=P - 1).long()]  # (B, n_pages, page, ..)
    B, n_pages, page = view.shape[:3]
    return view.reshape((B, n_pages * page) + tuple(view.shape[3:]))


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, C, H, D); k/v_pages: (P, page, K, D); block_table: (B,
    n_pages) int32; lengths: (B,) int32 row fill before the dispatch (query
    row c sits at absolute position lengths + c).  Returns (B, C, H, D)."""
    B, C, H, D = q.shape
    K = k_pages.shape[2]
    G = H // K
    scale = 1.0 / np.sqrt(D)
    ck = paged_gather_view(k_pages, block_table)          # (B, S, K, D)
    cv = paged_gather_view(v_pages, block_table)
    S = ck.shape[1]
    dev = q.device
    qpos = lengths.long()[:, None] + torch.arange(C, device=dev)[None, :]
    kpos = torch.arange(S, device=dev)[None, :]
    mask = kpos[:, None, :] <= qpos[:, :, None]           # (B, C, S)
    qg = q.reshape(B, C, K, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, ck).float() * scale
    logits = torch.where(mask[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, cv)
    return out.reshape(B, C, H, D).to(q.dtype)
