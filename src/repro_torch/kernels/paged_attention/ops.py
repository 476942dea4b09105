"""Public wrapper for paged attention: backend selection and byte model.

``paged_attention`` takes queries in the model's (B, C, H, D) layout and
the pool leaves exactly as ``paged_cache_specs`` stores them — no caller
builds the gathered ``(B, max_len)`` view.  ``impl="auto"`` launches the
CUDA kernel for CUDA tensors and runs the plain version for CPU tensors;
``impl="ref"`` forces the plain version, ``impl="cuda"`` the kernel.

``attention_kv_bytes_per_step`` is the shared byte model (a copy of the
reference's): the gathered path pays a pool gather read + a dense copy
write + the attention read of the copy, the in-place kernel one pass over
the mapped pages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.similarity.ops import resolve_impl
from repro_torch.obs.profile import active, record_op


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *, impl: str = "auto"
                    ) -> torch.Tensor:
    """In-place paged GQA attention for decode (C == 1) and chunked prefill.

    q: (B, C, H, D) chunk queries at absolute positions ``lengths + c``;
    k/v_pages: (P, page, K, D) physical page pools (H % K == 0);
    block_table: (B, n_pages) int32, entries >= P INVALID (skipped);
    lengths: (B,) int32 per-row fill before this dispatch.
    Returns (B, C, H, D)."""
    impl = resolve_impl(impl, q)
    if impl == "ref":
        fn = paged_attention_ref
    else:
        def fn(q, kp, vp, bt, ln):
            return paged_attention_cuda(
                q.contiguous(), kp.contiguous(), vp.contiguous(),
                bt.to(torch.int32).contiguous(),
                ln.to(torch.int32).contiguous())
    args = (q, k_pages, v_pages, block_table, lengths)
    if active() is None:
        return fn(*args)
    P, page, K, D = (int(s) for s in k_pages.shape)
    modeled = attention_kv_bytes_per_step(
        np.minimum(lengths.cpu().numpy() + int(q.shape[1]),
                   page * int(block_table.shape[1])),
        page_size=page, max_len=page * int(block_table.shape[1]),
        kv_heads=K, head_dim=D, dtype_bytes=k_pages.element_size(),
        impl="paged")
    return record_op("paged_attention", impl, fn, args, modeled)


def attention_kv_bytes_per_step(kv_len, *, page_size: int, max_len: int,
                                kv_heads: int, head_dim: int,
                                dtype_bytes: int, impl: str) -> float:
    """Modeled device bytes ONE attention layer's k+v traffic moves in one
    dispatch over rows with ``kv_len`` (array-like) valid tokens each (idle
    rows: kv_len 0).  ``impl="gather"``: mapped + 2 * B * max_len
    token-rows per leaf; ``impl="paged"``: the mapped pages only."""
    kv_len = np.asarray(kv_len, np.int64)
    row_bytes = 2 * kv_heads * head_dim * dtype_bytes        # k + v per token
    mapped = np.ceil(kv_len / page_size).astype(np.int64) * page_size
    if impl == "gather":
        tokens = int(mapped.sum()) + 2 * kv_len.size * max_len
    elif impl == "paged":
        tokens = int(mapped.sum())
    else:
        raise ValueError(impl)
    return float(tokens * row_bytes)
