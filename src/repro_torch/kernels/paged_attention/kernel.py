"""ctypes wrapper of the CUDA paged-attention kernel
(``csrc/paged_attention.cu``), which replaces the TPU
``paged_attention_kernel``.

The kernel reads q and writes the output in the model's (B, C, H, D)
layout, so the wrapper folds no heads.  It checks device, dtype, shape,
contiguity and alignment, allocates the output with ``torch.empty``,
launches on the current stream, raises on a launch error, and counts one
launch per call in ``LAUNCHES["paged_attention"]``, though a call whose
keys are split across blocks issues a split pass and a merge pass.  The
split pass's workspace is the one buffer per device and stream of
``_build.workspace``; its size per shape is looked up once.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels._build import LAUNCHES, check, load, workspace

D_MAX = 128              # head_dim the kernel's tiles hold

_VP = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = load("paged_attention").paged_attention_launch
    fn.argtypes = [_VP] * 7 + [_I] * 8 + [ctypes.c_float, _I, _VP]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _ws_entries(B: int, C: int, H: int, K: int, D: int, n_pages: int,
                page: int, bf16: bool) -> int:
    """fp32 entries of the split pass's (m, l, acc) partials (0: the keys
    are not split)."""
    fn = load("paged_attention").paged_attention_workspace_size
    fn.argtypes = [_I] * 8
    fn.restype = ctypes.c_longlong
    return fn(B, C, H, K, D, n_pages, page, int(bf16))


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q (B, C, H, D) f32/bf16; k/v_pages (P, page, K, D) of q's dtype;
    block_table (B, n_pages) int32; lengths (B,) int32 -> (B, C, H, D).
    head_dim a multiple of 8 up to ``D_MAX`` (16-byte row loads)."""
    B, C, H, D = q.shape
    P, page, K, _ = k_pages.shape
    n_pages = block_table.shape[1]
    for name, t, shape in (("q", q, (B, C, H, D)),
                           ("k_pages", k_pages, (P, page, K, D)),
                           ("v_pages", v_pages, (P, page, K, D)),
                           ("block_table", block_table, (B, n_pages)),
                           ("lengths", lengths, (B,))):
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor "
                             f"(got {t.device})")
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype} not float32/bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("k/v pages must have q's dtype "
                        f"({k_pages.dtype}, {v_pages.dtype} vs {q.dtype})")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    if H % K or D % 8 or D > D_MAX:
        raise ValueError(f"need H % K == 0 and head_dim a multiple of 8 up "
                         f"to {D_MAX} (H={H}, K={K}, D={D})")
    if (q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError("q and the k/v pages must be 16-byte aligned")
    out = torch.empty_like(q)
    if B and C:
        bf16 = q.dtype == torch.bfloat16
        stream = torch._C._cuda_getCurrentRawStream(q.get_device())
        n = _ws_entries(B, C, H, K, D, n_pages, page, bf16)
        ws = workspace(q, stream, n).data_ptr() if n else None
        err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_table.data_ptr(), lengths.data_ptr(), ws,
                    out.data_ptr(), B, C, H, K, D, P, page, n_pages,
                    float(1.0 / np.sqrt(D)), int(bf16), stream)
        check("paged_attention", err, "paged_attention")
        LAUNCHES["paged_attention"] += 1
    return out
