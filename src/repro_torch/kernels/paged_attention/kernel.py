"""ctypes wrapper of the CUDA paged-attention kernel
(``csrc/paged_attention.cu``), which replaces the TPU
``paged_attention_kernel``.

The kernel reads q and writes the output in the model's (B, C, H, D)
layout, so the wrapper folds no heads.  It checks device, dtype, shape
and contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises on a launch error, and counts the launch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import LAUNCHES, check, load

D_MAX = 128              # head_dim the kernel's register tiles hold

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = load("paged_attention").paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                       _I, _I, ctypes.c_float, _I, _VP]
        fn.restype = ctypes.c_int
    return fn


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q (B, C, H, D) f32/bf16; k/v_pages (P, page, K, D) of q's dtype;
    block_table (B, n_pages) int32; lengths (B,) int32 -> (B, C, H, D)."""
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
        if tuple(t.shape) != shape:
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
    if H % K or D > D_MAX:
        raise ValueError(f"need H % K == 0 and D <= {D_MAX} (H={H}, K={K}, "
                         f"D={D})")
    out = torch.empty_like(q)
    if B and C:
        err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_table.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), B, C, H, K, D, P, page, n_pages,
                    float(1.0 / np.sqrt(D)), int(q.dtype == torch.bfloat16),
                    torch.cuda.current_stream(q.device).cuda_stream)
        check("paged_attention", err, "paged_attention")
        LAUNCHES["paged_attention"] += 1
    return out
