"""ctypes wrapper of the CUDA flash-decode kernel
(``csrc/decode_attention.cu``), which replaces the TPU
``decode_attention_kernel``.

The kernel reads the cache in its sequence-major (B, S, K, D) layout, so
the wrapper copies nothing.  It checks the inputs, allocates the output
and the fp32 split scratch (one (m, l) pair and D partial sums per
(row, KV head, split of the cache, group head)) with ``torch.empty``,
launches on the current stream (a split pass and a merge pass), raises on
a launch error, and counts the launch in ``LAUNCHES["decode_attention"]``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import LAUNCHES, check, load
from repro_torch.kernels.flash_attention.kernel import check_attention_inputs

G_MAX = 16               # query heads per KV head one block holds

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 7 + [_I] * 5 + [ctypes.c_float, _I, _VP]
        fn.restype = ctypes.c_int
        lib.decode_attention_chunk.argtypes = []
        lib.decode_attention_chunk.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, H, D), k/v (B, S, K, D) f32/bf16, kv_len (B,) int32 ->
    (B, H, D)."""
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    check_attention_inputs(q, (("q", q, (B, H, D)),
                               ("k", k, (B, S, K, D)),
                               ("v", v, (B, S, K, D)),
                               ("kv_len", kv_len, (B,))))
    if kv_len.dtype != torch.int32:
        raise TypeError(f"kv_len: dtype {kv_len.dtype} != int32")
    if H % K or H // K > G_MAX:
        raise ValueError(f"need H % K == 0 and H / K <= {G_MAX} (H={H}, "
                         f"K={K})")
    out = torch.empty_like(q)
    if B and H and S:
        lib = _lib()
        n_split = -(-S // lib.decode_attention_chunk())
        rows = B * K * n_split * (H // K)
        ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
        acc = torch.empty(rows * D, dtype=torch.float32, device=q.device)
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            ml.data_ptr(), acc.data_ptr(), out.data_ptr(), B, S, H, K, D,
            float(1.0 / np.sqrt(D)), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
        check("decode_attention", err, "decode_attention")
        LAUNCHES["decode_attention"] += 1
    return out
