"""ctypes wrapper of the CUDA flash-decode kernel
(``csrc/decode_attention.cu``), which replaces the TPU
``decode_attention_kernel``.

The kernel reads the cache in its sequence-major (B, S, K, D) layout, so
the wrapper copies nothing.  It checks the inputs, allocates the output
with ``torch.empty``, launches on the current stream (a split pass and,
when the cache is split, a merge pass), raises on a launch error, and
counts one launch per call in ``LAUNCHES["decode_attention"]``, or in
``LAUNCHES["decode_attention_lse"]`` for a call that also asks for each
row's log-sum-exp (``return_lse``: the sequence-sharded decode's route).  How the
cache is split (``decode_plan``) depends on the shapes alone and is
looked up once per shape; the split pass's workspace is the one buffer
per device and stream of ``_build.workspace``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels._build import (LAUNCHES, check, load, sm_count,
                                        workspace)
from repro_torch.kernels.flash_attention.kernel import check_attention_inputs

G_MAX = 64               # query heads per KV head (granite-20b has 48)
TILE = 32                # slots of one shared-memory tile (csrc kTile)
STAGES = 3               # depth of the kernel's cp.async ring (csrc kStages)
ROWS = {False: 4, True: 16}  # query rows a block holds (fp32 FMA, bf16 mma)
SMEM_PER_SM = 228 * 1024     # H100: shared memory of an SM, 1 KB per block
BLOCKS_PER_SM = 4            # the kernels' __launch_bounds__ minimum

_VP = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = load("decode_attention").decode_attention_launch
    fn.argtypes = [_VP] * 7 + [_I] * 6 + [ctypes.c_float, _I, _VP]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, S: int, K: int, G: int, D: int, bf16: bool,
                sms: int) -> tuple:
    """(n_split, workspace entries): split s of a row takes the cache's
    tiles of ``TILE`` slots s, s + n_split, s + 2 n_split, ..., about one
    wave of blocks on ``sms`` SMs for a full cache; the workspace holds
    each split's fp32 (m, l) and D partial sums per (row, KV head, group
    head), and is 0 for one split."""
    es = 2 if bf16 else 4
    dp = max(32, 1 << (D - 1).bit_length())      # head_dim padded
    ring = STAGES * 2 * TILE * (dp + 16 // es) * es
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (ring + 1024))
    blocks = B * K * -(-G // ROWS[bf16])
    tiles = max(1, -(-S // TILE))
    n_split = max(1, min(tiles, per_sm * sms // blocks))
    ws = 0 if n_split == 1 else B * K * n_split * G * (2 + D)
    return n_split, ws


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor, return_lse: bool = False):
    """q (B, H, D), k/v (B, S, K, D) f32/bf16, kv_len (B,) int32 ->
    (B, H, D); with ``return_lse`` also lse (B, H) fp32, the natural-log
    log-sum-exp of each row's scaled logits over its valid slots (-inf
    where there is none)."""
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
    lse = (torch.full((B, H), float("-inf"), dtype=torch.float32,
                      device=q.device) if return_lse else None)
    if B and H and S:
        bf16 = q.dtype == torch.bfloat16
        dev = q.get_device()
        n_split, n = decode_plan(B, S, K, H // K, D, bf16, sm_count(dev))
        stream = torch._C._cuda_getCurrentRawStream(dev)
        ws = workspace(q, stream, n).data_ptr() if n else None
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_len.data_ptr(), ws, out.data_ptr(),
                    None if lse is None else lse.data_ptr(), B, S, H, K, D,
                    n_split, float(1.0 / np.sqrt(D)), int(bf16), stream)
        check("decode_attention", err, "decode_attention")
        LAUNCHES["decode_attention_lse" if return_lse
                 else "decode_attention"] += 1
    return (out, lse) if return_lse else out
