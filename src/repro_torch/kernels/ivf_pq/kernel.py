"""ctypes wrapper of the CUDA IVF-PQ probe (``csrc/ivf_pq.cu``), which
replaces the TPU kernel ``ivf_pq_probe_kernel``.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``,
raises on a launch error, and counts the launch in
``LAUNCHES["ivf_pq_probe"]``.  The C entry refuses (cudaErrorInvalidValue)
a launch whose shared-memory layout exceeds a block's 227 KiB.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import LAUNCHES, check, load
from repro_torch.kernels.similarity.kernel import _MASK_DTYPES, _need

K_MAX = 32               # largest k the kernel's top-k lists hold

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = load("ivf_pq").ivf_pq_probe_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 8 + [_I] * 7 + [_VP] * 4
        fn.restype = ctypes.c_int
    return fn


def ivf_pq_probe_cuda(queries, home, centroids, cent_valid, codes,
                      slot_valid, slot_owner, codebook, k: int,
                      n_probe: int):
    """queries (Q, D) f32, home (Q,) int32, centroids (L, D) f32,
    cent_valid (L,) bool/u8, codes (L, cap, S) uint8, slot_valid (L, cap)
    bool/u8, slot_owner (L, cap) int32, codebook (S, 256, D // S) f32 ->
    (idx (Q, k) int32, score (Q, k) f32, sel (Q, n_probe) int32)."""
    Q, D = queries.shape
    L, cap, S = codes.shape
    _need(queries, "queries", (torch.float32,), (Q, D))
    _need(home, "home", (torch.int32,), (Q,))
    _need(centroids, "centroids", (torch.float32,), (L, D))
    _need(cent_valid, "cent_valid", _MASK_DTYPES, (L,))
    _need(codes, "codes", (torch.uint8,), (L, cap, S))
    _need(slot_valid, "slot_valid", _MASK_DTYPES, (L, cap))
    _need(slot_owner, "slot_owner", (torch.int32,), (L, cap))
    if D % S:
        raise ValueError(f"D={D} is not a multiple of S={S}")
    _need(codebook, "codebook", (torch.float32,), (S, 256, D // S))
    if not 1 <= k <= min(K_MAX, L * cap):
        raise ValueError(f"k={k} must be in [1, min({K_MAX}, L*cap)]")
    if not 1 <= n_probe <= L:
        raise ValueError(f"n_probe={n_probe} must be in [1, L={L}]")
    dev = queries.device
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    score = torch.empty((Q, k), dtype=torch.float32, device=dev)
    sel = torch.empty((Q, n_probe), dtype=torch.int32, device=dev)
    if Q:
        err = _fn()(queries.data_ptr(), home.data_ptr(),
                    centroids.data_ptr(), cent_valid.data_ptr(),
                    codes.data_ptr(), slot_valid.data_ptr(),
                    slot_owner.data_ptr(), codebook.data_ptr(), Q, L, cap,
                    S, D, k, n_probe, idx.data_ptr(), score.data_ptr(),
                    sel.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
        check("ivf_pq", err, "ivf_pq_probe")
        LAUNCHES["ivf_pq_probe"] += 1
    return idx, score, sel
