"""ctypes wrappers of the CUDA similarity top-k kernel (``csrc/similarity.cu``).

One C entry point serves the three TPU kernels it replaces
(``similarity_topk_batched_kernel``, ``similarity_lookup_kernel``,
``similarity_topk_touch_kernel``).  The wrappers check device, dtype,
shape and contiguity, allocate the outputs with ``torch.empty``, launch on
``torch.cuda.current_stream()``, raise on a launch error, and count the
launch in ``LAUNCHES``.  Padding and layout are ``ops.py``'s job.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import LAUNCHES, check, load

K_MAX = 32               # largest k the kernel's register top-k holds
_MAX_SMEM = 227 * 1024   # shared memory a block may use on Hopper

_VP = ctypes.c_void_p


def _fn():
    fn = load("similarity").similarity_topk_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP, _VP, _VP, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP,
                       _VP, _VP, _VP, _VP, ctypes.c_float, ctypes.c_int,
                       _VP]
        fn.restype = ctypes.c_int
    return fn


def _need(t: torch.Tensor, name: str, dtypes, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor "
                         f"(got {t.device})")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_MASK_DTYPES = (torch.bool, torch.uint8, torch.int8)


def _launch(name, queries, keys, valid, k, *, qmask=None, last_used=None,
            freq=None, clock=None, threshold=0.0):
    N, Q, D = queries.shape
    C = keys.shape[1]
    _need(queries, "queries", (torch.float32,), (N, Q, D))
    _need(keys, "keys", (torch.float32,), (N, C, D))
    _need(valid, "valid", _MASK_DTYPES, (N, C))
    if not 1 <= k <= min(K_MAX, C):
        raise ValueError(f"k={k} must be in [1, min({K_MAX}, C={C})]")
    if D * 4 + 8 * K_MAX * 8 > _MAX_SMEM:
        raise ValueError(f"D={D} does not fit the kernel's shared memory")
    dev = queries.device
    idx = torch.empty((N, Q, k), dtype=torch.int32, device=dev)
    score = torch.empty((N, Q, k), dtype=torch.float32, device=dev)
    touch = qmask is not None
    if touch:
        _need(qmask, "qmask", _MASK_DTYPES, (Q,))
        _need(last_used, "last_used", (torch.int32,), (C,))
        _need(freq, "freq", (torch.int32,), (C,))
        _need(clock, "clock", (torch.int32,), (1,))
    if N and Q:
        ptr = lambda t: None if t is None else t.data_ptr()     # noqa: E731
        err = _fn()(queries.data_ptr(), keys.data_ptr(), valid.data_ptr(),
                    N, Q, C, D, k, idx.data_ptr(), score.data_ptr(),
                    ptr(qmask), ptr(last_used), ptr(freq), ptr(clock),
                    float(threshold), int(touch),
                    torch.cuda.current_stream(dev).cuda_stream)
        check("similarity", err, name)
        LAUNCHES[name] += 1
    return idx, score


def similarity_topk_batched_cuda(queries, keys, valid, k: int):
    """queries (N, Q, D) f32, keys (N, C, D) f32, valid (N, C) bool/u8 ->
    (idx (N, Q, k) int32, score (N, Q, k) f32)."""
    return _launch("similarity_topk_batched", queries, keys, valid, k)


def similarity_lookup_cuda(queries, keys, valid):
    """queries (Q, D), keys (C, D), valid (C,) -> (idx (Q,) int32, score
    (Q,) f32); an all-invalid row gives idx 0, score -1e30."""
    idx, score = _launch("similarity_lookup", queries[None], keys[None],
                         valid[None], 1)
    return idx[0, :, 0], score[0, :, 0]


def similarity_topk_touch_cuda(queries, qmask, keys, valid, last_used, freq,
                               clock, k: int, threshold: float):
    """queries (Q, D), qmask (Q,), keys (C, D), valid (C,), last_used/freq
    (C,) int32, clock (1,) int32 -> (idx (Q, k), score (Q, k), last_used,
    freq).  The metadata comes back as new tensors (the kernel updates
    clones), as the reference op is functional."""
    last_used = last_used.clone()
    freq = freq.clone()
    idx, score = _launch("similarity_topk_touch", queries[None], keys[None],
                         valid[None], k, qmask=qmask, last_used=last_used,
                         freq=freq, clock=clock, threshold=threshold)
    return idx[0], score[0], last_used, freq
