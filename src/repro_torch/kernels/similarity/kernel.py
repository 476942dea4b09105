"""ctypes wrappers of the CUDA similarity top-k kernel (``csrc/similarity.cu``).

One kernel serves the four TPU kernels it replaces
(``similarity_topk_batched_kernel``, ``similarity_lookup_kernel``,
``similarity_topk_touch_kernel`` through ``similarity_topk_launch``;
``similarity_topk_kernel`` through its own entry,
``similarity_topk_single_launch``).  Each entry makes two CUDA launches:
a score pass over tiles of the keys (and splits of D) that writes partial
dot products, and a merge that sums them and takes the top-k.  The
wrappers check device, dtype, shape and contiguity, allocate the outputs
with ``torch.empty``, launch on the current stream, raise on a launch
error, and count one launch per call in ``LAUNCHES``.  Padding and layout
are ``ops.py``'s job.  The kernels take microseconds, less than the host
takes to issue a call, so the wrappers keep their host work short: the
entry points and the workspace size per shape are looked up once, the
outputs are allocated in their final shapes (no views on the way out),
and the score pass's workspace is the one buffer per device and stream
of ``_build.workspace``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import LAUNCHES, check, load, workspace

K_MAX = 32               # largest k (the merge reads every row once per place)

_VP = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = load("similarity").similarity_topk_launch
    fn.argtypes = [_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _VP, _VP,
                   _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_float, _I, _I,
                   _VP]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _single_fn():
    fn = load("similarity").similarity_topk_single_launch
    fn.argtypes = [_VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP, _VP, _VP]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _ws_entries(NQ: int, C: int, D: int) -> int:
    """fp32 entries of the score pass's partial dot products (D splits,
    NQ, C), which the merge pass sums."""
    fn = load("similarity").similarity_workspace_size
    fn.argtypes = [_I, _I, _I]
    fn.restype = ctypes.c_longlong
    return fn(NQ, C, D)


def _need(t: torch.Tensor, name: str, dtypes, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor "
                         f"(got {t.device})")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_MASK_DTYPES = (torch.bool, torch.uint8, torch.int8)
_F32 = (torch.float32,)
_I32 = (torch.int32,)


def _check_k(k, C):
    if not 1 <= k <= min(K_MAX, C):
        raise ValueError(f"k={k} must be in [1, min({K_MAX}, C={C})]")


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _launch(name, queries, keys, valid, N, Q, k, out_shape, touch=None,
            threshold=0.0):
    """Allocates the outputs and the workspace, launches and counts.
    ``queries`` holds N * Q rows of D and ``valid`` N rows of C (their
    shapes checked by the caller); ``keys`` is (N, C, D), or (C, D) shared
    by every group.  ``touch``: (qmask, last_used_in, freq_in, last_used,
    freq, clock)."""
    C, D = keys.shape[-2], keys.shape[-1]
    shared = keys.dim() == 2
    _need(keys, "keys", _F32, (C, D) if shared else (N, C, D))
    _check_k(k, C)
    dev = queries.device
    idx = torch.empty(out_shape, dtype=torch.int32, device=dev)
    score = torch.empty(out_shape, dtype=torch.float32, device=dev)
    if N and Q:
        stream = _stream(queries)
        ws = workspace(queries, stream, _ws_entries(N * Q, C, D))
        meta = ((None,) * 6 if touch is None
                else tuple(t.data_ptr() for t in touch))
        err = _fn()(queries.data_ptr(), keys.data_ptr(), valid.data_ptr(),
                    N, Q, C, D, k, ws.data_ptr(), idx.data_ptr(),
                    score.data_ptr(), *meta, float(threshold),
                    touch is not None, shared, stream)
        check("similarity", err, name)
        LAUNCHES[name] += 1
    return idx, score


def similarity_topk_batched_cuda(queries, keys, valid, k: int):
    """queries (N, Q, D) f32, keys (N, C, D) f32 — or (C, D), one matrix
    shared by every group — valid (N, C) bool/u8 -> (idx (N, Q, k) int32,
    score (N, Q, k) f32)."""
    N, Q, D = queries.shape
    _need(queries, "queries", _F32, (N, Q, D))
    _need(valid, "valid", _MASK_DTYPES, (N, keys.shape[-2]))
    return _launch("similarity_topk_batched", queries, keys, valid, N, Q, k,
                   (N, Q, k))


def similarity_topk_cuda(queries, keys, valid, k: int):
    """The single-matrix top-k: queries (Q, D) f32, keys (C, D) f32, valid
    (C,) bool/u8 -> (idx (Q, k) int32, score (Q, k) f32); an all-invalid
    row gives indices 0..k-1 at -1e30."""
    Q, D = queries.shape
    C = keys.shape[0]
    _need(queries, "queries", _F32, (Q, D))
    _need(keys, "keys", _F32, (C, D))
    _need(valid, "valid", _MASK_DTYPES, (C,))
    _check_k(k, C)
    dev = queries.device
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    score = torch.empty((Q, k), dtype=torch.float32, device=dev)
    if Q:
        stream = _stream(queries)
        ws = workspace(queries, stream, _ws_entries(Q, C, D))
        err = _single_fn()(queries.data_ptr(), keys.data_ptr(),
                           valid.data_ptr(), Q, C, D, k, ws.data_ptr(),
                           idx.data_ptr(), score.data_ptr(), stream)
        check("similarity", err, "similarity_topk")
        LAUNCHES["similarity_topk"] += 1
    return idx, score


def similarity_lookup_cuda(queries, keys, valid):
    """queries (Q, D), keys (C, D), valid (C,) -> (idx (Q,) int32, score
    (Q,) f32); an all-invalid row gives idx 0, score -1e30."""
    Q, D = queries.shape
    _need(queries, "queries", _F32, (Q, D))
    _need(valid, "valid", _MASK_DTYPES, (keys.shape[0],))
    return _launch("similarity_lookup", queries, keys, valid, 1, Q, 1, (Q,))


def similarity_topk_touch_cuda(queries, qmask, keys, valid, last_used, freq,
                               clock, k: int, threshold: float):
    """queries (Q, D), qmask (Q,), keys (C, D), valid (C,), last_used/freq
    (C,) int32, clock one int32 -> (idx (Q, k), score (Q, k), last_used,
    freq).  The metadata comes back as new tensors, as the reference op
    is functional: the kernel copies the inputs into them and touches the
    copies."""
    Q, D = queries.shape
    C = keys.shape[0]
    _need(queries, "queries", _F32, (Q, D))
    _need(valid, "valid", _MASK_DTYPES, (C,))
    _need(qmask, "qmask", _MASK_DTYPES, (Q,))
    _need(last_used, "last_used", _I32, (C,))
    _need(freq, "freq", _I32, (C,))
    if not (clock.is_cuda and clock.dtype == torch.int32
            and clock.numel() == 1):
        raise ValueError("clock: one int32 on the CUDA device")
    if not Q:
        return (*_launch("similarity_topk_touch", queries, keys, valid, 1, Q,
                         k, (Q, k)), last_used.clone(), freq.clone())
    lu = torch.empty_like(last_used)
    fr = torch.empty_like(freq)
    idx, score = _launch("similarity_topk_touch", queries, keys, valid, 1, Q,
                         k, (Q, k), touch=(qmask, last_used, freq, lu, fr,
                                           clock), threshold=threshold)
    return idx, score, lu, fr
