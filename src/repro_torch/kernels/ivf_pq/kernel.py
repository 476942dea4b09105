"""ctypes wrapper of the CUDA IVF-PQ probe (``csrc/ivf_pq.cu``), which
replaces the TPU kernel ``ivf_pq_probe_kernel``.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current stream (one C call:
the coarse and lookup-table GEMMs, the list selection, the split slot
scan and the merge), raises on a launch error, and counts one launch per
call in ``LAUNCHES["ivf_pq_probe"]``.  How the work is split and where
each stage's scratch lies (``ivf_pq_plan``) depend on the shapes alone
and are looked up once per shape; the scratch is the one buffer per
device and stream of ``_build.workspace``.  The C entry refuses
(cudaErrorInvalidValue, nothing launched) a table of S * 256 fp32 above
a block's 227 KiB, and cuts that do not cover D and the probed slots.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._build import (LAUNCHES, check, load, sm_count,
                                        workspace)
from repro_torch.kernels.similarity.kernel import _MASK_DTYPES, _need

K_MAX = 32               # largest k the kernel's top-k lists hold
TILE = 64                # GEMM tile: queries x lists (csrc kTile)
TILE_K = 32              # GEMM k-step (csrc kBK)
MIN_SPLIT_STEPS = 4      # k-steps of a coarse split at the least
GEMM_WAVES = 2           # coarse GEMM blocks per SM the split aims at
SCAN_WAVES = 8           # scan blocks per SM the split aims at
CODES = 256              # codewords per subspace

_VP = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = load("ivf_pq").ivf_pq_probe_launch
    fn.argtypes = [_VP] * 8 + [_I] * 11 + [_VP] * 9
    fn.restype = _I
    return fn


def _round4(n: int) -> int:
    return -(-n // 4) * 4


class IvfPqPlan(NamedTuple):
    k_split: int         # splits of D for the coarse GEMM
    split_depth: int     # columns of D a split takes (a multiple of TILE_K)
    n_split: int         # scan blocks per query
    chunk: int           # probed slots a scan block takes
    lut_at: int          # fp32 offsets into the scratch of the lookup table,
    qc_at: int           # the probed lists' coarse scores,
    part_s_at: int       # the scan blocks' partial scores
    part_i_at: int       # and indices (the coarse partials start at 0)
    workspace: int       # fp32 entries of scratch


@functools.lru_cache(maxsize=None)
def ivf_pq_plan(Q: int, L: int, cap: int, S: int, D: int, k: int,
                n_probe: int, sms: int) -> IvfPqPlan:
    """How one probe is cut.  The coarse GEMM's depth D splits into
    ``k_split`` spans of ``split_depth`` (at least ``MIN_SPLIT_STEPS``
    k-steps each) so that its 64 x 64 tiles give about ``GEMM_WAVES``
    blocks per SM of ``sms``.  Each query's ``n_probe * cap`` probed slots
    (slot s of its p-th list is item ``p * cap + s``) split into
    ``n_split`` spans of ``chunk`` items, one scan block each, about
    ``SCAN_WAVES`` blocks per SM.  No span is empty.  The workspace holds
    the coarse partials (k_split, Q, L), the lookup table (Q, S, 256), the
    probed lists' coarse scores (Q, n_probe) and the scan blocks' partial
    lists (k scores, then k indices, per query and span), each region
    16-byte aligned; the C entry takes them where the plan puts them."""
    steps = -(-D // TILE_K)
    tiles = -(-Q // TILE) * -(-L // TILE)
    k_split = max(1, min(steps // MIN_SPLIT_STEPS,
                         round(GEMM_WAVES * sms / tiles)))
    per = -(-steps // k_split)
    k_split = -(-steps // per)
    items = n_probe * cap
    chunk = items // min(items, -(-SCAN_WAVES * sms // Q))
    n_split = -(-items // chunk)
    lut_at = _round4(k_split * Q * L)
    qc_at = lut_at + Q * S * CODES
    part_s_at = qc_at + _round4(Q * n_probe)
    part_i_at = part_s_at + _round4(Q * n_split * k)
    return IvfPqPlan(k_split, per * TILE_K, n_split, chunk, lut_at, qc_at,
                     part_s_at, part_i_at, part_i_at + Q * n_split * k)


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
    _need(codebook, "codebook", (torch.float32,), (S, CODES, D // S))
    if not 1 <= k <= min(K_MAX, L * cap):
        raise ValueError(f"k={k} must be in [1, min({K_MAX}, L*cap)]")
    if not 1 <= n_probe <= L:
        raise ValueError(f"n_probe={n_probe} must be in [1, L={L}]")
    dev = queries.device
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    score = torch.empty((Q, k), dtype=torch.float32, device=dev)
    sel = torch.empty((Q, n_probe), dtype=torch.int32, device=dev)
    if Q:
        d = queries.get_device()
        plan = ivf_pq_plan(Q, L, cap, S, D, k, n_probe, sm_count(d))
        stream = torch._C._cuda_getCurrentRawStream(d)
        ws = workspace(queries, stream, plan.workspace).data_ptr()
        err = _fn()(queries.data_ptr(), home.data_ptr(),
                    centroids.data_ptr(), cent_valid.data_ptr(),
                    codes.data_ptr(), slot_valid.data_ptr(),
                    slot_owner.data_ptr(), codebook.data_ptr(), Q, L, cap,
                    S, D, k, n_probe, plan.k_split, plan.split_depth,
                    plan.chunk, plan.n_split, ws, ws + 4 * plan.lut_at,
                    ws + 4 * plan.qc_at, ws + 4 * plan.part_s_at,
                    ws + 4 * plan.part_i_at, idx.data_ptr(), score.data_ptr(),
                    sel.data_ptr(), stream)
        check("ivf_pq", err, "ivf_pq_probe")
        LAUNCHES["ivf_pq_probe"] += 1
    return idx, score, sel
