"""ctypes wrapper of the CUDA absorbed MLA decode over the paged latent
(``csrc/paged_latent.cu``), which replaces no TPU kernel: the reference
computes MLA with XLA einsums.

The wrapper checks device, dtype, shape, contiguity and alignment, raising
with the shape it refuses, allocates the output with ``torch.empty``, picks
the split count (blocks for about four a streaming multiprocessor, so that
rows of unequal length still balance),
launches on the current stream, raises on a launch error, and counts one
launch per call in ``LAUNCHES["paged_latent"]``, though a call whose pages
are split issues a split pass and a merge pass.  The split pass's workspace
is the one buffer per device and stream of ``_build.workspace``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import (LAUNCHES, check, load, sm_count,
                                        workspace)

R_MAX = 512              # latent width the kernel's registers hold
DR_MAX = 64              # rope width

_VP = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn():
    fn = load("paged_latent").paged_latent_launch
    fn.argtypes = [_VP] * 8 + [_I] * 8 + [ctypes.c_float, _I, _VP]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, r: int, n_pages: int, sms: int):
    """(splits of each row's pages, fp32 workspace entries): B x splits x
    head groups of 16 at least four blocks a streaming multiprocessor, no
    more splits than the table has pages."""
    groups = -(-H // 16)
    ns = max(1, min(n_pages, -(-4 * sms // (B * groups))))
    fn = load("paged_latent").paged_latent_workspace_size
    fn.argtypes = [_I] * 4
    fn.restype = ctypes.c_longlong
    return ns, fn(B, H, r, ns)


def check_shapes(q_lat, q_rope, ckv_pages, krope_pages, block_table,
                 n_vis) -> None:
    """Raise, naming the shape, on what the kernel does not take: every
    tensor on the card and contiguous, q and pages of one dtype (bf16 or
    fp32), r and dr multiples of 8 up to ``R_MAX`` and ``DR_MAX``, int32
    table and counts."""
    B, H, r = q_lat.shape
    dr = q_rope.shape[2]
    P, page = ckv_pages.shape[:2]
    n_pages = block_table.shape[1]
    for name, t, shape in (("q_lat", q_lat, (B, H, r)),
                           ("q_rope", q_rope, (B, H, dr)),
                           ("ckv_pages", ckv_pages, (P, page, r)),
                           ("krope_pages", krope_pages, (P, page, dr)),
                           ("block_table", block_table, (B, n_pages)),
                           ("n_vis", n_vis, (B,))):
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor "
                             f"(got {t.device})")
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if q_lat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q_lat: dtype {q_lat.dtype} not bfloat16/float32")
    for name, t in (("q_rope", q_rope), ("ckv_pages", ckv_pages),
                    ("krope_pages", krope_pages)):
        if t.dtype != q_lat.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} != q_lat's "
                            f"{q_lat.dtype}")
    if block_table.dtype != torch.int32 or n_vis.dtype != torch.int32:
        raise TypeError("block_table and n_vis must be int32")
    if r % 8 or dr % 8 or not 0 < r <= R_MAX or not 0 < dr <= DR_MAX:
        raise ValueError(f"latent widths r={r}, dr={dr}: need multiples of "
                         f"8 with 0 < r <= {R_MAX}, 0 < dr <= {DR_MAX}")
    if (q_lat.data_ptr() | q_rope.data_ptr() | ckv_pages.data_ptr()
            | krope_pages.data_ptr()) % 16:
        raise ValueError("q_lat, q_rope and the pages must be 16-byte "
                         "aligned")


def paged_latent_cuda(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      ckv_pages: torch.Tensor, krope_pages: torch.Tensor,
                      block_table: torch.Tensor, n_vis: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """q_lat (B, H, r), q_rope (B, H, dr) bf16/fp32; ckv_pages (P, page,
    r), krope_pages (P, page, dr) of q's dtype; block_table (B, n_pages)
    int32; n_vis (B,) int32 -> o_lat (B, H, r)."""
    check_shapes(q_lat, q_rope, ckv_pages, krope_pages, block_table, n_vis)
    B, H, r = q_lat.shape
    dr = q_rope.shape[2]
    P, page = ckv_pages.shape[:2]
    n_pages = block_table.shape[1]
    out = torch.empty_like(q_lat)
    if B and H:
        dev = q_lat.get_device()
        stream = torch._C._cuda_getCurrentRawStream(dev)
        ns, n = _plan(B, H, r, n_pages, sm_count(dev))
        ws = workspace(q_lat, stream, n).data_ptr() if n else None
        err = _fn()(q_lat.data_ptr(), q_rope.data_ptr(),
                    ckv_pages.data_ptr(), krope_pages.data_ptr(),
                    block_table.data_ptr(), n_vis.data_ptr(), ws,
                    out.data_ptr(), B, H, r, dr, P, page, n_pages, ns,
                    float(scale), int(q_lat.dtype == torch.bfloat16),
                    stream)
        check("paged_latent", err, "paged_latent")
        LAUNCHES["paged_latent"] += 1
    return out
