"""Kernel profiling hooks — per-call wall ms + modeled bytes per kernel op.

The port's counterpart of ``repro/obs/profile.py``.  Each public kernel
entry point (``similarity_topk_batched`` / ``similarity_topk_touch`` /
``similarity_lookup`` in ``kernels/similarity/ops.py``, ``paged_attention``)
calls ``record_op`` around its dispatch when a profiler is installed.  The
record carries the measured ms of the call and the op's MODELED device
bytes, from the same byte models as the reference, tagged by impl
(``cuda`` | ``ref``), into the installed registry:

    kernel/<op>/<impl>/calls           Counter
    kernel/<op>/<impl>/wall_ms         Histogram (p50/p95/p99)
    kernel/<op>/<impl>/modeled_bytes   Counter (cumulative)

A call on CUDA tensors is timed with a pair of ``torch.cuda.Event``s and a
synchronize on the end event (PyTorch returns before the device finishes);
a call on CPU tensors with the host clock.  Disabled (the default) the hot
path pays ONE module-global ``is None`` check per op call.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.obs.metrics import MetricsRegistry

_PROFILER: Optional["KernelProfiler"] = None


class KernelProfiler:
    def __init__(self, metrics: MetricsRegistry):
        self.metrics = metrics

    def record(self, op: str, impl: str, wall_ms: float,
               modeled_bytes: float) -> None:
        base = f"kernel/{op}/{impl}"
        self.metrics.counter(f"{base}/calls").inc()
        self.metrics.histogram(f"{base}/wall_ms").observe(wall_ms)
        self.metrics.counter(f"{base}/modeled_bytes").inc(
            int(modeled_bytes))


def enable_profiling(metrics: MetricsRegistry) -> KernelProfiler:
    """Install a profiler recording into ``metrics``; returns it."""
    global _PROFILER
    _PROFILER = KernelProfiler(metrics)
    return _PROFILER


def disable_profiling() -> None:
    global _PROFILER
    _PROFILER = None


def active() -> Optional[KernelProfiler]:
    return _PROFILER


def record_op(op: str, impl: str, fn, args, modeled_bytes: float):
    """Run ``fn(*args)`` and, when a profiler is installed, record its
    completed wall time + modeled bytes.  Returns ``fn``'s result."""
    prof = _PROFILER
    if prof is None:
        return fn(*args)
    on_cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if on_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        out = fn(*args)
        ms = (time.perf_counter() - t0) * 1e3
    prof.record(op, impl, ms, modeled_bytes)
    return out


# ---------------------------------------------------------------------------
# Byte models (the same models as the reference's obs/profile.py)
# ---------------------------------------------------------------------------


def similarity_bytes(n_queries: int, n_keys: int, dim: int,
                     key_bytes_per_row: Optional[float] = None,
                     meta_rows: int = 0) -> float:
    """Modeled device traffic of one similarity probe: one read of the
    query block, one streaming read of the key matrix (+ validity byte per
    row), and the (Q, k) outputs (negligible, ignored).  ``meta_rows`` adds
    the fused-touch epilogue's read+write of two int32 metadata words per
    cache row."""
    row = (dim * 4.0 if key_bytes_per_row is None
           else float(key_bytes_per_row))
    return (n_queries * dim * 4.0            # query block read
            + n_keys * (row + 1.0)           # key rows + valid bytes
            + meta_rows * 2 * 4.0 * 2)       # last_used+freq, read+write


def digest_probe_bytes(n_queries: int, num_clusters: int, digest_size: int,
                       dim: int, quant: str) -> float:
    """Modeled bytes of one grouped region-board probe — the similarity
    model over K digest replicas in their wire format (int8 rows carry
    ``D + 4`` bytes, the ``DigestConfig.row_bytes`` model)."""
    row_bytes = dim + 4 if quant == "int8" else dim * 4
    return similarity_bytes(n_queries * num_clusters,
                            num_clusters * digest_size, dim,
                            key_bytes_per_row=row_bytes)


def ivf_pq_probe_bytes(n_queries: int, n_lists: int, list_cap: int,
                       n_sub: int, dim: int) -> float:
    """Modeled device traffic of one two-stage IVF-PQ board probe (the
    reference's model): the query tile, the coarse table (centroids +
    validity byte per list), the shared residual codebook, and one
    streaming read of the packed code lists — ``n_sub`` uint8 codes plus a
    validity and an owner byte per slot.  The port stores the owner as
    int32 (4 bytes per slot), so its measured bound counts that instead."""
    return (n_queries * dim * 4.0                      # query tile
            + n_lists * (dim * 4.0 + 1.0)              # centroids + valid
            + n_sub * 256 * (dim // n_sub) * 4.0       # shared codebook
            + n_lists * list_cap * (n_sub + 2.0))      # codes+valid+owner
