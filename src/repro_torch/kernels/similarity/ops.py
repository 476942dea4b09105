"""Public entry points of the edge-cache similarity ops.

``impl="auto"`` (the default) launches the CUDA kernel when the queries
lie on a CUDA device and runs the plain PyTorch version when they lie on
the CPU; ``impl="ref"`` forces the plain version (``chip_smoke.py`` and
the tests use it to hold the kernel against it); ``impl="cuda"`` forces
the kernel, which raises for a CPU tensor.  No path falls back from the
kernel to the plain version.

The wrappers keep the reference's contract (``repro/kernels/similarity/
ops.py``): any Q and C (the CUDA kernel needs no block padding), and
``k <= C``.  When a profiler is installed each call records its time and
modeled bytes under ``kernel/<op>/<impl>/...``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.similarity.kernel import (
    similarity_lookup_cuda, similarity_topk_batched_cuda, similarity_topk_cuda,
    similarity_topk_touch_cuda)
from repro_torch.kernels.similarity.ref import (similarity_lookup_ref,
                                                similarity_topk_batched_ref,
                                                similarity_topk_ref,
                                                similarity_topk_touch_ref)
from repro_torch.obs.profile import active, record_op, similarity_bytes


def resolve_impl(impl: str, t: torch.Tensor) -> str:
    """``auto`` -> ``cuda`` for a CUDA tensor, ``ref`` for a CPU one."""
    if impl == "auto":
        return "cuda" if t.is_cuda else "ref"
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl {impl!r} not in auto | cuda | ref")
    return impl


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous fp32; no op (and no dispatch) when it is."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def _i32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _cont(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def _check_k(k: int, C: int) -> None:
    if k > C:
        raise ValueError(f"k={k} must be <= C={C}")


def _run(op, impl, fn, args, modeled):
    if active() is None:
        return fn(*args)
    return record_op(op, impl, fn, args, modeled())


def similarity_lookup(queries: torch.Tensor, keys: torch.Tensor,
                      valid: torch.Tensor, *, impl: str = "auto"):
    """Nearest-neighbour cache lookup.  queries: (Q, D) unit-norm
    descriptors; keys: (C, D); valid: (C,) bool.  Returns (best_idx (Q,)
    int32, best_score (Q,) f32)."""
    impl = resolve_impl(impl, queries)
    if impl == "ref":
        fn = similarity_lookup_ref
    else:
        fn = lambda q, k, v: similarity_lookup_cuda(      # noqa: E731
            _f32(q), _f32(k), _cont(v))
    return _run("similarity_lookup", impl, fn, (queries, keys, valid),
                lambda: similarity_bytes(int(queries.shape[0]),
                                         int(keys.shape[0]),
                                         int(queries.shape[1])))


def similarity_topk(queries: torch.Tensor, keys: torch.Tensor,
                    valid: torch.Tensor, k: int, *, impl: str = "auto"):
    """Single-matrix top-k cache lookup (the pooled-shard primitive of
    ``parallel/sharding.py``).  queries: (Q, D); keys: (C, D); valid: (C,)
    bool.  Returns (idx (Q, k) int32, score (Q, k) f32), scores descending,
    ties toward the lower cache index.  k must be <= C."""
    C = int(keys.shape[0])
    _check_k(k, C)
    impl = resolve_impl(impl, queries)
    if impl == "ref":
        fn = functools.partial(similarity_topk_ref, k=k)
    else:
        fn = lambda q, ks, v: similarity_topk_cuda(       # noqa: E731
            _f32(q), _f32(ks), _cont(v), k)
    return _run("similarity_topk", impl, fn, (queries, keys, valid),
                lambda: similarity_bytes(int(queries.shape[0]), C,
                                         int(queries.shape[1])))


def similarity_topk_touch(queries: torch.Tensor, keys: torch.Tensor,
                          valid: torch.Tensor, k: int,
                          last_used: torch.Tensor, freq: torch.Tensor,
                          clock, *, threshold: float,
                          mask: torch.Tensor = None, impl: str = "auto"):
    """Fused top-k lookup + LRU-touch epilogue.  queries: (Q, D); keys:
    (C, D); valid: (C,) bool; last_used/freq: (C,) int32; clock: scalar
    int32.  Returns (idx (Q, k) int32, score (Q, k) f32, last_used (C,)
    int32, freq (C,) int32) — exactly ``SemanticCache.apply_probe``'s
    update for every above-``threshold`` top-1 winner whose ``mask`` row is
    True.  k must be <= C."""
    C = int(keys.shape[0])
    _check_k(k, C)
    impl = resolve_impl(impl, queries)
    if impl == "ref":
        fn = functools.partial(similarity_topk_touch_ref, k=k,
                               threshold=threshold)

        def call(q, ks, v, lu, fr, clk, m):
            return fn(q, ks, v, last_used=lu, freq=fr, clock=clk, mask=m)
    else:
        def call(q, ks, v, lu, fr, clk, m):
            Q = q.shape[0]
            m = (torch.ones((Q,), dtype=torch.bool, device=q.device)
                 if m is None else _cont(m))
            if not (isinstance(clk, torch.Tensor)
                    and clk.dtype == torch.int32):
                clk = torch.as_tensor(clk, device=q.device).to(torch.int32)
            return similarity_topk_touch_cuda(
                _f32(q), m, _f32(ks), _cont(v), _i32(lu), _i32(fr), clk, k,
                threshold)
    return _run("similarity_topk_touch", impl, call,
                (queries, keys, valid, last_used, freq, clock, mask),
                lambda: similarity_bytes(int(queries.shape[0]), C,
                                         int(queries.shape[1]),
                                         meta_rows=C))


def similarity_topk_batched(queries: torch.Tensor, keys: torch.Tensor,
                            valid: torch.Tensor, k: int, *,
                            impl: str = "auto"):
    """Grouped-query top-k: group ``n`` probes key matrix ``n`` only — one
    launch for N per-node shard lookups (the ladder's local rung).

    queries: (N, Q, D); keys: (N, C, D), or (C, D) — one matrix every
    group probes under its own ``valid`` row (the digest board; no copy
    per group); valid: (N, C) bool.  Returns (idx (N, Q, k) int32, score
    (N, Q, k) f32), scores descending, ties toward the lower cache index.
    k must be <= C."""
    N, Q, D = (int(s) for s in queries.shape)
    C = int(keys.shape[-2])
    _check_k(k, C)
    impl = resolve_impl(impl, queries)
    if impl == "ref":
        fn = functools.partial(similarity_topk_batched_ref, k=k)
    else:
        fn = lambda q, ks, v: similarity_topk_batched_cuda(  # noqa: E731
            _f32(q), _f32(ks), _cont(v), k)
    n_keys = C if keys.dim() == 2 else N * C
    return _run("similarity_topk_batched", impl, fn, (queries, keys, valid),
                lambda: similarity_bytes(N * Q, n_keys, D))
