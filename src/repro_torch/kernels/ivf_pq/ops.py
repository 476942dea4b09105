"""Public wrapper for the two-stage IVF-PQ digest probe.

``impl="auto"`` launches the CUDA kernel for CUDA tensors and runs the
plain version for CPU tensors; ``impl="ref"`` forces the plain version,
``impl="cuda"`` the kernel.  The kernel takes any Q (no query-tile
padding).  When a profiler is installed each call records its time and
the reference's modeled bytes under ``kernel/ivf_pq_probe/<impl>/...``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ivf_pq.kernel import ivf_pq_probe_cuda
from repro_torch.kernels.ivf_pq.ref import ivf_pq_probe_ref
from repro_torch.kernels.similarity.ops import _run, resolve_impl
from repro_torch.obs.profile import ivf_pq_probe_bytes


def ivf_pq_probe(queries: torch.Tensor, home: torch.Tensor,
                 centroids: torch.Tensor, cent_valid: torch.Tensor,
                 codes: torch.Tensor, slot_valid: torch.Tensor,
                 slot_owner: torch.Tensor, codebook: torch.Tensor, *,
                 k: int, n_probe: int, impl: str = "auto"):
    """Two-stage ANN probe over a packed IVF-PQ board index.

    queries: (Q, D) unit-norm descriptors; home: (Q,) int32 owning-cluster
    id per query (a probe never matches its own cluster's rows); index
    arrays as documented in ``ref.py``.  Returns (idx (Q, k) int32 flat
    ``list * cap + slot`` ids, score (Q, k) f32, sel (Q, n_probe) int32
    probed list ids), scores descending, ties toward the lower flat
    index."""
    impl = resolve_impl(impl, queries)
    if impl == "ref":
        def fn(*args):
            return ivf_pq_probe_ref(*args, k=k, n_probe=n_probe)
    else:
        def fn(q, h, c, cv, cd, sv, so, cb):
            return ivf_pq_probe_cuda(
                q.float().contiguous(), h.to(torch.int32).contiguous(),
                c.float().contiguous(), cv.contiguous(),
                cd.to(torch.uint8).contiguous(), sv.contiguous(),
                so.to(torch.int32).contiguous(), cb.float().contiguous(),
                k, n_probe)
    L, cap, S = (int(s) for s in codes.shape)
    return _run("ivf_pq_probe", impl, fn,
                (queries, home, centroids, cent_valid, codes, slot_valid,
                 slot_owner, codebook),
                lambda: ivf_pq_probe_bytes(int(queries.shape[0]), L, cap, S,
                                           int(queries.shape[1])))
