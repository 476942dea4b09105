"""Public wrapper of the absorbed MLA decode over the paged latent:
backend selection.

``paged_latent`` takes the absorbed query (``q_lat``: q_nope folded through
w_uk; ``q_rope`` rotated) and the latent pool leaves exactly as
``paged_cache_specs`` stores them.  ``impl="auto"`` launches the CUDA kernel
for CUDA tensors and runs the plain version for CPU tensors; ``impl="ref"``
forces the plain version, ``impl="cuda"`` the kernel, which raises for a
CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_latent.kernel import paged_latent_cuda
from repro_torch.kernels.paged_latent.ref import paged_latent_ref
from repro_torch.kernels.similarity.ops import resolve_impl


def paged_latent(q_lat: torch.Tensor, q_rope: torch.Tensor,
                 ckv_pages: torch.Tensor, krope_pages: torch.Tensor,
                 block_table: torch.Tensor, n_vis: torch.Tensor,
                 scale: float, *, impl: str = "auto") -> torch.Tensor:
    """One decode query a row against its visible latent keys.

    q_lat: (B, H, r); q_rope: (B, H, dr); ckv/krope_pages: (P, page, r) /
    (P, page, dr) physical page pools; block_table: (B, n_pages), entries
    >= P INVALID (no key); n_vis: (B,) keys each row sees (positions 0 ..
    n_vis - 1); ``scale`` the softmax scale.  Returns o_lat (B, H, r), the
    attention's output in the latent, before w_uv."""
    if resolve_impl(impl, q_lat) == "ref":
        return paged_latent_ref(q_lat, q_rope, ckv_pages, krope_pages,
                                block_table, n_vis, scale)
    return paged_latent_cuda(
        q_lat.contiguous(), q_rope.contiguous(), ckv_pages.contiguous(),
        krope_pages.contiguous(), block_table.to(torch.int32).contiguous(),
        n_vis.to(torch.int32).contiguous(), scale)
