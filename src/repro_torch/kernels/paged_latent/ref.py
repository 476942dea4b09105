"""Plain PyTorch absorbed MLA decode over the paged latent: the arithmetic
of ``csrc/paged_latent.cu``, the version the CPU runs and the card is held
to.

Each row attends, with all H heads, to the latent keys it sees: positions
below its visible count ``n_vis`` that lie in mapped pages of its block
table (an entry >= P is the INVALID sink: no key).  Only the pages that
hold such keys are gathered (the widest row's).  Logits are fp32,
``scale * (q_lat . c_kv + q_rope . k_rope)``; the softmax is fp32; the
probabilities are rounded to the latent's dtype, as the expanded form
casts them, and P . c_kv sums in fp32.  A row that sees no key gives zeros.
"""
from __future__ import annotations

import torch


def paged_latent_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     ckv_pages: torch.Tensor, krope_pages: torch.Tensor,
                     block_table: torch.Tensor, n_vis: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """q_lat (B, H, r), q_rope (B, H, dr); ckv_pages (P, page, r),
    krope_pages (P, page, dr); block_table (B, n_pages) int; n_vis (B,)
    int: the keys each row sees.  Returns o_lat (B, H, r) in q_lat's
    dtype."""
    B, H, r = q_lat.shape
    P, page = ckv_pages.shape[:2]
    width = block_table.shape[1] * page
    n_vis = n_vis.long().clamp(0, width)
    n_pages = -(-int(n_vis.max()) // page) if B else 0
    bt = block_table[:, :n_pages].long()
    ckv = ckv_pages[bt.clamp(max=P - 1)].reshape(B, n_pages * page, r)
    krope = krope_pages[bt.clamp(max=P - 1)].reshape(B, n_pages * page, -1)
    kpos = torch.arange(n_pages * page, device=q_lat.device)
    seen = ((kpos[None, :] < n_vis[:, None])
            & (bt < P).repeat_interleave(page, dim=1))       # (B, S)
    logits = (torch.einsum("bhr,btr->bht", q_lat.float(), ckv.float())
              + torch.einsum("bhe,bte->bht", q_rope.float(), krope.float())
              ) * scale
    logits = torch.where(seen[:, None, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(seen.any(-1)[:, None, None], probs, 0.0)
    probs = probs.to(ckv.dtype).float()
    out = torch.einsum("bht,btr->bhr", probs, ckv.float())
    return out.to(q_lat.dtype)
