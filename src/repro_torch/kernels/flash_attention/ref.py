"""Plain PyTorch flash attention: causal (optionally sliding-window) GQA
over the full sequence, the function the CUDA kernel computes.

Mirrors ``repro/kernels/flash_attention/ref.py``: fp32 logits and
probabilities, masked logits at -1e30, the PV product in fp32, cast to
q's dtype.  It materializes (B, K, G, S, S) fp32 logits, so at long S it is
a check, never the serving path on a card.
"""
from __future__ import annotations

import numpy as np
import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, K, D).  Returns (B, S, H, D)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, S, K, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
