"""Plain PyTorch flash-decode: one query token per row against a dense
KV cache, the function the CUDA kernel computes.

Mirrors ``repro/kernels/decode_attention/ref.py``: fp32 logits, slots at
or past ``kv_len`` masked to -1e30, fp32 softmax and PV, cast to q's
dtype.  A row with ``kv_len == 0`` averages V over every slot here, where
the kernel gives exact zeros (the TPU kernel's ``l == 0 -> 1``): no decode
row reaches it, since a step writes its own token before it attends.
"""
from __future__ import annotations

import numpy as np
import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, return_lse: bool = False):
    """q: (B, H, D) one new token per row; k/v: (B, S, K, D); kv_len: (B,)
    number of valid leading slots per row.  Returns (B, H, D); with
    ``return_lse`` also lse (B, H) fp32, ``torch.logsumexp`` of the scaled
    fp32 logits over the valid slots (-inf for a row with none)."""
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, K, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < kv_len.to(q.device)[:, None])                   # (B, S)
    masked = torch.where(valid[:, None, None, :], logits, -1e30)
    probs = torch.softmax(masked, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    out = out.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(valid[:, None, None, :], logits,
                                      float("-inf")), dim=-1)
    return out, lse.reshape(B, H)
