"""Layer primitives of the dense decoder path, as plain functions on tensors.

The port of the dense part of ``repro/models/layers.py``: RMSNorm,
rotate-half RoPE, the attention mask (causal, sliding window, cache
fill), GQA attention over a mask (the plain path of chunked prefill and
the gathered paged view), causal attention of a full sequence through
the flash-attention kernel (K8), the attention projections in the
reference's einsum layouts (``wq`` (D, H, Dh), ``wo`` (H, Dh, D)) and the
gated-SiLU MLP.  ``init_leaf`` copies the reference's
initializer distribution for random weights at published widths.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention


def init_leaf(shape: tuple, init: str, dtype: torch.dtype,
              generator: torch.Generator, device) -> torch.Tensor:
    """``repro.models.layers.init_leaf``'s distribution: ones, zeros, or a
    normal scaled by min(0.02 (0.006 for ``small_normal``), 1/sqrt(fan_in))
    with fan_in = shape[-2] (shape[-1] for vectors)."""
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    scale = 0.02 if init == "normal" else 0.006
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = min(scale, 1.0 / np.sqrt(max(1, fan_in)))
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate-half RoPE.  x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, x.device)              # (d/2,)
    angles = positions[..., None].float() * inv_freq             # (.., S, d/2)
    cos = torch.cos(angles)[..., None, :]                        # (.., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., Sq, Sk) boolean mask from absolute positions q_pos (..., Sq)
    and k_pos (..., Sk).  ``window > 0`` adds the sliding-window band
    (k_pos > q_pos - window); ``kv_len`` masks unwritten cache slots
    (k_pos < kv_len)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    if kv_len is not None:
        mask = mask & (kp < kv_len)
    return mask


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, *,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention, plain path.  q: (B, Sq, H, D); k/v: (B, Sk,
    K, D) with H % K == 0; mask: broadcastable to (B, Sq, Sk).  Softmax in
    fp32; probabilities cast to v's dtype before PV, as in the reference.
    Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    qg = q.reshape(B, Sq, K, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, Sq, H, D)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int = 0, impl: str = "auto") -> torch.Tensor:
    """Causal GQA attention of a full sequence at positions 0..S-1 (with
    the sliding-window band when ``window > 0``): the reference's
    ``causal_attention`` as ``forward``, ``forward_hidden`` and ``prefill``
    call it, through the flash-attention op (K8; ``impl`` auto | cuda |
    ref).  q: (B, S, H, D); k/v: (B, S, K, D).  Softmax and PV in fp32,
    where the reference's XLA path rounds the probabilities to v's dtype
    first: equal in fp32, within bf16 rounding in bf16."""
    return flash_attention(q, k, v, causal=True, window=window, impl=impl)


def attention_qkv(cfg, blk, x: torch.Tensor, positions: torch.Tensor):
    """Project to q, k, v (+bias, +rope on q, k).  ``blk`` holds the
    layer's weights in the reference layouts."""
    q = torch.einsum("bsd,dhe->bshe", x, blk.wq)
    k = torch.einsum("bsd,dke->bske", x, blk.wk)
    v = torch.einsum("bsd,dke->bske", x, blk.wv)
    if cfg.qkv_bias:
        q = q + blk.bq
        k = k + blk.bk
        v = v + blk.bv
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(blk, attn: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshe,hed->bsd", attn, blk.wo)


def mlp_apply(blk, x: torch.Tensor) -> torch.Tensor:
    """Gated-SiLU MLP (llama family)."""
    g = x @ blk.w_gate
    u = x @ blk.w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ blk.w_down
