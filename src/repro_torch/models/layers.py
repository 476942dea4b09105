"""Layer primitives of the decoder, as plain functions on tensors.

The port of ``repro/models/layers.py``: RMSNorm and
LayerNorm (whisper), rotate-half RoPE, the attention mask (causal,
sliding window, cache fill), GQA attention over a mask (the plain path
of chunked prefill and the gathered paged view), the encoder-decoder's
plain attention (q-chunked when long) and unmasked cross attention,
causal attention of a full sequence through
the flash-attention kernel (K8), the attention projections in the
reference's einsum layouts (``wq`` (D, H, Dh), ``wo`` (H, Dh, D)), MLA
(DeepSeek-V2's latent attention, plain PyTorch as in the reference, with
the port's YaRN on its rope dims), the dense MLPs (gated SiLU, and the
two-matrix GELU with biases) and the mixture of experts (top-k softmax
router, its weights renormalised or not; ``dense`` one-hot dispatch,
``dropless`` capacity buffers, and the port's drop-free ``grouped`` route
over expert-sorted assignments).  ``init_leaf`` copies the reference's
initializer distribution for random weights at published widths.

The sequence-sharded decode (``serving/sharded.py``) attends over each
rank's range of cache slots: ``partial_attention`` (GQA / MHA) and
``mla_partial`` (MLA's latent) return a rank's normalised output and the
log-sum-exp of its logits, and ``merge_partials`` combines the ranks'.

The expert products are plain ``bmm``/``einsum`` calls, as in the
reference, which computes them outside any Pallas kernel; the ``grouped``
route runs them as grouped GEMMs (``torch._grouped_mm`` on the card, one
matrix product per expert elsewhere).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.mesh import mesh_shape
from repro_torch.parallel.collectives import (copy_to, gather_along,
                                              gather_over, gather_rows,
                                              live_dims, mean_over,
                                              rank_index, reduce_from,
                                              scatter_to)
from repro_torch.parallel.sharding import constrain, current_sharder


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


class ShapeDtype(NamedTuple):
    """A leaf's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def leaf_layout(model, axes_of) -> tuple:
    """({name: logical axes}, {name: ``ShapeDtype``}) of every weight of
    ``model`` in the reference's flat layout: a repeating segment's leaf
    stacked, ``("layers",) + axes``.  ``axes_of(name)`` gives a leaf's own
    axes."""
    axes, shapes, reps = {}, {}, {}
    for name, r, owner, attr, _ in model.leaves():
        p = getattr(owner, attr)
        reps[name] = reps.get(name, 0) + 1
        axes[name] = axes_of(name)
        shapes[name] = (tuple(p.shape), p.dtype, r is not None)
    for name, (shape, dtype, stacked) in shapes.items():
        if stacked:
            shape, axes[name] = (reps[name],) + shape, ("layers",) + axes[name]
        shapes[name] = ShapeDtype(shape, dtype)
    return axes, shapes


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A weight's declaration, as the reference's ``ParamSpec``: its shape,
    logical axes, initializer (``normal`` | ``zeros`` | ``ones`` |
    ``small_normal``) and dtype (None: the model's)."""
    shape: tuple
    axes: tuple
    init: str = "normal"
    dtype: Optional[str] = None


def param_specs(model, axes_of) -> dict:
    """{reference name: ``ParamSpec``} of every weight of ``model``, from
    ``leaf_layout`` and the initializers of ``model.leaves()``; every
    weight has the model's dtype, as in the reference."""
    axes, shapes = leaf_layout(model, axes_of)
    inits = {name: init for name, _, _, _, init in model.leaves()}
    return {name: ParamSpec(s.shape, axes[name], inits[name])
            for name, s in shapes.items()}


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with bias (whisper), in fp32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, inv_freq: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Rotate-half RoPE.  x: (..., S, H, D); positions: (..., S).
    ``inv_freq`` (D/2,) replaces theta's frequencies (YaRN,
    ``mla_rope``)."""
    d = x.shape[-1]
    if inv_freq is None:
        inv_freq = rope_frequencies(d, theta, x.device)          # (d/2,)
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


def mha_cross_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Unmasked cross attention (encoder-decoder), q (B, Sq, H, D) over
    k/v (B, Sk, H, D): fp32 logits divided by sqrt(D), probabilities cast
    to v's dtype, as in the reference."""
    D = q.shape[-1]
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() / np.sqrt(D)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def softmax_partial(logits: torch.Tensor, valid: torch.Tensor):
    """(probs, lse) of fp32 ``logits`` (..., Sk) over the ``valid`` keys
    (broadcastable): ``probs`` the reference's softmax of the logits with
    invalid keys filled with -1e30 (a row with no valid key averages them,
    as the plain attention does), ``lse`` their log-sum-exp over the valid
    keys alone, -inf for a row with none."""
    probs = torch.softmax(torch.where(valid, logits, -1e30), dim=-1)
    lse = torch.logsumexp(torch.where(valid, logits, float("-inf")), dim=-1)
    return probs, lse


def partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor, *, scale: Optional[float] = None):
    """``gqa_attention`` over the keys a rank holds, with its log-sum-exp.
    q: (B, Sq, H, D); k/v: (B, Sk, K, D); valid: broadcastable to (B, Sq,
    Sk).  Returns (out (B, Sq, H, D), lse (B, Sq, H) fp32); a row with no
    valid key has lse -inf, so ``merge_partials`` gives it weight 0."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    qg = q.reshape(B, Sq, K, H // K, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    probs, lse = softmax_partial(logits, valid[:, None, None, :, :])
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D), lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def combine_partials(outs: torch.Tensor, lses: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Partials stacked over the ranks that split the keys, outs (n, ...,
    H, D) and lses (n, ..., H) fp32 -> the attention over all their keys:
    sum_r exp(lse_r - m) out_r / sum_r exp(lse_r - m), m the largest lse,
    in fp32, cast to ``dtype``.  A part with no valid key (lse -inf)
    weighs exactly 0; every row has one valid key somewhere (a decode step
    writes its own token first), so m must be finite, which is asserted on
    the device."""
    m = lses.max(dim=0).values
    torch._assert_async(torch.isfinite(m).all(),
                        "combine_partials: a row with no valid key")
    w = torch.exp(lses - m)
    merged = (outs.float() * w[..., None]).sum(0) / w.sum(0)[..., None]
    return merged.to(dtype)


def merge_partials(out: torch.Tensor, lse: torch.Tensor, mesh,
                   names) -> torch.Tensor:
    """The attention over every rank's keys from each rank's partial
    (out (..., H, D), lse (..., H) fp32) over the mesh dimensions
    ``names`` that split the keys: one all-gather of (out, lse) per
    dimension, then ``combine_partials`` in rank order.  Every rank
    combines the same gathered values: the same bits on each."""
    names = live_dims(mesh, names)
    if not names:
        return out
    packed = torch.cat([out.float(), lse.float()[..., None]], dim=-1)
    parts = gather_over(packed[None], mesh, names, 0)
    return combine_partials(parts[..., :-1], parts[..., -1], out.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """The reference's ``causal_attention`` at positions 0..Sq-1 against
    0..Sk-1, plain: ``gqa_attention`` over the position mask, one block
    of ``CHUNK_Q`` queries at a time once max(Sq, Sk) reaches
    ``CHUNKED_ATTN_THRESHOLD`` (and Sq divides into blocks), so the (Sq,
    Sk) logits never materialise in full.  The encoder-decoder's
    attention, which the reference computes outside any Pallas kernel."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    qpos = torch.arange(Sq, device=q.device)[None, :].expand(B, Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :].expand(B, Sk)
    if max(Sq, Sk) < CHUNKED_ATTN_THRESHOLD or Sq <= CHUNK_Q or Sq % CHUNK_Q:
        return gqa_attention(q, k, v,
                             attention_mask(qpos, kpos, causal=causal))
    return torch.cat([
        gqa_attention(q[:, i:i + CHUNK_Q], k, v,
                      attention_mask(qpos[:, i:i + CHUNK_Q], kpos,
                                     causal=causal))
        for i in range(0, Sq, CHUNK_Q)], dim=1)


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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention).  The reference computes it
# with einsums outside any Pallas kernel (its paged and flash kernels are
# GQA-shaped), so the port runs it as plain PyTorch on every device.
# ---------------------------------------------------------------------------


# Sequences at or above this length take the q-chunked path of
# ``mla_attention``, so the (Sq, Sk) logits never materialise in full
CHUNKED_ATTN_THRESHOLD = 8192
CHUNK_Q = 1024
# The port's memory bound (the reference has none): one block's (B, H, Sq,
# Sk) fp32 logits hold at most this many elements (1 GiB); a longer query
# side runs in blocks of queries, each row's softmax its own
ATTN_LOGITS_MAX = 1 << 28


def mla_specs(cfg) -> dict:
    """Shapes of the MLA leaves by reference suffix (under "attn/")."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    r = m.kv_lora_rank
    return {"wq": (D, H, dn + dr), "w_dkv": (D, r), "w_krope": (D, dr),
            "kv_norm": (r,), "w_uk": (r, H, dn), "w_uv": (r, H, dv),
            "wo": (H, dv, D)}


# The rest of DeepSeek-V2's published ``rope_scaling`` (type yarn), beside
# the config's ``yarn_factor``: the context it was trained at, the
# rotations that bound the correction ramp, and ``mscale`` =
# ``mscale_all_dim`` (so cos and sin keep their scale, and only the softmax
# scale takes YaRN's attention factor)
YARN_ORIGINAL_MAX_POSITION = 4096
YARN_BETA_FAST = 32
YARN_BETA_SLOW = 1
YARN_MSCALE_ALL_DIM = 0.707


def yarn_mscale(factor: float) -> float:
    """YaRN's attention factor 0.1 m ln(s) + 1, m = ``YARN_MSCALE_ALL_DIM``
    (1 for s <= 1)."""
    return (1.0 if factor <= 1
            else 0.1 * YARN_MSCALE_ALL_DIM * math.log(factor) + 1.0)


def yarn_frequencies(cfg, device) -> torch.Tensor:
    """(dr/2,) YaRN inverse frequencies of MLA's rope dims, as DeepSeek-V2's
    published modelling code builds them: theta^(-2i/dr) extrapolated
    below the correction dim of ``YARN_BETA_FAST`` rotations, the same /
    ``yarn_factor`` interpolated above that of ``YARN_BETA_SLOW``, a
    linear ramp between (for DeepSeek-V2-Lite: dims 10 and 23 of 64).
    Built once per (widths, device) and shared: every MLA layer's rope, at
    every launch, reads the same tensor (callers never write it)."""
    return _yarn_frequencies(cfg.mla.qk_rope_head_dim, cfg.rope_theta,
                             cfg.yarn_factor, torch.device(device))


@functools.lru_cache(maxsize=None)
def _yarn_frequencies(d: int, base: float, factor: float,
                      device: torch.device) -> torch.Tensor:
    def dim_of(rotations):
        return (d * math.log(YARN_ORIGINAL_MAX_POSITION
                             / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(dim_of(YARN_BETA_FAST)), 0)
    high = min(math.ceil(dim_of(YARN_BETA_SLOW)), d - 1)
    extra = rope_frequencies(d, base, device)
    inter = extra / factor
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def mla_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """RoPE of MLA's rope dims (q_rope, k_rope): plain under
    ``yarn_factor`` 1, else at YaRN's frequencies."""
    if cfg.yarn_factor <= 1:
        return apply_rope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta,
                      inv_freq=yarn_frequencies(cfg, x.device))


def mla_scale(cfg) -> float:
    """MLA's softmax scale: 1/sqrt(dn + dr), times ``yarn_mscale``^2 under
    YaRN."""
    m = cfg.mla
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    return scale * yarn_mscale(cfg.yarn_factor) ** 2


def mla_latent(cfg, blk, x: torch.Tensor, positions: torch.Tensor):
    """The cached quantities: the normalised latent c_kv (B, S, r) and
    the shared, rotated k_rope (B, S, dr)."""
    c_kv = torch.einsum("bsd,dr->bsr", x, blk.w_dkv)
    c_kv = rms_norm(c_kv, blk.kv_norm, cfg.norm_eps)
    k_rope = torch.einsum("bsd,dr->bsr", x, blk.w_krope)
    k_rope = mla_rope(cfg, k_rope[:, :, None, :], positions)[:, :, 0, :]
    return c_kv, k_rope


def mla_attention(cfg, blk, x: torch.Tensor, c_kv: torch.Tensor,
                  k_rope: torch.Tensor, q_positions: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None,
                  k_positions: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """MLA core.  x: (B, Sq, D) query-side activations; c_kv / k_rope
    cover the whole key side (B, Sk, r) / (B, Sk, dr).  Either an
    explicit ``mask`` (B, Sq, Sk) (chunks and decode) or ``k_positions``
    for a causal mask, built per block of ``CHUNK_Q`` queries once
    max(Sq, Sk) reaches ``CHUNKED_ATTN_THRESHOLD``; either way in blocks
    of queries whose logits stay under ``ATTN_LOGITS_MAX``.  Scale
    ``mla_scale``; the -1e30 fill before the fp32 softmax; probabilities
    cast to v's dtype, as in the reference."""
    H = cfg.num_heads
    dn = cfg.mla.qk_nope_head_dim
    q = torch.einsum("bsd,dhe->bshe", x, blk.wq)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = mla_rope(cfg, q_rope, q_positions)
    k_nope = torch.einsum("btr,rhe->bthe", c_kv, blk.w_uk)   # (B,Sk,H,dn)
    v = torch.einsum("btr,rhe->bthe", c_kv, blk.w_uv)        # (B,Sk,H,dv)
    scale = mla_scale(cfg)

    def attend(qn, qr, msk):
        logits = (torch.einsum("bshe,bthe->bhst", qn, k_nope)
                  + torch.einsum("bshe,bte->bhst", qr, k_rope)
                  ).float() * scale
        logits = torch.where(msk[:, None, :, :], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthe->bshe", probs, v)

    def mask_of(i, j):
        if mask is not None:
            return mask[:, i:j]
        return attention_mask(q_positions[:, i:j], k_positions, causal=True)

    Sq, Sk = x.shape[1], c_kv.shape[1]
    block = max(1, ATTN_LOGITS_MAX // (x.shape[0] * H * Sk))
    if (mask is None and max(Sq, Sk) >= CHUNKED_ATTN_THRESHOLD
            and Sq > CHUNK_Q and Sq % CHUNK_Q == 0):
        block = min(block, CHUNK_Q)          # the reference's q-chunks
    if block >= Sq:
        attn = attend(q_nope, q_rope, mask_of(0, Sq))
    else:
        attn = torch.cat([
            attend(q_nope[:, i:i + block], q_rope[:, i:i + block],
                   mask_of(i, i + block))
            for i in range(0, Sq, block)], dim=1)
    return torch.einsum("bshe,hed->bsd", attn, blk.wo)


def mla_partial(cfg, blk, x: torch.Tensor, c_kv: torch.Tensor,
                k_rope: torch.Tensor, q_positions: torch.Tensor,
                valid: torch.Tensor):
    """``mla_attention``'s core over the latent slots a rank holds, before
    the output projection: (attn (B, Sq, H, dv), lse (B, Sq, H) fp32).
    ``valid`` (B, Sq, Sk) marks the rank's visible slots."""
    dn = cfg.mla.qk_nope_head_dim
    q = torch.einsum("bsd,dhe->bshe", x, blk.wq)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = mla_rope(cfg, q_rope, q_positions)
    k_nope = torch.einsum("btr,rhe->bthe", c_kv, blk.w_uk)
    v = torch.einsum("btr,rhe->bthe", c_kv, blk.w_uv)
    logits = (torch.einsum("bshe,bthe->bhst", q_nope, k_nope)
              + torch.einsum("bshe,bte->bhst", q_rope, k_rope)
              ).float() * mla_scale(cfg)
    probs, lse = softmax_partial(logits, valid[:, None, :, :])
    attn = torch.einsum("bhst,bthe->bshe", probs.to(v.dtype), v)
    return attn, lse.transpose(1, 2)


def _same(t):
    return t


def mlp_apply(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, reduce=_same) -> torch.Tensor:
    """Gated-SiLU MLP (llama family; also MoE shared experts).
    ``reduce`` takes the down projection's output (the sharded step sums
    its partial outputs there)."""
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return reduce(h @ w_down)


def gelu_mlp_apply(blk, x: torch.Tensor, reduce=_same) -> torch.Tensor:
    """Two-matrix GELU MLP with biases (gpt-bigcode / granite-20b).  JAX's
    ``gelu`` is the tanh approximation, in fp32.  ``reduce`` as in
    ``mlp_apply``, before the output bias."""
    h = x @ blk.w_in + blk.b_in
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    return reduce(h @ blk.w_out) + blk.b_out


def dense_mlp_apply(cfg, blk, x: torch.Tensor, reduce=_same) -> torch.Tensor:
    """The config's dense MLP: two-matrix GELU or gated SiLU."""
    if cfg.mlp_kind == "gelu":
        return gelu_mlp_apply(blk, x, reduce)
    return mlp_apply(x, blk.w_gate, blk.w_up, blk.w_down, reduce)


# ---------------------------------------------------------------------------
# Mixture of experts.  ``w`` holds ``router`` (D, E), ``we_gate`` /
# ``we_up`` (E, D, F), ``we_down`` (E, F, D) and, with shared experts,
# ``shared_w_gate`` / ``shared_w_up`` / ``shared_w_down``.
# ---------------------------------------------------------------------------


def moe_router(x: torch.Tensor, router: torch.Tensor, top_k: int,
               renorm: bool = True):
    """Top-k softmax router.  x: (N, D) flat tokens.  Returns (weights
    (N, k) fp32, ids (N, k) int64, Switch-style aux loss).  The logits
    are a matmul in the model's dtype, the softmax fp32; ties go to the
    lower expert id (``lax.top_k``'s order: a stable descending sort).
    The top-k weights are renormalised to sum to 1 unless ``renorm`` is
    False (``ModelConfig.moe_norm_topk_prob``)."""
    logits = (x @ router).float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :top_k], ids[:, :top_k]
    if renorm:
        weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    E = logits.shape[-1]
    me = probs.mean(dim=0)
    one_hot = torch.nn.functional.one_hot(ids, E).float().sum(1)  # (N, E)
    fe = one_hot.mean(dim=0) / top_k
    aux = E * torch.sum(me * fe)
    return weights, ids, aux


def _shared_experts(cfg, w, x: torch.Tensor, out: torch.Tensor):
    if cfg.moe.num_shared_experts:
        out = out + mlp_apply(x, w.shared_w_gate, w.shared_w_up,
                              w.shared_w_down)
    return out


def moe_apply_dense(cfg, w, x: torch.Tensor):
    """GShard-style dense dispatch: every expert on every token, combined
    by the router weights (exact routing semantics, smoke scale).
    x: (B, S, D) -> ((B, S, D), aux)."""
    m = cfg.moe
    B, S, D = x.shape
    N = B * S
    xf = x.reshape(N, D)
    weights, ids, aux = moe_router(xf, w.router, m.top_k,
                                   cfg.moe_norm_topk_prob)
    comb = torch.zeros((N, m.num_experts), dtype=torch.float32,
                       device=x.device)
    comb.scatter_add_(1, ids, weights)                             # (N, E)
    g = torch.einsum("nd,edf->enf", xf, w.we_gate)
    u = torch.einsum("nd,edf->enf", xf, w.we_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = torch.einsum("enf,efd->end", h, w.we_down)
    out = torch.einsum("end,ne->nd", y.float(), comb).to(x.dtype)
    return _shared_experts(cfg, w, x, out.reshape(B, S, D)), aux


def expert_counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Assignments per expert id in [0, n): ``bincount(ids, minlength=n)``
    as a sum of ones into n rows, whose size does not depend on the ids'
    values (the dry run's ``meta`` tensors have none)."""
    return torch.zeros(n, dtype=ids.dtype, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def moe_capacity(n_tokens: int, cfg, capacity_factor: float = 1.25) -> int:
    """Slots per expert of a dropless call over ``n_tokens`` tokens."""
    m = cfg.moe
    return max(8, int(np.ceil(n_tokens * m.top_k * capacity_factor
                              / m.num_experts)))


def moe_apply_dropless(cfg, w, x: torch.Tensor,
                       capacity_factor: float = 1.25):
    """Capacity-padded dispatch: assignment j (token-major) takes slot
    pos = (its expert's assignments before it) in that expert's (C, D)
    buffer, C = ``moe_capacity`` of the call's N tokens; assignments past
    C drop (their router weight is lost; the reference's scatter adds
    zeros into slot C - 1, which changes nothing).  The experts run as
    one batched matmul (E, C, D) x (E, D, F).  x: (B, S, D) -> ((B, S,
    D), aux)."""
    m = cfg.moe
    B, S, D = x.shape
    N, k, E = B * S, m.top_k, m.num_experts
    C = moe_capacity(N, cfg, capacity_factor)
    xf = x.reshape(N, D)
    weights, ids, aux = moe_router(xf, w.router, k,
                                   cfg.moe_norm_topk_prob)        # (N, k)
    flat_ids = ids.reshape(N * k)
    # token-major rank within its expert: a stable sort keeps each
    # expert's assignments in order, and a slot's rank in its run is its
    # sorted place less the run's start (the reference's one-hot cumsum,
    # without its (N*k, E) buffer)
    order = torch.argsort(flat_ids, stable=True)
    counts = expert_counts(flat_ids, E)
    starts = counts.cumsum(0) - counts
    pos = torch.empty_like(flat_ids)
    pos[order] = (torch.arange(N * k, device=x.device)
                  - starts[flat_ids[order]])
    keep = pos < C
    safe_pos = torch.where(keep, pos, C - 1)
    # kept assignments own distinct slots, so a plain write fills them; the
    # dropped ones land in a spare slot C that no expert reads
    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    # reference: layers.py:445 (the buffer's constraint before the scatter)
    buf = constrain(buf, ("experts", "moe_capacity", None))
    buf[flat_ids, torch.where(keep, pos, C)] = xf.repeat_interleave(k, 0)
    # reference: layers.py:447 (and after it)
    buf = constrain(buf[:, :C], ("experts", "moe_capacity", None))
    g = torch.bmm(buf, w.we_gate)
    u = torch.bmm(buf, w.we_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, w.we_down)                                   # (E, C, D)
    # reference: layers.py:453
    y = constrain(y, ("experts", "moe_capacity", None))
    gathered = y[flat_ids, safe_pos]                              # (N*k, D)
    wts = weights.reshape(N * k) * keep
    out = (gathered.float() * wts[:, None]).reshape(N, k, D).sum(1)
    out = out.to(x.dtype).reshape(B, S, D)
    return _shared_experts(cfg, w, x, out), aux


def moe_apply_dropless_ep(cfg, w, x: torch.Tensor,
                          capacity_factor: float = 1.25):
    """Expert-parallel dropless MoE — the reference's shard_map dispatch
    on the installed sharder's mesh.

    Each data rank routes its own rows into its own capacity buffers (a
    local rank within each expert, so no buffer is shared across data
    ranks); ``me`` / ``fe`` are averaged over the data ranks before the
    aux product (the aux is nonlinear in them).  Over 'model', a rank runs
    its E / model experts (``ep``, when the experts divide) or its slice
    of every expert's FFN (``fp``, when d_ff_expert divides), and the
    outputs are summed over 'model'.  With no sharder, no split axis, or
    a batch that does not divide over the data ranks, it is
    ``moe_apply_dropless``, as in the reference.

    ``w`` holds the whole weights (every rank the same); x is this rank's
    rows when the sharder says the rows are split (the sharded train
    step), else the whole batch, and the result is alike.  Returns
    (out, aux)."""
    sh = current_sharder()
    if sh is None:
        return moe_apply_dropless(cfg, w, x, capacity_factor)
    mesh = sh.mesh
    sizes = mesh_shape(mesh)
    m = cfg.moe
    E, k, F = m.num_experts, m.top_k, m.d_ff_expert
    dp = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    n_dp = int(np.prod([sizes[a] for a in dp])) if dp else 1
    n_mp = sizes.get("model", 1)
    whole = not sh.rows
    if (not dp and n_mp <= 1) or (dp and whole and x.shape[0] % n_dp):
        return moe_apply_dropless(cfg, w, x, capacity_factor)
    ep = n_mp > 1 and E % n_mp == 0            # expert-sharded
    fp = n_mp > 1 and not ep and F % n_mp == 0  # expert-FFN sharded
    mp = ("model",) if (ep or fp) else ()
    E_loc = E // n_mp if ep else E
    # this rank's rows (the whole batch in: its slice, gathered back out,
    # and the weights' gradients summed over the data ranks, as the
    # reference's shard_map sums a replicated input's)
    xl = scatter_to(x, mesh, dp, 0) if whole else x
    router, we_gate, we_up, we_down = (
        copy_to(t, mesh, dp) if whole else t
        for t in (w.router, w.we_gate, w.we_up, w.we_down))
    B_loc, S, D = xl.shape
    N = B_loc * S
    xf = xl.reshape(N, D)
    probs = torch.softmax((xf @ router).float(), dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    if cfg.moe_norm_topk_prob:
        weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    # load-balance aux: me / fe are the means over every data rank's rows
    me = mean_over(probs.mean(dim=0), mesh, dp)
    fe = mean_over(torch.nn.functional.one_hot(ids, E).float().sum(1)
                   .mean(dim=0) / k, mesh, dp)
    aux = E * torch.sum(me * fe)

    # the experts' part: each rank's expert (or FFN) slice of the whole
    # weights (``scatter_to``: every rank gets the whole gradient back);
    # the rows and combine weights it sees pass through ``copy_to``, their
    # gradients summed over 'model'
    if ep:
        wg, wu, wd = (scatter_to(t, mesh, mp, 0)
                      for t in (we_gate, we_up, we_down))
    elif fp:
        wg, wu = (scatter_to(t, mesh, mp, 2) for t in (we_gate, we_up))
        wd = scatter_to(we_down, mesh, mp, 1)
    else:
        wg, wu, wd = we_gate, we_up, we_down
    xe = copy_to(xf, mesh, mp)
    wts_all = copy_to(weights, mesh, mp)
    C = moe_capacity(N, cfg, capacity_factor)
    flat_ids = ids.reshape(N * k)
    e0 = mesh.get_local_rank("model") * E_loc if ep else 0
    mine = (flat_ids >= e0) & (flat_ids < e0 + E_loc)
    loc_ids = torch.where(mine, flat_ids - e0, E_loc)       # E_loc: spare
    # token-major rank within each local expert (a stable sort, as in
    # ``moe_apply_dropless``); assignments to other ranks' experts sort
    # into the spare expert E_loc
    order = torch.argsort(loc_ids, stable=True)
    counts = expert_counts(loc_ids, E_loc + 1)
    starts = counts.cumsum(0) - counts
    pos = torch.empty_like(loc_ids)
    pos[order] = (torch.arange(N * k, device=x.device)
                  - starts[loc_ids[order]])
    keep = mine & (pos < C)
    buf = torch.zeros((E_loc + 1, C + 1, D), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, loc_ids, E_loc), torch.where(keep, pos, C)] = \
        xe.repeat_interleave(k, 0)
    buf = buf[:E_loc, :C]
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    hmid = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(hmid, wd)                                   # (E_loc, C, D)
    gathered = y[loc_ids.clamp(max=E_loc - 1), torch.where(keep, pos, 0)]
    wts = wts_all.reshape(N * k) * keep
    out = (gathered.float() * wts[:, None]).reshape(N, k, D).sum(1)
    out = reduce_from(out.to(x.dtype), mesh, mp)   # combine expert shards
    out = out.reshape(B_loc, S, D)
    if whole:
        out = gather_along(out, mesh, dp, 0)
    return _shared_experts(cfg, w, x, out), aux


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """Rows of ``x`` (M, K) sorted by group, times their group's matrix
    of ``w`` (G, K, N); ``ends`` (G,) int32 holds each group's end row
    (an empty group repeats the one before).  On the card one
    ``torch._grouped_mm`` launch with the ends on the device (no sync);
    elsewhere one matrix product per group."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=ends)
    out = x.new_empty((x.shape[0], w.shape[2]))
    lo = 0
    for g, hi in enumerate(ends.tolist()):
        out[lo:hi] = x[lo:hi] @ w[g]
        lo = hi
    return out


def moe_apply_grouped(cfg, w, x: torch.Tensor):
    """Drop-free dispatch (``ModelConfig.moe_drop_free``): the N k
    assignments sorted by expert on the device (a stable sort, so each
    expert's run is token-major), each expert's run through its gate, up
    and down matrices as three grouped GEMMs (``grouped_mm``), the
    outputs put back in token-major order and summed over k by the router
    weights in fp32, as ``moe_apply_dropless`` combines its slots.  No
    assignment drops, so a token's output does not depend on the other
    tokens of the call; with nothing dropped it is the dropless result.
    x: (B, S, D) -> ((B, S, D), aux)."""
    m = cfg.moe
    B, S, D = x.shape
    N, k, E = B * S, m.top_k, m.num_experts
    xf = x.reshape(N, D)
    weights, ids, aux = moe_router(xf, w.router, k, cfg.moe_norm_topk_prob)
    flat_ids = ids.reshape(N * k)
    order = torch.argsort(flat_ids, stable=True)
    ends = expert_counts(flat_ids, E).cumsum(0).to(torch.int32)
    xs = xf[order // k]                                        # (N*k, D)
    g = grouped_mm(xs, w.we_gate, ends)
    u = grouped_mm(xs, w.we_up, ends)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = grouped_mm(h, w.we_down, ends)                         # sorted
    y = torch.empty_like(y).index_copy_(0, order, y)           # token-major
    out = (y.float() * weights.reshape(N * k, 1)).reshape(N, k, D).sum(1)
    out = out.to(x.dtype).reshape(B, S, D)
    return _shared_experts(cfg, w, x, out), aux


MOE_IMPLS = ("dense", "dropless", "ep", "grouped")


def check_moe_impl(impl: str) -> None:
    """``dense`` | ``dropless`` | ``ep`` | ``grouped``; any other name is
    refused."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe impl {impl!r} not in "
                         + " | ".join(MOE_IMPLS))


def moe_apply(cfg, w, x: torch.Tensor, impl: str = "dense"):
    """``dense`` | ``dropless`` | ``ep`` | ``grouped``
    (``check_moe_impl``).  Under the sharded train step (a sharder whose
    ``rows`` are split) ``dense``, ``dropless`` and ``grouped`` see the
    whole batch, as the reference's global dispatch does: the rows are
    gathered, and this rank keeps its own."""
    check_moe_impl(impl)
    if impl == "ep":
        return moe_apply_dropless_ep(cfg, w, x)
    fn = {"dense": moe_apply_dense, "dropless": moe_apply_dropless,
          "grouped": moe_apply_grouped}[impl]
    sh = current_sharder()
    if sh is None or not sh.rows:
        return fn(cfg, w, x)
    idx, _ = rank_index(sh.mesh, sh.rows)
    B = x.shape[0]
    y, aux = fn(cfg, w, gather_rows(x, sh.mesh, sh.rows))
    return y[idx * B:(idx + 1) * B], aux
