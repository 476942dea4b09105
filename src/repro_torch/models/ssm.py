"""Mamba-2 SSD (state-space duality) block — the port of
``repro/models/ssm.py``: the chunked prefill form and the O(1) decode
recurrence.  [arXiv:2405.21060]

Used by ``mamba2-2.7b`` (pure SSM) and ``jamba-v0.1-52b`` (hybrid).  The
reference computes this block with einsums and a scan outside any Pallas
kernel, so the port runs it as plain PyTorch on every device: products
are ``einsum`` calls, the decay math is fp32, and the inter-chunk scan is
a Python loop over the chunks (a cumulative product would round
differently).

Shapes: d_inner = expand * d_model; H = d_inner // head_dim SSD heads of
dim P = head_dim; state N = d_state; G = ngroups shared B/C projections.
``p`` is the layer's ``DecoderBlock``, whose attributes hold the leaves
``ssm/w_in``, ``conv_w``, ``conv_b``, ``a_log``, ``d_skip``, ``dt_bias``,
``norm_w`` and ``w_out`` (``SSM_LEAVES``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
from repro_torch.parallel.sharding import constrain

# reference leaf suffix (under "ssm/") -> (DecoderBlock attr, init)
SSM_LEAVES = {
    "w_in": ("ssm_w_in", "normal"),
    "conv_w": ("conv_w", "normal"),
    "conv_b": ("conv_b", "zeros"),
    "a_log": ("a_log", "ones"),
    "d_skip": ("d_skip", "ones"),
    "dt_bias": ("dt_bias", "zeros"),
    "norm_w": ("ssm_norm_w", "ones"),
    "w_out": ("ssm_w_out", "normal"),
}


# each leaf's logical axes, by the same suffix
SSM_AXES = {
    "w_in": ("embed", "ssm_inner"),
    "conv_w": ("conv_w", "ssm_inner"),
    "conv_b": ("ssm_inner",),
    "a_log": ("ssm_heads",),
    "d_skip": ("ssm_heads",),
    "dt_bias": ("ssm_heads",),
    "norm_w": ("ssm_inner",),
    "w_out": ("ssm_inner", "embed"),
}


def ssm_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return d_inner, H, conv_dim


def ssm_specs(cfg) -> dict:
    """Shapes of the block's leaves, by ``SSM_LEAVES`` suffix."""
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, conv_dim = ssm_dims(cfg)
    in_dim = 2 * d_inner + 2 * s.ngroups * s.d_state + H
    return {"w_in": (D, in_dim), "conv_w": (s.d_conv, conv_dim),
            "conv_b": (conv_dim,), "a_log": (H,), "d_skip": (H,),
            "dt_bias": (H,), "norm_w": (d_inner,), "w_out": (d_inner, D)}


def _split_in_proj(cfg, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d_inner, H, _ = ssm_dims(cfg)
    gn = s.ngroups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: (B, L, C); w: (W, C); state: (B, W-1,
    C) holds the trailing inputs of the previous segment (decode).
    Returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B, L+W-1, C)
    L = x.shape[1]
    # y[t] = sum_k w[k] * xp[t+k], summed in the reference's order
    y = sum(xp[:, k:k + L, :] * w[k][None, None, :] for k in range(W))
    y = y + b
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    return y, new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B, L, H, P); dt: (B, L, H) (post-softplus); a: (H,) negative;
    b, c: (B, L, G, N).  Returns (y (B,L,H,P) fp32, h_final (B,H,P,N)
    fp32).  All decay math in fp32.  Above the diagonal the intra-chunk
    decay exp(cs_i - cs_j) may overflow to inf: ``torch.where`` selects
    zero there, as the reference's ``jnp.where`` does (a multiply by the
    mask would turn inf * 0 into NaN)."""
    Bsz, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    assert L % chunk == 0, f"seq {L} % chunk {chunk} != 0"
    NC = L // chunk
    rep = H // G
    f32 = torch.float32

    xc = x.reshape(Bsz, NC, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, NC, chunk, H).to(f32)
    bc = b.reshape(Bsz, NC, chunk, G, N).to(f32)
    cc = c.reshape(Bsz, NC, chunk, G, N).to(f32)

    da = dtc * a.to(f32)                                   # (B,NC,Q,H) <= 0
    cs = torch.cumsum(da, dim=2)                           # inclusive

    # ---- intra-chunk (quadratic within the chunk) ----
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)
    cb = torch.repeat_interleave(cb, rep, dim=2)           # (B,NC,H,Q,Q)
    cs_h = cs.permute(0, 1, 3, 2)                          # (B,NC,H,Q)
    decay = torch.exp(cs_h[..., :, None] - cs_h[..., None, :])
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    m = torch.where(causal, cb * decay, 0.0)               # (B,NC,H,Q,Q)
    m = m * dtc.permute(0, 1, 3, 2)[..., None, :]          # * dt_j
    y_intra = torch.einsum("bchik,bckhp->bcihp", m, xc)

    # ---- chunk states ----
    decay_states = torch.exp(cs_h[..., -1:] - cs_h)        # (B,NC,H,Q)
    bg = torch.repeat_interleave(bc, rep, dim=3)           # (B,NC,Q,H,N)
    bx = torch.einsum("bckhn,bckh,bckhp->bchpn", bg,
                      dtc * decay_states.permute(0, 1, 3, 2), xc)

    # ---- inter-chunk recurrence over the NC chunks ----
    chunk_decay = torch.exp(cs_h[..., -1])                 # (B,NC,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prevs = []
    for i in range(NC):
        h_prevs.append(h)
        h = h * chunk_decay[:, i, :, None, None] + bx[:, i]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,NC,H,P,N)

    # ---- inter-chunk output ----
    state_decay = torch.exp(cs_h)                          # (B,NC,H,Q)
    cg = torch.repeat_interleave(cc, rep, dim=3)           # (B,NC,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn,bchq->bcqhp", cg, h_prevs,
                           state_decay)
    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    return y, h


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv_and_split(cfg, p, x, conv_state):
    """In-projection, causal conv over (x, B, C), SiLU; returns (z, xc,
    b, c, dt, new_conv_state)."""
    s = cfg.ssm
    d_inner = ssm_dims(cfg)[0]
    zxbcdt = torch.einsum("bld,de->ble", x, p.ssm_w_in)
    z, xc, b, c, dt = _split_in_proj(cfg, zxbcdt)
    conv_in = torch.cat([xc, b, c], dim=-1)                # (B,L,conv_dim)
    conv_out, new_conv = _causal_conv(conv_in, p.conv_w, p.conv_b,
                                      conv_state)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    gn = s.ngroups * s.d_state
    xc, b, c = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
    return z, xc, b, c, dt, new_conv


def _gate_out(cfg, p, y: torch.Tensor, z: torch.Tensor, dtype):
    """Gated RMSNorm and the out projection.  y: (B, L, d_inner)."""
    y = y * F.silu(z.float()).to(dtype)
    y = rms_norm(y, p.ssm_norm_w, cfg.norm_eps)
    return torch.einsum("ble,ed->bld", y, p.ssm_w_out)


def ssm_apply(cfg, p, x: torch.Tensor,
              conv_state: Optional[torch.Tensor] = None,
              ssd_state: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """The Mamba-2 block over a sequence.  x: (B, L, D).  A tail that is
    not a chunk multiple is zero-padded with dt = 0 (decay 1, no input),
    so pads never reach earlier outputs or the final state.  With
    ``return_state``: (out, (conv_state, ssd_state fp32))."""
    s = cfg.ssm
    d_inner, H, _ = ssm_dims(cfg)
    P, N, G = s.head_dim, s.d_state, s.ngroups
    z, xc, b, c, dt, new_conv = _conv_and_split(cfg, p, x, conv_state)
    Bsz, L, _ = x.shape
    # reference: ssm.py:160
    xh = constrain(xc.reshape(Bsz, L, H, P),
                   ("batch", None, "ssm_heads", None))
    bh = b.reshape(Bsz, L, G, N)
    ch = c.reshape(Bsz, L, G, N)
    dt = _softplus(dt.float() + p.dt_bias.float())
    a = -torch.exp(p.a_log.float())

    chunk = min(s.chunk_size, L)
    pad = (-L) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bh = F.pad(bh, (0, 0, 0, 0, 0, pad))
        ch = F.pad(ch, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, h_final = ssd_chunked(xh, dt, a, bh, ch, chunk, ssd_state)
    if pad:
        y = y[:, :L]
        xh = xh[:, :L]
    y = y + xh.float() * p.d_skip.float()[None, None, :, None]
    y = y.reshape(Bsz, L, d_inner).to(x.dtype)
    out = _gate_out(cfg, p, y, z, x.dtype)
    if return_state:
        return out, (new_conv, h_final)
    return out


def ssm_decode_step(cfg, p, x: torch.Tensor, conv_state: torch.Tensor,
                    ssd_state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  x: (B, 1, D); conv_state: (B, W-1,
    conv_dim); ssd_state: (B, H, P, N) fp32.  Returns (y (B,1,D),
    conv_state, ssd_state)."""
    s = cfg.ssm
    d_inner, H, _ = ssm_dims(cfg)
    P, N, G = s.head_dim, s.d_state, s.ngroups
    Bsz = x.shape[0]
    z, xc, b, c, dt, new_conv = _conv_and_split(cfg, p, x, conv_state)
    rep = H // G
    xh = xc.reshape(Bsz, H, P).float()
    bh = torch.repeat_interleave(b.reshape(Bsz, G, N).float(), rep, dim=1)
    ch = torch.repeat_interleave(c.reshape(Bsz, G, N).float(), rep, dim=1)
    dt1 = _softplus(dt.float()[:, 0, :] + p.dt_bias.float())
    a = -torch.exp(p.a_log.float())
    decay = torch.exp(dt1 * a[None, :])                    # (B,H)
    new_state = (ssd_state * decay[..., None, None]
                 + torch.einsum("bh,bhp,bhn->bhpn", dt1, xh, bh))
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    y = y + xh * p.d_skip.float()[None, :, None]
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    return _gate_out(cfg, p, y, z, x.dtype), new_conv, new_state
