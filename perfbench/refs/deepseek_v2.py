"""DeepSeek-V2's decoder layer: the plain reference of its layer, its
leaves and its work (``family.py`` says what a reference module provides).

Written from the published modelling code of DeepSeek-V2 (arXiv:2405.04434)
and the configuration's sizes alone, in plain PyTorch and fp32; it imports
nothing of the program.  Departures, each one the configuration states
under ``assumed``: the rope dims are rotate-half (the checkpoint's
interleaved layout is a fixed column permutation of ``wq`` and ``w_krope``,
which random weights do not see), and the shared experts are one gated
MLP of their summed width.

Leaves, by the program's attribute names (r ``kv_lora_rank``; dn, dr, dv
the nope, rope and value head dims; E experts of width Fe, shared width
Fs):

    attn_norm, mlp_norm (D,)   wq (D, H, dn + dr)   w_dkv (D, r)
    w_krope (D, dr)   kv_norm (r,)   w_uk (r, H, dn)   w_uv (r, H, dv)
    wo (H, dv, D)
    a dense layer:  w_gate, w_up (D, F)  w_down (F, D)
    an MoE layer:   router (D, E)  we_gate, we_up (E, D, Fe)
                    we_down (E, Fe, D)  shared_w_gate, shared_w_up (D, Fs)
                    shared_w_down (Fs, D)
    top (index -1): embed (V, D)  final_norm (D,)  head (D, V)

The layer: RMSNorm; MLA in its expanded form (q, the latent c_kv =
RMSNorm(x w_dkv), K = c_kv w_uk beside the shared rotated k_rope, V =
c_kv w_uv), YaRN on the rope dims when ``yarn_factor`` > 1, with the rest
of the published ``rope_scaling`` (``ROPE_SCALING``; ``yarn_inv_freq``, cos
and sin times mscale(f, mscale) / mscale(f, mscale_all_dim)) and the
softmax scale (dn + dr)^-1/2 mscale(f, mscale_all_dim)^2, causal; then the gated-SiLU MLP (layer 0) or the MoE:
softmax over the E experts, greedy top-k, weights renormalised only under
``moe_norm_topk_prob`` (absent: true), every assignment kept (no
capacity), times ``routed_scaling_factor`` 1, plus the shared experts.

Work (what the inputs need, whatever implements them; PERF.md section 4's
rule): a token costs 2 x the parameters it uses (MLA's projections with
the K/V up-projections once per token written, the norms, and the dense
MLP or the router, top_k routed experts and the shared ones); a visible
(query, key) pair the expanded form's 2 H (dn + dr) + 2 H dv; a visible
key's bytes are its latent's, (r + dr) x 2 a layer.  ``moe_flops`` and
``moe_bytes`` are one MoE layer's expert work in one launch of n tokens
(``metrics/moe_roofline.py``).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from perfbench.reference import mm, rms_norm

# the input dims of each matrix: fp8 scales it once per output column (an
# expert's matrices once per expert and column)
IN_DIMS = {"wq": (0,), "w_dkv": (0,), "w_krope": (0,), "w_uk": (0,),
           "w_uv": (0,), "wo": (0, 1), "w_gate": (0,), "w_up": (0,),
           "w_down": (0,), "router": (0,), "we_gate": (1,), "we_up": (1,),
           "we_down": (1,), "shared_w_gate": (0,), "shared_w_up": (0,),
           "shared_w_down": (0,), "head": (0,)}


def _dims(spec: dict):
    a = spec["mla"]
    return (a["kv_lora_rank"], a["qk_nope_head_dim"], a["qk_rope_head_dim"],
            a["v_head_dim"])


def is_moe(spec: dict, i: int) -> bool:
    """Layer ``i`` is an MoE layer (DeepSeek-V2: all but the first)."""
    m = spec["moe"]
    return i >= m["first_dense_layers"] and \
        (i - m["expert_layer_offset"]) % m["expert_layer_period"] == 0


def leaf_shapes(spec: dict, i: int) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of layer ``i``'s leaves; ``i = -1`` is
    the embedding, the final norm and the head."""
    D, H, V = spec["d_model"], spec["num_heads"], spec["vocab_size"]
    r, dn, dr, dv = _dims(spec)
    if i < 0:
        return [("embed", (V, D), "matrix", 1),
                ("final_norm", (D,), "norm", 0),
                ("head", (D, V), "matrix", D)]
    out = [("attn_norm", (D,), "norm", 0),
           ("wq", (D, H, dn + dr), "matrix", D),
           ("w_dkv", (D, r), "matrix", D),
           ("w_krope", (D, dr), "matrix", D),
           ("kv_norm", (r,), "norm", 0),
           ("w_uk", (r, H, dn), "matrix", r),
           ("w_uv", (r, H, dv), "matrix", r),
           ("wo", (H, dv, D), "matrix", H * dv),
           ("mlp_norm", (D,), "norm", 0)]
    if not is_moe(spec, i):
        F = spec["d_ff"]
        return out + [("w_gate", (D, F), "matrix", D),
                      ("w_up", (D, F), "matrix", D),
                      ("w_down", (F, D), "matrix", F)]
    m = spec["moe"]
    E, Fe, Fs = m["num_experts"], m["d_ff_expert"], m["d_ff_shared"]
    return out + [("router", (D, E), "matrix", D),
                  ("we_gate", (E, D, Fe), "matrix", D),
                  ("we_up", (E, D, Fe), "matrix", D),
                  ("we_down", (E, Fe, D), "matrix", Fe),
                  ("shared_w_gate", (D, Fs), "matrix", D),
                  ("shared_w_up", (D, Fs), "matrix", D),
                  ("shared_w_down", (Fs, D), "matrix", Fs)]


# ----------------------------------------------------------------------
# YaRN, as DeepSeek-V2's modelling code builds its rotary embedding
# ----------------------------------------------------------------------
# DeepSeek-V2's published ``rope_scaling`` (type yarn) beside its factor,
# which the configuration gives as ``yarn_factor``
ROPE_SCALING = {"original_max_position_embeddings": 4096, "beta_fast": 32,
                "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}


def yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float,
                    max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_inv_freq(spec: dict, device) -> torch.Tensor:
    """(dr/2,) inverse frequencies: extrapolated (base^(-2i/dr)) below the
    low correction dim, interpolated (the same / factor) above the high
    one, a linear ramp between."""
    dim, base, f = (spec["mla"]["qk_rope_head_dim"], spec["rope_theta"],
                    spec["yarn_factor"])
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                      device=device) / dim)
    freq_extra = 1.0 / pos_freqs
    freq_inter = 1.0 / (f * pos_freqs)
    rs = ROPE_SCALING
    orig = rs["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rs["beta_fast"], dim, base,
                                         orig)), 0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], dim, base,
                                         orig)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    extra_mask = 1.0 - ramp
    return freq_inter * (1 - extra_mask) + freq_extra * extra_mask


def rope(x: torch.Tensor, spec: dict) -> torch.Tensor:
    """Rotate-half RoPE of x (S, heads, dr) at positions 0..S-1, YaRN's
    when ``yarn_factor`` > 1."""
    S, _, dr = x.shape
    f = spec.get("yarn_factor", 1.0)
    if f > 1:
        inv = yarn_inv_freq(spec, x.device)
        mult = (yarn_get_mscale(f, ROPE_SCALING["mscale"])
                / yarn_get_mscale(f, ROPE_SCALING["mscale_all_dim"]))
    else:
        inv = 1.0 / spec["rope_theta"] ** (
            torch.arange(0, dr, 2, dtype=torch.float32, device=x.device) / dr)
        mult = 1.0
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = (torch.cos(ang) * mult)[:, None, :]
    sin = (torch.sin(ang) * mult)[:, None, :]
    x1, x2 = x[..., :dr // 2], x[..., dr // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(spec: dict) -> float:
    a = spec["mla"]
    scale = (a["qk_nope_head_dim"] + a["qk_rope_head_dim"]) ** -0.5
    f = spec.get("yarn_factor", 1.0)
    if f > 1:
        m = yarn_get_mscale(f, ROPE_SCALING["mscale_all_dim"])
        scale = scale * m * m
    return scale


# ----------------------------------------------------------------------
# the layer
# ----------------------------------------------------------------------
def attention(q, k, v, scale: float, block: int = 1024) -> torch.Tensor:
    """Causal attention, q/k (S, H, dn + dr), v (S, H, dv), queries in
    blocks."""
    S = q.shape[0]
    out = q.new_empty((S, q.shape[1], v.shape[2]))
    jpos = torch.arange(S, device=q.device)[None, :]
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        s = torch.einsum("qhd,thd->hqt", q[lo:hi], k) * scale
        ipos = torch.arange(lo, hi, device=q.device)[:, None]
        s = torch.where(jpos <= ipos, s, float("-inf"))
        out[lo:hi] = torch.einsum("hqt,thd->qhd", torch.softmax(s, -1), v)
    return out


def swiglu(h, w_gate, w_up, w_down, low: bool) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(h, w_gate, low))
              * mm(h, w_up, low), w_down, low)


def moe(spec: dict, w: dict, h: torch.Tensor, low: bool) -> torch.Tensor:
    """Softmax router, greedy top-k, each expert over the tokens routed to
    it (none dropped), the weighted sum, and the shared experts."""
    m = spec["moe"]
    k = m["top_k"]
    probs = torch.softmax(mm(h, w["router"], low), dim=-1)
    wts, ids = torch.topk(probs, k, dim=-1)
    if spec.get("moe_norm_topk_prob", True):
        wts = wts / wts.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(m["num_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if len(tok) == 0:
            continue
        ye = swiglu(h[tok], w["we_gate"][e], w["we_up"][e], w["we_down"][e],
                    low)
        y.index_add_(0, tok, ye * wts[tok, slot, None])
    if m["num_shared_experts"]:
        y = y + swiglu(h, w["shared_w_gate"], w["shared_w_up"],
                       w["shared_w_down"], low)
    return y


def block(spec: dict, w: dict, x: torch.Tensor, low: bool) -> torch.Tensor:
    """One decoder layer over x (S, D), its MLP dense or MoE by the layer's
    leaves."""
    eps = spec["norm_eps"]
    S, D = x.shape
    H = spec["num_heads"]
    r, dn, dr, dv = _dims(spec)
    h = rms_norm(x, w["attn_norm"], eps)
    q = mm(h, w["wq"].reshape(D, H * (dn + dr)), low).reshape(S, H, dn + dr)
    c_kv = rms_norm(mm(h, w["w_dkv"], low), w["kv_norm"], eps)
    k_rope = rope(mm(h, w["w_krope"], low)[:, None, :], spec)   # (S, 1, dr)
    k_nope = mm(c_kv, w["w_uk"].reshape(r, H * dn), low).reshape(S, H, dn)
    v = mm(c_kv, w["w_uv"].reshape(r, H * dv), low).reshape(S, H, dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], spec)], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(S, H, dr)], dim=-1)
    a = attention(q, k, v, softmax_scale(spec))
    x = x + mm(a.reshape(S, H * dv), w["wo"].reshape(H * dv, D), low)
    h = rms_norm(x, w["mlp_norm"], eps)
    if "router" in w:
        return x + moe(spec, w, h, low)
    return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"], low)


# ----------------------------------------------------------------------
# work
# ----------------------------------------------------------------------
def layer_flops(spec: dict, i: int) -> int:
    """2 x the parameters a token uses: MLA's projections (the K/V
    up-projections once per token written), the norms, and the dense MLP
    or the router, top_k routed experts and the shared ones."""
    D, H = spec["d_model"], spec["num_heads"]
    r, dn, dr, dv = _dims(spec)
    p = (D * H * (dn + dr) + D * r + D * dr + r + r * H * dn + r * H * dv
         + H * dv * D + 2 * D)
    if is_moe(spec, i):
        m = spec["moe"]
        p += (D * m["num_experts"] + m["top_k"] * 3 * D * m["d_ff_expert"]
              + 3 * D * m["d_ff_shared"])
    else:
        p += 3 * D * spec["d_ff"]
    return 2 * p


def pair_flops(spec: dict, i: int) -> int:
    H = spec["num_heads"]
    _, dn, dr, dv = _dims(spec)
    return 2 * H * (dn + dr) + 2 * H * dv


def query_bytes(spec: dict, i: int) -> int:
    H = spec["num_heads"]
    _, dn, dr, dv = _dims(spec)
    return (H * (dn + dr) + H * dv) * 2          # q read + output, bf16


def key_bytes(spec: dict, i: int) -> int:
    r, _, dr, _ = _dims(spec)
    return (r + dr) * 2                          # the latent, bf16


def moe_flops(spec: dict, i: int, n: int) -> int:
    """The routed experts' FLOPs of ``n`` tokens in layer ``i``: gate, up
    and down, 6 D Fe per assignment (0 in a dense layer)."""
    if not is_moe(spec, i):
        return 0
    m = spec["moe"]
    return 6 * spec["d_model"] * m["d_ff_expert"] * m["top_k"] * n


def moe_bytes(spec: dict, i: int, n: int) -> int:
    """The least bytes of one launch of the routed experts over ``n``
    tokens in layer ``i``: min(E, n k) experts' three matrices read once,
    each token's input read and output written, in bf16 (0 in a dense
    layer)."""
    if not is_moe(spec, i):
        return 0
    m = spec["moe"]
    D = spec["d_model"]
    experts = min(m["num_experts"], n * m["top_k"])
    return (experts * 3 * D * m["d_ff_expert"] + n * 2 * D) * 2
