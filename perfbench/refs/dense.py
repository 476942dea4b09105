"""The dense GQA decoder: the plain reference of its layer, its leaves and
its work (``family.py`` says what a reference module provides).

Leaves, by the program's attribute names:

    wq (D, H, Dh)   wk, wv (D, K, Dh)   wo (H, Dh, D)
    attn_norm, mlp_norm (D,)
    gelu MLP:  w_in (D, F)  b_in (F,)  w_out (F, D)  b_out (D,)
    gated MLP: w_gate, w_up (D, F)  w_down (F, D)
    top (index -1): embed (V, D)  final_norm (D,)  head (D, V)

The layer: RMSNorm, rotate-half RoPE, causal GQA attention with the
optional sliding window of ``window`` keys including the query's own, the
two-matrix tanh-GELU MLP with biases or the gated-SiLU MLP.

Work (what the inputs need, whatever implements them): a token costs 2 x
the layer's parameters; a visible (query, key) pair 4 x heads x head_dim
(QK^T and PV); a query reads its q and writes its output, a visible key
its K and V, in bf16.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from perfbench.reference import mm, rms_norm


def leaf_shapes(spec: dict, i: int) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of layer ``i``'s leaves; ``i = -1`` is
    the embedding, the final norm and the head.  ``kind``: matrix | bias |
    norm."""
    D, H, K, Dh = spec["d_model"], spec["num_heads"], spec["num_kv_heads"], \
        spec["head_dim"]
    F, V = spec["d_ff"], spec["vocab_size"]
    if i < 0:
        out = [("embed", (V, D), "matrix", 1), ("final_norm", (D,), "norm", 0)]
        if not spec.get("tie_embeddings", False):
            out.append(("head", (D, V), "matrix", D))
        return out
    out = [("attn_norm", (D,), "norm", 0),
           ("wq", (D, H, Dh), "matrix", D), ("wk", (D, K, Dh), "matrix", D),
           ("wv", (D, K, Dh), "matrix", D), ("wo", (H, Dh, D), "matrix", H * Dh),
           ("mlp_norm", (D,), "norm", 0)]
    if spec["mlp_kind"] == "gelu":
        out += [("w_in", (D, F), "matrix", D), ("b_in", (F,), "bias", 0),
                ("w_out", (F, D), "matrix", F), ("b_out", (D,), "bias", 0)]
    else:
        out += [("w_gate", (D, F), "matrix", D), ("w_up", (D, F), "matrix", D),
                ("w_down", (F, D), "matrix", F)]
    return out


# the input dims of each matrix: fp8 scales it once per output column
IN_DIMS = {"wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1), "w_in": (0,),
           "w_out": (0,), "w_gate": (0,), "w_up": (0,), "w_down": (0,),
           "head": (0,)}


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x (S, heads, Dh) at positions 0..S-1."""
    S, _, Dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32,
                                       device=x.device) / Dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int, block: int = 1024) -> torch.Tensor:
    """Causal GQA attention, q (S, H, Dh), k/v (S, K, Dh), queries in
    blocks; query i sees keys j with j <= i and, under a window, i - j <
    window."""
    S, H, Dh = q.shape
    K = k.shape[1]
    G = H // K
    kk = k.permute(1, 2, 0)                          # (K, Dh, S)
    vv = v.permute(1, 0, 2)                          # (K, S, Dh)
    out = torch.empty_like(q)
    jpos = torch.arange(S, device=q.device)[None, :]
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        qb = q[lo:hi].reshape(hi - lo, K, G, Dh).permute(1, 0, 2, 3)
        s = torch.einsum("kqgd,kdt->kgqt", qb, kk) / math.sqrt(Dh)
        ipos = torch.arange(lo, hi, device=q.device)[:, None]
        ok = jpos <= ipos
        if window > 0:
            ok = ok & (jpos > ipos - window)
        s = torch.where(ok, s, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("kgqt,ktd->qkgd", p, vv)
        out[lo:hi] = o.reshape(hi - lo, H, Dh)
    return out


def block(spec: dict, w: dict, x: torch.Tensor, low: bool) -> torch.Tensor:
    """One decoder layer over x (S, D)."""
    eps = spec["norm_eps"]
    S, D = x.shape
    H, K, Dh = spec["num_heads"], spec["num_kv_heads"], spec["head_dim"]
    h = rms_norm(x, w["attn_norm"], eps)
    q = mm(h, w["wq"].reshape(D, H * Dh), low).reshape(S, H, Dh)
    k = mm(h, w["wk"].reshape(D, K * Dh), low).reshape(S, K, Dh)
    v = mm(h, w["wv"].reshape(D, K * Dh), low).reshape(S, K, Dh)
    q, k = rope(q, spec["rope_theta"]), rope(k, spec["rope_theta"])
    a = attention(q, k, v, spec.get("sliding_window", 0))
    x = x + mm(a.reshape(S, H * Dh), w["wo"].reshape(H * Dh, D), low)
    h = rms_norm(x, w["mlp_norm"], eps)
    if spec["mlp_kind"] == "gelu":
        m = torch.nn.functional.gelu(mm(h, w["w_in"], low) + w["b_in"],
                                     approximate="tanh")
        y = mm(m, w["w_out"], low) + w["b_out"]
    else:
        m = torch.nn.functional.silu(mm(h, w["w_gate"], low)) \
            * mm(h, w["w_up"], low)
        y = mm(m, w["w_down"], low)
    return x + y


# ----------------------------------------------------------------------
# work: every layer alike
# ----------------------------------------------------------------------
def layer_params(spec: dict) -> int:
    D, H, K, Dh, F = (spec["d_model"], spec["num_heads"],
                      spec["num_kv_heads"], spec["head_dim"], spec["d_ff"])
    attn = D * H * Dh + 2 * D * K * Dh + H * Dh * D
    mlp = (2 * D * F + F + D) if spec["mlp_kind"] == "gelu" else 3 * D * F
    return attn + mlp + 2 * D


def attn_flops_per_pair(spec: dict) -> int:
    return 4 * spec["num_heads"] * spec["head_dim"]


def layer_flops(spec: dict, i: int) -> int:
    return 2 * layer_params(spec)


def pair_flops(spec: dict, i: int) -> int:
    return attn_flops_per_pair(spec)


def query_bytes(spec: dict, i: int) -> int:
    return 2 * spec["num_heads"] * spec["head_dim"] * 2  # q read + out, bf16


def key_bytes(spec: dict, i: int) -> int:
    return 2 * spec["num_kv_heads"] * spec["head_dim"] * 2  # k + v, bf16
