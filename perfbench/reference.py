"""The plain reference: a decoder's forward pass in fp32, written from the
configuration's sizes alone, in plain PyTorch.

It knows nothing of the program: the weights are the benchmark's own
(``weights.py``, drawn again here layer by layer from the seed) and every
step is written out below (RMSNorm, rotate-half RoPE, causal GQA attention
with the optional sliding window of ``window`` keys including the query's
own, the two-matrix tanh-GELU MLP with biases or the gated-SiLU MLP, the
final norm and the head).  TF32 is switched off for the pass.

``served_gaps`` judges a served model: over each sequence (prompt + served
tokens), for each position that produced a served token, how far that
token's reference logit lies below the reference's best.  In the same pass
it reads each prompt's CoIC descriptor: the hidden state after the first
``k_layers`` layers, mean-pooled over the prompt's positions and scaled to
unit length (the prompt's positions see only the prompt, so the served
tokens after it change nothing there).  ``control``
computes, in the same pass, the same model with every matrix product in
fp8 (e4m3: weights scaled per output column, activations per token;
attention and norms in fp32), the precision step below the configuration's
bf16, and reads the reference's gap of the token it puts first and its own
descriptor.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from perfbench import weights as W

_FP8 = torch.float8_e4m3fn
_FP8_MAX = 448.0


@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# the input dims of each matrix: fp8 scales it once per output column
_IN_DIMS = {"wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1), "w_in": (0,),
            "w_out": (0,), "w_gate": (0,), "w_up": (0,), "w_down": (0,),
            "head": (0,)}


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` rounded to e4m3, one scale per slice across ``dims`` (its amax
    maps to the format's largest value)."""
    amax = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12)
    scale = amax / _FP8_MAX
    return (x / scale).to(_FP8).to(torch.float32) * scale


def fp8_weights(w: dict) -> dict:
    """A layer's leaves with every matrix rounded to fp8 per column."""
    return {n: (_fp8(t, _IN_DIMS[n]) if n in _IN_DIMS else t)
            for n, t in w.items()}


def _mm(x: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    """x (S, in) @ w (in, out); ``low``: x rounded to fp8 per token (w is
    rounded already, ``fp8_weights``)."""
    if low:
        return _fp8(x, (-1,)) @ w
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


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
    q = _mm(h, w["wq"].reshape(D, H * Dh), low).reshape(S, H, Dh)
    k = _mm(h, w["wk"].reshape(D, K * Dh), low).reshape(S, K, Dh)
    v = _mm(h, w["wv"].reshape(D, K * Dh), low).reshape(S, K, Dh)
    q, k = rope(q, spec["rope_theta"]), rope(k, spec["rope_theta"])
    a = attention(q, k, v, spec.get("sliding_window", 0))
    x = x + _mm(a.reshape(S, H * Dh), w["wo"].reshape(H * Dh, D), low)
    h = rms_norm(x, w["mlp_norm"], eps)
    if spec["mlp_kind"] == "gelu":
        m = torch.nn.functional.gelu(_mm(h, w["w_in"], low) + w["b_in"],
                                     approximate="tanh")
        y = _mm(m, w["w_out"], low) + w["b_out"]
    else:
        m = torch.nn.functional.silu(_mm(h, w["w_gate"], low)) \
            * _mm(h, w["w_up"], low)
        y = _mm(m, w["w_down"], low)
    return x + y


class Pass(NamedTuple):
    """What one reference pass reads (control fields None without it)."""
    gaps: List[torch.Tensor]              # per sequence, one per served token
    control_gaps: Optional[List[torch.Tensor]]
    desc: List[torch.Tensor]              # per sequence, (D,) unit, fp32
    control_desc: Optional[List[torch.Tensor]]


def descriptor(x: torch.Tensor, n: int) -> torch.Tensor:
    """The unit mean of the first ``n`` rows of a hidden state (S, D)."""
    pooled = x[:n].mean(0)
    return (pooled / pooled.norm().clamp(min=1e-8)).cpu()


@torch.no_grad()
def served_gaps(spec: dict, seed: int, prompts: Sequence[torch.Tensor],
                served: Sequence[torch.Tensor], device,
                control: bool = False, layers: Optional[int] = None,
                k_layers: int = 2) -> Pass:
    """For each (prompt, served tokens) pair: the gap (fp32 tensor, one per
    served token) by which the served token's reference logit lies below
    the reference's best at its position, and the prompt's descriptor after
    ``k_layers`` layers; with ``control`` also the gaps of the tokens that
    the fp8 model puts first, and its descriptors.  ``layers`` limits the
    depth (tests)."""
    L = spec["num_layers"] if layers is None else layers
    seqs, starts = [], []
    for p, t in zip(prompts, served):
        p, t = p.to(device).long(), t.to(device).long()
        seqs.append(torch.cat([p, t[:-1]]))
        starts.append(len(p) - 1)
    desc, cdesc = [], ([] if control else None)
    with _no_tf32():
        top = W.layer(spec, seed, -1, device, torch.float32)
        xs = [top["embed"][s] for s in seqs]
        x8 = [x.clone() for x in xs] if control else None
        for i in range(L):
            w = W.layer(spec, seed, i, device, torch.float32)
            xs = [block(spec, w, x, False) for x in xs]
            if control:
                w8 = fp8_weights(w)
                x8 = [block(spec, w8, x, True) for x in x8]
                del w8
            del w
            if i + 1 == k_layers:
                desc = [descriptor(x, s0 + 1) for x, s0 in zip(xs, starts)]
                if control:
                    cdesc = [descriptor(x, s0 + 1)
                             for x, s0 in zip(x8, starts)]
        head = top["embed"].T if spec.get("tie_embeddings") else top["head"]
        head8 = _fp8(head, (0,)) if control else None
        gaps, cgaps = [], ([] if control else None)
        for j, (x, t, s0) in enumerate(zip(xs, served, starts)):
            h = rms_norm(x[s0:], top["final_norm"], spec["norm_eps"])
            logits = h @ head
            best = logits.max(-1).values
            tok = t.to(device).long()
            gaps.append((best - logits.gather(1, tok[:, None])[:, 0]).cpu())
            if control:
                h8 = rms_norm(x8[j][s0:], top["final_norm"], spec["norm_eps"])
                lt = _mm(h8, head8, True).argmax(-1)
                cgaps.append((best - logits.gather(1, lt[:, None])[:, 0])
                             .cpu())
        return Pass(gaps, cgaps, desc, cdesc)


@torch.no_grad()
def logits(spec: dict, seed: int, tokens: torch.Tensor, device,
           layers: Optional[int] = None) -> torch.Tensor:
    """The reference's fp32 logits (S, V) of one sequence."""
    L = spec["num_layers"] if layers is None else layers
    with _no_tf32():
        top = W.layer(spec, seed, -1, device, torch.float32)
        x = top["embed"][tokens.to(device).long()]
        for i in range(L):
            x = block(spec, W.layer(spec, seed, i, device, torch.float32), x,
                      False)
        head = top["embed"].T if spec.get("tie_embeddings") else top["head"]
        return rms_norm(x, top["final_norm"], spec["norm_eps"]) @ head
