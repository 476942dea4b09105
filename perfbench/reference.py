"""The plain reference: a decoder's forward pass in fp32, written from the
configuration's sizes alone, in plain PyTorch.

It knows nothing of the program: the weights are the benchmark's own
(``weights.py``, drawn again here layer by layer from the seed) and every
step is written out: the embedding, each layer by the configuration's
reference module (``family.py``; ``refs/dense.py``, the GQA decoder's
RMSNorm, RoPE, attention and MLP), the final norm and the head.  TF32 is
switched off for the pass.  Here too are the primitives the modules share:
``rms_norm``, ``fp8`` and ``mm``, the matrix product with the control's
rounding.

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
from typing import List, NamedTuple, Optional, Sequence

import torch

from perfbench import family as F
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


def fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` rounded to e4m3, one scale per slice across ``dims`` (its amax
    maps to the format's largest value)."""
    amax = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12)
    scale = amax / _FP8_MAX
    return (x / scale).to(_FP8).to(torch.float32) * scale


def fp8_weights(w: dict, in_dims: dict) -> dict:
    """A layer's leaves with every matrix (``in_dims``: its input dims, the
    module's ``IN_DIMS``) rounded to fp8 per column."""
    return {n: (fp8(t, in_dims[n]) if n in in_dims else t)
            for n, t in w.items()}


def mm(x: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    """x (S, in) @ w (in, out); ``low``: x rounded to fp8 per token (w is
    rounded already, ``fp8_weights``)."""
    if low:
        return fp8(x, (-1,)) @ w
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


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
    ref = F.of(spec)
    with _no_tf32():
        top = W.layer(spec, seed, -1, device, torch.float32)
        xs = [top["embed"][s] for s in seqs]
        x8 = [x.clone() for x in xs] if control else None
        for i in range(L):
            w = W.layer(spec, seed, i, device, torch.float32)
            xs = [ref.block(spec, w, x, False) for x in xs]
            if control:
                w8 = fp8_weights(w, ref.IN_DIMS)
                x8 = [ref.block(spec, w8, x, True) for x in x8]
                del w8
            del w
            if i + 1 == k_layers:
                desc = [descriptor(x, s0 + 1) for x, s0 in zip(xs, starts)]
                if control:
                    cdesc = [descriptor(x, s0 + 1)
                             for x, s0 in zip(x8, starts)]
        head = top["embed"].T if spec.get("tie_embeddings") else top["head"]
        head8 = fp8(head, (0,)) if control else None
        gaps, cgaps = [], ([] if control else None)
        for j, (x, t, s0) in enumerate(zip(xs, served, starts)):
            h = rms_norm(x[s0:], top["final_norm"], spec["norm_eps"])
            logits = h @ head
            best = logits.max(-1).values
            tok = t.to(device).long()
            gaps.append((best - logits.gather(1, tok[:, None])[:, 0]).cpu())
            if control:
                h8 = rms_norm(x8[j][s0:], top["final_norm"], spec["norm_eps"])
                lt = mm(h8, head8, True).argmax(-1)
                cgaps.append((best - logits.gather(1, lt[:, None])[:, 0])
                             .cpu())
        return Pass(gaps, cgaps, desc, cdesc)


@torch.no_grad()
def logits(spec: dict, seed: int, tokens: torch.Tensor, device,
           layers: Optional[int] = None) -> torch.Tensor:
    """The reference's fp32 logits (S, V) of one sequence."""
    L = spec["num_layers"] if layers is None else layers
    ref = F.of(spec)
    with _no_tf32():
        top = W.layer(spec, seed, -1, device, torch.float32)
        x = top["embed"][tokens.to(device).long()]
        for i in range(L):
            x = ref.block(spec, W.layer(spec, seed, i, device, torch.float32),
                          x, False)
        head = top["embed"].T if spec.get("tie_embeddings") else top["head"]
        return rms_norm(x, top["final_norm"], spec["norm_eps"]) @ head
