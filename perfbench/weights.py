"""Seeded random weights of a decoder configuration, made on the device.

The benchmark owns the weights: ``layer(spec, seed, i)`` draws layer
``i``'s leaves from one generator seeded by (seed, i), in one ``randn``
call, so the loader (which copies them into the program's model) and the
reference (which draws them again, layer by layer, in fp32) see the same
values.  Leaves are named by the reference's own layout:

    wq (D, H, Dh)   wk, wv (D, K, Dh)   wo (H, Dh, D)
    attn_norm, mlp_norm (D,)
    gelu MLP:  w_in (D, F)  b_in (F,)  w_out (F, D)  b_out (D,)
    gated MLP: w_gate, w_up (D, F)  w_down (F, D)
    top (index -1): embed (V, D)  final_norm (D,)  head (D, V)

A matrix is N(0, s^2) with s = min(0.02, 1 / sqrt(fan_in)); a bias is
N(0, 0.02^2); a norm weight is 1 + N(0, 0.02^2), so a path that drops the
bias or the norm weight shows in the comparison.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_MASK63 = (1 << 63) - 1


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


def _seed_of(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + (i + 1) * 7919) & _MASK63


@torch.no_grad()
def layer(spec: dict, seed: int, i: int, device, dtype=torch.bfloat16
          ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves (``i = -1``: the top leaves) in ``dtype``: the
    values as served, rounded to the configuration's dtype first
    (``spec["dtype"]``), whatever ``dtype`` asks for."""
    served = getattr(torch, spec.get("dtype", "bfloat16"))
    leaves = leaf_shapes(spec, i)
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    g = torch.Generator(device=device).manual_seed(_seed_of(seed, i))
    flat = torch.randn(sum(sizes), generator=g, dtype=torch.float32,
                       device=device)
    out, at = {}, 0
    for (name, shape, kind, fan_in), n in zip(leaves, sizes):
        x = flat[at:at + n].view(shape)
        at += n
        if kind == "matrix":
            x = x * min(0.02, 1.0 / math.sqrt(fan_in))
        elif kind == "bias":
            x = x * 0.02
        else:
            x = 1.0 + x * 0.02
        out[name] = x.to(served).to(dtype)
    del flat
    return out
