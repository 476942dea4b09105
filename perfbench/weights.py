"""Seeded random weights of a decoder configuration, made on the device.

The benchmark owns the weights: ``layer(spec, seed, i)`` draws layer
``i``'s leaves from one generator seeded by (seed, i), in one ``randn``
call, so the loader (which copies them into the program's model) and the
reference (which draws them again, layer by layer, in fp32) see the same
values.  The leaves, their order and their shapes are the configuration's
reference module's (``family.py``; ``refs/dense.py`` lists the GQA
decoder's).

A matrix is N(0, s^2) with s = min(0.02, 1 / sqrt(fan_in)); a bias is
N(0, 0.02^2); a norm weight is 1 + N(0, 0.02^2), so a path that drops the
bias or the norm weight shows in the comparison.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench import family as F

_MASK63 = (1 << 63) - 1


def _seed_of(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + (i + 1) * 7919) & _MASK63


@torch.no_grad()
def layer(spec: dict, seed: int, i: int, device, dtype=torch.bfloat16
          ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves (``i = -1``: the top leaves) in ``dtype``: the
    values as served, rounded to the configuration's dtype first
    (``spec["dtype"]``), whatever ``dtype`` asks for."""
    served = getattr(torch, spec.get("dtype", "bfloat16"))
    leaves = F.of(spec).leaf_shapes(spec, i)
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
