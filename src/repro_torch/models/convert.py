"""Weights across the two packages: the reference ``DecoderLM``'s (or
``EncDecLM``'s) flat ``{name: array}`` params dict <-> the port's
modules, and that flat layout as tensors for training
(``master_params``, ``module_params``).

Names are ``{segment}/{position}/{suffix}`` (``blocks/0/attn/wq``,
``prefix0/0/mlp/w_gate``, ``blocks/4/ssm/a_log``) plus the top-level
``embed/tokens``, ``final_norm/w`` and ``head/w``; an ``EncDecLM``'s are
``embed/``, ``enc/`` and ``dec/`` leaves, each ``enc/l/`` and ``dec/l/``
leaf stacked over its layers.  The reference stacks a
segment's leaves along a leading axis whenever the segment repeats
(``seg.repeats > 1``), whatever ``scan_layers`` says; the port keeps one
module per layer, and ``DecoderLM.leaves`` gives each leaf's repeat index
(None for a segment that does not repeat).  Layouts are the reference's
own, so a leaf moves across unchanged; ``DecoderLM.leaves`` lists the
ones a model has (no ``head/w`` under tied embeddings).  Arrays pass
through numpy as float32 (a bf16 reference leaf is widened first; the
port narrows to its own dtype).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


@torch.no_grad()
def params_from_jax(flat: Dict[str, np.ndarray], model) -> None:
    """Load the reference's flat params (as numpy arrays) into ``model``
    in place.  Every leaf of the model must be present, and nothing else."""
    seen = set()
    for name, r, owner, attr, _ in model.leaves():
        if name not in flat:
            raise KeyError(f"reference params lack {name!r}")
        arr = np.asarray(flat[name], np.float32)
        if r is not None:
            arr = arr[r]
        p = getattr(owner, attr)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}[{r}]: shape {arr.shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
        seen.add(name)
    extra = set(flat) - seen
    if extra:
        raise KeyError(f"reference params the port does not carry: "
                       f"{sorted(extra)}")


def params_to_numpy(model) -> Dict[str, np.ndarray]:
    """The inverse: the port's weights as the reference's flat dict of
    float32 arrays (a repeating segment's leaves stacked)."""
    return {name: t.cpu().numpy() for name, t in master_params(model).items()}


def master_params(model, dtype: torch.dtype = torch.float32
                  ) -> Dict[str, torch.Tensor]:
    """The model's weights in the reference's flat layout, as ``dtype``
    tensors on the model's device (a repeating segment's leaves
    stacked): the layout of ``train/trainer.py``'s master weights and of
    a checkpoint, so a leaf has the reference's shape and rank."""
    per_name: Dict[str, list] = {}
    stacked = set()
    for name, r, owner, attr, _ in model.leaves():
        per_name.setdefault(name, []).append(
            getattr(owner, attr).detach().to(dtype))
        if r is not None:
            stacked.add(name)
    return {name: torch.stack(ts) if name in stacked else ts[0].clone()
            for name, ts in per_name.items()}


def module_params(model, flat: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``flat`` (the reference's layout, as ``master_params`` gives it) as
    ``{module parameter path: tensor}`` for
    ``torch.func.functional_call(model, ...)``: a stacked leaf is unbound
    along its leading axis, one view per layer, so the gradients of the
    layers stack back into the stacked leaf's."""
    paths = {id(m): n for n, m in model.named_modules()}
    parts: Dict[str, tuple] = {}
    out = {}
    for name, r, owner, attr, _ in model.leaves():
        t = flat[name]
        if r is not None:
            if name not in parts:
                parts[name] = t.unbind(0)
            t = parts[name][r]
        prefix = paths[id(owner)]
        out[f"{prefix}.{attr}" if prefix else attr] = t
    return out
