"""Weights across the two packages: the reference ``DecoderLM``'s flat
``{name: array}`` params dict <-> the port's ``DecoderLM`` modules.

The reference stacks every ``blocks/...`` leaf along a leading layers
axis whenever the segment repeats (``num_layers > 1``), whatever
``scan_layers`` says; the port keeps one module per layer.  Layouts are
the reference's own (``wq`` (D, H, Dh), ``wo`` (H, Dh, D), the GELU MLP's
``mlp/w_in`` / ``b_in`` / ``w_out`` / ``b_out``, the experts'
``moe/router`` (D, E), ``moe/we_*`` (E, ...), ``moe/shared/*``), so a leaf
moves across unchanged; ``DecoderLM.leaves`` lists the ones a model has
(no ``head/w`` under tied embeddings).  Arrays pass through numpy as float32 (a bf16
reference leaf is widened first; the port narrows to its own dtype).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


@torch.no_grad()
def params_from_jax(flat: Dict[str, np.ndarray], model) -> None:
    """Load the reference's flat params (as numpy arrays) into ``model``
    in place.  Every leaf of the model must be present, and nothing else."""
    stacked = model.cfg.num_layers > 1
    seen = set()
    for name, layer, owner, attr, _ in model.leaves():
        if name not in flat:
            raise KeyError(f"reference params lack {name!r}")
        arr = np.asarray(flat[name], np.float32)
        if layer is not None and stacked:
            arr = arr[layer]
        p = getattr(owner, attr)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}[{layer}]: shape {arr.shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
        seen.add(name)
    extra = set(flat) - seen
    if extra:
        raise KeyError(f"reference params the port does not carry: "
                       f"{sorted(extra)}")


def params_to_numpy(model) -> Dict[str, np.ndarray]:
    """The inverse: the port's weights as the reference's flat dict of
    float32 arrays (layers stacked when ``num_layers > 1``)."""
    per_name: Dict[str, list] = {}
    for name, layer, owner, attr, _ in model.leaves():
        arr = getattr(owner, attr).detach().float().cpu().numpy()
        per_name.setdefault(name, []).append(arr)
    stacked = model.cfg.num_layers > 1
    return {name: (np.stack(arrs) if stacked and name.startswith("blocks/")
                   else arrs[0])
            for name, arrs in per_name.items()}
