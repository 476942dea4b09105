"""AdamW over fp32 master weights — the port of ``repro/optim/adamw.py``.

Functional, on flat ``{name: tensor}`` dicts: ``init`` builds the state,
``update`` takes fp32 gradients and returns new weights and state.
Global-norm clipping (the norm of every gradient, reported before the
clip, with 1e-9 in the divisor), bias correction and decoupled weight
decay.  A leaf decays iff its rank is above 1, so norms, biases and
scalars do not; the trainer keeps the reference's flat layout, in which
a repeating segment's leaves are stacked, so a stacked norm weight
(R, D) decays exactly where the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor                # () int32


class AdamW:
    def __init__(self, cfg: AdamWConfig, schedule: Callable):
        self.cfg = cfg
        self.schedule = schedule

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
        dev = next(iter(params.values())).device
        return OptState(mu=zeros(), nu=zeros(),
                        count=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor],
               gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], OptState, dict]:
        """grads/params fp32.  Returns (new_params, new_state, metrics
        {grad_norm, lr}).  ``gnorm``: the global gradient norm when the
        leaves are this rank's slices of a sharded state (the sharded step
        sums it over the mesh); by default the norm of ``grads``."""
        cfg = self.cfg
        names = sorted(params)                 # the reference's leaf order
        if gnorm is None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k].float()))
                                   for k in names))
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        count = state.count + 1
        lr = self.schedule(count)
        c = count.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=c.device), c)
        b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=c.device), c)
        new_p, new_m, new_v = {}, {}, {}
        for k in names:
            p = params[k]
            g = grads[k].float() * scale
            m = cfg.b1 * state.mu[k] + (1 - cfg.b1) * g
            v = cfg.b2 * state.nu[k] + (1 - cfg.b2) * torch.square(g)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if p.ndim > 1:
                upd = upd + cfg.weight_decay * p
            new_p[k], new_m[k], new_v[k] = p - lr * upd, m, v
        return (new_p, OptState(mu=new_m, nu=new_v, count=count),
                {"grad_norm": gnorm, "lr": lr})
