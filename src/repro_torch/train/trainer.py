"""The training loop — the port of ``repro/train/trainer.py``.

``make_train_step`` builds the step: bf16 compute over fp32 master
weights, optional gradient accumulation over microbatches, global-norm
clipping and AdamW.  ``Trainer`` is the host loop: the data iterator,
checkpoints, and the straggler watch (an EWMA of step time).

The master weights keep the reference's flat layout (``{name: fp32
tensor}``, a repeating segment's leaves stacked: ``models/convert.py::
master_params``), so the optimiser's decay rule, the checkpoint and the
parity tests all see the reference's leaves.  A step casts the master to
the compute dtype, binds the casts to the model with
``torch.func.functional_call`` (a stacked leaf unbound into its layers),
and differentiates the model's ``loss`` through the cast, inside that
call: a rematerialised layer recomputes with the bound weights.  The
cast is explicit, as in the reference, and not ``torch.autocast``, which
keeps some operations in fp32.  On a CUDA model the attention runs the
flash-attention kernel K8 forward (``FlashAttention``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models.convert import master_params, module_params
from repro_torch.optim.adamw import AdamW, AdamWConfig, OptState
from repro_torch.optim.schedule import cosine_with_warmup


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]    # fp32 master, the reference's layout
    opt: OptState
    step: torch.Tensor                 # () int32


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1            # gradient accumulation factor
    compute_dtype: str = "bfloat16"


def make_optimizer(tcfg: TrainerConfig) -> AdamW:
    return AdamW(tcfg.adamw, cosine_with_warmup(
        tcfg.peak_lr, tcfg.warmup_steps, tcfg.total_steps))


def init_train_state(model, generator: torch.Generator,
                     tcfg: TrainerConfig) -> TrainState:
    """Random weights from ``generator`` (``model.init``), widened to the
    fp32 master, and a fresh optimiser state, on the model's device."""
    params = master_params(model.init(generator))
    return TrainState(params=params, opt=make_optimizer(tcfg).init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def train_state_shapes(model, tcfg: TrainerConfig):
    """The abstract state for the dry run and resharding: the launch
    port's work."""
    raise NotImplementedError("train_state_shapes serves the dry run "
                              "(ROADMAP.md Queue 1 item 15, launch)")


def make_train_step_compressed(*args, **kwargs):
    """Cross-pod training with int8 error-feedback compression: the
    multi-card port's work."""
    raise NotImplementedError("the compressed train step needs a mesh with "
                              "a pod axis (ROADMAP.md Queue 1 item 12)")


class _LossGrad(nn.Module):
    """``model.loss`` and its gradients in one call, so that
    ``functional_call`` keeps the weights bound while autograd (and a
    rematerialised layer's recomputation) runs."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch, leaves):
        total, metrics = self.model.loss(batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=False)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads


def to_device(batch: dict, device) -> dict:
    """A numpy (or tensor) batch as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(model, params: Dict[str, torch.Tensor], batch: dict,
                   compute_dtype: torch.dtype):
    """(total loss, metrics, {name: fp32 gradient}) of ``model.loss`` at
    the master weights ``params`` cast to ``compute_dtype``.  Every
    leaf must get a gradient (``allow_unused=False``)."""
    names = sorted(params)
    with torch.enable_grad():
        leaves = [params[k].detach().requires_grad_() for k in names]
        cast = {k: p.to(compute_dtype) for k, p in zip(names, leaves)}
        bound = {f"model.{k}": v
                 for k, v in module_params(model, cast).items()}
        total, metrics, grads = torch.func.functional_call(
            _LossGrad(model), bound, (batch, leaves), strict=True)
    return total, metrics, {k: g.float() for k, g in zip(names, grads)}


def make_train_step(model, tcfg: TrainerConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), ``batch`` a
    dict of numpy arrays or tensors.  With microbatches, gradients and
    the loss are the means over the microbatches (contiguous row blocks)
    and ``aux_loss`` reads zero, as in the reference."""
    optimizer = make_optimizer(tcfg)
    compute_dtype = getattr(torch, tcfg.compute_dtype)
    mb = tcfg.microbatches

    def train_step(state: TrainState, batch: dict):
        batch = to_device(batch, model.device)
        if mb > 1:
            micro = [{k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(mb)]
            gsum = lsum = None
            for part in micro:
                loss, _, grads = loss_and_grads(model, state.params, part,
                                                compute_dtype)
                if gsum is None:
                    gsum, lsum = grads, loss
                else:
                    gsum = {k: gsum[k] + grads[k] for k in gsum}
                    lsum = lsum + loss
            grads = {k: g / mb for k, g in gsum.items()}
            loss = lsum / mb
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            metrics = {"loss": loss, "total_loss": loss, "aux_loss": zero}
        else:
            _, metrics, grads = loss_and_grads(model, state.params, batch,
                                               compute_dtype)
        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state.opt, state.params)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerWatch:
    """EWMA step-time watchdog: flags steps slower than ratio x the EWMA
    and records them (step, seconds, EWMA before it)."""

    ratio: float = 2.0
    alpha: float = 0.1
    ewma: Optional[float] = None
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.ratio * self.ewma
        if slow:
            self.events.append((step, dt, self.ewma))
        self.ewma = (dt if self.ewma is None
                     else (1 - self.alpha) * self.ewma + self.alpha * dt)
        return slow


class Trainer:
    def __init__(self, model, tcfg: TrainerConfig, *, checkpointer=None,
                 log_every: int = 10):
        self.model = model
        self.tcfg = tcfg
        self.checkpointer = checkpointer
        self.log_every = log_every
        self.watch = StragglerWatch()
        self._step_fn = make_train_step(model, tcfg)

    def fit(self, state: TrainState, data_iter, num_steps: int,
            checkpoint_every: int = 0):
        """``num_steps`` steps over ``data_iter``; returns (state, history:
        one dict of float metrics per step, with its ``seconds``)."""
        history = []
        for i in range(num_steps):
            batch = next(data_iter)
            t0 = time.perf_counter()
            state, metrics = self._step_fn(state, batch)
            row = {k: float(v) for k, v in metrics.items()}   # synchronises
            dt = time.perf_counter() - t0
            step = int(state.step)
            self.watch.observe(step, dt)
            history.append(dict(row, seconds=dt))
            if self.log_every and (i % self.log_every == 0):
                print(f"step {step:5d} loss {row['loss']:.4f} "
                      f"({dt * 1e3:.1f} ms)")
            if (self.checkpointer is not None and checkpoint_every
                    and step % checkpoint_every == 0):
                self.checkpointer.save(step, state)
        return state, history
