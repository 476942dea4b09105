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
from torch.distributed.tensor import Shard

import numpy as np

from repro_torch.data.pipeline import shard_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.convert import master_params, module_params
from repro_torch.models.layers import ShapeDtype
from repro_torch.optim.adamw import AdamW, AdamWConfig, OptState
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.parallel.collectives import (by_dim, gather_over,
                                              mean_over, rank_index,
                                              reduce_over, slice_over)
from repro_torch.parallel.sharding import (RULES_TRAIN, batch_rows,
                                           compute_weight,
                                           set_activation_sharder, tp_dims)
from repro_torch.utils.tree import map_with_paths


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


def train_state_shapes(model, tcfg: TrainerConfig) -> TrainState:
    """The abstract train state (``ShapeDtype`` leaves) for the dry run
    and resharding: fp32 master weights and moments, int32 counters."""
    p = {k: ShapeDtype(tuple(v.shape), torch.float32)
         for k, v in model.init_shapes().items()}
    scalar = ShapeDtype((), torch.int32)
    return TrainState(params=p, opt=OptState(mu=p, nu=dict(p), count=scalar),
                      step=scalar)


class _LossGrad(nn.Module):
    """``model.loss`` and its gradients in one call, so that
    ``functional_call`` keeps the weights bound while autograd (and a
    rematerialised layer's recomputation) runs.  ``objective(total,
    metrics)`` is what is differentiated (``total`` by default)."""

    def __init__(self, model, objective=None):
        super().__init__()
        self.model = model
        self.objective = objective

    def forward(self, batch, leaves):
        total, metrics = self.model.loss(batch)
        obj = total if self.objective is None else self.objective(total,
                                                                  metrics)
        grads = torch.autograd.grad(obj, leaves, allow_unused=False)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads


def to_device(batch: dict, device) -> dict:
    """A numpy (or tensor) batch as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_and_grads(model, params: Dict[str, torch.Tensor], batch: dict,
                   compute_dtype: torch.dtype, objective=None):
    """(total loss, metrics, {name: fp32 gradient}) of ``model.loss`` at
    the master weights ``params`` cast to ``compute_dtype``; the gradient
    is of ``objective(total, metrics)`` when given.  Every leaf must get a
    gradient (``allow_unused=False``)."""
    names = sorted(params)
    with torch.enable_grad():
        leaves = [params[k].detach().requires_grad_() for k in names]
        cast = {k: p.to(compute_dtype) for k, p in zip(names, leaves)}
        bound = {f"model.{k}": v
                 for k, v in module_params(model, cast).items()}
        total, metrics, grads = torch.func.functional_call(
            _LossGrad(model, objective), bound, (batch, leaves), strict=True)
    return total, metrics, {k: g.float() for k, g in zip(names, grads)}


def make_train_step(model, tcfg: TrainerConfig, mesh=None,
                    shardings: Optional[TrainState] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), ``batch`` a
    dict of numpy arrays or tensors.  With microbatches, gradients and
    the loss are the means over the microbatches (contiguous row blocks)
    and ``aux_loss`` reads zero, as in the reference.

    With a ``mesh``, the step is the sharded one (``sharded_train_step``):
    the state is this rank's slices, laid out by ``shardings``
    (``state_shardings`` by default)."""
    if mesh is not None:
        return sharded_train_step(model, tcfg, mesh, shardings)
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
# Sharded training
# ---------------------------------------------------------------------------


def state_shardings(model, mesh) -> TrainState:
    """A ``Sharding`` for every leaf of the train state: the master weights
    and both AdamW moments by the model's logical axes under
    ``RULES_TRAIN``, the counters replicated — the layout of the
    reference's ``launch/train.py``."""
    axes, shapes = model.logical_axes(), model.init_shapes()
    p_sh = {k: RULES_TRAIN.sharding_for(axes[k], shapes[k].shape, mesh)
            for k in shapes}
    rep = RULES_TRAIN.sharding_for((), (), mesh)
    return TrainState(params=p_sh,
                      opt=OptState(mu=dict(p_sh), nu=dict(p_sh), count=rep),
                      step=rep)


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """This rank's slices of a whole state (the same on every rank)."""
    return map_with_paths(
        lambda path, t: _at(shardings, path).place(t), state)


def unshard_state(state: TrainState, shardings: TrainState) -> TrainState:
    """The whole state from every rank's slices (collective over the
    mesh): what a checkpoint saves."""
    return map_with_paths(
        lambda path, t: _at(shardings, path).unshard(t), state)


def _at(tree, path):
    for p in path:
        tree = (getattr(tree, p) if hasattr(tree, "_fields")
                else tree[p if isinstance(tree, dict) else int(p)])
    return tree


def _aux_coef(model) -> float:
    moe = getattr(model.cfg, "moe", None)
    return moe.router_aux_loss_coef if moe is not None else 0.0


def _rows_loss_and_grads(model, params, batch, compute_dtype, mesh, rows):
    """(loss, aux, grads) of this rank's block of rows, the loss weighted
    by the block's share of the loss positions over the ``rows`` ranks
    (and the MoE aux counted once over them), so that the gradients summed
    over the row axes are the whole batch's.  ``loss`` is the whole
    batch's; the gradients are not yet summed."""

    # the loss positions of these rows: the mask's, else every target
    # (an encoder-decoder's targets are its decoder tokens)
    mask = batch.get("loss_mask")
    targets = batch["dec_tokens" if "dec_tokens" in batch else "tokens"]
    n_pos = (torch.ones(targets[:, 1:].shape, device=model.device)
             if mask is None else mask[:, 1:].float()).sum()
    share = n_pos / torch.clamp(reduce_over(n_pos, mesh, rows), min=1.0)
    _, n_row_ranks = rank_index(mesh, rows)
    coef = _aux_coef(model)

    def objective(total, metrics):
        return share * metrics["loss"] + coef * metrics["aux_loss"] \
            / n_row_ranks

    with set_activation_sharder(mesh, rows):
        _, metrics, grads = loss_and_grads(model, params, batch,
                                           compute_dtype, objective)
    loss = reduce_over(share * metrics["loss"], mesh, rows)
    return loss, metrics["aux_loss"], grads


def sharded_train_step(model, tcfg: TrainerConfig, mesh,
                       shardings: Optional[TrainState] = None) -> Callable:
    """The train step on a (pod,) data, model mesh, one program per rank.

    The state is this rank's slices: master weights and both moments laid
    out by ``shardings`` (the reference's GSPMD placements of
    ``RULES_TRAIN``: ``embed`` over data as FSDP storage, heads / kv heads
    / mlp / vocab over model).  ``batch`` is the host batch, the same on
    every rank; ``shard_batch`` keeps this rank's rows (the batch over
    (pod, data) where it divides).  A step

    1. gathers each weight over the axes other than 'model' (the FSDP
       gather at use), and over 'model' too unless the forward computes
       with its slice (``model.tp_leaves()``: GQA attention, whose heads
       run K8 per rank, the dense MLPs and the vocabulary, with their
       partial outputs summed over 'model');
    2. differentiates this rank's rows' loss, weighted by its share of
       the batch's loss positions (the MoE aux once over the row ranks);
    3. sums the gradients over the row axes and keeps this rank's slice;
    4. runs AdamW on the slices with the global gradient norm.

    Collectives are the mesh's (``parallel/collectives.py``); on ranks
    that share one card they are ``gloo``, staged through the host.  The
    numbers are the one-card step's, up to the order of floating-point
    sums.  Microbatches split each rank's rows into contiguous blocks."""

    shardings = shardings or state_shardings(model, mesh)
    optimizer = make_optimizer(tcfg)
    compute_dtype = getattr(torch, tcfg.compute_dtype)
    mb = tcfg.microbatches
    sizes = mesh_shape(mesh)
    names_all = list(sizes)
    coef = _aux_coef(model)

    keeps = tp_dims(model, shardings.params)

    def compute_param(name, local):
        return compute_weight(local, shardings.params[name], keeps[name])

    def storage_grad(name, g):
        sh = shardings.params[name]
        keep = keeps[name]
        for d, ax in by_dim(mesh, sh.placements).items():
            if d != keep:
                g = slice_over(g, mesh, ax, d)
        return g.contiguous()

    def replication(sh) -> int:
        return int(np.prod([sizes[a] for a, p in zip(names_all,
                                                     sh.placements)
                            if not isinstance(p, Shard)]))

    def part_grads(params, batch, rows):
        return _rows_loss_and_grads(model, params, batch, compute_dtype,
                                    mesh, rows)

    def train_step(state: TrainState, batch: dict):
        B = int(next(iter(batch.values())).shape[0])
        rows = batch_rows(RULES_TRAIN, mesh, B)
        local = shard_batch(batch, mesh, RULES_TRAIN, model.device)
        params = {k: compute_param(k, v) for k, v in state.params.items()}
        if mb > 1:
            parts = [{k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                      for k, v in local.items()} for i in range(mb)]
        else:
            parts = [local]
        gsum, lsum = None, None
        for part in parts:
            loss, aux, grads = part_grads(params, part, rows)
            if gsum is None:
                gsum, lsum = grads, loss
            else:
                gsum = {k: gsum[k] + grads[k] for k in gsum}
                lsum = lsum + loss
        grads = {k: storage_grad(k, reduce_over(g / mb, mesh, rows))
                 for k, g in gsum.items()}
        loss = lsum / mb
        sq = sum(torch.sum(torch.square(grads[k]))
                 / replication(shardings.params[k]) for k in sorted(grads))
        gnorm = torch.sqrt(reduce_over(sq, mesh, names_all))
        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state.opt, state.params, gnorm=gnorm)
        if mb > 1:
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        metrics = {"loss": loss, "aux_loss": aux,
                   "total_loss": loss + coef * aux}
        metrics.update(opt_metrics)
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1), metrics

    return train_step


def init_compression_errors(model, mesh, n_pods: int,
                            device="cuda") -> dict:
    """Per-pod error-feedback residuals: the reference's (n_pods, ...)
    stack laid out over 'pod' (``Shard(0)``), so a rank holds its own
    pod's row, (1, ...)."""
    assert mesh_shape(mesh)["pod"] == n_pods, (mesh_shape(mesh), n_pods)
    dev = resolve_device(device)
    return {k: torch.zeros((1,) + tuple(v.shape), dtype=torch.float32,
                           device=dev)
            for k, v in model.init_shapes().items()}


def make_train_step_compressed(model, tcfg: TrainerConfig,
                               mesh) -> Callable:
    """Cross-pod training with int8 error-feedback gradient compression.

    Within a pod the gradients are computed as ``sharded_train_step``
    computes them: the pod's rows over its data axis, the tensor-parallel
    weights' 'model' slices (cut locally here: the state is whole on every
    rank, replicated across pods as the reference's ``P()`` parameters,
    and each slice's gradient is gathered whole over 'model').  The
    *inter-pod* mean — the bytes that cross the slow links — is
    ``compressed_cross_pod_mean`` over the 'pod' dimension: quantize,
    int32 sum, dequantize, with an error-feedback residual per pod
    (``optim/grad_compress.py``).

    Returns train_step(state, err, batch) -> (state, err, metrics);
    ``err`` is this rank's row of ``init_compression_errors``'s stack,
    updated in place.  Needs a 'pod' axis; the layouts are
    ``RULES_TRAIN``'s."""
    from repro_torch.optim.grad_compress import (CompressionState,
                                                 compressed_cross_pod_mean)

    sizes = mesh_shape(mesh)
    assert "pod" in sizes, "compressed sync needs a 'pod' mesh axis"
    optimizer = make_optimizer(tcfg)
    compute_dtype = getattr(torch, tcfg.compute_dtype)
    n_pods = sizes["pod"]
    axes, shapes = model.logical_axes(), model.init_shapes()
    tp = tp_dims(model, {k: RULES_TRAIN.sharding_for(
        axes[k], shapes[k].shape, mesh) for k in shapes})

    def train_step(state: TrainState, err: dict, batch: dict):
        pod = mesh.get_local_rank("pod")
        host = {k: np.asarray(v) for k, v in batch.items()}
        per = next(iter(host.values())).shape[0] // n_pods
        pod_batch = {k: v[pod * per:(pod + 1) * per] for k, v in host.items()}
        rows = tuple(a for a in ("data",)
                     if sizes.get(a, 1) > 1 and per % sizes[a] == 0)
        local = {k: slice_over(torch.as_tensor(v, device=model.device),
                               mesh, rows, 0).contiguous()
                 for k, v in pod_batch.items()}
        params = {k: (p if tp[k] is None
                      else slice_over(p, mesh, ["model"],
                                      tp[k]).contiguous())
                  for k, p in state.params.items()}
        loss, aux, grads = _rows_loss_and_grads(
            model, params, local, compute_dtype, mesh, rows)
        grads = {k: reduce_over(g if tp[k] is None
                                else gather_over(g, mesh, ["model"], tp[k]),
                                mesh, rows)
                 for k, g in grads.items()}
        grads, new_state = compressed_cross_pod_mean(
            grads, CompressionState(error={k: e[0] for k, e in err.items()}),
            mesh.get_group("pod"))
        for k, e in new_state.error.items():      # this pod's row, in place
            err[k][0] = e
        del new_state
        total = mean_over(loss + _aux_coef(model) * aux, mesh, ("pod",))
        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state.opt, state.params)
        metrics = {"loss": total}
        metrics.update(opt_metrics)
        return (TrainState(params=new_params, opt=new_opt,
                           step=state.step + 1), err, metrics)

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
