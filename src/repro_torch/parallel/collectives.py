"""Collectives on the dimensions of a ``DeviceMesh``, and the autograd
forms the sharded train step and the expert-parallel MoE use.

A value laid out over a mesh is held as this rank's slice, a plain
tensor: ``local_slice`` cuts it from the full value (no communication)
and ``unshard`` all-gathers it back, minor mesh dimension first, so a
tensor dimension over two mesh axes, as ``("pod", "data")``, is split
major-first as XLA lays it out.  Placements are ``DTensor``'s own
(``Shard(d)`` / ``Replicate()``, one per mesh dimension).

The ranks of one card share it, so their process group runs ``gloo``; a
``gloo`` collective of a CUDA tensor is staged through host memory here,
explicitly: ``.cpu()``, the collective, ``.to(device)``
(``host_staged``).  Nothing else changes: the kernels run on the card.

The autograd forms (``copy_to``, ``reduce_from``, ``gather_along``,
``gather_rows``, ``mean_over``) take the mesh and the names of the mesh
dimensions they span; each is the identity on a dimension of size 1.

Every collective of the port goes through ``gather_stack`` (all-gather)
or ``all_reduce``: the expert-parallel MoE dispatch too, whose exchange is
built from these forms.  Inside ``record_collectives()`` each of the two
appends a ``Collective`` (kind, bytes of the whole gathered or reduced
tensor, group size) to the record, the dry run's counterpart of the
collectives in XLA's compiled program (``launch/collective_bytes.py``).
``train/elastic.py``'s ``dist.barrier`` calls are not recorded: a barrier
moves no payload.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_shape


class Collective(NamedTuple):
    """One collective issued: the reference's kind name, the bytes of the
    whole gathered (or reduced) tensor, and the group's size."""
    kind: str
    bytes: int
    group: int


_RECORD: Optional[List[Collective]] = None


@contextlib.contextmanager
def record_collectives():
    """Yields a list that every collective issued inside the context is
    appended to, in issue order.  Outside it nothing is recorded."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _note(kind: str, whole: torch.Tensor, group) -> None:
    if _RECORD is not None:
        _RECORD.append(Collective(kind, whole.numel() * whole.element_size(),
                                  dist.get_world_size(group)))


def host_staged(group, t: torch.Tensor) -> bool:
    """Whether a collective of ``t`` on ``group`` goes through host memory:
    a CUDA tensor on a ``gloo`` group (the ranks that share one card)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` of ``group``, in group-rank order
    (one all-gather)."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    if host_staged(group, src):
        src = src.cpu()                  # gloo: stage through the host
    out = torch.empty((n * src.numel(),), dtype=src.dtype,
                      device=src.device)
    _note("all-gather", out, group)
    dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
    return out.reshape((n,) + tuple(src.shape)).to(t.device)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` by ``op``, as a new tensor."""
    src = t.detach().clone()
    if host_staged(group, src):
        src = src.cpu()                  # gloo: stage through the host
    _note("all-reduce", src, group)
    dist.all_reduce(src, op=op, group=group)
    return src.to(t.device)


def live_dims(mesh, names: Sequence[str]) -> list:
    """The mesh dimensions of ``names`` that the mesh has with size > 1, in
    the mesh's order."""
    sizes = mesh_shape(mesh)
    return [a for a in sizes if a in names and sizes[a] > 1]



def reduce_over(t: torch.Tensor, mesh, names: Sequence[str],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced by ``op`` over the mesh dimensions ``names``."""
    for a in live_dims(mesh, names):
        t = all_reduce(t, mesh.get_group(a), op)
    return t


def slice_over(t: torch.Tensor, mesh, names: Sequence[str], d: int):
    """This rank's chunk of ``t`` along dim ``d``, split over the mesh
    dimensions ``names`` major first (a view; no communication)."""
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for a in names:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    size = t.shape[d] // n
    assert size * n == t.shape[d], (tuple(t.shape), d, names)
    return t.narrow(d, idx * size, size)


def gather_over(t: torch.Tensor, mesh, names: Sequence[str], d: int):
    """The inverse of ``slice_over``: all-gathers along ``d``, minor first."""
    for a in reversed(list(names)):
        t = torch.cat(gather_stack(t, mesh.get_group(a)).unbind(0), dim=d)
    return t


def by_dim(mesh, placements) -> dict:
    """{tensor dim: the mesh dims (in mesh order) that shard it}."""
    from torch.distributed.tensor import Shard
    out: dict = {}
    for a, p in zip(mesh_shape(mesh), placements):
        if isinstance(p, Shard):
            out.setdefault(p.dim, []).append(a)
    return out


def local_slice(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's slice of the full value ``t`` under ``placements`` (a
    contiguous copy; no communication)."""
    for d, names in by_dim(mesh, placements).items():
        t = slice_over(t, mesh, names, d)
    return t.contiguous()


def unshard(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The full value from every rank's ``local`` slice (all-gathers)."""
    for d, names in by_dim(mesh, placements).items():
        local = gather_over(local, mesh, names, d)
    return local


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_over(g, ctx.mesh, ctx.names), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names):
        return reduce_over(x, mesh, names)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names, d):
        ctx.mesh, ctx.names, ctx.d = mesh, names, d
        return gather_over(x, mesh, names, d)

    @staticmethod
    def backward(ctx, g):
        return slice_over(g, ctx.mesh, ctx.names, ctx.d).contiguous(), None, \
            None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names, d):
        ctx.mesh, ctx.names, ctx.d = mesh, names, d
        return slice_over(x, mesh, names, d).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_over(g, ctx.mesh, ctx.names, ctx.d), None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return gather_over(x, mesh, names, 0)

    @staticmethod
    def backward(ctx, g):
        g = reduce_over(g, ctx.mesh, ctx.names)
        return slice_over(g, ctx.mesh, ctx.names, 0).contiguous(), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        ctx.n = 1
        for a in live_dims(mesh, names):
            ctx.n *= mesh_shape(mesh)[a]
        return reduce_over(x, mesh, names) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return reduce_over(g, ctx.mesh, ctx.names) / ctx.n, None, None


def copy_to(x, mesh, names):
    """Identity forward; the gradient summed over ``names`` backward (a
    replicated input that each rank uses for its own part)."""
    names = live_dims(mesh, names)
    return _CopyTo.apply(x, mesh, names) if names else x


def reduce_from(x, mesh, names):
    """Summed over ``names`` forward (partial results); identity backward."""
    names = live_dims(mesh, names)
    return _ReduceFrom.apply(x, mesh, names) if names else x


def gather_along(x, mesh, names, d: int):
    """The slices of ``names`` concatenated along ``d`` forward; this
    rank's slice of the gradient backward (the consumer is replicated)."""
    names = live_dims(mesh, names)
    return _GatherAlong.apply(x, mesh, names, d) if names else x


def scatter_to(x, mesh, names, d: int):
    """This rank's slice along ``d`` forward (of a value every rank holds
    whole); the slices' gradients gathered whole backward, so every rank
    gets the whole gradient."""
    names = live_dims(mesh, names)
    return _ScatterTo.apply(x, mesh, names, d) if names else x


def rank_index(mesh, names) -> tuple:
    """(this rank's index, count) over the mesh dimensions ``names``,
    major first: the chunk of a dimension split over them."""
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for a in live_dims(mesh, names):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def gather_rows(x, mesh, names):
    """Every rank's rows forward; backward the gradient summed over
    ``names`` and sliced to this rank's rows (a reduce-scatter: each rank's
    consumer differs)."""
    names = live_dims(mesh, names)
    return _GatherRows.apply(x, mesh, names) if names else x


def mean_over(x, mesh, names):
    """The mean over ``names`` forward and backward."""
    names = live_dims(mesh, names)
    return _MeanOver.apply(x, mesh, names) if names else x
