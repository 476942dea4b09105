"""Device meshes — the port of ``repro/launch/mesh.py``.

The reference builds a single-controller ``jax.sharding.Mesh``; here a
mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
process group that the caller started (SPMD: every rank runs the same
program and builds the same mesh).  These are FUNCTIONS, so importing the
module touches no process group.  Single pod: (data=16, model=16) = 256
ranks; multi-pod: (pod=2, data=16, model=16) = 512 ranks, ``pod`` the
outer pure data-parallel axis.

Every mesh constructor raises when ``torch.distributed.is_initialized()`` is
False: nothing runs one rank in a world's place.  The mesh's device type
follows the package's rule: ``cuda`` unless the caller asks for ``cpu``.
Building a mesh is collective: every rank of the group calls it, also a
rank that a smaller mesh (``ranks``) leaves out.

``CacheMeshConfig`` is the cooperative cache's launch surface: one mesh
whose ``cache`` axis spans the cluster's shard holders, bound to
``parallel/sharding.py::sharded_topk_lookup`` so that the peer rung runs
as a collective (each rank's local top-k and one all-gather of (k idx,
k score)) instead of pooling the shards on one rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def require_world() -> None:
    """Raise unless a ``torch.distributed`` process group is running."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs a process group: call "
            "torch.distributed.init_process_group (backend, rank, world "
            "size and init method) on every rank first")


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda",
              ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ``ranks`` (the
    first prod(shape) ranks of the group by default), row-major as
    ``jax.make_mesh`` lays its devices out.  Tests and elastic
    reconfiguration build meshes of any shape; a rank outside ``ranks``
    still calls this (the subgroups are made collectively) and gets a mesh
    it is not a member of."""
    from torch.distributed.device_mesh import DeviceMesh

    require_world()
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    assert len(shape) == len(axes), (shape, axes)
    n = 1
    for s in shape:
        n *= s
    ids = list(range(n)) if ranks is None else [int(r) for r in ranks]
    assert len(ids) == n and n <= dist.get_world_size(), (
        shape, ids, dist.get_world_size())
    return DeviceMesh(resolve_device(device).type,
                      torch.tensor(ids, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_cache_mesh(num_shards: Optional[int] = None,
                    axis_name: str = "cache", device="cuda"):
    """1-D mesh over the cache-shard holders; ``num_shards`` defaults to
    every rank of the group."""
    require_world()
    n = dist.get_world_size() if num_shards is None else int(num_shards)
    return make_mesh((n,), (axis_name,), device)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of any object whose
    ``shape`` is already such a dict (a shape-only stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(mesh.shape)


@dataclasses.dataclass
class CacheMeshConfig:
    """Launch-time binding of the peer rung's collective lookup.

    ``lookup`` mirrors ``cluster_topk_lookup``'s signature with the mesh
    bound; ``surviving_lookup`` is the membership-aware variant — the
    collective whenever the survivor count equals the mesh's cache axis,
    the pooled one-launch probe otherwise (the same results either way).
    The mesh is built on first use, never at import or construction."""

    num_shards: Optional[int] = None
    axis_name: str = "cache"
    device: str = "cuda"
    _mesh: object = dataclasses.field(default=None, repr=False)

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = make_cache_mesh(self.num_shards, self.axis_name,
                                         self.device)
        return self._mesh

    def lookup(self, queries, keys, valid, k, *, impl: str = "auto"):
        from repro_torch.parallel.sharding import sharded_topk_lookup
        return sharded_topk_lookup(queries, keys, valid, k, self.mesh,
                                   self.axis_name, impl=impl)

    def surviving_lookup(self, queries, keys, valid, alive, k, *,
                         impl: str = "auto"):
        from repro_torch.parallel.sharding import surviving_topk_lookup
        return surviving_topk_lookup(queries, keys, valid, alive, k,
                                     self.mesh, self.axis_name, impl=impl)
