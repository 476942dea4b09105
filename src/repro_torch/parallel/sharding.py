"""Logical-axis sharding rules and the cache ladder's device-side probes —
the port of ``repro/parallel/sharding.py``.

Every parameter / cache / activation dimension carries a *logical* name
(``embed``, ``heads``, ``cache_seq``, ...).  A rule set maps logical names
to mesh axes per workload.  ``ShardingRules.spec_for`` applies a rule only
when the dimension divides by the mesh-axis product and no earlier
dimension of the same tensor took the axis; otherwise the dimension stays
replicated.  A spec is a tuple with one entry per dimension (trailing
``None``s dropped, as ``PartitionSpec`` prints): a mesh-axis name, a tuple
of them, or ``None``.  ``placements_for`` turns it into ``DTensor``
placements on a ``DeviceMesh``, one per mesh dimension: ``Shard(d)`` where
the dimension ``d`` takes that mesh axis, ``Replicate()`` elsewhere; a
dimension over two axes, as ``("pod", "data")``, is ``Shard(d)`` on both,
the major axis first, as XLA lays it out.

Rule sets (``RULES_TRAIN``, ``RULES_SERVE``, ``RULES_SERVE_LONG``) are
copied from the reference with their comments.  The activation sharder
(``set_activation_sharder``) tells the models which mesh dimensions split
the batch's rows and, under the sharded serve steps
(``serving/sharded.py``), the query heads and each cache leaf's
dimensions (its ``Sharding``: the slots for attention and MLA, the
channels and heads for SSM states), all from the rules' ``spec_for``;
``constrain`` marks the reference's ``with_sharding_constraint`` sites and
returns its input, because every rank holds plain tensors (its own
slices), never a ``DTensor``.

Cache-probe collectives
-----------------------

Each probe is ONE kernel launch however wide the tier gets, which is what
keeps the engine's per-step ladder bound constant:

* ``cluster_topk_lookup`` — a lookup over stacked per-node shards as one
  single-matrix top-k (``similarity_topk``, K4) over the pooled rows,
  which the reference's docstring states equals its per-shard top-k +
  ``_merge_shard_topk`` (the parity tests hold it).
* ``federated_digest_lookup`` (and ``_quantized``) — the remote rung's
  digest probe: every home cluster's miss batch against every OTHER
  cluster's top-M digest in one ``similarity_topk_batched`` launch.  The
  reference broadcast the pooled board to (K, K*M, D), free in XLA; here
  every group reads the one pooled board in place (the kernel's shared-key
  mode) under its own validity row, so nothing is copied K times.  The int8
  variant dequantizes once per call.
* ``federated_digest_lookup_ivfpq`` — the same probe over the board's
  packed IVF-PQ index (``kernels/ivf_pq``, K6): one launch for all K home
  batches, the home exclusion inside the kernel.
* ``sharded_topk_lookup`` — the peer rung as a collective over a real
  ``cache`` mesh axis: each rank runs K4 on its own shard only, and one
  all-gather of (k idx, k score) per shard replaces shipping whole shards
  around; the merge is the pooled probe's order, bit for bit.
* ``regroup_surviving_shards`` / ``surviving_topk_lookup`` — the lookup
  over the shards that survived a membership change, with indices mapped
  back to the original shard ids.

Digest hits are hints: the caller confirms them against the candidate
cluster's authoritative shards (``core/federation.py``).

Collectives run on the mesh dimension's process group.  The ranks of one
card share it, so they run ``gloo``; a ``gloo`` group's CUDA tensors are
staged through host memory explicitly (``gather_stack``,
``all_reduce``): ``.cpu()``, the collective, ``.to(device)``.  The
kernels still run on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ivf_pq import ivf_pq_probe
from repro_torch.kernels.similarity import (similarity_topk,
                                            similarity_topk_batched)
from repro_torch.kernels.similarity.ops import _run
from repro_torch.launch.mesh import mesh_shape
from repro_torch.obs.profile import digest_probe_bytes, ivf_pq_probe_bytes
from repro_torch.parallel.collectives import (by_dim, gather_over,
                                              gather_stack, local_slice,
                                              rank_index, slice_over,
                                              unshard)

Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh, the spec the rules chose and
    its ``DTensor`` placements.  A value laid out by it is held as this
    rank's slice, a plain tensor (``place``), and made whole again by
    all-gathers over the mesh (``unshard``)."""

    mesh: object
    spec: Spec
    placements: tuple

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t`` (the full value, the same on every
        rank): no communication."""
        return local_slice(t, self.mesh, self.placements)

    def unshard(self, local: torch.Tensor) -> torch.Tensor:
        """The full value from every rank's slice (collective over the
        mesh)."""
        return unshard(local, self.mesh, self.placements)


def placements_for(spec: Spec, mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``, one per mesh
    dimension: ``Shard(d)`` where tensor dim ``d`` takes the mesh axis,
    ``Replicate()`` elsewhere.  A dim over several axes lists them major
    first, in the mesh's own order (XLA's layout of ``P(("pod",
    "data"))``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in axes]
        assert pos == sorted(pos), (spec, names)
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered (logical_axis -> mesh axes) with fallbacks.

    rules maps a logical name to a tuple of *candidate* assignments; the
    first candidate whose mesh axes are free and divide the dim is used.
    Each candidate is a tuple of mesh-axis names (multi-axis sharding).
    ``mesh`` is a ``DeviceMesh`` or any object whose ``shape`` is a
    {axis: size} dict."""

    rules: Dict[str, Tuple[Tuple[str, ...], ...]]

    def spec_for(self, axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh) -> Spec:
        sizes = mesh_shape(mesh)
        used: set = set()
        out = []
        for dim, name in zip(shape, axes):
            chosen = None
            for cand in self.rules.get(name or "", ()):
                cand = tuple(a for a in cand if a in sizes)
                if not cand:
                    continue
                size = int(np.prod([sizes[a] for a in cand]))
                if size <= 1:
                    continue
                if any(a in used for a in cand):
                    continue
                if dim % size != 0:
                    continue
                chosen = cand
                break
            if chosen:
                used.update(chosen)
                out.append(chosen if len(chosen) > 1 else chosen[0])
            else:
                out.append(None)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def sharding_for(self, axes, shape, mesh) -> Sharding:
        spec = self.spec_for(axes, shape, mesh)
        return Sharding(mesh, spec, placements_for(spec, mesh))


def _mk(d: Dict[str, Sequence[Sequence[str]]]) -> ShardingRules:
    return ShardingRules({k: tuple(tuple(c) for c in v) for k, v in d.items()})


RULES_TRAIN = _mk({
    "batch": [("pod", "data"), ("data",)],
    "moe_capacity": [("data",)],
    "ssm_heads": [("model",)],
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    # NOTE: a "qk_dim" -> model fallback (head-dim TP for indivisible head
    # counts) was evaluated and REFUTED: it multiplies activation all-reduces
    # (llava train collective 19.7 -> 461.7 s; whisper prefill 0.07 -> 104.8 s).
    # Attention stays replicated over 'model' for indivisible head counts.
    "mlp": [("model",)],
    "experts": [("model",)],
    "ssm_inner": [("model",)],
    "kv_lora": [("model",)],
    # FSDP storage sharding of the non-TP param dim
    "embed": [("data",)],
    # activations (2D): embed over model inside scan bodies
    "act_embed": [("model",)],
})

RULES_SERVE = _mk({
    "batch": [("pod", "data"), ("data",)],
    "moe_capacity": [("data",)],
    "ssm_heads": [("model",)],
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    # NOTE: a "qk_dim" -> model fallback (head-dim TP for indivisible head
    # counts) was evaluated and REFUTED: it multiplies activation all-reduces
    # (llava train collective 19.7 -> 461.7 s; whisper prefill 0.07 -> 104.8 s).
    # Attention stays replicated over 'model' for indivisible head counts.
    "mlp": [("model",)],
    "experts": [("model",)],
    "ssm_inner": [("model",)],
    "kv_lora": [("model",)],
    "embed": [("data",)],          # weight-gathered serving (fits 72B on v5e-256)
    "act_embed": [("model",)],
    # KV cache: kv_heads over model when divisible (rule above), else the
    # cache_seq dim shards over model => GSPMD flash-decode
    # (What the rules do: ``spec_for`` gives mesh axes to a tensor's dims in
    # order, and a cache leaf is (layers, batch, cache_seq, kv_heads,
    # qk_dim), so cache_seq takes 'model' whenever it divides and kv_heads
    # then stays whole.  Every decode cell's cache is split by slots, and
    # its step is the sequence-sharded flash-decode.)
    "cache_seq": [("model",)],
})

# long_500k: global_batch=1 — nothing to gain from batch sharding; spread the
# cache sequence over everything instead.
RULES_SERVE_LONG = _mk({
    "moe_capacity": [("data",)],
    "ssm_heads": [("model",)],
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    # NOTE: a "qk_dim" -> model fallback (head-dim TP for indivisible head
    # counts) was evaluated and REFUTED: it multiplies activation all-reduces
    # (llava train collective 19.7 -> 461.7 s; whisper prefill 0.07 -> 104.8 s).
    # Attention stays replicated over 'model' for indivisible head counts.
    "mlp": [("model",)],
    "experts": [("model",)],
    "ssm_inner": [("model",)],
    "kv_lora": [("model",)],
    "embed": [("data",)],
    "act_embed": [("model",)],
    "cache_seq": [("pod", "data", "model"), ("data", "model"), ("model",)],
})


def logical_to_sharding(tree_axes: dict, tree_shapes: dict, mesh,
                        rules: ShardingRules) -> dict:
    """Flat-dict version: {name: axes} + {name: shape-and-dtype} ->
    {name: ``Sharding``}."""
    return {k: rules.sharding_for(tree_axes[k], tree_shapes[k].shape, mesh)
            for k in tree_axes}


def batch_rows(rules: ShardingRules, mesh, batch: int) -> tuple:
    """The mesh dims that ``rules`` split a batch of ``batch`` rows over
    (empty where the batch stays whole)."""
    spec = rules.spec_for(("batch",), (batch,), mesh)
    if not spec or spec[0] is None:
        return ()
    return spec[0] if isinstance(spec[0], tuple) else (spec[0],)


def tp_dims(model, shardings: Dict[str, Sharding]) -> Dict[str, object]:
    """{weight: the tensor dim whose 'model' slice the forward computes
    with, or None: gathered whole}.  The forward slices
    ``model.tp_leaves()`` (an ``EncDecLM`` none) where the rules split
    exactly one dim over 'model' alone."""
    tp_ok = getattr(model, "tp_leaves", set)()

    def dim(sh):
        return next((d for d, ax in by_dim(sh.mesh, sh.placements).items()
                     if ax == ["model"]), None)
    return {k: dim(sh) if k in tp_ok else None for k, sh in shardings.items()}


def compute_weight(local: torch.Tensor, sh: Sharding, keep) -> torch.Tensor:
    """The weight a rank computes with, from its slice under ``sh``:
    gathered over every mesh dim that splits it (the FSDP gather at use),
    except 'model' when the forward computes with the 'model' slice of
    dim ``keep`` (``tp_dims``)."""
    from torch.distributed.tensor import Replicate

    gather = tuple(Replicate() if (a == "model" and keep is not None) else p
                   for a, p in zip(mesh_shape(sh.mesh), sh.placements))
    return unshard(local, sh.mesh, gather)


# ---------------------------------------------------------------------------
# Activation sharding hook (called at the reference's sites in the models)
# ---------------------------------------------------------------------------

_ACTIVE_SHARDER = None


@dataclasses.dataclass
class ActivationSharder:
    """The installed hook: the mesh the models split heads, MLPs,
    vocabulary and experts over, and ``rows``, the mesh dimensions that the
    batch's rows are split over when each rank holds only its own rows
    (the sharded train and serve steps); empty when every rank holds the
    whole batch.  The serve steps also give ``heads``, the mesh dimensions
    that split the query heads, and ``cache``, {cache leaf: ``Sharding``}
    of the full leaves: a rank holds its slice of each, with its rows."""

    mesh: object
    rows: tuple = ()
    heads: tuple = ()
    cache: dict = dataclasses.field(default_factory=dict)

    def cache_dims(self, name: str) -> dict:
        """{leaf dim: the mesh dims that split it} of a cache leaf, the
        layers (dim 0) and rows (dim 1) left out: the rows are already
        this rank's.  Empty for a leaf the rules leave whole."""
        sh = self.cache.get(name)
        if sh is None:
            return {}
        dims = by_dim(sh.mesh, sh.placements)
        assert 0 not in dims, (name, sh.spec)
        assert tuple(dims.get(1, ())) == tuple(self.rows), (
            name, sh.spec, self.rows)
        return {d: ax for d, ax in dims.items() if d >= 2}

    def slots(self, name: str) -> tuple:
        """The mesh dims that split a seq-indexed leaf's slots (dim 2).  A
        leaf split along any other dim (its kv heads) is refused: the
        decode reads every head of its slots."""
        dims = self.cache_dims(name)
        other = {d for d in dims if d != 2}
        if other:
            raise NotImplementedError(
                f"{name}: cache split along dims {sorted(other)} "
                f"({self.cache[name].spec}); the sharded decode splits "
                "only the slots")
        return tuple(dims.get(2, ()))

    def slot_range(self, name: str, n_local: int) -> tuple:
        """(first slot, slots of the whole leaf) of this rank's range of a
        leaf holding ``n_local`` slots here."""
        r, n = rank_index(self.mesh, self.slots(name))
        return r * n_local, n * n_local

    def local_shape(self, name: str, shape: tuple) -> tuple:
        """This rank's shape of a leaf whose rows are already its own."""
        sizes = mesh_shape(self.mesh)
        out = list(shape)
        for d, ax in self.cache_dims(name).items():
            out[d] //= int(np.prod([sizes[a] for a in ax]))
        return tuple(out)

    def keep(self, name: str, val: torch.Tensor) -> torch.Tensor:
        """This rank's part of one layer's whole value (the leaf without
        its layers dim, this rank's rows)."""
        for d, ax in self.cache_dims(name).items():
            val = slice_over(val, self.mesh, ax, d - 1)
        return val

    def whole(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The inverse of ``keep``: all-gathers over the dims that split
        the leaf (its rows stay this rank's)."""
        for d, ax in self.cache_dims(name).items():
            part = gather_over(part, self.mesh, ax, d - 1)
        return part


class set_activation_sharder:
    """Context manager installing the activation hook (none for a ``None``
    mesh)."""

    def __init__(self, mesh, rows: tuple = (), heads: tuple = (),
                 cache: Optional[dict] = None):
        self.sharder = (ActivationSharder(mesh, tuple(rows), tuple(heads),
                                          dict(cache or {}))
                        if mesh is not None else None)

    def __enter__(self):
        global _ACTIVE_SHARDER
        self._prev = _ACTIVE_SHARDER
        _ACTIVE_SHARDER = self.sharder
        return self.sharder

    def __exit__(self, *exc):
        global _ACTIVE_SHARDER
        _ACTIVE_SHARDER = self._prev
        return False


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]):
    """``x`` itself: a rank's activations are already its own slices."""
    return x


def current_sharder() -> Optional[ActivationSharder]:
    return _ACTIVE_SHARDER


def serve_sharder() -> Optional[ActivationSharder]:
    """The installed sharder when it lays out a cache (the sharded serve
    steps), else None."""
    sh = _ACTIVE_SHARDER
    return sh if sh is not None and sh.cache else None


def model_sharder() -> Optional[ActivationSharder]:
    """The installed sharder when its mesh splits a 'model' axis (the
    sharded train step's tensor parallelism), else None."""
    sh = _ACTIVE_SHARDER
    if sh is None or mesh_shape(sh.mesh).get("model", 1) <= 1:
        return None
    return sh


# ---------------------------------------------------------------------------
# The cache ladder's probes
# ---------------------------------------------------------------------------


def cluster_topk_lookup(queries: torch.Tensor, keys: torch.Tensor,
                        valid: torch.Tensor, k: int, *, impl: str = "auto"):
    """Cluster-wide lookup over stacked per-node cache shards in one launch.

    queries: (Q, D); keys: (N, C, D); valid: (N, C).  Returns (idx
    (Q, min(k, N*C)) int32 global indices in [0, N*C), score f32) — equal
    to ``similarity_topk`` over the pooled ``keys.reshape(N*C, D)``, which
    is what runs."""
    n, c, d = keys.shape
    return similarity_topk(queries, keys.reshape(n * c, d),
                           valid.reshape(n * c), min(k, n * c), impl=impl)


def federated_digest_lookup(queries: torch.Tensor, digests: torch.Tensor,
                            valid: torch.Tensor, k: int = 1, *,
                            impl: str = "auto"):
    """Cross-cluster digest probe — the federation tier's remote rung, ONE
    launch regardless of cluster count.

    queries: (K, B, D) — group h holds home-cluster h's miss batch;
    digests: (K, M, D); valid: (K, M).  Each group probes every cluster's
    digest EXCEPT its own.  Returns (idx (K, B, k) int32 global digest
    indices in [0, K*M), score (K, B, k) f32); candidate cluster = idx // M.
    """
    K, M, D = (int(s) for s in digests.shape)

    def fn(q, dg, v):
        not_home = ~torch.eye(K, dtype=torch.bool, device=v.device)
        valid_h = (v.bool()[None, :, :] & not_home[:, :, None]).reshape(
            K, K * M)
        return similarity_topk_batched(q, dg.reshape(K * M, D), valid_h, k,
                                       impl=impl)

    return _run("federated_digest_lookup", impl, fn,
                   (queries, digests, valid),
                   lambda: digest_probe_bytes(int(queries.shape[1]), K, M,
                                              D, "fp32"))


def federated_digest_lookup_quantized(queries: torch.Tensor,
                                      codes: torch.Tensor,
                                      scales: torch.Tensor,
                                      valid: torch.Tensor, k: int = 1, *,
                                      impl: str = "auto"):
    """``federated_digest_lookup`` over int8-quantized digests: codes
    (K, M, D) int8 symmetric per-row codes, scales (K, M) f32 — the wire
    format the region received — dequantized once for the call."""
    K, M, D = (int(s) for s in codes.shape)

    def fn(q, cd, sc, v):
        digests = cd.float() * sc.float()[..., None]
        return federated_digest_lookup(q, digests, v, k, impl=impl)

    return _run("federated_digest_lookup_quantized", impl, fn,
                   (queries, codes, scales, valid),
                   lambda: digest_probe_bytes(int(queries.shape[1]), K, M,
                                              D, "int8"))


def federated_digest_lookup_ivfpq(queries: torch.Tensor, index, k: int = 1,
                                  *, n_probe: int, impl: str = "auto"):
    """``federated_digest_lookup`` over the board's packed IVF-PQ index.

    queries: (K, B, D); ``index`` is a ``core/digest.py::IVFPQIndex``
    whose arrays are numpy or tensors (moved to the queries' device).  ONE
    ``ivf_pq_probe`` launch covers all K home batches; the home-cluster
    exclusion runs inside the kernel (``slot_owner != home``).  Returns
    (idx (K, B, k) int32 GLOBAL digest row ids — the flat slot winners
    mapped through ``slot_rid`` — and score (K, B, k) f32 of the
    PQ-approximated similarity).  Candidates from empty slots score -1e30,
    so any caller-side score threshold removes them."""
    K, B, D = (int(s) for s in queries.shape)
    cent, cvalid, codes, svalid, sowner, cb, rid = (
        torch.as_tensor(getattr(index, f), device=queries.device)
        for f in ("centroids", "cent_valid", "codes", "slot_valid",
                  "slot_owner", "codebook", "slot_rid"))
    home = torch.arange(K, dtype=torch.int32,
                        device=queries.device).repeat_interleave(B)

    def fn(q, *arrays):
        idx, score, _ = ivf_pq_probe(q.reshape(K * B, D), home, *arrays,
                                     k=k, n_probe=n_probe, impl=impl)
        rid_of = rid.reshape(-1)[idx.long()]              # flat slot -> rid
        return rid_of.reshape(K, B, k), score.reshape(K, B, k)

    L, cap, S = (int(s) for s in codes.shape)
    return _run("federated_digest_lookup_ivfpq", impl, fn,
                   (queries, cent, cvalid, codes, svalid, sowner, cb),
                   lambda: ivf_pq_probe_bytes(K * B, L, cap, S, D))


def _merge_shard_topk(shard_idx: torch.Tensor, shard_scores: torch.Tensor,
                      out_k: int):
    """Merge per-shard top-k' candidates: (N, Q, k') -> (Q, out_k).

    Candidates are laid out shard-major, which is global-index order for
    contiguous shards, and each shard's list is score-descending with
    index-ordered ties, so a stable descending sort of the candidates (the
    reference's ``lax.top_k``, whose ties go to the earlier position)
    reproduces one top-k over the whole pooled cache bit for bit."""
    n, q, k_local = shard_scores.shape
    cand_s = shard_scores.permute(1, 0, 2).reshape(q, n * k_local)
    cand_i = shard_idx.permute(1, 0, 2).reshape(q, n * k_local)
    top_s, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
    top_i = torch.gather(cand_i, 1, pos[:, :out_k])
    return top_i.to(torch.int32), top_s[:, :out_k]


def sharded_topk_lookup(queries: torch.Tensor, keys: torch.Tensor,
                        valid: torch.Tensor, k: int, mesh,
                        axis_name: str = "cache", *, impl: str = "auto"):
    """``cluster_topk_lookup`` as a collective over the mesh dimension
    ``axis_name``: rank r runs ``similarity_topk`` (K4) on its own shard
    ``keys[r]`` only, offsets its indices by r * C, and one all-gather of
    (k idx, k score) per shard replaces shipping whole shards around.

    queries: (Q, D), the same on every rank; keys: (N, C, D); valid:
    (N, C); N must equal the mesh dimension's size.  Every rank of the
    dimension calls it and gets the same (idx (Q, k) int32, score (Q, k)
    f32), identical to the pooled ``cluster_topk_lookup``."""
    n, c, _ = keys.shape
    assert n == mesh_shape(mesh)[axis_name], (n, mesh_shape(mesh))
    r = mesh.get_local_rank(axis_name)
    group = mesh.get_group(axis_name)
    idx, score = similarity_topk(queries, keys[r], valid[r], min(k, c),
                                 impl=impl)
    idx = idx + r * c
    return _merge_shard_topk(gather_stack(idx, group),
                             gather_stack(score, group), min(k, n * c))


def regroup_surviving_shards(keys: torch.Tensor, valid: torch.Tensor,
                             alive: np.ndarray):
    """Compact the shard axis onto the surviving shard set.  keys (N, C, D)
    / valid (N, C) / alive (N,) bool -> (keys (A, C, D), valid (A, C),
    shard_ids (A,) int32) where ``shard_ids[a]`` is the original shard id of
    compacted row ``a``.  Entries on dead shards do not appear — lost,
    never phantom."""
    alive = np.asarray(alive, bool)
    assert alive.shape == (keys.shape[0],), (alive.shape, keys.shape)
    ids = np.nonzero(alive)[0].astype(np.int32)
    sel = torch.as_tensor(ids, dtype=torch.long, device=keys.device)
    return keys[sel], valid[sel], ids


def surviving_topk_lookup(queries: torch.Tensor, keys: torch.Tensor,
                          valid: torch.Tensor, alive: np.ndarray, k: int,
                          mesh: Optional[object] = None,
                          axis_name: str = "cache", *, impl: str = "auto"):
    """``sharded_topk_lookup`` regrouped over the surviving shard set: the
    lookup runs over only the ``alive`` shards (compacted, so dead shards
    cost nothing and can never serve), and returned indices map back to the
    ORIGINAL [0, N*C) space so ``owner = idx // C`` stays
    membership-agnostic.  When ``mesh``'s ``axis_name`` size equals the
    survivor count the probe is the collective; otherwise it is the pooled
    one-launch probe (the same results).  With no survivors every query
    misses: idx -1, score -inf."""
    n, c, _ = keys.shape
    q = queries.shape[0]
    keys_a, valid_a, ids = regroup_surviving_shards(keys, valid, alive)
    if len(ids) == 0:
        return (torch.full((q, k), -1, dtype=torch.int32,
                           device=queries.device),
                torch.full((q, k), float("-inf"), dtype=torch.float32,
                           device=queries.device))
    if mesh is not None and mesh_shape(mesh).get(axis_name) == len(ids):
        idx, score = sharded_topk_lookup(queries, keys_a, valid_a, k, mesh,
                                         axis_name, impl=impl)
    else:
        idx, score = cluster_topk_lookup(queries, keys_a, valid_a, k,
                                         impl=impl)
    # compacted shard a -> original shard ids[a], preserving the slot
    ids_t = torch.as_tensor(ids, device=idx.device)
    idx = ids_t[(idx // c).long()] * c + idx % c
    return idx.to(torch.int32), score
