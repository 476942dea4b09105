"""Device-side probes of the cooperative cache ladder — the one-card part of
``repro/parallel/sharding.py``.

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
* ``regroup_surviving_shards`` / ``surviving_topk_lookup`` — the lookup
  over the shards that survived a membership change, with indices mapped
  back to the original shard ids.

Digest hits are hints: the caller confirms them against the candidate
cluster's authoritative shards (``core/federation.py``).  The multi-card
``cache``-axis collective (``sharded_topk_lookup``), the logical-axis
sharding rules and ``launch/mesh.py`` are ROADMAP.md Queue 1 item 12; a
``mesh`` argument raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ivf_pq import ivf_pq_probe
from repro_torch.kernels.similarity import (similarity_topk,
                                            similarity_topk_batched)
from repro_torch.kernels.similarity.ops import _run
from repro_torch.obs.profile import digest_probe_bytes, ivf_pq_probe_bytes

MESH_TODO = ("a real cache-axis mesh (multi-card sharded_topk_lookup) is "
             "not ported yet (ROADMAP.md Queue 1 item 12)")


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
    """``cluster_topk_lookup`` over the surviving shard set: the lookup runs
    over only the ``alive`` shards (compacted, so dead shards cost nothing
    and can never serve), and returned indices map back to the ORIGINAL
    [0, N*C) space so ``owner = idx // C`` stays membership-agnostic.  With
    no survivors every query misses: idx -1, score -inf.  ``mesh`` (the
    multi-card collective) raises."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)
    n, c, _ = keys.shape
    q = queries.shape[0]
    keys_a, valid_a, ids = regroup_surviving_shards(keys, valid, alive)
    if len(ids) == 0:
        return (torch.full((q, k), -1, dtype=torch.int32,
                           device=queries.device),
                torch.full((q, k), float("-inf"), dtype=torch.float32,
                           device=queries.device))
    idx, score = cluster_topk_lookup(queries, keys_a, valid_a, k, impl=impl)
    # compacted shard a -> original shard ids[a], preserving the slot
    ids_t = torch.as_tensor(ids, device=idx.device)
    idx = ids_t[(idx // c).long()] * c + idx % c
    return idx.to(torch.int32), score
