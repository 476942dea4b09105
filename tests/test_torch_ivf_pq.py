"""The IVF-PQ digest probe (K6) of the PyTorch port against the JAX
package (CPU, fp32).

The port's plain version ``ivf_pq_probe_ref`` is held against the JAX
``ivf_pq_probe_ref`` (never against Pallas-interpret output): indices and
probed lists exact, scores within ``atol=1e-5`` (both sum the same dot
products in other orders).  The gather decode equals the reference's
one-hot decode bit for bit, and ``federated_digest_lookup_ivfpq`` maps
flat winners through ``slot_rid`` as the reference does.  The kernel's
split plan (``ivf_pq_plan``, plain Python) is checked here too: the
coarse GEMM's depth splits cover D once, every probed slot of a query
lands in exactly one scan block, and the workspace holds every region.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.digest import build_ivfpq_index as j_build
from repro.core.digest import train_pq_codebook as j_train
from repro.kernels.ivf_pq.ref import decode_pq_codes as j_decode
from repro.kernels.ivf_pq.ref import ivf_pq_probe_ref as j_probe
from repro.parallel.sharding import federated_digest_lookup_ivfpq as j_fed
import repro_torch.kernels.ivf_pq.ref as ivf_ref
from repro_torch.kernels.ivf_pq import (decode_pq_codes, ivf_pq_probe,
                                        ivf_pq_probe_ref)
from repro_torch.kernels.ivf_pq.kernel import CODES, TILE_K, ivf_pq_plan
from repro_torch.parallel.sharding import federated_digest_lookup_ivfpq

ATOL = 1e-5


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _index(rng, L, cap, S, D, Q=6):
    """A random packed index with invalid lists, empty slots, owners over
    3 clusters and duplicated codes (exact ties); query 0's home (7) owns
    no slot."""
    q = _unit(rng, Q, D)
    cent = (0.3 * rng.standard_normal((L, D))).astype(np.float32)
    cent_valid = rng.random(L) < 0.8
    codes = rng.integers(0, 256, size=(L, cap, S)).astype(np.uint8)
    codes[:, 1] = codes[:, 2]                       # exact ties per list
    slot_valid = rng.random((L, cap)) < 0.8
    owner = rng.integers(0, 3, size=(L, cap)).astype(np.int32)
    cb = (0.1 * rng.standard_normal((S, 256, D // S))).astype(np.float32)
    home = rng.integers(0, 3, size=Q).astype(np.int32)
    home[0] = 7                                     # owns nothing
    return [q, home, cent, cent_valid, codes, slot_valid, owner, cb]


def _both(arrays, k, n_probe):
    ji, js, jsel = j_probe(*(jnp.asarray(a) for a in arrays), k=k,
                           n_probe=n_probe)
    ti, ts, tsel = ivf_pq_probe_ref(*(torch.from_numpy(a) for a in arrays),
                                    k=k, n_probe=n_probe)
    return (np.asarray(ji), np.asarray(js), np.asarray(jsel)), \
        (ti.numpy(), ts.numpy(), tsel.numpy())


def _assert_same(j, t):
    np.testing.assert_array_equal(t[0], j[0])       # idx
    np.testing.assert_array_equal(t[2], j[2])       # sel
    np.testing.assert_allclose(t[1], j[1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("L", [4, 16])
def test_probe_ref_matches_jax(L, cap, S, D, monkeypatch):
    """Every k in {1, 4} and n_probe in {1, L}; the port walks the lists in
    chunks of 3 (its top-k merge must equal one top-k over the row)."""
    monkeypatch.setattr(ivf_ref, "CHUNK_BYTES", 3 * cap * D * 4)
    rng = np.random.default_rng(L * 1000 + cap * 100 + S * 10 + D)
    arrays = _index(rng, L, cap, S, D)
    for k in (1, 4):
        for n_probe in (1, L):
            j, t = _both(arrays, k, n_probe)
            _assert_same(j, t)


def test_probe_edge_cases_match_jax():
    """All lists invalid but one, a query whose home owns every live slot
    (candidate-free: indices 0..k-1 at -1e30), and a real candidate at
    flat index 0 with k = 4."""
    rng = np.random.default_rng(5)
    L, cap, S, D = 4, 8, 4, 16
    q, home, cent, cv, codes, sv, owner, cb = _index(rng, L, cap, S, D)
    cv[:] = False
    cv[2] = True
    home[1] = 1
    owner[:] = 1                                    # row 1 sees nothing
    sv[:] = False
    sv[0, 0] = sv[2, 3] = True                      # row 0: flat 0 and 19
    arrays = [q, home, cent, cv, codes, sv, owner, cb]
    for n_probe in (1, 2, L):
        j, t = _both(arrays, 4, n_probe)
        _assert_same(j, t)
    j, t = _both(arrays, 4, L)
    assert (t[1][1] == -1e30).all() and list(t[0][1]) == [0, 1, 2, 3]
    # two real candidates, then the lowest free flat indices (no duplicate)
    assert sorted(t[0][0][:2]) == [0, 19] and list(t[0][0][2:]) == [1, 2]


def test_gather_decode_bit_identical():
    rng = np.random.default_rng(1)
    for S, D in ((2, 16), (8, 64)):
        codes = rng.integers(0, 256, size=(5, 7, S)).astype(np.uint8)
        cb = rng.standard_normal((S, 256, D // S)).astype(np.float32)
        j = np.asarray(j_decode(jnp.asarray(cb),
                                jnp.asarray(codes).astype(jnp.int32)))
        t = decode_pq_codes(torch.from_numpy(cb), torch.from_numpy(codes))
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("k", [1, 4])
def test_federated_ivfpq_lookup_matches_jax(k):
    """The remote rung's probe over a board index built by
    ``build_ivfpq_index``: global row ids through ``slot_rid``."""
    rng = np.random.default_rng(k)
    K, M, D, B = 3, 16, 32, 4
    keys = _unit(rng, K * M, D)
    valid = rng.random(K * M) < 0.85
    owner = np.repeat(np.arange(K, dtype=np.int32), M)
    cb = j_train(keys[valid], n_lists=4, n_sub=4, seed=0, iters=4)
    index = j_build(cb, keys, valid, owner)
    qs = (keys[rng.integers(0, K * M, size=K * B)]
          + 0.05 * rng.standard_normal((K * B, D))).astype(np.float32)
    qs = (qs / np.linalg.norm(qs, axis=1, keepdims=True)).reshape(K, B, D)
    ji, js = j_fed(jnp.asarray(qs), index, k, n_probe=2, impl="ref")
    ti, ts = federated_digest_lookup_ivfpq(torch.from_numpy(qs), index, k,
                                           n_probe=2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL,
                               rtol=0)


def test_cuda_impl_needs_a_cuda_tensor():
    arrays = [torch.from_numpy(a) for a in
              _index(np.random.default_rng(0), 4, 8, 2, 16)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        ivf_pq_probe(*arrays, k=1, n_probe=2, impl="cuda")


H100_SMS = 132
# (Q, L, cap, S, D, k, n_probe)
BOARD = (256, 1024, 984, 8, 2048, 1, 16)       # the region board
FED_PATH = (16, 4, 8, 8, 2048, 1, 4)           # the remote rung's launch
PLAN_SHAPES = [BOARD, FED_PATH,
               (32, 64, 96, 8, 2048, 4, 8),    # the default switch shape
               (70, 100, 33, 16, 512, 4, 7),   # ragged against the tiles
               (2, 60000, 2, 2, 8, 1, 2),      # 60000 lists
               (4, 4, 8, 2, 16, 32, 2),        # k = 32 over short lists
               (3, 8, 8, 2, 16, 4, 8)]         # n_probe = L


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_ivf_pq_plan_covers_every_probed_slot(shape):
    """The coarse GEMM's k_split spans of D (each a whole number of
    k-steps, as deep as the C entry makes them) cover D once, none empty;
    each query's n_probe * cap probed slots (item p * cap + s is slot s of
    its p-th list) land in exactly one of its n_split scan blocks, none
    empty; the workspace holds the coarse partials, the lookup table, the
    probed lists' coarse scores and each scan block's k scores and k
    indices, in that order, disjoint and each 16-byte aligned."""
    Q, L, cap, S, D, k, n_probe = shape
    plan = ivf_pq_plan(Q, L, cap, S, D, k, n_probe, H100_SMS)
    steps = -(-D // TILE_K)             # the C entry's rule for the depth
    assert plan.split_depth == -(-steps // plan.k_split) * TILE_K
    depth = np.zeros(D, np.int64)
    for b in range(plan.k_split):
        span = slice(b * plan.split_depth, (b + 1) * plan.split_depth)
        assert depth[span].size > 0
        depth[span] += 1
    assert (depth == 1).all()
    items = n_probe * cap
    owner = np.zeros(items, np.int64)
    for split in range(plan.n_split):
        mine = np.arange(split * plan.chunk,
                         min(items, (split + 1) * plan.chunk))
        assert mine.size > 0
        owner[mine] += 1
    assert (owner == 1).all()
    regions = [(0, plan.k_split * Q * L), (plan.lut_at, Q * S * CODES),
               (plan.qc_at, Q * n_probe),
               (plan.part_s_at, Q * plan.n_split * k),
               (plan.part_i_at, Q * plan.n_split * k)]
    end = 0
    for at, size in regions:
        assert at % 4 == 0 and at >= end
        end = at + size
    assert plan.workspace == end


@pytest.mark.parametrize("shape", [BOARD, FED_PATH], ids=["board", "fed"])
def test_ivf_pq_plan_fills_the_card(shape):
    """The board and the federated path's launch (16 queries x 4 lists of
    8 slots) give the scan at least one block per SM of an H100."""
    Q, L, cap, S, D, k, n_probe = shape
    plan = ivf_pq_plan(Q, L, cap, S, D, k, n_probe, H100_SMS)
    assert Q * plan.n_split >= H100_SMS
