"""The port's cache-axis collective and layouts on four CPU ``gloo``
ranks (one spawned world for the module, ``tests/torch_multicard_cases``),
held against the JAX package in this process:

- ``sharded_topk_lookup`` (``n, c, q, d, k = 4, 32, 6, 16, 5``, seed 2, the
  reference's ``test_shard_map_lookup_bitexact`` inputs) on every rank,
  bit-equal to the reference's ``similarity_topk(impl="ref")`` over the
  pooled keys; ``surviving_topk_lookup`` with shard 1 dead on a 4-rank
  mesh (the pooled branch) and on a 3-rank mesh (the collective), bit-equal
  to the reference's mesh-less probe;
- the 4-node ``CooperativeEdgeCluster`` on a cache mesh through the seeded
  stream of ``test_torch_cluster.py`` (kill, revive, wipe): hits, tiers,
  owners and payloads equal to the reference's mesh-less cluster, scores
  within 1e-5 (the one-process port's tolerance), stats equal; and
  bit-equal, scores too, to the port's cluster without a mesh;
- ``shard_batch``, ``Checkpointer.restore(shardings=...)`` (each rank's
  slice of the saved leaf, by the rules) and the activation hook on the
  mesh (``constrain`` returns a rank's own slice as it is).
"""
import numpy as np
import pytest

import torch_multicard_cases as C
from repro.core.cluster import ClusterConfig as JConfig
from repro.core.cluster import CooperativeEdgeCluster as JCluster
from repro.core.policies import EvictionPolicy as JPolicy
from repro.parallel.sharding import RULES_TRAIN as J_RULES
from repro.parallel.sharding import surviving_topk_lookup as j_surviving

RANKS = range(4)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax.numpy as jnp

    from repro.configs import get_config, reduced_config
    from repro.models import build_model

    d = tmp_path_factory.mktemp("cache_world")
    res = C.run_world(C.cache_cases, 4, str(d))
    jm = build_model(reduced_config(get_config("llama3.2-1b")))
    rng = np.random.default_rng(4)
    leaves = {k: (v.axes, rng.standard_normal(v.shape).astype(np.float32))
              for k, v in jm.param_specs().items()}
    d2 = tmp_path_factory.mktemp("layout_world")
    layout = C.run_world(C.layout_cases, 4, str(d2), str(d2 / "ckpt"),
                         leaves)
    del jnp
    return res, layout, leaves


def _oracle(keys, valid, qs, k):
    import jax.numpy as jnp

    from repro.kernels.similarity import similarity_topk
    n, c, d = keys.shape
    oi, os_ = similarity_topk(jnp.asarray(qs),
                              jnp.asarray(keys.reshape(n * c, d)),
                              jnp.asarray(valid.reshape(-1)), k, impl="ref")
    return np.asarray(oi), np.asarray(os_)


@pytest.mark.parametrize("key", ["topk", "direct", "all_alive"])
@pytest.mark.parametrize("rank", RANKS)
def test_sharded_topk_bit_equal_to_pooled_reference(world, rank, key):
    qs, keys, valid = C.topk_inputs()
    oi, os_ = _oracle(keys, valid, qs, C.TOPK["k"])
    idx, score = world[0][rank][key]
    np.testing.assert_array_equal(idx, oi)
    np.testing.assert_array_equal(score, os_)


@pytest.mark.parametrize("key,ranks", [("surviving_pooled", RANKS),
                                       ("surviving_mesh3", range(3))])
def test_surviving_lookup_bit_equal_to_reference(world, key, ranks):
    import jax.numpy as jnp
    qs, keys, valid = C.topk_inputs()
    alive = np.array([True, False, True, True])
    oi, os_ = j_surviving(jnp.asarray(qs), jnp.asarray(keys),
                          jnp.asarray(valid), alive, C.TOPK["k"])
    for r in ranks:
        idx, score = world[0][r][key]
        np.testing.assert_array_equal(idx, np.asarray(oi))
        np.testing.assert_array_equal(score, np.asarray(os_))
        assert not np.isin(idx // C.TOPK["c"], [1]).any()   # dead shard


@pytest.mark.parametrize("admission", ["always", "second_hit"])
@pytest.mark.parametrize("rank", RANKS)
def test_mesh_cluster_matches_reference(world, rank, admission):
    kw = dict(num_nodes=C.CLUSTER["N"], node_capacity=C.CLUSTER["C"],
              key_dim=C.CLUSTER["D"], payload_dim=C.CLUSTER["P"],
              threshold=0.9, admission=admission)
    ref, ref_stats = C.drive_cluster(
        JCluster(JConfig(policy=JPolicy("lru"), **kw)), C.cluster_stream(),
        admission)
    (mesh_out, mesh_stats), (plain_out, plain_stats) = \
        world[0][rank]["cluster"][admission]
    assert mesh_stats == ref_stats == plain_stats
    assert mesh_stats["ladder"]["tier_counts"]["peer"] > 0
    for step, (m, p, j) in enumerate(zip(mesh_out, plain_out, ref)):
        for f, a, b in zip(("hit", "tier", "owner", "score", "value"), m, p):
            np.testing.assert_array_equal(a, b, err_msg=f"{f} {step}")
        hit = m[0]
        for f, a, b in zip(("hit", "tier", "owner"), m, j):
            np.testing.assert_array_equal(a, b, err_msg=f"{f} {step}")
        np.testing.assert_array_equal(m[4], j[4], err_msg=f"value {step}")
        np.testing.assert_allclose(m[3][hit], np.asarray(j[3])[hit],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("rank", RANKS)
def test_shard_batch_keeps_this_ranks_rows(world, rank):
    out = world[1][rank]
    d, _ = out["coord"]
    rows, cols = C.LAYOUT_BATCH["rows"], C.LAYOUT_BATCH["cols"]
    full = np.arange(rows * cols, dtype=np.int32).reshape(rows, cols)
    np.testing.assert_array_equal(out["batch"]["tokens"],
                                  full[d * rows // 2:(d + 1) * rows // 2])
    # 3 rows do not divide over data: replicated, as the rules say
    np.testing.assert_array_equal(out["batch"]["odd"],
                                  np.arange(6, dtype=np.float32).reshape(3, 2))


@pytest.mark.parametrize("rank", RANKS)
def test_restore_with_shardings_places_each_leaf(world, rank):
    out, leaves = world[1][rank], world[2]
    d, m = out["coord"]
    mesh = type("FakeMesh", (), {"shape": {"data": 2, "model": 2}})()
    for k, (axes, full) in leaves.items():
        spec = tuple(J_RULES.spec_for(axes, full.shape, mesh))
        assert out["specs"][k] == spec, k
        want = full
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            coord, n = (d, 2) if ax == "data" else (m, 2)
            size = full.shape[dim] // n
            want = np.take(want, range(coord * size, (coord + 1) * size),
                           axis=dim)
        np.testing.assert_array_equal(out["restored"][k], want, err_msg=k)
    assert out["roundtrip"] and out["one_sharding"]


@pytest.mark.parametrize("rank", RANKS)
def test_constrain_keeps_each_rank_slice(world, rank):
    same, tp, rows = world[1][rank]["constrain"]
    assert same and tp and rows == ("data",)
