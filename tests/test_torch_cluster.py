"""The cooperative edge cluster of the PyTorch port against the JAX package
(CPU, fp32): a 4-node ``CooperativeEdgeCluster`` over a seeded stream of
grouped lookups and inserts — with a node kill, its revive and a whole
cluster wipe in the stream — under each admission policy.  Hits, tiers,
owners and payloads must be equal at every step, scores within 1e-5, and
``stats()`` equal at the end.
"""
import numpy as np
import pytest

from repro.core.cluster import ClusterConfig as JConfig
from repro.core.cluster import CooperativeEdgeCluster as JCluster
from repro.core.policies import EvictionPolicy as JPolicy
from repro_torch.core.cluster import ClusterConfig as TConfig
from repro_torch.core.cluster import CooperativeEdgeCluster as TCluster
from repro_torch.core.policies import EvictionPolicy as TPolicy

N, C, D, P, B = 4, 8, 32, 4, 4


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(admission, policy="lru"):
    kw = dict(num_nodes=N, node_capacity=C, key_dim=D, payload_dim=P,
              threshold=0.9, admission=admission)
    return (JCluster(JConfig(policy=JPolicy(policy), **kw)),
            TCluster(TConfig(policy=TPolicy(policy), **kw), device="cpu"))


def _same(rj, rt):
    for f in ("hit", "tier", "owner", "value"):
        np.testing.assert_array_equal(np.asarray(getattr(rt, f)),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    np.testing.assert_allclose(rt.score[rt.hit], np.asarray(rj.score)[rj.hit],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("admission", ["always", "never", "second_hit",
                                       "freq_weighted"])
def test_cluster_stream_matches_jax(admission):
    jc, tc = _pair(admission, "lfu" if admission == "freq_weighted"
                   else "lru")
    rng = np.random.default_rng(0)
    pool = _unit(rng, 24, D)
    pay = np.arange(24 * P, dtype=np.float32).reshape(24, P)
    for step in range(10):
        if step == 4:
            jc.kill_node(1), tc.kill_node(1)
        if step == 6:
            jc.revive_node(1), tc.revive_node(1)
        if step == 8:
            jc.wipe(), tc.wipe()
        ids = rng.integers(0, 24, size=(N, B))
        q = pool[ids] + 0.01 * rng.standard_normal((N, B, D)).astype(
            np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        mask = rng.random((N, B)) < 0.8
        rj, rt = jc.lookup_grouped(q, mask), tc.lookup_grouped(q, mask)
        _same(rj, rt)
        for g in range(N):
            miss = mask[g] & ~rt.hit[g]
            if miss.any():
                for cl in (jc, tc):
                    cl.insert(g, q[g][miss], pay[ids[g][miss]])
    node = 2
    qs = pool[:3]
    _same(jc.lookup(node, qs), tc.lookup(node, qs))
    assert tc.stats() == jc.stats()
    assert tc.stats()["ladder"]["tier_counts"]["peer"] > 0
