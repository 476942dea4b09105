"""The membership control plane and the one-card pooled probes of the
PyTorch port against the JAX package (CPU, fp32).

* The chaos loop of tests/test_chaos.py (a seeded ``ChaosSchedule``
  killing and reviving clusters and nodes while a ``RoamingWorkload``
  streams through a federated tier, requests at dead targets rerouted)
  runs through both packages for seeds 0-2, announced and silent: the
  served records, the tier counts and the membership stats must be equal.
* ``cluster_topk_lookup``, ``surviving_topk_lookup`` (zero survivors
  included) and ``federated_digest_lookup{,_quantized}`` against the
  reference's ``impl="ref"`` paths: indices exact, scores within 1e-5.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cluster as jcl
import repro.core.federation as jfed
import repro.core.membership as jmb
import repro.core.policies as jpol
import repro.parallel.sharding as jsh
import repro_torch.core.cluster as tcl
import repro_torch.core.federation as tfed
import repro_torch.core.membership as tmb
import repro_torch.core.policies as tpol
import repro_torch.parallel.sharding as tsh
from repro.data.workload import ChaosSchedule, RoamingWorkload
from test_torch_federation import pack_round

K, N, DIM, PAY, CAP, STEPS, EVERY = 3, 2, 48, 8, 16, 20, 4
JAX = types.SimpleNamespace(cl=jcl, fed=jfed, mb=jmb, pol=jpol, kw={})
TORCH = types.SimpleNamespace(cl=tcl, fed=tfed, mb=tmb, pol=tpol,
                              kw={"device": "cpu"})


def _apply_silent(chaos, mb, step, clock):
    """tests/test_chaos.py::_apply_silent: cluster events as silent
    crashes on the logical clock, node events announced."""
    for ev in chaos.by_step.get(step, []):
        if ev.kind == "kill_cluster":
            mb.kill_cluster(ev.cluster, announce=False, now=clock)
        elif ev.kind == "revive_cluster":
            mb.revive_cluster(ev.cluster, now=clock)
        elif ev.kind == "kill_node":
            mb.kill_node(ev.cluster, ev.node)
        else:
            mb.revive_node(ev.cluster, ev.node)


def _drive(pkg, seed, chaos, silent):
    """tests/test_chaos.py::_drive through one package: route on ground
    truth, probe, insert the misses; returns (served, tier, membership)."""
    wl = RoamingWorkload(num_clusters=K, nodes_per_cluster=N,
                         users_per_node=4, pool_size=32, dim=DIM,
                         payload_dim=PAY, noise=0.0, mobility=0.25,
                         seed=seed)
    tier = pkg.fed.FederatedEdgeTier(pkg.fed.FederationConfig(
        num_clusters=K, digest_size=8, digest_interval=1,
        cluster=pkg.cl.ClusterConfig(num_nodes=N, node_capacity=CAP,
                                     key_dim=DIM, payload_dim=PAY,
                                     threshold=0.85,
                                     policy=pkg.pol.EvictionPolicy("lru"))),
        **pkg.kw)
    mb = pkg.mb.ClusterMembership(K, N, timeout_s=1.0)
    tier.attach_membership(mb)
    served, clock = [], 0.0
    for step, round_ in enumerate(wl.stream(STEPS, seed=seed + 1000), 1):
        clock += 1.0
        for k in range(K):
            if mb.cluster_alive[k]:
                mb.beat(k, at=clock)
        mb.sweep(now=clock)
        if silent:
            _apply_silent(chaos, mb, step, clock)
        else:
            chaos.apply(mb, step)
        routed = [(*mb.route(k, n), ids, desc) for k, n, ids, desc in round_]
        q, mask, recs = pack_round(routed)
        res = tier.lookup_grouped(q, mask)
        assert tier.last_ladder_dispatches <= 4
        ins = {}
        for k, n, b, sid in recs:
            hit = bool(res.hit[k, n, b])
            served.append((step, k, n, sid, hit, int(res.tier[k, n, b]),
                           int(res.cluster[k, n, b]),
                           int(res.owner[k, n, b]),
                           np.asarray(res.value[k, n, b]).tobytes()))
            if not hit:
                ins.setdefault((k, n), []).append((q[k, n, b], sid))
        for (k, n), rows in ins.items():
            for i in range(0, len(rows), CAP):
                part = rows[i:i + CAP]
                tier.insert(k, n, np.stack([d for d, _ in part]),
                            wl.payloads[[s for _, s in part]])
    return served, tier, mb


@pytest.mark.parametrize("silent", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_loop_matches_jax(seed, silent):
    chaos = ChaosSchedule(K, N, every=EVERY, steps=STEPS, node_prob=0.3,
                          seed=seed)
    sj, fj, mj = _drive(JAX, seed, chaos, silent)
    st, ft, mt = _drive(TORCH, seed, chaos, silent)
    assert st == sj
    assert mt.stats() == mj.stats()
    assert ft.tier_counts == fj.tier_counts
    assert ft.stats() == fj.stats()


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _cmp(t, j):
    ti, ts = t
    ji, js = j
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("k", [1, 4])
def test_pooled_lookups_match_jax(k):
    rng = np.random.default_rng(k)
    n, c, q, d = 4, 8, 5, 32
    keys = _unit(rng, n, c, d)
    keys[1, 3] = keys[0, 2]                         # an exact tie
    valid = rng.random((n, c)) < 0.7
    queries = _unit(rng, q, d)
    queries[0] = keys[0, 2]
    jargs = (jnp.asarray(queries), jnp.asarray(keys), jnp.asarray(valid))
    targs = tuple(torch.from_numpy(a) for a in (queries, keys, valid))
    _cmp(tsh.cluster_topk_lookup(*targs, k),
         jsh.cluster_topk_lookup(*jargs, k, impl="ref"))
    for alive in ([True, False, True, True], [False, True, False, False],
                  [False] * n):
        alive = np.array(alive)
        _cmp(tsh.surviving_topk_lookup(*targs, alive, k),
             jsh.surviving_topk_lookup(*jargs, alive, k, impl="ref"))


@pytest.mark.parametrize("k", [1, 4])
def test_federated_digest_lookups_match_jax(k):
    rng = np.random.default_rng(10 + k)
    K, M, B, D = 3, 8, 4, 32
    digests = _unit(rng, K, M, D)
    valid = rng.random((K, M)) < 0.8
    queries = _unit(rng, K, B, D)
    queries[0, 0] = digests[1, 2]
    _cmp(tsh.federated_digest_lookup(torch.from_numpy(queries),
                                     torch.from_numpy(digests),
                                     torch.from_numpy(valid), k),
         jsh.federated_digest_lookup(jnp.asarray(queries),
                                     jnp.asarray(digests),
                                     jnp.asarray(valid), k, impl="ref"))
    from repro.core.digest import quantize_rows
    codes, scales = quantize_rows(digests.reshape(K * M, D))
    codes, scales = codes.reshape(K, M, D), scales.reshape(K, M)
    _cmp(tsh.federated_digest_lookup_quantized(
        torch.from_numpy(queries), torch.from_numpy(codes),
        torch.from_numpy(scales), torch.from_numpy(valid), k),
         jsh.federated_digest_lookup_quantized(
        jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(scales),
        jnp.asarray(valid), k, impl="ref"))
