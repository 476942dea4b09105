"""The cross-cluster federation of the PyTorch port against the JAX package
(CPU, fp32): a ``FederatedEdgeTier`` of 3 clusters x 2 nodes on a seeded
``RoamingWorkload``, for the digest wire formats (full/delta x fp32/int8)
and the IVF-PQ remote probe, plus region-aware eviction pins.

Per step hit, tier, serving cluster, owner and payload must be equal;
at the end the tier counts, digest false hits, shipped bytes, remote
fills and the whole ``stats()`` dict, with at most 4 ladder dispatches.
"""
import numpy as np
import pytest

from repro.core.cluster import ClusterConfig as JCC
from repro.core.federation import FederatedEdgeTier as JFed
from repro.core.federation import FederationConfig as JFC
from repro.core.policies import EvictionPolicy as JPol
from repro.core.tiers import pow2
from repro.data.workload import RoamingWorkload
from repro_torch.core.cluster import ClusterConfig as TCC
from repro_torch.core.federation import FederatedEdgeTier as TFed
from repro_torch.core.federation import FederationConfig as TFC
from repro_torch.core.policies import EvictionPolicy as TPol

K, N, DIM, PAY, CAP, STEPS = 3, 2, 48, 8, 16, 8
ANN = dict(ann_mode="ivfpq", ann_lists=4, ann_sub=4, ann_probe=2)


def _pair(policy=None, **kw):
    def cfg(FC, CC, Pol):
        return FC(num_clusters=K, digest_size=8, digest_interval=1,
                  cluster=CC(num_nodes=N, node_capacity=CAP, key_dim=DIM,
                             payload_dim=PAY, threshold=0.85,
                             policy=Pol(**(policy or {"kind": "lru"}))),
                  **kw)
    return JFed(cfg(JFC, JCC, JPol)), TFed(cfg(TFC, TCC, TPol), device="cpu")


def pack_round(round_):
    """One roaming round as the grouped (K, N, B, D) tensor + mask, and
    (k, n, b, scene) per request."""
    fill = {}
    for k, n, ids, _ in round_:
        fill[(k, n)] = fill.get((k, n), 0) + len(ids)
    B = pow2(max(fill.values()))
    q = np.zeros((K, N, B, DIM), np.float32)
    mask = np.zeros((K, N, B), bool)
    fill, recs = {}, []
    for k, n, ids, desc in round_:
        b0 = fill.get((k, n), 0)
        q[k, n, b0:b0 + len(ids)] = desc
        mask[k, n, b0:b0 + len(ids)] = True
        fill[(k, n)] = b0 + len(ids)
        recs += [(k, n, b0 + i, int(s)) for i, s in enumerate(ids)]
    return q, mask, recs


def _run(jf, tf, seed=0, mobility=0.25):
    wl = RoamingWorkload(num_clusters=K, nodes_per_cluster=N,
                         users_per_node=4, pool_size=32, dim=DIM,
                         payload_dim=PAY, noise=0.0, mobility=mobility,
                         seed=seed)
    for step, round_ in enumerate(wl.stream(STEPS, seed=seed + 1000)):
        q, mask, recs = pack_round(round_)
        rj, rt = jf.lookup_grouped(q, mask), tf.lookup_grouped(q, mask)
        for f in ("hit", "tier", "cluster", "owner", "value"):
            np.testing.assert_array_equal(getattr(rt, f),
                                          np.asarray(getattr(rj, f)),
                                          err_msg=f"{f} at step {step}")
        ins = {}
        for k, n, b, sid in recs:
            if not rt.hit[k, n, b]:
                ins.setdefault((k, n), []).append((q[k, n, b], sid))
        for (k, n), rows in ins.items():
            for i in range(0, len(rows), CAP):
                part = rows[i:i + CAP]
                for fed in (jf, tf):
                    fed.insert(k, n, np.stack([d for d, _ in part]),
                               wl.payloads[[s for _, s in part]])
    js, ts = jf.stats(), tf.stats()
    assert ts == js        # tier counts, false hits, bytes, fills, ...
    assert ts["max_ladder_dispatches"] <= 4
    return ts


@pytest.mark.parametrize("refresh,quant,ann", [
    ("full", "fp32", "off"), ("full", "int8", "off"),
    ("delta", "fp32", "off"), ("delta", "int8", "off"),
    ("full", "fp32", "ivfpq"), ("delta", "int8", "ivfpq")])
def test_federation_matches_jax(refresh, quant, ann):
    kw = dict(digest_refresh=refresh, digest_quant=quant)
    kw.update(ANN if ann == "ivfpq" else {"ann_mode": "off"})
    ts = _run(*_pair(**kw))
    assert ts["tier_counts"]["remote"] > 0
    if ann == "ivfpq":
        assert ts["digest"]["ann_rows"] > 0


def test_region_aware_pins_match_jax():
    """Region pins on every refresh; the stats (and so the pins' effect on
    eviction) stay equal under heavy roaming."""
    jf, tf = _pair(policy={"kind": "lru", "region_aware": True},
                   region_hot_min=1)
    _run(jf, tf, seed=3, mobility=0.6)
    pins = [[st.region_pin.numpy() for st in cl.states]
            for cl in tf.clusters]
    np.testing.assert_array_equal(
        np.array(pins), np.array([[np.asarray(st.region_pin)
                                   for st in cl.states]
                                  for cl in jf.clusters]))
    assert np.array(pins).any()
