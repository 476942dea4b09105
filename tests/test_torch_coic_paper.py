"""The paper's own engine, ``CoICEngine`` on ``coic-paper`` (fp32, the
reference's weights carried across), against the JAX package's on the
CPU: Fig. 2a's stream (``chip_smoke.coic_stream``: Zipf(1.1) over 16
prompts of 32 tokens, 12 batches of 8) under two of its network
conditions, a 4-node cluster whose requests move from node 0 to nodes 1
and 2 (peer hits), two clusters (remote hits), and Fig. 2b's asset cache
keyed by a str, bytes, a numpy array and a bf16 tensor.

Sources, hits by tier, ladder and cache statistics must be equal and
payloads within 1e-4.  Of each result's latency breakdowns, every
modeled term (the network's: ``uplink_ms``, ``peer_net_ms``,
``remote_net_ms``, ``cloud_net_ms``, ``downlink_ms``, and
``amortized_over``; the origin baseline's network terms) must be exactly
equal: both packages compute them by the same arithmetic from the tiers.
``descriptor_ms``, ``lookup_ms`` and ``cloud_compute_ms`` are left out:
each engine measures them as wall time on its own run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import COIC_CONDITIONS, COIC_PAPER, coic_stream
from repro.core.coic import CoICConfig as JCoIC
from repro.core.coic import CoICEngine as JEngine
from repro.core.coic import recognition_cloud_fn as j_recognition
from repro.core.network import Link as JLink
from repro.core.network import NetworkModel as JNet
from repro_torch.core.coic import CoICConfig as TCoIC
from repro_torch.core.coic import CoICEngine as TEngine
from repro_torch.core.coic import recognition_cloud_fn as t_recognition
from repro_torch.core.network import Link as TLink
from repro_torch.core.network import NetworkModel as TNet
from torch_twins import twin

MODELED = ("uplink_ms", "peer_net_ms", "remote_net_ms", "cloud_net_ms",
           "downlink_ms", "amortized_over")
ORIGIN_MODELED = ("uplink_ms", "cloud_net_ms", "downlink_ms",
                  "amortized_over")


def _engines(condition=None, **kw):
    """The reference's engine and the port's on the same weights, cloud
    (the first 64 logits) and network (a Fig. 2a condition, or the
    default)."""
    cfg, jm, jp, tm = twin("coic-paper")
    nets = (JNet(), TNet())
    if condition is not None:
        _, me, ec = next(c for c in COIC_CONDITIONS if c[0] == condition)
        nets = (JNet(m_e=JLink(me, rtt_ms=2.0), e_c=JLink(ec, rtt_ms=20.0)),
                TNet(m_e=TLink(me, rtt_ms=2.0), e_c=TLink(ec, rtt_ms=20.0)))
    ccfg = dict(COIC_PAPER, **kw)
    je = JEngine(jm, jp, JCoIC(**ccfg), cloud_fn=j_recognition(jm, jp, 64),
                 network=nets[0], miss_bucket=8)
    te = TEngine(tm, TCoIC(**ccfg), cloud_fn=t_recognition(tm, 64),
                 network=nets[1], miss_bucket=8, device="cpu")
    return cfg, je, te


def _drive(je, te, batches, where):
    """Each batch through both engines at ``where[i]`` = (cluster, node);
    results held as the module says.  Returns the sources seen."""
    sources = []
    for toks, (k, n) in zip(batches, where):
        jres = je.process_batch(toks, node_id=n, cluster_id=k)
        tres = te.process_batch(toks, node_id=n, cluster_id=k)
        assert [r.source for r in tres] == [r.source for r in jres]
        for a, b in zip(tres, jres):
            np.testing.assert_allclose(a.payload, b.payload, atol=1e-4)
            for f in MODELED:
                assert getattr(a.coic, f) == getattr(b.coic, f), f
            for f in ORIGIN_MODELED:
                assert getattr(a.origin, f) == getattr(b.origin, f), f
            assert a.origin.peer_net_ms == b.origin.peer_net_ms == 0.0
            assert a.coic.deadline_miss is b.coic.deadline_miss is None
        sources += [r.source for r in tres]
    js, ts = je.stats(), te.stats()
    for key in ("hits", "misses", "ladder", "digest", "asset_cache",
                "deadline"):
        assert ts.get(key) == js.get(key), key
    return sources


@pytest.mark.parametrize("condition", ["400/100", "50/20"])
def test_fig2a_stream_matches_jax(condition):
    cfg, je, te = _engines(condition)
    batches = coic_stream(cfg.vocab_size)
    sources = _drive(je, te, batches, [(0, 0)] * len(batches))
    assert len(sources) == 96 and 0 < sources.count("edge") < 96
    assert set(sources) == {"edge", "cloud"}


def test_peer_ladder_matches_jax():
    """A 4-node cluster: the stream's batches arrive at node 0, then at
    nodes 1 and 2, whose local misses find node 0's results (peer hits)
    and re-admit them."""
    cfg, je, te = _engines("400/50", num_nodes=4)
    batches = coic_stream(cfg.vocab_size)
    where = [(0, 0)] * 4 + [(0, 1)] * 4 + [(0, 2)] * 4
    sources = _drive(je, te, batches, where)
    assert sources.count("peer") > 0 and sources.count("edge") > 0
    assert te.stats()["ladder"]["tier_counts"]["peer"] > 0


def test_federated_ladder_matches_jax():
    """Two clusters of two nodes, digests refreshed every step: batches at
    (0, 0), (0, 1), then cluster 1, whose misses hit cluster 0 through its
    digest (remote hits)."""
    cfg, je, te = _engines("100/50", num_nodes=2, num_clusters=2,
                           digest_interval=1)
    batches = coic_stream(cfg.vocab_size, steps=8)
    where = [(0, 0)] * 3 + [(0, 1)] * 2 + [(1, 0)] * 2 + [(1, 1)]
    sources = _drive(je, te, batches, where)
    assert sources.count("remote") > 0 and sources.count("peer") > 0


def test_load_asset_matches_jax():
    """Fig. 2b's hash-keyed loads: the first load of each key is "cloud"
    and every repeat "edge" at 0.0 ms in both packages, with the same keys
    in the same LRU order and the same stats; a bf16 tensor (with grad)
    keys the same entry as the JAX array of its values."""
    _, je, te = _engines()
    x = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    bf = jnp.asarray(x, jnp.bfloat16)
    tbf = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    keys = [("scene-3", "scene-3"), (b"\x01pano", b"\x01pano"),
            (np.arange(12, dtype=np.int32), np.arange(12, dtype=np.int32)),
            (bf, tbf)]
    for rep in range(3):
        for i, (jk, tk) in enumerate(keys):
            blob = np.full((256 * (i + 1),), i, np.float32)
            jv, jms, jsrc = je.load_asset(jk, lambda: jnp.asarray(blob))
            tv, tms, tsrc = te.load_asset(tk, lambda: torch.from_numpy(blob))
            assert tsrc == jsrc == ("cloud" if rep == 0 else "edge")
            assert (tms > 0.0) if rep == 0 else (tms == jms == 0.0)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert list(te.asset_cache._store) == list(je.asset_cache._store)
    assert te.stats()["asset_cache"] == je.stats()["asset_cache"]
    assert te.stats()["asset_cache"]["hits"] == 8
