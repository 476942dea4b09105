"""The slice as a whole, second half: ``CoICEngine`` and the semantic
prefix index of the PyTorch port against the JAX package (CPU, fp32
``coic-paper``, same weights).

The quickstart stream (examples/quickstart.py) through both ``CoICEngine``s
must give the same sources, with payloads within 1e-4 (token payloads
exact), and the same cache statistics; the n-gram-sketch prefix index of
the paged serving engine must map the same pages.
"""
import numpy as np
import pytest

from repro.core.coic import CoICConfig as JCoIC
from repro.core.coic import CoICEngine as JEngine
from repro.core.coic import generation_cloud_fn as j_generation
from repro.core.coic import recognition_cloud_fn as j_recognition
from repro_torch.core.coic import CoICConfig as TCoIC
from repro_torch.core.coic import CoICEngine as TEngine
from repro_torch.core.coic import generation_cloud_fn as t_generation
from repro_torch.core.coic import recognition_cloud_fn as t_recognition
from test_torch_serving import _serve_both
from torch_twins import twin


def test_semantic_prefix_mode_matches_jax():
    """The approximate (n-gram sketch) prefix index maps the same pages."""
    je, te = _serve_both("paged", waves=(4, 1), prefix_mode="semantic")
    assert te.stats()["kv"] == je.stats()["kv"]
    assert ([r.tokens.tolist() for r in te.results]
            == [r.tokens.tolist() for r in je.results])


@pytest.mark.parametrize("cloud", ["recognition", "generation"])
def test_coic_engine_quickstart_matches_jax(cloud):
    """examples/quickstart.py's stream (three rounds of four scenes)."""
    cfg, jm, jp, tm = twin("coic-paper")
    if cloud == "recognition":
        jfn, tfn = j_recognition(jm, jp, 64), t_recognition(tm, 64)
        kw = dict(capacity=256, threshold=0.98, payload_dim=64)
    else:
        jfn, tfn = j_generation(jm, jp, 4), t_generation(tm, 4)
        kw = dict(capacity=256, threshold=0.98, payload_dim=4,
                  payload_dtype="int32")
    je = JEngine(jm, jp, JCoIC(**kw), cloud_fn=jfn, miss_bucket=4)
    te = TEngine(tm, TCoIC(**kw), cloud_fn=tfn, miss_bucket=4, device="cpu")
    scenes = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    for _ in range(3):
        jres = je.process_batch(scenes)
        tres = te.process_batch(scenes)
        assert [r.source for r in tres] == [r.source for r in jres]
        for a, b in zip(tres, jres):
            np.testing.assert_allclose(a.payload, b.payload, atol=1e-4)
    js, ts = je.stats(), te.stats()
    for key in ("hits", "misses", "occupancy", "ladder", "digest"):
        assert ts[key] == js[key], key
    assert ts["hits"] == 8



def test_coic_engine_serves_through_cluster_death():
    """tests/test_chaos.py's CoICEngine run: requests aimed at a dead
    cluster reroute and complete with the same payloads, in both
    packages."""
    from repro.core.membership import ClusterMembership as JMember
    from repro_torch.core.membership import ClusterMembership as TMember
    cfg, jm, jp, tm = twin("coic-paper")
    kw = dict(capacity=16, threshold=0.98, descriptor="sketch",
              descriptor_dim=128, payload_dim=4, num_nodes=1,
              num_clusters=3, digest_size=4, digest_interval=1)
    jmb, tmb = JMember(3, 1, timeout_s=60.0), TMember(3, 1, timeout_s=60.0)
    je = JEngine(jm, jp, JCoIC(**kw), cloud_fn=j_recognition(jm, jp, 4),
                 membership=jmb)
    te = TEngine(tm, TCoIC(**kw), cloud_fn=t_recognition(tm, 4),
                 membership=tmb, device="cpu")
    toks = np.random.default_rng(21).integers(
        1, cfg.vocab_size, size=(4, 12)).astype(np.int32)
    for step in range(3):
        if step == 1:
            jmb.kill_cluster(1), tmb.kill_cluster(1)
        jres = je.process_batch(toks, node_id=0, cluster_id=1)
        tres = te.process_batch(toks, node_id=0, cluster_id=1)
        assert [r.source for r in tres] == [r.source for r in jres]
        for a, b in zip(tres, jres):
            np.testing.assert_allclose(a.payload, b.payload, atol=1e-4)
    js, ts = je.stats(), te.stats()
    for key in ("hits", "misses", "ladder", "digest", "membership"):
        assert ts[key] == js[key], key
    assert ts["membership"]["cluster_kills"] == 1
