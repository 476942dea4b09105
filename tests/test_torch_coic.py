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

