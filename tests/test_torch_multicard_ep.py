"""The port's expert-parallel MoE on eight CPU ``gloo`` ranks, a (data 4,
model 2) mesh, as the reference's ``test_ep_moe_matches_dense`` sets it
up: E = 8 (the experts divide over 'model': ``ep``) and E = 6 (they do
not, d_ff_expert does: ``fp``), top-2, capacity factor 4.0.  On every
rank the output within rtol 2e-4 / atol 2e-5 and the aux within rtol 1e-4
of the reference's ``moe_apply_dense`` (this process), and the gradients
of the output's sum finite and within atol 1e-5 + rtol 1e-4 of the
reference's dense gradients.  Then both production meshes, (16, 16) and
(2, 16, 16), on a 512-rank fake process group in one spawned process (the
counterpart of the reference's 512 placeholder devices).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_multicard_cases as C
from repro.configs import MoEConfig, ModelConfig
from repro.models import layers as JL

LEAVES = ("router", "we_gate", "we_up", "we_down")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return C.run_world(C.ep_cases, 8, str(tmp_path_factory.mktemp("ep")),
                       (4, 2))


def _dense(E):
    cfg = ModelConfig(name="t", family="moe", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                      moe=MoEConfig(num_experts=E, top_k=2, d_ff_expert=64))
    p, x = C.moe_inputs(E)
    jp = {f"moe/{k}": jnp.asarray(v) for k, v in p.items()}
    y, aux = JL.moe_apply_dense(cfg, jp, "moe", jnp.asarray(x))
    g = jax.grad(lambda q: JL.moe_apply_dense(
        cfg, q, "moe", jnp.asarray(x))[0].sum())(jp)
    return np.asarray(y), float(aux), [np.asarray(g[f"moe/{k}"])
                                       for k in LEAVES]


@pytest.mark.parametrize("rank", range(8))
@pytest.mark.parametrize("E", [8, 6], ids=["ep", "fp"])
def test_ep_moe_matches_dense(world, E, rank):
    y, aux, grads = _dense(E)
    out = world[rank][E]
    np.testing.assert_allclose(out["y"], y, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out["aux"], aux, rtol=1e-4)
    for k, a, b in zip(LEAVES, out["grads"], grads):
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=k)


def test_production_meshes_on_512_fake_ranks(tmp_path):
    out = C.run_fake_mesh(str(tmp_path))
    assert out["single"] == {"data": 16, "model": 16}
    assert out["multi"] == {"pod": 2, "data": 16, "model": 16}
    assert out["spec_single"] == ("data",)
    assert out["spec_multi"] == (("pod", "data"),)
    assert out["placements"] == ["S(0)", "S(0)", "R"]
    assert out["local_multi"] == (16, 128)
