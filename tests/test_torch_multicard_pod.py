"""The port's cross-pod compression and elastic training on four CPU
``gloo`` ranks (one spawned world):

- ``compressed_cross_pod_mean`` on the 'pod' dimension of a (pod 2, data
  1, model 2) mesh: within 5% of the exact mean (``test_multidevice.py``),
  and the mean and each pod's error-feedback residual within 1e-6 of the
  reference's own function run over a named ``jax.vmap`` axis (its
  psum / pmax reduce over the mapped pods), so the int8 payload is the
  reference's;
- the compressed train step (reduced llama3.2-1b, fp32) within 0.05 of the
  exact one-rank step's loss after 6 steps (``test_multidevice.py``);
- ``ElasticTrainer``: 4 data shards, a failure at step 7 shrinking to 2,
  checkpoints every 5 steps: the reference's events ("step 7: reconfigure
  to 2 data shards", "restored step 5 onto new mesh"), step 12, finite
  losses, the replayed steps' losses within 1e-5 of their first run; the
  two ranks outside the new mesh say so and wait for the run's end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_multicard_cases as C
from repro.optim import grad_compress as JG
from torch_twins import twin


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, _, jp, _ = twin("llama3.2-1b", True)
    params = {k: np.asarray(v) for k, v in jp.items()}
    d = tmp_path_factory.mktemp("pod")
    return C.run_world(C.pod_cases, 4, str(d), params, str(d / "ckpt"))


def _reference_mean():
    """The reference's ``compressed_cross_pod_mean`` over a leading pod
    axis under ``jax.vmap(axis_name="pod")``."""
    g = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
    err = np.random.default_rng(1).standard_normal((2, 64)).astype(
        np.float32) * 0.01

    def f(gp, ep):
        out, st = JG.compressed_cross_pod_mean(
            {"w": gp}, JG.CompressionState(error={"w": ep}), "pod")
        return out["w"], st.error["w"]
    mean, new_err = jax.vmap(f, axis_name="pod")(jnp.asarray(g),
                                                 jnp.asarray(err))
    return g, err, np.asarray(mean), np.asarray(new_err)


@pytest.mark.parametrize("rank", range(4))
def test_compressed_mean_matches_reference(world, rank):
    g, err, mean, new_err = _reference_mean()
    out = world[rank]["compress"]
    pod = out["pod"]
    assert pod == rank // 2
    np.testing.assert_allclose(out["mean"], mean[pod], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["err"], new_err[pod], rtol=0, atol=1e-6)
    want = (g + err).mean(0)
    rel = np.linalg.norm(out["mean"] - want) / np.linalg.norm(want)
    assert rel < 0.05, rel


def test_compressed_step_tracks_exact(world):
    out = world[0]["compressed_step"]
    assert all(r["compressed_step"]["loss"] == out["loss"] for r in world)
    assert np.isfinite(out["loss"]).all()
    assert abs(out["loss"][-1] - out["exact"][-1]) < 0.05
    # the first step's gradients have no error feedback yet: the same loss
    np.testing.assert_allclose(out["loss"][0], out["exact"][0], rtol=1e-5)


@pytest.mark.parametrize("rank", range(4))
def test_elastic_shrink_and_recover(world, rank):
    out = world[rank]["elastic"]
    assert out["events"][0] == "step 7: reconfigure to 2 data shards"
    if rank < 2:
        assert out["events"] == ["step 7: reconfigure to 2 data shards",
                                 "restored step 5 onto new mesh"]
        assert out["step"] == 12
        losses = out["loss"]
        assert len(losses) == 7 + 7 and np.isfinite(losses).all()
        # steps 5 and 6 ran on 4 shards, then again on 2 after the restore
        np.testing.assert_allclose(losses[7:9], losses[5:7], rtol=1e-5)
        assert losses == world[0]["elastic"]["loss"]
    else:
        assert out["step"] is None
        assert out["events"][1] == (f"rank {rank}: outside the 2-shard mesh,"
                                    " waiting for the run's end")
        assert len(out["loss"]) == 7
