"""Sharded training of the port on four CPU ``gloo`` ranks, (data 2,
model 2): the reduced llama3.2-1b (the reference's weights), 3 steps of
``SyntheticLMData(seq_len=32, global_batch=8)``, the master weights and
both AdamW moments laid out by ``RULES_TRAIN`` (``state_shardings``).
Held against the one-rank port step on the same batches (rank 0 runs it)
and against the reference's single-device step in this process (its own
``test_multidevice.py`` training tests need a multi-device XLA, which a
pytest process cannot have):

- fp32: every rank's losses equal; within 1e-5 relative of the one-rank
  step and within ``test_torch_trainer.py``'s rtol 1e-5 of the
  reference's; the gathered parameters after the first step within 1e-6
  of the one-rank step's where the gradient is above rounding level,
  within 2 x lr where it is not, and after the last within 2 x lr a step;
- bf16 compute: within the reference's own rtol 2e-2 / atol 2e-3
  (``test_multidevice.py``) of the one-rank step.
"""
import numpy as np
import pytest

import torch_multicard_cases as C
from torch_twins import twin

STEPS = range(3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import SyntheticLMData
    from repro.train import trainer as JT

    cfg, jm, jp, _ = twin("llama3.2-1b", True)
    params = {k: np.asarray(v) for k, v in jp.items()}
    res = C.run_world(C.train_cases, 4, str(tmp_path_factory.mktemp("tr")),
                      params)
    jtcfg = JT.TrainerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                             compute_dtype="float32")
    p = {k: jnp.asarray(v, jnp.float32) for k, v in jp.items()}
    state = JT.TrainState(params=p, opt=JT.make_optimizer(jtcfg).init(p),
                          step=jnp.zeros((), jnp.int32))
    step = jax.jit(JT.make_train_step(jm, jtcfg))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, **C.TRAIN)
    ref = []
    for i in STEPS:
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data.batch_at(i).items()})
        ref.append(float(m["loss"]))
    return res, ref


@pytest.mark.parametrize("step", STEPS)
def test_fp32_losses_match_one_rank_and_reference(world, step):
    res, ref = world
    one = res[0]["float32"]["one_rank"]["loss"][step]
    for r in res:
        assert r["float32"]["loss"][step] == res[0]["float32"]["loss"][step]
    got = res[0]["float32"]["loss"][step]
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, ref[step], rtol=1e-5, atol=0)


def test_fp32_parameters_match_one_rank(world):
    """The gathered parameters against the one-rank step's.  After the
    first step, the one-step rule of ``test_torch_trainer.py``: within
    1e-6 where the clipped gradient (10 x AdamW's first moment) is at
    least 1e-6, within 2 x lr elsewhere, where AdamW's normalised step
    turns a gradient at rounding level into a step of up to lr in either
    direction.  Those steps move the next steps' gradients by more than
    rounding, so after the last step every parameter is held within 2 x
    lr a step."""
    res, _ = world
    one_rank = res[0]["float32"]["one_rank"]
    (first, last), (one1, one3) = res[0]["float32"]["params"], \
        one_rank["params"]
    lr1, lr3 = one_rank["lr"]
    assert set(first) == set(one1) == set(last) == set(one3)
    for k in one1:
        assert first[k].shape == one1[k].shape, k
        big = np.abs(one_rank["mu"][0][k] / (1 - 0.9)) >= 1e-6
        assert big.mean() > 0.5, k
        np.testing.assert_allclose(first[k][big], one1[k][big], rtol=0,
                                   atol=1e-6, err_msg=k)
        assert np.abs(first[k] - one1[k])[~big].max(initial=0) <= 2 * lr1, k
        assert np.abs(last[k] - one3[k]).max() <= 2 * lr3 * len(STEPS), k


@pytest.mark.parametrize("step", STEPS)
def test_bf16_losses_match_one_rank(world, step):
    res, _ = world
    one = res[0]["bfloat16"]["one_rank"]["loss"][step]
    for r in res:
        np.testing.assert_allclose(r["bfloat16"]["loss"][step], one,
                                   rtol=2e-2, atol=2e-3)


def test_grad_norms_finite_and_equal_across_ranks(world):
    res, _ = world
    for dtype in ("float32", "bfloat16"):
        norms = [r[dtype]["grad_norm"] for r in res]
        assert all(n == norms[0] for n in norms), dtype
        assert np.isfinite(norms[0]).all() and min(norms[0]) > 0
