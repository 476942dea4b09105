"""The port's training path against the JAX package's (CPU, fp32).

Both packages hold the same weights (``params_from_jax``) on the reduced
``llama3.2-1b`` (tied, GQA; dense CE, chunked CE in chunks of 8, and each
repeat rematerialised: ``remat`` full and ``dots``) and the reduced
``granite-moe-3b-a800m`` (MoE, its router aux loss; ``dense`` and
``dropless`` dispatch), on the same seeded ``SyntheticLMData`` batch:

- ``DecoderLM.loss`` and its metrics within rtol 1e-5;
- every gradient against ``jax.grad`` within atol 1e-6 + rtol 1e-4;
- one ``make_train_step`` step (fp32 compute; 1 and 2 microbatches):
  loss, grad norm and lr within rtol 1e-5; the optimiser moments within
  rtol 1e-4 + atol 1e-7 (mu) or 1e-10 (nu); every parameter within atol 1e-6 where its
  |gradient| >= 1e-6, and within 2 x lr where it is smaller (the first
  AdamW step is about lr x sign(g), and a gradient at rounding noise
  may flip its sign between packages);
- a bf16-compute step (fp32 master, explicit casts as the reference):
  loss within 2e-2 and grad norm within 5e-2, relative;
- microbatch equivalence in the port alone (the reference's test);
- ``StragglerWatch`` as the reference's test drives it;
- ``SyntheticLMData`` batches bit-equal to the reference's, across seeds,
  steps, host shards, image patches and the encoder-decoder branch;
- K8's ``FlashAttention`` on the CPU route: gradients equal to the plain
  version's, and every attention projection of every layer gets a
  nonzero gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMData as JData
from repro.train import trainer as JT
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models.convert import master_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import trainer as TT
from torch_twins import twin

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MOE = "granite-moe-3b-a800m"
CASES = [("llama3.2-1b", "", None), ("llama3.2-1b", "chunk8", None),
         ("llama3.2-1b", "remat", None), ("llama3.2-1b", "dots", None),
         (MOE, "", "dense"), (MOE, "", "dropless")]
IDS = ["llama", "llama-chunk8", "llama-remat", "llama-dots", "moe-dense",
       "moe-dropless"]


def _batch(vocab, B=4, S=33, step=0, mask=False):
    b = SyntheticLMData(vocab_size=vocab, seq_len=S, global_batch=B,
                        seed=3).batch_at(step)
    if mask:
        b["loss_mask"] = (np.random.default_rng(1).random((B, S)) < 0.7
                          ).astype(np.float32)
    return b


def _jloss(jmodel, jparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, jb)
    return total, metrics, grads


@pytest.mark.parametrize("name,variant,moe_impl", CASES, ids=IDS)
def test_loss_and_grads_match_reference(name, variant, moe_impl):
    cfg, jm, jp, tm = twin(name, True, variant, moe_impl)
    batch = _batch(cfg.vocab_size, mask=variant == "chunk8")
    jtotal, jmet, jgrads = _jloss(jm, jp, batch)
    total, met, grads = TT.loss_and_grads(
        tm, master_params(tm), TT.to_device(batch, "cpu"), torch.float32)
    np.testing.assert_allclose(float(total), float(jtotal), **LOSS_TOL)
    for k in ("loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **LOSS_TOL)
    if cfg.moe is not None:                      # the router aux is live
        assert float(met["aux_loss"]) > 0
        np.testing.assert_allclose(
            float(met["total_loss"]),
            float(met["loss"]) + cfg.moe.router_aux_loss_coef
            * float(met["aux_loss"]), rtol=1e-6)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   err_msg=k, **GRAD_TOL)


def test_loss_mask_shifts_by_one():
    """A mask that hides every position but the last: only the final
    target counts (the mask shifts with the targets)."""
    cfg, jm, jp, tm = twin("llama3.2-1b", True)
    batch = _batch(cfg.vocab_size)
    mask = np.zeros(batch["tokens"].shape, np.float32)
    mask[:, -1] = 1.0
    batch["loss_mask"] = mask
    jtotal, _, _ = _jloss(jm, jp, batch)
    total, _ = tm.loss(TT.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(total), float(jtotal), **LOSS_TOL)


def _states(jm, jp, tm, tcfg, jtcfg):
    params = {k: jnp.asarray(v, jnp.float32) for k, v in jp.items()}
    jstate = JT.TrainState(params=params,
                           opt=JT.make_optimizer(jtcfg).init(params),
                           step=jnp.zeros((), jnp.int32))
    tp = master_params(tm)
    tstate = TT.TrainState(params=tp, opt=TT.make_optimizer(tcfg).init(tp),
                           step=torch.zeros((), dtype=torch.int32))
    return jstate, tstate


def _tcfgs(**kw):
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, **kw)
    return (TT.TrainerConfig(**kw),
            JT.TrainerConfig(**{**kw, "adamw": JT.AdamWConfig()}))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name,variant,moe_impl",
                         [CASES[1], CASES[4]], ids=["llama-chunk8",
                                                    "moe-dense"])
def test_train_step_matches_reference(name, variant, moe_impl,
                                      microbatches):
    cfg, jm, jp, tm = twin(name, True, variant, moe_impl)
    tcfg, jtcfg = _tcfgs(microbatches=microbatches, compute_dtype="float32")
    jstate, tstate = _states(jm, jp, tm, tcfg, jtcfg)
    batch = _batch(cfg.vocab_size)
    jnew, jmet = jax.jit(JT.make_train_step(jm, jtcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tmet = TT.make_train_step(tm, tcfg)(tstate, batch)
    assert set(tmet) == set(jmet)
    for k in ("loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(float(tmet["aux_loss"]),
                               float(jmet["aux_loss"]), **LOSS_TOL)
    if microbatches > 1:
        assert float(tmet["aux_loss"]) == 0.0          # as the reference
    assert int(tnew.step) == int(jnew.step) == 1
    assert int(tnew.opt.count) == int(jnew.opt.count) == 1
    lr = float(jmet["lr"])
    for k, p in tnew.params.items():
        g = tnew.opt.mu[k].numpy() / (1 - 0.9)         # the clipped grad
        jpk = np.asarray(jnew.params[k])
        big = np.abs(g) >= 1e-6
        np.testing.assert_allclose(p.numpy()[big], jpk[big], rtol=0,
                                   atol=1e-6, err_msg=k)
        assert np.abs(p.numpy()[~big] - jpk[~big]).max(initial=0) <= 2 * lr
        for mom in ("mu", "nu"):
            np.testing.assert_allclose(
                getattr(tnew.opt, mom)[k].numpy(),
                np.asarray(getattr(jnew.opt, mom)[k]), rtol=1e-4,
                atol=1e-7 if mom == "mu" else 1e-10, err_msg=f"{mom} {k}")


def test_bf16_compute_step_matches_reference():
    """bf16 compute over the fp32 master, cast explicitly on both sides."""
    cfg, jm, jp, tm = twin("llama3.2-1b", True)
    tcfg, jtcfg = _tcfgs(compute_dtype="bfloat16")
    jstate, tstate = _states(jm, jp, tm, tcfg, jtcfg)
    batch = _batch(cfg.vocab_size)
    _, jmet = jax.jit(JT.make_train_step(jm, jtcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tmet = TT.make_train_step(tm, tcfg)(tstate, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=2e-2)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=5e-2)
    assert all(p.dtype == torch.float32 for p in tnew.params.values())


def test_microbatch_equivalence():
    """1 vs 2 microbatches: the same step (the mean of the gradients)."""
    cfg, jm, jp, tm = twin("llama3.2-1b", True)
    t1, _ = _tcfgs(compute_dtype="float32")
    t2 = dataclasses.replace(t1, microbatches=2)
    batch = _batch(cfg.vocab_size)
    out = []
    for t in (t1, t2):
        p = master_params(tm)
        st = TT.TrainState(p, TT.make_optimizer(t).init(p),
                           torch.zeros((), dtype=torch.int32))
        out.append(TT.make_train_step(tm, t)(st, batch))
    (s1, m1), (s2, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for k in s1.params:
        np.testing.assert_allclose(s1.params[k].numpy(),
                                   s2.params[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_trainer_fit_loss_falls_and_watch_records():
    cfg, _, _, tm = twin("llama3.2-1b", True)
    tcfg = TT.TrainerConfig(peak_lr=3e-3, warmup_steps=2, total_steps=40,
                            compute_dtype="float32")
    state = TT.init_train_state(tm, torch.Generator().manual_seed(0), tcfg)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=33,
                           global_batch=8)
    batches = [data.batch_at(i) for i in range(2)]
    trainer = TT.Trainer(tm, tcfg, log_every=0)
    state, hist = trainer.fit(state, (batches[i % 2] for i in range(20)),
                              20)
    assert int(state.step) == 20 and len(hist) == 20
    assert np.mean([h["loss"] for h in hist[-3:]]) < hist[0]["loss"] - 0.3
    assert trainer.watch.ewma is not None
    # training runs on the master; the module's own weights stay frozen
    assert all(not p.requires_grad for p in tm.parameters())


def test_straggler_watch_flags_slow_steps():
    jw, w = JT.StragglerWatch(ratio=2.0, alpha=0.5), TT.StragglerWatch(
        ratio=2.0, alpha=0.5)
    times = [0.1] * 10 + [1.0, 0.1, 0.35, 0.1]
    for i, dt in enumerate(times):
        assert w.observe(i, dt) == jw.observe(i, dt)
    assert w.events == jw.events and w.events[0][0] == 10
    assert w.ewma == pytest.approx(jw.ewma)


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=7, num_hosts=2, host_id=1),
    dict(seed=1, num_hosts=4, host_id=3),
    dict(seed=2, image_patches=4, d_model=16),
    dict(seed=5, encdec=True, d_model=16, dec_len=6)],
    ids=["plain", "host1of2", "host3of4", "image", "encdec"])
def test_synthetic_data_bit_equal_to_reference(kw):
    args = dict(vocab_size=1000, seq_len=24, global_batch=8, **kw)
    ours, ref = SyntheticLMData(**args), JData(**args)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    it = ours.iterator(start_step=5)
    np.testing.assert_array_equal(next(it)[next(iter(a))],
                                  ref.batch_at(5)[next(iter(a))])


@pytest.mark.parametrize("window", [0, 5])
def test_flash_attention_function_grad_equals_plain_on_cpu(window):
    g = np.random.default_rng(0)
    q, k, v = (torch.tensor(g.standard_normal((2, 17, 4, 16)),
                            dtype=torch.float32) for _ in range(3))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    dout = torch.tensor(g.standard_normal((2, 17, 4, 16)),
                        dtype=torch.float32)
    grads = []
    for fn in (flash_attention, flash_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, window=window)
        if fn is flash_attention:
            assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        grads.append(torch.autograd.grad(out, leaves, dout))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_every_attention_projection_gets_a_gradient():
    """Through the model's attention (the ``FlashAttention`` route on the
    CPU): each layer's slice of wq, wk, wv and wo has a nonzero
    gradient."""
    cfg, _, _, tm = twin("llama3.2-1b", True, "remat")
    batch = TT.to_device(_batch(cfg.vocab_size), "cpu")
    _, _, grads = TT.loss_and_grads(tm, master_params(tm), batch,
                                    torch.float32)
    for w in ("wq", "wk", "wv", "wo"):
        g = grads[f"blocks/0/attn/{w}"]
        assert g.shape[0] == cfg.num_layers
        assert bool((g.flatten(1).abs().amax(1) > 0).all()), w


def test_adamw_config_matches_reference():
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(
        JT.AdamWConfig())
    assert (dataclasses.asdict(TT.TrainerConfig())
            == dataclasses.asdict(JT.TrainerConfig()))
