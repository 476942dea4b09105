"""The port's ``EncDecLM`` against the reference's (reduced whisper-small,
CPU, fp32, the same weights through ``params_from_jax``; every bias and
LayerNorm leaf moved off its constant by a seeded draw so the parity
exercises it).

- the converter covers ``embed/``, ``enc/`` and ``dec/`` (stacked ``enc/l/``
  and ``dec/l/``) and round-trips;
- ``encode``, ``forward`` and ``loss`` (and its gradients, and one train
  step) against the reference within atol 1e-4 + rtol 1e-4 (gradients
  atol 1e-6 + rtol 1e-4);
- ``prefill`` against the reference's (logits and every cache leaf) and
  against ``forward``'s last position;
- greedy ``decode_step``s against the reference's and against
  ``forward`` over the extended tokens, one of them a row whose cache is
  full (its write dropped, as JAX's scatter drops it);
- the q-chunked plain attention at 8192 positions against the
  reference's;
- the serving engine and ``DecoderLM`` refuse the model; ``build_model``
  builds it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.train import trainer as JT
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.convert import (master_params, params_from_jax,
                                        params_to_numpy)
from repro_torch.models.encdec import EncDecLM
from repro_torch.train import trainer as TT

TOL = dict(atol=1e-4, rtol=1e-4)
B, S_ENC, SD = 2, 24, 8


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(reduced_config(get_config("whisper-small")),
                               dtype="float32")
    tcfg = dataclasses.replace(treduced(tget("whisper-small")),
                               dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    for k in sorted(jp):
        if k.rsplit("/", 1)[1] in ("bq", "bv", "bo", "b", "w", "b_in",
                                   "b_out"):
            jp[k] = jnp.asarray(np.asarray(jp[k]) + 0.1 * rng.standard_normal(
                jp[k].shape), jnp.float32)
    tm = build_model(tcfg, device="cpu")
    params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tm)
    return jcfg, jm, jp, tm


def _inputs(cfg, Sd=SD, seed=1):
    g = np.random.default_rng(seed)
    enc = g.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    dec = g.integers(0, cfg.vocab_size, size=(B, Sd)).astype(np.int32)
    return enc, dec


def _t(x):
    return torch.from_numpy(np.array(x))


def test_converter_covers_every_leaf(pair):
    cfg, jm, jp, tm = pair
    assert isinstance(tm, EncDecLM)
    back = params_to_numpy(tm)
    assert set(back) == set(jp)
    assert {k.split("/")[0] for k in back} == {"embed", "enc", "dec"}
    for k, v in jp.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    assert back["enc/l/attn/wq"].shape[0] == cfg.encdec.num_encoder_layers
    assert back["dec/l/cross/wk"].shape[0] == cfg.num_layers


def test_encode_forward_loss_match_reference(pair):
    cfg, jm, jp, tm = pair
    enc, dec = _inputs(cfg)
    np.testing.assert_allclose(tm.encode(_t(enc)).numpy(),
                               np.asarray(jm.encode(jp, enc)), **TOL)
    batch = {"enc_embeds": enc, "dec_tokens": dec}
    with torch.no_grad():
        out = tm.forward(TT.to_device(batch, "cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.forward(jp, batch)),
                               **TOL)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, batch)
    total, met, grads = TT.loss_and_grads(
        tm, master_params(tm), TT.to_device(batch, "cpu"), torch.float32)
    np.testing.assert_allclose(float(total), float(jl), rtol=1e-5)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_train_step_matches_reference(pair):
    cfg, jm, jp, tm = pair
    enc, dec = _inputs(cfg)
    batch = {"enc_embeds": enc, "dec_tokens": dec}
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10,
              compute_dtype="float32")
    tcfg, jtcfg = TT.TrainerConfig(**kw), JT.TrainerConfig(**kw)
    params = {k: jnp.asarray(v) for k, v in jp.items()}
    jstate = JT.TrainState(params, JT.make_optimizer(jtcfg).init(params),
                           jnp.zeros((), jnp.int32))
    jnew, jmet = jax.jit(JT.make_train_step(jm, jtcfg))(jstate, batch)
    p = master_params(tm)
    tnew, tmet = TT.make_train_step(tm, tcfg)(
        TT.TrainState(p, TT.make_optimizer(tcfg).init(p),
                      torch.zeros((), dtype=torch.int32)), batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)
    lr = float(jmet["lr"])
    for k, v in tnew.params.items():
        small = np.abs(tnew.opt.mu[k].numpy() / 0.1) < 1e-6
        d = np.abs(v.numpy() - np.asarray(jnew.params[k]))
        assert d[~small].max(initial=0) <= 1e-6, k
        assert d[small].max(initial=0) <= 2 * lr, k


def _close_cache(tc, jc):
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **TOL)


def test_prefill_matches_reference_and_forward(pair):
    cfg, jm, jp, tm = pair
    enc, dec = _inputs(cfg)
    lg, cache, ln = tm.prefill(_t(enc), _t(dec), max_len=SD + 4)
    jlg, jcache, jln = jm.prefill(jp, enc, dec, max_len=SD + 4)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    _close_cache(cache, jcache)
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jln))
    shapes = {k: s for k, (s, _) in tm.cache_specs(B, SD + 4, S_ENC).items()}
    assert shapes == {k: v.shape for k, v in jm.cache_specs(
        B, SD + 4, S_ENC).items()}
    with torch.no_grad():
        full = tm.forward({"enc_embeds": _t(enc), "dec_tokens": _t(dec)})
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("max_len", [SD + 3, SD + 2], ids=["room",
                                                           "full"])
def test_decode_steps_match_reference_and_forward(pair, max_len):
    """Three greedy steps; with ``max_len`` SD + 2 the third step's
    write falls past the cache and is dropped in both packages."""
    cfg, jm, jp, tm = pair
    enc, dec = _inputs(cfg)
    lg, cache, ln = tm.prefill(_t(enc), _t(dec), max_len=max_len)
    jlg, jcache, jln = jm.prefill(jp, enc, dec, max_len=max_len)
    cur = dec
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jlg, -1), np.int32)
        assert (lg.argmax(-1).numpy() == nxt).all()
        lg, cache, ln = tm.decode_step(cache, _t(nxt), ln)
        jlg, jcache, jln = jm.decode_step(jp, jcache, nxt, jln)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _close_cache(cache, jcache)
        np.testing.assert_array_equal(ln.numpy(), np.asarray(jln))
        cur = np.concatenate([cur, nxt[:, None]], axis=1)
        if SD + step < max_len:              # the step's write was kept
            with torch.no_grad():
                full = tm.forward({"enc_embeds": _t(enc),
                                   "dec_tokens": _t(cur)})
            np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(),
                                       **TOL)


def test_chunked_plain_attention_matches_reference():
    """At 8192 positions both packages attend one 1024-query block at a
    time; encoder (no mask) and decoder (causal) forms."""
    g = np.random.default_rng(0)
    S = JL.CHUNKED_ATTN_THRESHOLD
    q, k, v = (g.standard_normal((1, S, 1, 8)).astype(np.float32)
               for _ in range(3))
    pos = jnp.arange(S)[None]
    for causal in (False, True):
        ref = JL.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), pos, pos, causal=causal)
        out = TL.plain_attention(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_engine_and_decoder_refuse_encdec(pair):
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    cfg, _, _, tm = pair
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(tm, ServingConfig(), device="cpu")
    with pytest.raises(ValueError, match="EncDecLM"):
        DecoderLM(cfg, device="cpu")
    with pytest.raises(ValueError):
        EncDecLM(treduced(tget("llama3.2-1b")), device="cpu")
