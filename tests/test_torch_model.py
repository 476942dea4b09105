"""PyTorch port of the decoder vs the JAX ``DecoderLM`` (CPU, fp32).

Both packages run the same weights (the converter moves them across) on
the same seeded tokens: ``coic-paper`` (MHA, untied), the reduced
``llama3.2-1b`` (GQA, tied embeddings), the reduced ``granite-20b``
(multi-query) and its ``gelu48`` variant (the GELU MLP, 48 query heads on
1 KV head), the reduced ``qwen2-72b`` (QKV biases, drawn at random), the
reduced ``granite-moe-3b-a800m`` (MoE, tied) under both ``moe_impl``
``dense`` and ``dropless`` and, on the slotted path, the reduced
``h2o-danube3-4b`` (GQA, sliding window 16: a ring cache).  The reduced
``deepseek-v2-lite-16b`` (MLA, a dense ``prefix0`` then MoE with a shared
expert) runs both cache layouts; the reduced ``mamba2-2.7b`` (SSM, no
MLP) and ``jamba-v0.1-52b`` (a 4-layer SSM / attention / MoE pattern,
once and, as ``l8``, repeated twice: stacked leaves) run the slotted one.
Logits and cache state within ``atol=1e-4, rtol=1e-4``; greedy tokens
exact.  Configs and layer plans compare field for field with the
reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import reduced_config as torch_reduced
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_numpy
from torch_twins import twin

TOL = dict(atol=1e-4, rtol=1e-4)


def _case(name, reduced, variant="", moe_impl=None):
    tag = "".join(f"-{x}" for x in (variant, moe_impl) if x)
    return pytest.param(name, reduced, variant, moe_impl,
                        id=f"{name}-{reduced}{tag}")


CASE = "name,reduced,variant,moe_impl"
MODELS = [_case("coic-paper", False), _case("llama3.2-1b", True),
          _case("granite-20b", True), _case("granite-20b", True, "gelu48"),
          _case("qwen2-72b", True),
          _case("granite-moe-3b-a800m", True, moe_impl="dense"),
          _case("granite-moe-3b-a800m", True, moe_impl="dropless"),
          _case("deepseek-v2-lite-16b", True)]
# recurrent models keep the slotted cache (paged KV refuses them)
RECURRENT = [_case("mamba2-2.7b", True), _case("jamba-v0.1-52b", True),
             _case("jamba-v0.1-52b", True, "l8")]
# the slotted path also serves sliding-window models (paged KV refuses them)
SLOTTED = MODELS + [_case("h2o-danube3-4b", True)] + RECURRENT
INVALID = 2 ** 30
PORTED = ["coic-paper", "llama3.2-1b", "h2o-danube3-4b", "granite-20b",
          "qwen2-72b", "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
          "mamba2-2.7b", "jamba-v0.1-52b", "llava-next-34b", "whisper-small"]


def _fields(cfg, like=None):
    """Field values, sub-configs (``MoEConfig``, ...) compared by their
    own fields: the two packages' dataclasses are different types.  With
    ``like`` (the reference's twin) only the fields it has; the port's
    own fields must then hold their defaults (``ModelConfig.yarn_factor``,
    ``moe_norm_topk_prob`` and ``moe_drop_free``), which compute the
    reference's arithmetic (``tests/test_torch_moe_grouped.py``)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if like is not None and not hasattr(like, f.name):
            assert v == f.default, (type(cfg).__name__, f.name, v)
            continue
        sub = None if like is None else getattr(like, f.name)
        out[f.name] = _fields(v, sub) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("name", PORTED)
def test_configs_equal_reference(name):
    """Field for field (``MoEConfig``, ``MLAConfig``, ``SSMConfig``
    included), full and reduced, and so are each layer's kind and MoE
    flag."""
    from repro.configs import reduced_config
    assert (_fields(torch_get_config(name), get_config(name))
            == _fields(get_config(name)))
    assert (_fields(torch_reduced(torch_get_config(name)),
                    reduced_config(get_config(name)))
            == _fields(reduced_config(get_config(name))))
    for t, j in ((torch_get_config(name), get_config(name)),
                 (torch_reduced(torch_get_config(name)),
                  reduced_config(get_config(name)))):
        for i in range(j.num_layers):
            assert t.layer_kind(i) == j.layer_kind(i), (j.name, i)
            assert t.is_moe_layer(i) == j.is_moe_layer(i), (j.name, i)


@pytest.mark.parametrize("name", [
    "coic-paper", "llama3.2-1b", "h2o-danube3-4b", "granite-20b",
    "qwen2-72b", "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
    "mamba2-2.7b", "jamba-v0.1-52b", "llava-next-34b"])
def test_layer_plan_equals_reference(name):
    """``build_plan`` of every config the reference builds a
    ``DecoderLM`` for (llava's too, on the reference's config object),
    full and reduced: the same segment names, patterns and repeats."""
    from repro.configs import reduced_config
    from repro.models.transformer import build_plan as jax_plan
    from repro_torch.models.transformer import build_plan

    def plan(p):
        return [(s.name, [(sl.kind, sl.mlp) for sl in s.pattern],
                 int(s.repeats)) for s in p]
    for cfg in (get_config(name), reduced_config(get_config(name))):
        assert plan(build_plan(cfg)) == plan(jax_plan(cfg)), cfg.name


def test_unported_config_and_missing_gpu_raise():
    """Every reference config is ported now: an unknown name raises, and
    an encoder-decoder config refuses the decoder-only model."""
    from repro_torch.models.transformer import DecoderLM
    with pytest.raises(ValueError):
        torch_get_config("no-such-model")
    with pytest.raises(ValueError):
        DecoderLM(torch_get_config("whisper-small"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_model(torch_get_config("coic-paper"))


@pytest.mark.parametrize(CASE, SLOTTED)
def test_converter_round_trips(name, reduced, variant, moe_impl):
    _, _, jparams, tmodel = twin(name, reduced, variant, moe_impl)
    flat = {k: np.asarray(v) for k, v in jparams.items()}
    back = params_to_numpy(tmodel)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    # and the other way: port weights -> reference layout -> a fresh port
    fresh = build_model(tmodel.cfg, device="cpu", moe_impl=moe_impl)
    params_from_jax(back, fresh)
    for (n, l, o, a, _), (_, _, o2, a2, _) in zip(tmodel.leaves(),
                                                  fresh.leaves()):
        assert torch.equal(getattr(o, a), getattr(o2, a2)), (n, l)


@pytest.mark.parametrize(CASE, SLOTTED)
def test_forward_and_hidden_match(name, reduced, variant, moe_impl):
    cfg, jm, jp, tm = twin(name, reduced, variant, moe_impl)
    jfwd = jax.jit(jm.forward)
    jhid = jax.jit(jm.forward_hidden, static_argnames=("num_layers",))
    # 37 positions: past h2o's reduced window of 16
    for S in (13, 37):
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(2, S)).astype(np.int32)
        np.testing.assert_allclose(
            tm.forward(torch.from_numpy(toks)).numpy(),
            np.asarray(jfwd(jp, jnp.asarray(toks))), **TOL)
        np.testing.assert_allclose(
            tm.forward_hidden(torch.from_numpy(toks), num_layers=1).numpy(),
            np.asarray(jhid(jp, jnp.asarray(toks), num_layers=1)), **TOL)


def _close_cache(tc, jc):
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)


@pytest.mark.parametrize("attn_impl", ["gather", "ref"])
@pytest.mark.parametrize(CASE, MODELS)
def test_paged_chunk_and_decode_match(name, reduced, variant, moe_impl,
                                      attn_impl):
    """A width-padded paged chunk (one row mid-table, one pad row), then two
    greedy decode steps, through both attention reads.  The pad row and
    the idle decode row take MoE capacity as in the reference."""
    cfg, jm, jp, tm = twin(name, reduced, variant, moe_impl)
    rng = np.random.default_rng(1)
    P, page = 10, 4
    bt = np.array([[0, 1, 2, 3], [4, 5, 6, INVALID], [INVALID] * 4],
                  np.int32)
    lens = np.array([0, 4, 0], np.int32)
    widths = np.array([7, 5, 0], np.int32)
    chunk = rng.integers(0, cfg.vocab_size, size=(3, 8)).astype(np.int32)
    jpool = {k: jnp.zeros(v.shape, v.dtype)
             for k, v in jm.paged_cache_specs(P, page).items()}
    tpool = {k: torch.zeros(s, dtype=d)
             for k, (s, d) in tm.paged_cache_specs(P, page).items()}
    J = lambda a: jnp.asarray(a)                     # noqa: E731
    T = lambda a: torch.from_numpy(np.array(a))      # noqa: E731
    jchunk = jax.jit(jm.prefill_chunk, static_argnames=("attn_impl",))
    jdecode = jax.jit(jm.decode_step, static_argnames=("attn_impl",))
    jl, jpool, jn = jchunk(jp, J(chunk), jpool, J(lens), J(widths),
                           block_table=J(bt), attn_impl=attn_impl)
    tl, tpool, tn = tm.prefill_chunk(T(chunk), tpool, T(lens), T(widths),
                                     block_table=T(bt), attn_impl=attn_impl)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close_cache(tpool, jpool)
    dbt = bt.copy()
    dbt[2] = INVALID                                 # idle row
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(2):
        np.testing.assert_array_equal(tl.argmax(-1)[:2].numpy(), tok[:2])
        jl, jpool, jn = jdecode(jp, jpool, J(tok), jn, block_table=J(dbt),
                                attn_impl=attn_impl)
        tl, tpool, tn = tm.decode_step(tpool, T(tok), tn, block_table=T(dbt),
                                       attn_impl=attn_impl)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
        _close_cache(tpool, jpool)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)


@pytest.mark.parametrize(CASE, SLOTTED)
def test_dense_prefill_and_decode_match(name, reduced, variant, moe_impl):
    """The slotted-cache prefill + decode that ``generation_cloud_fn``
    runs: logits, cache and greedy tokens."""
    cfg, jm, jp, tm = twin(name, reduced, variant, moe_impl)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    jdecode = jax.jit(jm.decode_step)
    jl, jc, jn = jax.jit(jm.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(toks), max_len=12)
    tl, tc, tn = tm.prefill(torch.from_numpy(toks), max_len=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)
    for _ in range(3):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc, jn = jdecode(jp, jc, jnp.asarray(tok), jn)
        tl, tc, tn = tm.decode_step(tc, torch.from_numpy(tok), tn)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _close_cache(tc, jc)


@pytest.mark.parametrize(CASE, [c for c in SLOTTED
                                if c.values[0] != "h2o-danube3-4b"])
def test_slotted_chunks_and_decode_match(name, reduced, variant, moe_impl):
    """``prefill_chunk`` on the slotted cache, unpadded: a chunk of 20
    tokens (an SSM layer's scan pads its tail past the reduced chunk of
    16 with dt = 0), then one of 7 from there, then two greedy decode
    steps: logits and every cache leaf (an SSM's conv and fp32 state
    too) against the reference."""
    cfg, jm, jp, tm = twin(name, reduced, variant, moe_impl)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, 27)).astype(np.int32)
    jc = jm.init_cache(2, 32)
    tc = tm.init_cache(2, 32)
    jn = jnp.zeros((2,), jnp.int32)
    tn = torch.zeros((2,), dtype=torch.int32)
    jchunk, jdecode = jax.jit(jm.prefill_chunk), jax.jit(jm.decode_step)
    for a, b in ((0, 20), (20, 27)):
        jl, jc, jn = jchunk(jp, jnp.asarray(toks[:, a:b]), jc, jn)
        tl, tc, tn = tm.prefill_chunk(torch.from_numpy(toks[:, a:b]), tc,
                                      tn)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        _close_cache(tc, jc)
    for _ in range(2):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc, jn = jdecode(jp, jc, jnp.asarray(tok), jn)
        tl, tc, tn = tm.decode_step(tc, torch.from_numpy(tok), tn)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _close_cache(tc, jc)


@pytest.mark.parametrize(CASE, RECURRENT)
def test_recurrent_models_refuse_pages_and_pads(name, reduced, variant,
                                                moe_impl):
    """As in the reference: a recurrent model has no paged pool,
    ``prefill_chunk`` raises on a block table or a pad mask (both
    packages), the engine refuses ``kv_page > 0`` and ignores its
    ``prefill_chunk`` setting (exact-length prefill runs)."""
    from repro.serving.engine import ServingConfig as JServing
    from repro.serving.engine import ServingEngine as JServe
    from repro_torch.serving.engine import ServingConfig as TServing
    from repro_torch.serving.engine import ServingEngine as TServe
    cfg, jm, jp, tm = twin(name, reduced, variant, moe_impl)
    with pytest.raises(ValueError):
        tm.paged_cache_specs(8, 4)
    with pytest.raises(ValueError):
        jm.paged_cache_specs(8, 4)
    toks = np.zeros((1, 4), np.int32)
    bt = np.zeros((1, 2), np.int32)
    w = np.array([3], np.int32)
    for kw in (dict(block_table=bt), dict(widths=w)):
        with pytest.raises(NotImplementedError):
            jm.prefill_chunk(jp, jnp.asarray(toks), jm.init_cache(1, 8),
                             jnp.zeros((1,), jnp.int32),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
        with pytest.raises(NotImplementedError):
            tm.prefill_chunk(torch.from_numpy(toks), tm.init_cache(1, 8),
                             torch.zeros((1,), dtype=torch.int32),
                             **{k: torch.from_numpy(v)
                                for k, v in kw.items()})
    with pytest.raises(ValueError):
        JServe(jm, jp, JServing(kv_page=16))
    with pytest.raises(ValueError):
        TServe(tm, TServing(kv_page=16), device="cpu")
    je = JServe(jm, jp, JServing(prefill_chunk=8))
    te = TServe(tm, TServing(prefill_chunk=8), device="cpu")
    assert je._exact_prefill and te._exact_prefill
    assert not je._can_chunk and not te._can_chunk


@pytest.mark.parametrize("S,max_len", [(40, 48), (12, 48), (16, 16),
                                       (30, 12)])
def test_swa_ring_prefill_matches_jax(S, max_len):
    """The reduced h2o (window 16) prefills into a ring of min(16,
    max_len) slots: the last Sk positions rotated so slot = position % Sk
    (S 40 and 30: rotated; 12: no wrap; 16: exactly one ring), leaf for
    leaf against the reference, with the row-true-length logits."""
    cfg, jm, jp, tm = twin("h2o-danube3-4b", True)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    jl, jc, jn = jax.jit(jm.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(toks), max_len=max_len)
    tl, tc, tn = tm.prefill(torch.from_numpy(toks), max_len=max_len)
    assert tc["blocks/0/k"].shape[2] == min(cfg.sliding_window, max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _close_cache(tc, jc)


def _jax_slot_mask(lengths, Sk, window):
    """The reference decode step's slot mask (``_sublayer_decode``):
    slot j holds the position p with p % Sk == j and p <= length, valid
    when 0 <= p <= length and, with a window, p > length - window."""
    slots = jnp.arange(Sk)[None, :]
    cur = jnp.asarray(lengths)[:, None]
    kpos = cur - ((cur - slots) % Sk)
    valid = (kpos >= 0) & (kpos <= cur)
    if window > 0:
        valid &= kpos > cur - window
    return np.asarray(valid)


@pytest.mark.parametrize("Sk,window", [(16, 16), (12, 16), (16, 0),
                                       (5, 5)])
def test_decode_kv_len_is_the_reference_slot_mask(Sk, window):
    """The port's decode attends over the first min(length + 1, Sk) slots
    (K7's ``kv_len``).  For every length up to four wraps of the ring,
    that prefix is exactly the reference's slot mask, for a ring as long
    as the window, one shorter (max_len < window) and a linear cache."""
    lengths = np.arange(4 * Sk + 3)
    kv_len = np.minimum(lengths + 1, Sk)
    prefix = np.arange(Sk)[None, :] < kv_len[:, None]
    np.testing.assert_array_equal(prefix, _jax_slot_mask(lengths, Sk,
                                                         window))


@pytest.mark.parametrize("S,max_len", [(24, 40), (9, 40), (9, 12)])
def test_swa_decode_past_the_window_matches_jax(S, max_len):
    """tests/test_decode_consistency.py::test_sliding_window_ring_buffer
    on the twin: greedy decode steps that wrap the ring (S 24, window 16;
    S 9 crosses slot 15 on the way; max_len 12 makes the ring shorter than
    the window) give the reference's logits, caches and tokens.  Where the
    ring is the whole window, the port's last-step logits also equal its
    own ``forward`` over the whole sequence (a 12-slot ring decoded past
    max_len sees 12 positions, as the reference's does, not 16)."""
    cfg, jm, jp, tm = twin("h2o-danube3-4b", True)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    jdecode = jax.jit(jm.decode_step)
    jl, jc, jn = jax.jit(jm.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(toks), max_len=max_len)
    tl, tc, tn = tm.prefill(torch.from_numpy(toks), max_len=max_len)
    seq = toks
    for _ in range(10):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
        jl, jc, jn = jdecode(jp, jc, jnp.asarray(tok), jn)
        tl, tc, tn = tm.decode_step(tc, torch.from_numpy(tok), tn)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        _close_cache(tc, jc)
    if tc["blocks/0/k"].shape[2] == cfg.sliding_window:
        full = tm.forward(torch.from_numpy(seq))[:, -1]
        np.testing.assert_allclose(tl.numpy(), full.numpy(), **TOL)


def test_swa_refuses_chunks_pages_and_bad_impls():
    _, _, _, tm = twin("h2o-danube3-4b", True)
    cache = tm.init_cache(1, 32)
    with pytest.raises(NotImplementedError):
        tm.prefill_chunk(torch.zeros((1, 4), dtype=torch.int32), cache,
                         torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError):
        tm.paged_cache_specs(8, 4)
    with pytest.raises(ValueError):
        build_model(tm.cfg, device="cpu", attention_impl="xla")


def test_random_init_distribution():
    """``init(generator)`` follows the reference initializer: ones for
    norms, normal * min(0.02, 1/sqrt(fan_in)) for matrices."""
    cfg = torch_reduced(torch_get_config("llama3.2-1b"))
    m = build_model(dataclasses.replace(cfg, dtype="float32"), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(m.final_norm, torch.ones_like(m.final_norm))
    std = float(m.layers[0].w_gate.std())
    assert abs(std - min(0.02, cfg.d_model ** -0.5)) < 0.002
