"""The port's per-layer KV-block reuse (``repro_torch.core.layer_reuse``) vs
the JAX package (CPU, fp32).

The four reference tests of ``tests/test_layer_reuse.py`` on the port, with
the reference's model on the same weights as the yardstick (chunked
prefill equals the full prefill; exact reuse; a changed suffix; SSM and
sliding-window models refused), then one seeded ``SharedPrefixWorkload``
stream (plus near-copies that hit the sketch path) through both packages'
``BlockReuseCache``: per-request stats dicts equal, logits within
``atol=1e-4, rtol=1e-4``.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layer_reuse import BlockReuseCache as JBlockReuseCache
from repro.data.workload import SharedPrefixWorkload as JWorkload
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import reduced_config as torch_reduced
from repro_torch.core import BlockReuseCache, SemOffsetEntry
from repro_torch.data.workload import SharedPrefixWorkload
from repro_torch.models import build_model
from repro_torch.serving import kv_cache
from torch_twins import twin

TOL = dict(atol=1e-4, rtol=1e-4)


def _prompt(seed, vocab, S):
    return np.random.default_rng(seed).integers(0, vocab, size=(S,)).astype(
        np.int32)


def test_chunked_prefill_matches_full():
    """prefill_chunk over blocks == one-shot prefill (logits + cache), in
    the port and against the reference's prefill."""
    cfg, jm, jp, tm = twin("coic-paper")
    S, Bk = 96, 32
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    ref_logits, ref_cache, _ = tm.prefill(torch.from_numpy(toks),
                                          max_len=S + 8)
    jl, jc, _ = jm.prefill(jp, jnp.asarray(toks), max_len=S + 8)
    cache = tm.init_cache(2, S + 8)
    lengths = torch.zeros((2,), dtype=torch.int32)
    for i in range(S // Bk):
        logits, cache, lengths = tm.prefill_chunk(
            torch.from_numpy(toks[:, i * Bk:(i + 1) * Bk]), cache, lengths)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for k in ref_cache:
        np.testing.assert_allclose(cache[k].numpy(), ref_cache[k].numpy(),
                                   **TOL)
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]),
                                   **TOL)


def test_exact_block_reuse_identical_logits():
    cfg, jm, jp, tm = twin("coic-paper")
    S, Bk = 128, 32
    prompt = _prompt(1, cfg.vocab_size, S)
    brc = BlockReuseCache(tm, block_size=Bk)
    lg1, _, _, st1 = brc.prefill(prompt, max_len=S + 16)
    assert st1["blocks_computed"] == 4
    lg2, _, _, st2 = brc.prefill(prompt.copy(), max_len=S + 16)
    assert st2["blocks_exact"] == 3 and st2["blocks_computed"] == 1
    ref, _, _ = jm.prefill(jp, jnp.asarray(prompt[None]), max_len=S + 16)
    np.testing.assert_allclose(lg2.numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(lg1.numpy(), np.asarray(ref[0]), **TOL)
    assert brc.stats.reuse_rate == 3 / 8


def test_prefix_reuse_with_changed_suffix():
    cfg, jm, jp, tm = twin("coic-paper")
    S, Bk = 128, 32
    prompt = _prompt(2, cfg.vocab_size, S)
    brc = BlockReuseCache(tm, block_size=Bk)
    brc.prefill(prompt, max_len=S + 16)
    p2 = prompt.copy()
    p2[-Bk:] = _prompt(3, cfg.vocab_size, Bk)
    lg, _, _, st = brc.prefill(p2, max_len=S + 16)
    assert st["blocks_exact"] == 3                 # shared prefix reused
    ref, _, _ = jm.prefill(jp, jnp.asarray(p2[None]), max_len=S + 16)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref[0]), **TOL)


def test_reuse_rejects_ssm_and_swa():
    """A recurrent family is refused by the cache (a stand-in config, and
    the reduced mamba2-2.7b and jamba-v0.1-52b, which the port now
    builds); a sliding-window ring is refused too."""
    cfg = dataclasses.replace(torch_get_config("coic-paper"), family="ssm")
    with pytest.raises(ValueError):
        BlockReuseCache(types.SimpleNamespace(cfg=cfg, device="cpu"),
                        block_size=8)
    for name in ("mamba2-2.7b", "jamba-v0.1-52b"):
        model = build_model(torch_reduced(torch_get_config(name)),
                            device="cpu")
        with pytest.raises(ValueError):
            BlockReuseCache(model, block_size=8)
    _, _, _, swa = twin("h2o-danube3-4b", True)
    with pytest.raises(ValueError):
        BlockReuseCache(swa, block_size=8)


def test_sem_offset_entry_lives_in_layer_reuse():
    assert kv_cache.SemOffsetEntry is SemOffsetEntry
    assert SemOffsetEntry.__module__ == "repro_torch.core.layer_reuse"


@pytest.mark.parametrize("name,reduced,moe_impl", [
    ("coic-paper", False, None),
    ("granite-moe-3b-a800m", True, "dropless")])
def test_shared_prefix_stream_matches_reference(name, reduced, moe_impl):
    """Eight requests of a seeded ``SharedPrefixWorkload`` (3 sessions, a
    64-token prefix = 2 blocks, 64-token suffixes), then two near-copies
    of earlier prompts (one token changed in a middle block: the sketch
    path at threshold 0.85), through both packages' cache."""
    cfg, jm, jp, tm = twin(name, reduced, "", moe_impl)
    Bk = 32
    kw = dict(num_sessions=3, prefix_len=64, suffix_min=64, suffix_max=64,
              vocab_size=cfg.vocab_size, seed=5)
    stream = list(SharedPrefixWorkload(**kw).stream(8, seed=6))
    jstream = list(JWorkload(**kw).stream(8, seed=6))
    for (s, p), (js, jpr) in zip(stream, jstream):
        assert s == js and np.array_equal(p, jpr)
    prompts = [p for _, p in stream]
    for i in (0, 3):
        near = prompts[i].copy()
        near[2 * Bk + 5] = (near[2 * Bk + 5] + 1) % cfg.vocab_size
        prompts.append(near)
    tc = BlockReuseCache(tm, block_size=Bk, threshold=0.85)
    jc = JBlockReuseCache(jm, jp, block_size=Bk, threshold=0.85)
    for p in prompts:
        tl, tcache, tlen, tst = tc.prefill(p, max_len=len(p) + 8)
        jl, jcache, jlen, jst = jc.prefill(p, max_len=len(p) + 8)
        assert tst == jst
        assert int(tlen[0]) == int(jlen[0]) == len(p)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for k in jcache:
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)
    assert dataclasses.asdict(tc.stats) == dataclasses.asdict(jc.stats)
    assert tc.stats.blocks_exact > 0 and tc.stats.blocks_semantic > 0
