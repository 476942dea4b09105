"""The port's MLA (DeepSeek-V2 multi-head latent attention,
``repro_torch/models/layers.py``) vs ``repro.models.layers`` (CPU, fp32),
at the reduced ``deepseek-v2-lite-16b`` widths (d_model 64, 4 heads,
nope 16 + rope 8, v 16, latent rank 32).

The same seeded weights and activations go through both: the latent
(normalised c_kv, rotated k_rope), attention over an explicit mask (the
chunk and decode branch), over a causal mask built from key positions,
and the q-chunked branch, taken in both packages by lowering
``CHUNKED_ATTN_THRESHOLD`` / ``CHUNK_Q`` inside the test.  Within
``atol=rtol=1e-4``.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as J
import repro_torch.models.layers as T
from repro.configs import get_config
from repro.configs import reduced_config

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dataclasses.replace(reduced_config(get_config("deepseek-v2-lite-16b")),
                          dtype="float32")


def _params(seed=0):
    """Random MLA weights: the reference's dict under prefix ``a`` and the
    port's attribute holder (``kv_norm`` about one)."""
    rng = np.random.default_rng(seed)
    raw = {k: ((1.0 if k == "kv_norm" else 0.0)
               + 0.2 * rng.standard_normal(shape)).astype(np.float32)
           for k, shape in T.mla_specs(CFG).items()}
    return ({f"a/{k}": jnp.asarray(v) for k, v in raw.items()},
            types.SimpleNamespace(**{k: torch.from_numpy(v)
                                     for k, v in raw.items()}))


def _inputs(B, Sq, Sk, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Sq, CFG.d_model)).astype(np.float32)
    kx = rng.standard_normal((B, Sk, CFG.d_model)).astype(np.float32)
    return x, kx


def _latents(jp, tp, kx, kpos):
    jl = J.mla_latent(CFG, jp, "a", jnp.asarray(kx), jnp.asarray(kpos))
    tl = T.mla_latent(CFG, tp, torch.from_numpy(kx), torch.from_numpy(kpos))
    return jl, tl


def test_mla_latent_matches():
    jp, tp = _params()
    _, kx = _inputs(2, 1, 11)
    kpos = np.tile(np.arange(5, 16), (2, 1))
    (jc, jr), (tc, tr) = _latents(jp, tp, kx, kpos)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    assert tc.shape == (2, 11, CFG.mla.kv_lora_rank)
    assert tr.shape == (2, 11, CFG.mla.qk_rope_head_dim)


def test_mla_attention_mask_branch():
    """Decode-shaped queries (Sq 1 at per-row positions) over 12 cached
    keys with the explicit mask kpos <= position."""
    jp, tp = _params(seed=2)
    x, kx = _inputs(2, 1, 12, seed=3)
    kpos = np.tile(np.arange(12), (2, 1))
    qpos = np.array([[4], [11]])
    (jc, jr), (tc, tr) = _latents(jp, tp, kx, kpos)
    mask = kpos[:, None, :] <= qpos[:, :, None]
    j = J.mla_attention(CFG, jp, "a", jnp.asarray(x), jc, jr,
                        jnp.asarray(qpos), mask=jnp.asarray(mask))
    t = T.mla_attention(CFG, tp, torch.from_numpy(x), tc, tr,
                        torch.from_numpy(qpos), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("chunked", [False, True])
def test_mla_attention_causal_branch(chunked, monkeypatch):
    """Self-attention of 32 positions with a causal mask from the key
    positions; with ``chunked`` the threshold (16) and block (8) are
    lowered in both packages, so both take the q-chunked branch (the
    port builds one mask per block of 8 queries)."""
    if chunked:
        for mod in (J, T):
            monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", 16)
            monkeypatch.setattr(mod, "CHUNK_Q", 8)
    masks = []
    orig = T.attention_mask

    def counted(*a, **kw):
        masks.append(a[0].shape)
        return orig(*a, **kw)
    monkeypatch.setattr(T, "attention_mask", counted)
    jp, tp = _params(seed=4)
    x, _ = _inputs(2, 32, 1, seed=5)
    pos = np.tile(np.arange(32), (2, 1))
    (jc, jr), (tc, tr) = _latents(jp, tp, x, pos)
    j = J.mla_attention(CFG, jp, "a", jnp.asarray(x), jc, jr,
                        jnp.asarray(pos), k_positions=jnp.asarray(pos))
    t = T.mla_attention(CFG, tp, torch.from_numpy(x), tc, tr,
                        torch.from_numpy(pos), k_positions=torch.from_numpy(pos))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert masks == ([(2, 8)] * 4 if chunked else [(2, 32)])
