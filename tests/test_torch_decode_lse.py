"""K7's log-sum-exp route (``decode_attention(..., return_lse=True)``) and
the partial-softmax pieces of the sequence-sharded decode
(``layers.partial_attention``, ``mla_partial``, ``combine_partials``),
against the JAX package (CPU).

- The plain version's (out, lse) against the reference's
  ``decode_attention_ref`` and a ``logsumexp`` of its masked fp32 logits,
  fp32 and bf16, GQA groups of 1, 4 and 48, kv_len 0 / partial / full:
  out within 1e-5 (fp32) or 2e-2 (bf16, its rounding), lse within 1e-5
  relative; a row with kv_len 0 gives lse -inf, and its out keeps the
  plain version's average of V (the kernel's exact zeros are held on the
  card, ``tests/test_torch_kernels_gpu.py``).  The default call returns
  what it returned before, bit for bit.
- Split and merge: K7 over two halves of the slots (each with its own
  kv_len, a half with none included), combined by ``combine_partials``,
  against K7 over the whole cache, within 1e-6; the same for
  ``partial_attention`` against ``gqa_attention`` and ``mla_partial``
  against ``mla_attention``'s core.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import decode_attention_ref as jref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import layers as L

GROUPS = [(1, 4, 32), (4, 2, 64), (48, 1, 128)]        # (G, K, D)
S = 40


def _inputs(G, K, D, lens, dtype, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = rng.normal(size=(B, G * K, D)).astype(np.float32)
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return t + [torch.tensor(lens, dtype=torch.int32)]


def _jax_lse(q, k, kv_len):
    B, H, D = q.shape
    K = k.shape[2]
    qg = jnp.asarray(q.float().numpy()).reshape(B, K, H // K, D)
    logits = jnp.einsum("bkgd,bskd->bkgs", qg,
                        jnp.asarray(k.float().numpy())) / np.sqrt(D)
    valid = jnp.arange(S)[None, :] < jnp.asarray(kv_len.numpy())[:, None]
    lse = jax.nn.logsumexp(jnp.where(valid[:, None, None, :], logits,
                                     -jnp.inf), axis=-1)
    return np.asarray(lse).reshape(B, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,K,D", GROUPS)
def test_lse_route_matches_reference(G, K, D, dtype):
    q, k, v, ln = _inputs(G, K, D, (0, 17, S), dtype)
    out, lse = decode_attention(q, k, v, ln, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    to_jax = (lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              if dtype == torch.bfloat16 else jnp.asarray(t.numpy()))
    ref = np.asarray(jref(to_jax(q), to_jax(k), to_jax(v),
                          jnp.asarray(ln.numpy())).astype(jnp.float32))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)
    want = _jax_lse(q, k, ln)
    assert np.isneginf(lse[0].numpy()).all() and np.isneginf(want[0]).all()
    np.testing.assert_allclose(lse[1:].numpy(), want[1:], rtol=1e-5,
                               atol=1e-5)
    # the default call: the same output as before, bit for bit
    assert torch.equal(decode_attention(q, k, v, ln), out)


@pytest.mark.parametrize("G,K,D", GROUPS)
def test_halves_merged_equal_whole(G, K, D):
    q, k, v, ln = _inputs(G, K, D, (3, 20, 31, S), torch.float32, seed=1)
    whole = decode_attention(q, k, v, ln)
    h = S // 2
    parts = [decode_attention(q, k[:, lo:lo + h], v[:, lo:lo + h],
                              (ln - lo).clamp(0, h).to(torch.int32),
                              return_lse=True) for lo in (0, h)]
    assert np.isneginf(parts[1][1][:2].numpy()).all()   # rows 0, 1: none
    merged = L.combine_partials(torch.stack([o for o, _ in parts]),
                                torch.stack([s for _, s in parts]),
                                torch.float32)
    torch.testing.assert_close(merged, whole, atol=1e-6, rtol=0)


def test_partial_attention_merged_equals_gqa_attention():
    rng = np.random.default_rng(2)
    B, Sq, H, K, D, Sk = 2, 3, 4, 2, 16, 24
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)))
    qpos = torch.tensor([[5, 6, 7], [18, 19, 20]])
    kpos = torch.arange(Sk)[None].expand(B, Sk)
    mask = L.attention_mask(qpos, kpos, causal=True)
    whole = L.gqa_attention(q, k, v, mask)
    h = Sk // 3
    parts = [L.partial_attention(q, k[:, i:i + h], v[:, i:i + h],
                                 mask[..., i:i + h])
             for i in range(0, Sk, h)]
    merged = L.combine_partials(torch.stack([o for o, _ in parts]),
                                torch.stack([s for _, s in parts]),
                                torch.float32)
    torch.testing.assert_close(merged, whole, atol=1e-6, rtol=0)


def test_mla_partial_merged_equals_mla_attention():
    import types

    from repro_torch.configs import get_config, reduced_config

    cfg = reduced_config(get_config("deepseek-v2-lite-16b"))
    g = torch.Generator().manual_seed(0)
    blk = types.SimpleNamespace(**{
        n: torch.randn(s, generator=g) * 0.2
        for n, s in L.mla_specs(cfg).items()})
    B, Sk, r = 2, 16, cfg.mla.kv_lora_rank
    x = torch.randn(B, 1, cfg.d_model, generator=g)
    ckv = torch.randn(B, Sk, r, generator=g)
    krope = torch.randn(B, Sk, cfg.mla.qk_rope_head_dim, generator=g)
    pos = torch.tensor([[9], [3]])
    mask = (torch.arange(Sk)[None, :] <= pos)[:, None, :]
    whole = L.mla_attention(cfg, blk, x, ckv, krope, pos, mask=mask)
    h = Sk // 2
    parts = [L.mla_partial(cfg, blk, x, ckv[:, i:i + h], krope[:, i:i + h],
                           pos, mask[..., i:i + h]) for i in (0, h)]
    attn = L.combine_partials(torch.stack([o for o, _ in parts]),
                              torch.stack([s for _, s in parts]),
                              torch.float32)
    torch.testing.assert_close(torch.einsum("bshe,hed->bsd", attn, blk.wo),
                               whole, atol=1e-5, rtol=0)
