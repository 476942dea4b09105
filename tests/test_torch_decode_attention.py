"""PyTorch port of flash-decode (K7) vs the JAX package (CPU, fp32).

The same seeded query, cache and per-row ``kv_len`` go through the port's
``decode_attention`` (its plain version on CPU tensors), the reference's
``decode_attention_ref`` and its Pallas kernel in interpret mode, at the
shapes of tests/test_kernels.py plus head_dim 120 (h2o-danube3-4b) and
granite-20b's grouping (48 query heads on one KV head, head_dim 128), with
kv_len 1, ragged and full.  Tolerance 1e-5 absolute (fp32 sums in another
order).  A row with kv_len 0 is pinned as a convention: the plain version
averages V over every slot, as the reference's oracle does, where the CUDA
kernel gives exact zeros (tests/test_torch_kernels_gpu.py); no decode row
reaches it.  The byte model is a copy and must agree exactly.  The CUDA
kernel's split plan (``decode_plan``, plain Python) is checked here too:
every tile of the cache in exactly one split, every partial in the
workspace.
"""
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.obs.profile import decode_attention_bytes as jax_bytes
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention.kernel import (G_MAX, ROWS, TILE,
                                                         decode_plan)
from repro_torch.obs.profile import decode_attention_bytes

ATOL = 1e-5
SHAPES = [(2, 64, 4, 4, 16), (3, 100, 8, 2, 32), (1, 128, 4, 1, 64),
          (4, 70, 32, 8, 120), (2, 96, 48, 1, 128)]


def _inputs(b, s, h, k, d, kv_len, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kk = rng.normal(size=(b, s, k, d)).astype(np.float32)
    v = rng.normal(size=(b, s, k, d)).astype(np.float32)
    return q, kk, v, np.asarray(kv_len, np.int32)


def _lens(kind, b, s):
    return {"one": [1] * b, "ragged": [min(s, 7 + 13 * i) for i in range(b)],
            "full": [s] * b}[kind]


@pytest.mark.parametrize("lens", ["one", "ragged", "full"])
@pytest.mark.parametrize("b,s,h,k,d", SHAPES)
def test_plain_matches_jax_ref_and_interpret(b, s, h, k, d, lens):
    args = _inputs(b, s, h, k, d, _lens(lens, b, s))
    out = decode_attention(*(torch.from_numpy(a) for a in args))
    assert out.shape == (b, h, d) and out.dtype == torch.float32
    ref = jax_decode(*args, impl="ref")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    pal = jax_decode(*args, impl="pallas_interpret", block_kv=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), atol=ATOL,
                               rtol=0)


def test_kv_len_zero_convention():
    """kv_len 0: the plain version is the reference oracle's uniform
    average of V (every logit at -1e30), finite like the Pallas kernel's
    output (which gives zeros, as the CUDA kernel does)."""
    args = _inputs(2, 32, 4, 2, 16, [0, 5])
    out = decode_attention(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(jax_decode(*args, impl="ref"))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    v = args[2]
    np.testing.assert_allclose(out[0], np.repeat(v[0].mean(0), 2, axis=0),
                               atol=ATOL, rtol=0)
    pal = np.asarray(jax_decode(*args, impl="pallas_interpret", block_kv=16))
    assert np.isfinite(pal).all() and not pal[0].any()


def test_auto_on_cpu_is_the_plain_version_and_cuda_raises():
    args = [torch.from_numpy(a) for a in _inputs(2, 40, 8, 2, 16, [3, 40])]
    torch.testing.assert_close(decode_attention(*args),
                               decode_attention_ref(*args), atol=0, rtol=0)
    with pytest.raises(ValueError):
        decode_attention(*args, impl="cuda")


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_byte_model_matches_jax(dtype_bytes):
    shape = (8, 4096, 8, 120, dtype_bytes)
    assert decode_attention_bytes(*shape) == jax_bytes(*shape)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("B,S,K,G,D", [
    (8, 4096, 8, 4, 120), (1, 4096, 1, 48, 128), (2, 96, 1, 48, 128),
    (3, 600, 2, 16, 64), (64, 4096, 8, 4, 128), (1, 1, 1, 1, 16),
    (5, 1000, 3, G_MAX, 72)])
def test_decode_plan_covers_every_slot(B, S, K, G, D, bf16):
    """Each tile of an S-slot cache lands in exactly one split (split s
    takes tiles s, s + n_split, ...), no split is empty, the workspace
    holds the (m, l) pair and the D partial sums of every (row, KV head,
    split, group head), and a full cache gives no more blocks than about
    one wave would hold."""
    n_split, ws = decode_plan(B, S, K, G, D, bf16, 132)
    tiles = -(-S // TILE)
    owner = np.zeros(tiles, np.int64)
    for s in range(n_split):
        mine = np.arange(s, tiles, n_split)
        assert mine.size > 0
        owner[mine] += 1
    assert (owner == 1).all()
    assert ws == (0 if n_split == 1 else B * K * n_split * G * (2 + D))
    blocks = B * K * -(-G // ROWS[bf16]) * n_split
    assert n_split == 1 or blocks <= 4 * 132


def test_decode_plan_swa_path_is_one_wave():
    """The swa path's launch (B = 8, a 4096-slot ring, K = 8, G = 4,
    head_dim 120, bf16) runs in 8 splits of 16 tiles: 8 x 64 = 512
    blocks, one wave at 4 blocks on each of 132 SMs."""
    assert decode_plan(8, 4096, 8, 4, 120, True, 132)[0] == 8
