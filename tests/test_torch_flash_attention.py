"""PyTorch port of flash attention (K8) vs the JAX package (CPU, fp32).

The same seeded q, k, v go through the port's ``flash_attention`` (its
plain version on CPU tensors), the reference's ``flash_attention_ref`` and
the reference's Pallas kernel in interpret mode, at the shapes of
tests/test_kernels.py plus head_dim 120 (h2o-danube3-4b), a ragged S and
a non-causal band.  Tolerance 1e-5 absolute: every version sums fp32
products, in another order.  The CUDA kernel against the plain version is
tests/test_torch_kernels_gpu.py, run on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models import layers as TL

ATOL = 1e-5
SHAPES = [(1, 64, 4, 4, 16), (2, 128, 8, 2, 32), (1, 96, 4, 1, 64),
          (1, 64, 6, 3, 8), (1, 50, 8, 2, 120), (2, 37, 4, 1, 24)]


def _inputs(b, s, h, k, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, k, d), (b, s, k, d))]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window", [0, 5, 32])
@pytest.mark.parametrize("b,s,h,k,d", SHAPES)
def test_plain_matches_jax_ref_and_interpret(b, s, h, k, d, window):
    q, kk, v = _inputs(b, s, h, k, d)
    out = flash_attention(*_t((q, kk, v)), window=window)
    assert out.shape == (b, s, h, d) and out.dtype == torch.float32
    ref = jax_flash(q, kk, v, causal=True, window=window, impl="ref")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    pal = jax_flash(q, kk, v, causal=True, window=window,
                    impl="pallas_interpret", block_q=32, block_kv=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("window", [0, 9])
def test_non_causal_matches_jax_ref(window):
    q, kk, v = _inputs(2, 40, 8, 2, 16, seed=1)
    out = flash_attention(*_t((q, kk, v)), causal=False, window=window)
    ref = jax_flash(q, kk, v, causal=False, window=window, impl="ref")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("window", [0, 16])
def test_model_causal_attention_matches_jax(window):
    """``layers.causal_attention`` (through K8's op) against the
    reference model's XLA ``causal_attention`` on the same tensors — the
    function the model's full-sequence attention computes."""
    b, s, h, k, d = 2, 64, 4, 2, 16
    q, kk, v = _inputs(b, s, h, k, d, seed=2)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    ref = JL.causal_attention(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v),
                              pos, pos, causal=True, window=window)
    out = TL.causal_attention(*_t((q, kk, v)), window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_auto_on_cpu_is_the_plain_version_and_cuda_raises():
    args = _t(_inputs(1, 33, 4, 2, 16))
    torch.testing.assert_close(flash_attention(*args, window=8),
                               flash_attention_ref(*args, window=8),
                               atol=0, rtol=0)
    with pytest.raises(ValueError):
        flash_attention(*args, impl="cuda")
    with pytest.raises(ValueError):
        flash_attention(*args, impl="pallas")
