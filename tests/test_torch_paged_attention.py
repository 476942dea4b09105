"""PyTorch port of paged attention vs the JAX oracle (CPU), fp32.

The same seeded pools, block tables (with INVALID entries, an idle row
and pages shared between rows) and queries go through
``repro.kernels.paged_attention.ref`` and the port's ``paged_attention``
(its plain version on CPU tensors), within 2e-5.  The byte model is a
copy and must agree exactly.  The CUDA kernel against the plain version
is tests/test_torch_kernels_gpu.py, run on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (
    attention_kv_bytes_per_step as jax_bytes, paged_attention_ref)
from repro_torch.kernels.paged_attention import (attention_kv_bytes_per_step,
                                                 paged_attention)

INVALID = 2 ** 30
ATOL = 2e-5


def _inputs(C, G, *, B=4, K=2, D=16, P=12, page=4, n_pages=5, seed=0):
    rng = np.random.default_rng(seed)
    H = K * G
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, page, K, D)).astype(np.float32)
    vp = rng.normal(size=(P, page, K, D)).astype(np.float32)
    bt = np.full((B, n_pages), INVALID, np.int32)
    bt[0, :4] = [0, 1, 2, 3]
    bt[1, :3] = [0, 1, 4]            # shares pages 0 and 1 with row 0
    bt[2, :5] = [5, 6, 7, 8, 9]
    # row 3 is idle: an all-INVALID table at length 0
    lengths = np.array([8, 3, 16 - C, 0], np.int32)
    return q, kp, vp, bt, lengths


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("C", [1, 8])
def test_paged_attention_matches_jax(C, G):
    q, kp, vp, bt, ln = _inputs(C, G)
    ref = np.asarray(paged_attention_ref(*(jnp.asarray(a)
                                           for a in (q, kp, vp, bt, ln))))
    out = paged_attention(*(_t(a) for a in (q, kp, vp, bt, ln)))
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_auto_on_cpu_is_the_plain_version_and_cuda_raises():
    args = [_t(a) for a in _inputs(8, 4)]
    torch.testing.assert_close(paged_attention(*args),
                               paged_attention(*args, impl="ref"),
                               atol=0, rtol=0)
    with pytest.raises(ValueError):
        paged_attention(*args, impl="cuda")


@pytest.mark.parametrize("impl", ["gather", "paged"])
def test_byte_model_matches_jax(impl):
    kv_len = np.array([0, 5, 16, 33])
    kw = dict(page_size=16, max_len=64, kv_heads=8, head_dim=64,
              dtype_bytes=2, impl=impl)
    assert attention_kv_bytes_per_step(kv_len, **kw) == jax_bytes(kv_len,
                                                                  **kw)

