"""The one-call PyTorch yardsticks that ``chip_smoke.py`` times beside the
attention kernels compute the kernels' functions: SDPA over the
GQA-expanded view with the causal band as a mask equals the plain flash
attention (K8), and SDPA over the expanded cache with the valid slots as
a mask equals the plain flash-decode (K7), on the CPU in fp32 (within
1e-5: sums in another order)."""
import numpy as np
import pytest
import torch

from chip_smoke import sdpa_band, sdpa_slots
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def _t(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("S,H,K,D,window", [(1, 4, 4, 16, 0),
                                            (37, 8, 2, 24, 0),
                                            (50, 8, 2, 16, 20),
                                            (64, 12, 4, 8, 1)])
def test_sdpa_band_is_flash_attention(S, H, K, D, window):
    rng = np.random.default_rng(S + window)
    q, k, v = _t(rng, 2, S, H, D), _t(rng, 2, S, K, D), _t(rng, 2, S, K, D)
    got = sdpa_band(torch, q, k, v, window if window else S)()
    ref = flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got.transpose(1, 2), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("lens", [(1, 1), (5, 40), (40, 40)])
@pytest.mark.parametrize("G", [1, 4])
def test_sdpa_slots_is_decode_attention(lens, G):
    rng = np.random.default_rng(sum(lens) + G)
    q = _t(rng, 2, 2 * G, 16)
    k, v = _t(rng, 2, 40, 2, 16), _t(rng, 2, 40, 2, 16)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    got = sdpa_slots(torch, q, k, v, kv_len)()[:, :, 0]
    ref = decode_attention_ref(q, k, v, kv_len)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
