"""PyTorch port of the CoIC descriptors vs the JAX ones (CPU).

``NgramSketchDescriptor`` hashes in uint32 in the reference and in int64
masked to 32 bits in the port: buckets, signs and the normalized sketch
must agree bit for bit, ``-1`` pads included.  ``PrefixDescriptor`` runs
the first layers of the same fp32 model: within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.descriptor import NgramSketchDescriptor as JSketch
from repro.core.descriptor import PrefixDescriptor as JPrefix
from repro_torch.core.descriptor import NgramSketchDescriptor as TSketch
from repro_torch.core.descriptor import PrefixDescriptor as TPrefix
from torch_twins import twin


def _padded_tokens(rng, vocab, B=4, S=24):
    toks = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    for b, L in enumerate(rng.integers(4, S + 1, size=B)):
        toks[b, L:] = -1
    return toks


@pytest.mark.parametrize("dim,n", [(64, 3), (256, 3), (128, 2)])
def test_ngram_sketch_bit_exact(dim, n):
    rng = np.random.default_rng(dim + n)
    toks = _padded_tokens(rng, 2 ** 31 - 1)        # large ids stress the hash
    j = np.asarray(JSketch(dim=dim, n=n)(jnp.asarray(toks)))
    t = TSketch(dim=dim, n=n)(torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("k_layers", [1, 2])
def test_prefix_descriptor_matches(k_layers):
    cfg, jm, jp, tm = twin("coic-paper")
    toks = _padded_tokens(np.random.default_rng(7), cfg.vocab_size)
    j = np.asarray(JPrefix(jm, k_layers=k_layers)(jp, jnp.asarray(toks)))
    t = TPrefix(tm, k_layers=k_layers)(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-6)
