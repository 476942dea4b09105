"""The digest control plane of the PyTorch port (``core/digest.py``, host
numpy as in the reference) against the JAX package: int8 quantization,
publisher and board for full/delta x fp32/int8 (rows, bytes shipped,
replica reconstruction, tombstones), codebook training, the packed IVF-PQ
index and region pins — all exactly equal.
"""
import numpy as np
import pytest

from repro.core import digest as jd
from repro_torch.core import digest as td


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("seed", range(3))
def test_quantize_rows_matches(seed):
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((16, 32)).astype(np.float32) * (seed + 1)
    keys[3] = 0.0
    for a, b in zip(jd.quantize_rows(keys), td.quantize_rows(keys)):
        np.testing.assert_array_equal(b, a)
    codes, scales = td.quantize_rows(keys)
    np.testing.assert_array_equal(td.dequantize_rows(codes, scales),
                                  jd.dequantize_rows(codes, scales))


@pytest.mark.parametrize("refresh", ["full", "delta"])
@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_publisher_and_board_match(quant, refresh):
    """A random interleaving of refreshes, a tombstone and a publisher
    reset, on two clusters, with a codebook attached half way: every
    update and every board field equal."""
    rng = np.random.default_rng(3)
    M, D, K = 8, 16, 2
    cfg = dict(size=M, quant=quant, refresh=refresh)
    pubs = {m: [m.DigestPublisher(m.DigestConfig(**cfg), D) for _ in range(K)]
            for m in (jd, td)}
    boards = {m: m.RegionDigestBoard(m.DigestConfig(**cfg), K, D)
              for m in (jd, td)}
    keys = [_unit(rng, M, D) for _ in range(K)]
    valid = [np.ones((M,), bool) for _ in range(K)]
    cb = jd.train_pq_codebook(np.concatenate(keys), n_lists=4, n_sub=4,
                              seed=0, iters=4)
    for step in range(10):
        c = step % K
        rows = rng.random(M) < 0.4
        keys[c][rows] = _unit(rng, int(rows.sum()), D)
        valid[c] ^= rng.random(M) < 0.2
        if step == 4:
            for m in (jd, td):
                boards[m].adopt_codebook(cb)
                for p in pubs[m]:
                    p.attach_codebook(cb)
        if step == 6:
            for m in (jd, td):
                boards[m].tombstone(c)
                pubs[m][c].reset()
        ups = {m: pubs[m][c].publish(keys[c].copy(), valid[c].copy())
               for m in (jd, td)}
        for a, b in zip(ups[jd], ups[td]):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        for m in (jd, td):
            boards[m].apply(c, ups[m])
        bj, bt = boards[jd], boards[td]
        for f in ("valid", "keys", "codes", "scales", "list_id"):
            np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f))
        np.testing.assert_array_equal(bt.probe_keys(), bj.probe_keys())
        assert bt.stats() == bj.stats()
    assert boards[td].bytes_shipped == boards[jd].bytes_shipped > 0


@pytest.mark.parametrize("seed", range(2))
def test_train_pq_codebook_bit_identical(seed):
    keys = _unit(np.random.default_rng(seed), 96, 32)
    a = jd.train_pq_codebook(keys, n_lists=8, n_sub=4, seed=seed, iters=6)
    b = td.train_pq_codebook(keys, n_lists=8, n_sub=4, seed=seed, iters=6)
    np.testing.assert_array_equal(b.centroids, a.centroids)
    np.testing.assert_array_equal(b.codebook, a.codebook)
    np.testing.assert_array_equal(td.assign_lists(b, keys),
                                  jd.assign_lists(a, keys))


@pytest.mark.parametrize("cap", [None, 8, 2])
def test_build_ivfpq_index_field_by_field(cap):
    """Spill to the next-nearest lists and, at cap 2, dropped rows."""
    rng = np.random.default_rng(7)
    keys = _unit(rng, 64, 32)
    valid = rng.random(64) < 0.8
    owner = np.repeat(np.arange(4, dtype=np.int32), 16)
    list_ids = rng.integers(-1, 4, size=64).astype(np.int32)
    cb = jd.train_pq_codebook(keys[valid], n_lists=4, n_sub=4, seed=1,
                              iters=4)
    a = jd.build_ivfpq_index(cb, keys, valid, owner, list_ids=list_ids,
                             cap=cap)
    b = td.build_ivfpq_index(cb, keys, valid, owner, list_ids=list_ids,
                             cap=cap)
    for f in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                      np.asarray(getattr(a, f)))
    if cap == 2:
        assert b.dropped > 0


def test_region_pin_mask_matches():
    rng = np.random.default_rng(11)
    keys = _unit(rng, 12, 16)
    valid = rng.random(12) < 0.8
    served = rng.integers(0, 3, size=12)
    for protected in (None, keys[:3], keys[5:6] * 0.5):
        for hot_min in (1, 2):
            np.testing.assert_array_equal(
                td.region_pin_mask(keys, valid, served, protected, 0.9,
                                   hot_min),
                jd.region_pin_mask(keys, valid, served, protected, 0.9,
                                   hot_min))
