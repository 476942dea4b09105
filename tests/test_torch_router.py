"""The paper's latency model and asset cache in the PyTorch port against
the JAX package (CPU): ``core/network.py`` (every link's transfer time),
``core/router.py`` (``TwoTierRouter``'s broadcast shares and per-tier
breakdowns with batch > 1, the origin baseline, ``LatencyBreakdown``'s
total and deadline, ``DeadlineStats``, ``pad_rows``) and
``core/hash_cache.py`` (``content_hash`` of tensors of any dtype and grad
state, ``HashCache``'s LRU under its byte bound, ``_nbytes``).

The latency terms are the same Python arithmetic on the same floats in
both packages, so they must be exactly equal, not close.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hash_cache as jhc
from repro.core import network as jnet
from repro.core import router as jrt
from repro_torch.core import hash_cache as thc
from repro_torch.core import network as tnet
from repro_torch.core import router as trt

# (m_e, e_e, e_r, e_c) as (Mbps, RTT ms): the default, then Fig. 2a's
# slowest condition with a slow peer and region link
NETS = {"default": None,
        "fig2a_50_20": ((50.0, 2.0), (100.0, 3.0), (200.0, 9.0),
                        (20.0, 20.0))}
SIZES = dict(input_bytes=256 * 1024, descriptor_bytes=256 * 4,
             result_bytes=64 * 4)
PAYLOADS = (0, 1, 1024, 256 * 1024, 64 * (1 << 20), 3.5)
NET_METHODS = ("client_to_edge_ms", "edge_to_client_ms", "edge_to_edge_ms",
               "edge_to_region_ms", "region_to_edge_ms", "edge_to_cloud_ms",
               "cloud_to_edge_ms")


def _nets(name):
    spec = NETS[name]
    if spec is None:
        return jnet.NetworkModel(), tnet.NetworkModel()
    links = [dict(bandwidth_mbps=bw, rtt_ms=rtt) for bw, rtt in spec]
    return tuple(mod.NetworkModel(*(mod.Link(**kw) for kw in links))
                 for mod in (jnet, tnet))


def _routers(name, sizes=SIZES):
    jn, tn = _nets(name)
    return (jrt.TwoTierRouter(jn, jrt.PayloadSizes(**sizes)),
            trt.TwoTierRouter(tn, trt.PayloadSizes(**sizes)))


def _same(t, j):
    """Two ``LatencyBreakdown``s field for field, and their totals."""
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.total_ms == j.total_ms
    assert t.deadline_miss == j.deadline_miss


@pytest.mark.parametrize("bw,rtt", [(400.0, 2.0), (100.0, 20.0),
                                    (1000.0, 1.0), (20.0, 0.0)])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_link_transfer_matches_jax(bw, rtt, payload):
    assert (tnet.Link(bw, rtt_ms=rtt).transfer_ms(payload)
            == jnet.Link(bw, rtt_ms=rtt).transfer_ms(payload))


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("method", NET_METHODS)
def test_network_model_matches_jax(net, method):
    jn, tn = _nets(net)
    assert dataclasses.asdict(tn) == dataclasses.asdict(jn)
    for payload in PAYLOADS:
        assert getattr(tn, method)(payload) == getattr(jn, method)(payload)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("n", [0, 1, 3, 8, 64])
def test_broadcast_shares_match_jax(net, n):
    jr, tr = _routers(net)
    assert tr.peer_broadcast_ms(n) == jr.peer_broadcast_ms(n)
    assert tr.region_broadcast_ms(n) == jr.region_broadcast_ms(n)
    assert tr.digest_ship_ms(n * 1024.5) == jr.digest_ship_ms(n * 1024.5)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("tier", ["local", "edge", "peer", "remote", "miss",
                                  "cloud"])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_tier_latency_matches_jax(net, tier, batch):
    """Every tier's breakdown, as the engines charge it: amortized
    descriptor and lookup shares, a peer share paid past the peer rung, a
    region share paid by a miss, and the cloud's compute."""
    jr, tr = _routers(net)
    kw = dict(batch=batch, peer_net_ms=tr.peer_broadcast_ms(batch),
              remote_net_ms=tr.region_broadcast_ms(batch),
              cloud_compute_ms=12.345)
    t = tr.tier_latency(tier, 0.7 / batch, 0.11 / batch, **kw)
    j = jr.tier_latency(tier, 0.7 / batch, 0.11 / batch, **kw)
    _same(t, j)
    assert t.amortized_over == (batch if tier not in ("peer", "remote")
                                else max(1, batch))
    with pytest.raises(AssertionError):
        tr.tier_latency("nowhere", 0.0, 0.0)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("cloud_ms", [0.0, 3.25, 250.0])
def test_origin_latency_matches_jax(net, cloud_ms):
    jr, tr = _routers(net)
    _same(tr.origin_latency(cloud_ms), jr.origin_latency(cloud_ms))


@pytest.mark.parametrize("deadline", [None, 1.0, 25.0, 1e9])
def test_breakdown_total_and_deadline_match_jax(deadline):
    terms = dict(descriptor_ms=0.5, uplink_ms=2.1, lookup_ms=0.03,
                 peer_net_ms=1.2, remote_net_ms=6.4, cloud_net_ms=41.0,
                 cloud_compute_ms=9.9, downlink_ms=2.01, amortized_over=4,
                 deadline_ms=deadline)
    _same(trt.LatencyBreakdown(**terms), jrt.LatencyBreakdown(**terms))
    assert trt.LatencyBreakdown().deadline_miss is None


def test_deadline_stats_match_jax():
    from repro.obs.metrics import MetricsRegistry as JReg
    from repro_torch.obs.metrics import MetricsRegistry as TReg
    js, ts = jrt.DeadlineStats(JReg()), trt.DeadlineStats(TReg())
    for tier, done, dl in (("edge", 3.0, 16.6), ("cloud", 80.0, 16.6),
                           ("peer", 5.0, None), ("remote", 17.0, 16.6),
                           ("edge", 20.0, 16.6)):
        assert ts.observe(tier, done, dl) == js.observe(tier, done, dl)
    assert ts.as_dict() == js.as_dict()


@pytest.mark.parametrize("bucket", [None, 3, 5, 8])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_pad_rows_matches_jax(bucket, dtype):
    arr = np.arange(7 * 4, dtype=dtype).reshape(7, 4)
    rows = np.array([5, 0, 2])
    (tp, tn), (jp, jn) = (trt.pad_rows(arr, rows, bucket),
                          jrt.pad_rows(arr, rows, bucket))
    assert tn == jn == 3
    assert tp.dtype == jp.dtype and tp.shape == jp.shape
    np.testing.assert_array_equal(tp, jp)


# ---------------------------------------------------------------------------
# core/hash_cache.py
# ---------------------------------------------------------------------------
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16),
          "int32": (torch.int32, jnp.int32),
          "int64": (torch.int64, np.int64),
          "bool": (torch.bool, jnp.bool_)}


def _pair(name, shape=(2, 3), seed=0):
    """The same values as a torch tensor and a JAX array of ``name``."""
    tdt, jdt = DTYPES[name]
    x = 4 * np.random.default_rng(seed).standard_normal(shape)
    if name == "bool":
        x = x > 0
    x = x.astype(np.dtype(jdt))
    return torch.from_numpy(np.asarray(x, np.float32)).to(tdt), x


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(), (5,), (2, 3), (2, 0, 4)])
def test_content_hash_of_tensors_matches_jax(name, shape):
    """A tensor hashes to the reference's digest of a JAX array holding
    the same values: dtype by numpy's name (bfloat16 too), shape as a
    tuple, the raw bytes; with ``requires_grad`` as without."""
    t, x = _pair(name, shape)
    # JAX without x64 holds no int64 array: the reference hashes numpy's
    want = jhc.content_hash(x if name == "int64" else jnp.asarray(x))
    assert thc.content_hash(t) == want
    assert thc.content_hash(x) == want
    if t.is_floating_point():
        assert thc.content_hash(t.clone().requires_grad_()) == want


@pytest.mark.parametrize("obj", ["scene-7", b"\x00\x01pano", 42, 2.5,
                                 ("a", (1, b"z")), [1, [2.0, "x"]]])
def test_content_hash_of_plain_values_matches_jax(obj):
    assert thc.content_hash(obj) == jhc.content_hash(obj)


def test_content_hash_of_nested_tensors_matches_jax():
    (t1, x1), (t2, x2) = _pair("bfloat16"), _pair("int32", (4,), seed=1)
    tkey = ("mesh", (t1.requires_grad_(), [t2, b"tex"]), 3)
    jkey = ("mesh", (jnp.asarray(x1), [jnp.asarray(x2), b"tex"]), 3)
    assert thc.content_hash(tkey) == jhc.content_hash(jkey)


def test_nbytes_matches_jax():
    (t1, x1), (t2, x2) = _pair("bfloat16", (3, 5)), _pair("int32", (7,))
    tree_t = {"a": t1, "b": [t2, np.zeros((2, 2), np.float64)]}
    tree_j = {"a": jnp.asarray(x1), "b": [jnp.asarray(x2),
                                          np.zeros((2, 2), np.float64)]}
    assert thc._nbytes(tree_t) == jhc._nbytes(tree_j) == 30 + 28 + 32
    assert thc._nbytes(t1) == jhc._nbytes(jnp.asarray(x1)) == 30


# (op, key, n float32 values) sequences run through both caches
SEQS = {
    "roundtrip": [("put", f"k{i}", 8) for i in range(6)]
                 + [("get", f"k{i}", 0) for i in range(6)],
    "lru_bound": [("put", f"k{i}", 256) for i in range(6)]
                 + [("get", f"k{i}", 0) for i in range(6)],
    "recency": [("put", f"k{i}", 256) for i in range(3)]
               + [("get", "k0", 0), ("put", "k3", 256), ("get", "k0", 0),
                  ("get", "k1", 0)],
    "oversized": [("put", "small", 16), ("put", "big", 2048),
                  ("get", "big", 0), ("get", "small", 0)],
    "replace": [("put", "k0", 256), ("put", "k1", 256), ("put", "k0", 512),
                ("get", "k1", 0), ("put", "k2", 128), ("get", "k0", 0)],
}


@pytest.mark.parametrize("seq", sorted(SEQS))
def test_hash_cache_matches_jax(seq):
    """The same puts and gets (capacity 4 KiB of float32 values): the same
    returned values, resident keys in LRU order, bytes and stats."""
    jc, tc = jhc.HashCache(4096), thc.HashCache(4096)
    for i, (op, key, n) in enumerate(SEQS[seq]):
        if op == "put":
            x = np.full((n,), i, np.float32)
            jc.put(key, jnp.asarray(x))
            tc.put(key, torch.from_numpy(x))
        else:
            jv, tv = jc.get(key), tc.get(key)
            assert (jv is None) == (tv is None), (seq, i, key)
            if tv is not None:
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert list(tc._store) == list(jc._store), (seq, i)
        assert tc.size_bytes == jc.size_bytes <= 4096
        assert (key in tc) == (key in jc) and len(tc) == len(jc)
    assert tc.stats() == jc.stats()
