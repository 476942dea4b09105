"""PyTorch port of the semantic cache vs the JAX ``SemanticCache`` (CPU).

A seeded sequence of insert, lookup (fused and unfused), apply_probe and
touch runs through both under every eviction policy; after every op the
whole state must be equal field by field — victim order included (ties
broken toward the lower slot, as ``lax.top_k`` does) — and lookup results
equal (scores within 1e-5).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policies import EvictionPolicy as JPolicy
from repro.core.semantic_cache import SemanticCache as JCache
from repro_torch.core.policies import EvictionPolicy as TPolicy
from repro_torch.core.semantic_cache import SemanticCache as TCache

C, D, P, Q = 12, 8, 3, 5
POLICIES = [dict(kind="lru"), dict(kind="lfu"), dict(kind="fifo"),
            dict(kind="lru_ttl", ttl=4), dict(kind="lru", peer_aware=True),
            dict(kind="lru", region_aware=True)]


def _assert_state_equal(ts, js):
    for f in dataclasses.fields(js):
        t = getattr(ts, f.name).numpy()
        j = np.asarray(getattr(js, f.name))
        if f.name == "keys":
            np.testing.assert_allclose(t, j, atol=1e-6, err_msg=f.name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=f.name)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: "-".join(
    f"{k}={v}" for k, v in p.items()))
def test_state_sequence_matches_jax(policy, fuse):
    rng = np.random.default_rng(0)
    kw = dict(capacity=C, key_dim=D, payload_dim=P, threshold=0.9,
              payload_dtype="int32", fuse_touch=fuse)
    jc = JCache(policy=JPolicy(**policy), **kw)
    tc = TCache(policy=TPolicy(**policy), **kw)
    js, ts = jc.init(), tc.init(device="cpu")
    pool = _unit(rng.normal(size=(20, D)))
    J, T = jnp.asarray, torch.from_numpy

    for step in range(8):
        # insert a masked batch, then look up near-duplicates of cached keys
        rows = rng.integers(0, len(pool), size=Q)
        keys = pool[rows]
        vals = rng.integers(0, 100, size=(Q, P)).astype(np.int32)
        mask = rng.random(Q) < 0.8
        js = jc.insert(js, J(keys), J(vals), J(mask))
        ts = tc.insert(ts, T(keys), T(vals), T(mask))
        _assert_state_equal(ts, js)

        q = _unit(pool[rng.integers(0, len(pool), size=Q)]
                  + 0.01 * rng.normal(size=(Q, D)))
        qmask = rng.random(Q) < 0.7
        js, jr = jc.lookup(js, J(q), J(qmask))
        ts, tr = tc.lookup(ts, T(q), T(qmask))
        _assert_state_equal(ts, js)
        np.testing.assert_array_equal(tr.hit.numpy(), np.asarray(jr.hit))
        np.testing.assert_array_equal(tr.value.numpy(), np.asarray(jr.value))
        hit = np.asarray(jr.hit)
        np.testing.assert_array_equal(tr.index.numpy()[hit],
                                      np.asarray(jr.index)[hit])
        np.testing.assert_allclose(tr.score.numpy()[hit],
                                   np.asarray(jr.score)[hit], atol=1e-5)

        # an externally computed probe, and remote touches
        idx = rng.integers(0, C, size=Q).astype(np.int32)
        score = rng.uniform(0.8, 1.0, size=Q).astype(np.float32)
        js, jr = jc.apply_probe(js, J(idx), J(score), J(qmask))
        ts, tr = tc.apply_probe(ts, T(idx), T(score), T(qmask))
        _assert_state_equal(ts, js)
        np.testing.assert_array_equal(tr.value.numpy(), np.asarray(jr.value))
        if step % 2:
            js = jc.touch(js, J(idx), J(qmask))
            ts = tc.touch(ts, T(idx), T(qmask))
            _assert_state_equal(ts, js)
    assert tc.stats(ts) == jc.stats(js)
    assert int(ts.hits) > 0


def test_region_pin_priority_matches_jax():
    """Pinned slots lift above unpinned ones through the stable rank
    transform; ties among equal priorities keep slot order."""
    rng = np.random.default_rng(3)
    jc = JCache(capacity=C, key_dim=D, payload_dim=P,
                policy=JPolicy("lru", region_aware=True))
    tc = TCache(capacity=C, key_dim=D, payload_dim=P,
                policy=TPolicy("lru", region_aware=True))
    js, ts = jc.init(), tc.init(device="cpu")
    lu = rng.integers(0, 3, size=C).astype(np.int32)      # many ties
    pin = rng.random(C) < 0.4
    valid = rng.random(C) < 0.8
    js = dataclasses.replace(js, last_used=jnp.asarray(lu),
                             region_pin=jnp.asarray(pin),
                             valid=jnp.asarray(valid))
    ts = dataclasses.replace(ts, last_used=torch.from_numpy(lu),
                             region_pin=torch.from_numpy(pin),
                             valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tc.policy.priority(ts).numpy(),
                                  np.asarray(jc.policy.priority(js)))
