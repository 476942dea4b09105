"""PyTorch port of the similarity ops vs the JAX oracles (CPU).

Inputs come from a seeded numpy generator and go through
``repro.kernels.similarity.ref`` and the port's entry points (which run
their plain version on CPU tensors).  Indices, counts, ``last_used`` and
``freq`` must match exactly; scores within 1e-5 (the two frameworks sum
the dot products in different orders).  The CUDA kernel against the plain
version is tests/test_torch_kernels_gpu.py, run on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.similarity.ref import (similarity_lookup_ref,
                                          similarity_topk_batched_ref,
                                          similarity_topk_touch_ref)
from repro_torch.kernels.similarity import (similarity_lookup,
                                            similarity_topk_batched,
                                            similarity_topk_touch)

ATOL = 1e-5
CASES = ("random", "duplicate_keys", "all_invalid", "partly_invalid")


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(case, N, Q, C, D, seed=0):
    rng = np.random.default_rng(seed)
    keys = _unit(rng.normal(size=(N, C, D)))
    valid = np.ones((N, C), bool)
    if case == "duplicate_keys":
        half = C // 2
        keys[:, half:2 * half] = keys[:, :half]      # exact ties
    if case == "all_invalid":
        valid[0] = False
    if case == "partly_invalid":
        valid = rng.random((N, C)) < 0.5
    # queries near cached keys, so the top entries are well separated
    # from noise and duplicate keys tie exactly
    pick = rng.integers(0, C, size=(N, Q))
    q = _unit(np.take_along_axis(keys, pick[..., None], axis=1)
              + 0.05 * rng.normal(size=(N, Q, D)))
    if case == "duplicate_keys":
        q[:, 0] = keys[:, 0]                         # score 1.0 twice
    return q, keys, valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("C", [37, 64])
@pytest.mark.parametrize("case", CASES)
def test_topk_batched_matches_jax(case, C, k):
    q, keys, valid = _inputs(case, 3, 5, C, 24)
    ji, js = similarity_topk_batched_ref(jnp.asarray(q), jnp.asarray(keys),
                                         jnp.asarray(valid), k)
    ti, ts = similarity_topk_batched(_t(q), _t(keys), _t(valid), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    if case == "all_invalid":
        np.testing.assert_array_equal(ti[0].numpy(),
                                      np.broadcast_to(np.arange(k), (5, k)))


@pytest.mark.parametrize("C", [37, 64])
@pytest.mark.parametrize("case", CASES)
def test_lookup_matches_jax(case, C):
    q, keys, valid = _inputs(case, 1, 6, C, 24)
    ji, js = similarity_lookup_ref(jnp.asarray(q[0]), jnp.asarray(keys[0]),
                                   jnp.asarray(valid[0]))
    ti, ts = similarity_lookup(_t(q[0]), _t(keys[0]), _t(valid[0]))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_topk_touch_matches_jax(case, masked, k):
    C = 37
    q, keys, valid = _inputs(case, 1, 7, C, 16, seed=1)
    q, keys, valid = q[0], keys[0], valid[0]
    rng = np.random.default_rng(2)
    last_used = rng.integers(0, 50, size=(C,)).astype(np.int32)
    freq = rng.integers(0, 5, size=(C,)).astype(np.int32)
    mask = rng.random(7) < 0.6 if masked else None
    clock, thr = 40, 0.9
    jout = similarity_topk_touch_ref(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(valid), k,
        jnp.asarray(last_used), jnp.asarray(freq), jnp.int32(clock), thr,
        mask=None if mask is None else jnp.asarray(mask))
    tout = similarity_topk_touch(
        _t(q), _t(keys), _t(valid), k, _t(last_used), _t(freq),
        torch.tensor(clock, dtype=torch.int32), threshold=thr,
        mask=None if mask is None else _t(mask))
    ji, js, jl, jf = (np.asarray(a) for a in jout)
    ti, ts, tl, tf = (a.numpy() for a in tout)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=ATOL)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tf, jf)
    if case != "all_invalid":
        assert (tf != freq).any(), "the case should touch some slot"


def test_touch_leaves_inputs_unchanged():
    q, keys, valid = _inputs("random", 1, 4, 16, 8)
    lu = torch.zeros(16, dtype=torch.int32)
    fr = torch.zeros(16, dtype=torch.int32)
    similarity_topk_touch(_t(q[0]), _t(keys[0]), _t(valid[0]), 1, lu, fr,
                          torch.tensor(3, dtype=torch.int32), threshold=0.5)
    assert int(lu.sum()) == 0 and int(fr.sum()) == 0


def test_k_above_C_and_cuda_on_cpu_raise():
    q, keys, valid = _inputs("random", 1, 2, 5, 8)
    with pytest.raises(ValueError):
        similarity_topk_batched(_t(q), _t(keys), _t(valid), 6)
    with pytest.raises(ValueError):
        similarity_topk_batched(_t(q), _t(keys), _t(valid), 1, impl="cuda")



@pytest.mark.parametrize("op", ["topk_batched", "lookup", "topk_touch"])
def test_profiler_records_like_jax(op):
    """With a profiler installed, each entry point records the reference's
    metric names (``kernel/<op>/<impl>/...``) and modeled bytes."""
    from repro.kernels import similarity as jsim
    from repro.obs import profile as jprof
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.kernels import similarity as tsim
    from repro_torch.obs import profile as tprof
    from repro_torch.obs.metrics import MetricsRegistry as TRegistry

    q, keys, valid = _inputs("random", 2, 3, 20, 8)
    C = keys.shape[1]
    state = np.zeros(C, np.int32)
    calls = {
        "topk_batched": lambda m, a: m.similarity_topk_batched(
            a(q), a(keys), a(valid), 2),
        "lookup": lambda m, a: m.similarity_lookup(a(q[0]), a(keys[0]),
                                                   a(valid[0])),
        "topk_touch": lambda m, a: m.similarity_topk_touch(
            a(q[0]), a(keys[0]), a(valid[0]), 1, a(state), a(state),
            a(np.int32(2)), threshold=0.5),
    }
    snaps = []
    for prof, reg, mod, conv in ((jprof, JRegistry(), jsim, jnp.asarray),
                                 (tprof, TRegistry(), tsim, torch.as_tensor)):
        prof.enable_profiling(reg)
        try:
            calls[op](mod, conv)
        finally:
            prof.disable_profiling()
        snaps.append(reg.snapshot())
    jsnap, tsnap = snaps
    assert sorted(tsnap) == sorted(jsnap)
    for name, v in jsnap.items():
        if not name.endswith("wall_ms"):
            assert tsnap[name] == v, name
