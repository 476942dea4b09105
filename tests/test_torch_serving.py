"""The slice as a whole: the PyTorch ``ServingEngine`` and ``CoICEngine``
against the JAX ones (CPU, fp32 ``coic-paper``, same weights).

The seeded shared-prefix stream of tests/test_kv_paged.py runs in two
waves through both serving engines (paged pool, ``kv_page=16,
prefill_chunk=32``, CoIC front at ``capacity=64, threshold=0.98``), for
both attention reads: decoded tokens and ``source`` per request,
prefill-token counts, ``stats()["kv"]``, hit counts, dispatch counters
and the ladder block must be equal.  The slotted cache (``kv_page=0``)
runs the same stream with bucketed and with chunked admission, and the
reduced ``h2o-danube3-4b`` (a sliding-window ring) runs prompts longer
than its window in equal-length runs; both with the same checks.
"""
import numpy as np
import pytest

from repro.core.coic import CoICConfig as JCoIC
from repro.serving.engine import ServingConfig as JServing
from repro.serving.engine import ServingEngine as JServe
from repro_torch.core.coic import CoICConfig as TCoIC
from repro_torch.serving.engine import ServingConfig as TServing
from repro_torch.serving.engine import ServingEngine as TServe
from torch_twins import shared_prefix_prompts, twin

STATS_KEYS = ("completed", "edge_hits", "peer_hits", "remote_hits", "cloud",
              "dispatches", "max_step_ladder", "prefill_tokens", "kv",
              "semantic", "ladder", "digest", "deadline")


def _waves(vocab, n1=7, n2=3):
    rng = np.random.default_rng(0)
    wave1 = shared_prefix_prompts(rng, vocab, n1)
    wave2 = wave1[:4] + shared_prefix_prompts(rng, vocab, n2)
    return wave1, wave2


def _serve_both(attn_impl, waves=(7, 3), **extra):
    cfg, jm, jp, tm = twin("coic-paper")
    kw = dict(max_batch=4, max_len=96, max_new_tokens=6, kv_page=16,
              prefill_chunk=32, attn_impl=attn_impl)
    kw.update(extra)
    je = JServe(jm, jp, JServing(coic=JCoIC(capacity=64, threshold=0.98),
                                 **kw))
    te = TServe(tm, TServing(coic=TCoIC(capacity=64, threshold=0.98), **kw),
                device="cpu")
    for wave in _waves(cfg.vocab_size, *waves):
        for p in wave:
            assert je.submit(p) == te.submit(p)
        je.run_until_drained()
        te.run_until_drained()
    return je, te


@pytest.mark.parametrize("attn_impl", ["gather", "paged"])
def test_serving_engine_matches_jax(attn_impl):
    je, te = _serve_both(attn_impl)
    jr = {r.req_id: r for r in je.results}
    tr = {r.req_id: r for r in te.results}
    assert sorted(jr) == sorted(tr)
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        assert tr[rid].source == jr[rid].source
        assert tr[rid].decode_steps == jr[rid].decode_steps
    js, ts = je.stats(), te.stats()
    for key in STATS_KEYS:
        assert ts[key] == js[key], key
    assert ts["edge_hits"] >= 4 and ts["prefill_tokens"]["shared"] > 0
    assert ts["max_step_ladder"] <= 2
    assert (te.kv.refcount == 0).all()


def _compare(je, te, keys=STATS_KEYS):
    jr = {r.req_id: r for r in je.results}
    tr = {r.req_id: r for r in te.results}
    assert sorted(jr) == sorted(tr)
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        assert tr[rid].source == jr[rid].source
        assert tr[rid].decode_steps == jr[rid].decode_steps
    js, ts = je.stats(), te.stats()
    assert set(ts) == set(js)
    for key in keys:
        assert ts[key] == js[key], key
    return ts


@pytest.mark.parametrize("prefill_chunk,scheduling", [
    (0, "batched"), (32, "batched"), (32, "sequential")])
def test_slotted_engine_matches_jax(prefill_chunk, scheduling):
    """coic-paper on the slotted cache: one bucketed ``prefill`` per step
    (prefill_chunk 0), long prompts trickling through ``prefill_chunk``
    (32), and the one-request-per-step baseline."""
    kw = dict(kv_page=0, prefill_chunk=prefill_chunk, scheduling=scheduling)
    je, te = _serve_both("gather", **kw)
    ts = _compare(je, te, tuple(k for k in STATS_KEYS if k != "kv"))
    assert "kv" not in ts
    assert ts["edge_hits"] >= 4 and ts["max_step_ladder"] <= 2
    assert ts["dispatches"]["prefill"] > 0
    assert (ts["dispatches"]["prefill_chunk"] > 0) == (
        prefill_chunk > 0 and scheduling == "batched")


def _swa_waves(vocab):
    """Equal-length runs around the reduced window of 16: lengths 20, 40
    (longer than the window: the ring wraps at prefill), 9 and 16, in an
    order that splits them into several runs."""
    rng = np.random.default_rng(5)
    wave1 = [rng.integers(0, vocab, size=(n,)).astype(np.int32)
             for n in (20, 20, 40, 40, 20, 9, 16, 16, 40)]
    wave2 = wave1[:4] + [rng.integers(0, vocab, size=(n,)).astype(np.int32)
                         for n in (40, 20)]
    return wave1, wave2


def test_swa_engine_matches_jax():
    """The reduced h2o-danube3-4b behind the CoIC front on the slotted
    cache: exact-length prefill runs, decode past the window; the chunk
    width is ignored for a ring, as in the reference."""
    cfg, jm, jp, tm = twin("h2o-danube3-4b", True)
    kw = dict(max_batch=4, max_len=64, max_new_tokens=8, prefill_chunk=16)
    je = JServe(jm, jp, JServing(coic=JCoIC(capacity=64, threshold=0.98),
                                 **kw))
    te = TServe(tm, TServing(coic=TCoIC(capacity=64, threshold=0.98), **kw),
                device="cpu")
    for wave in _swa_waves(cfg.vocab_size):
        for p in wave:
            assert je.submit(p) == te.submit(p)
        je.run_until_drained()
        te.run_until_drained()
    ts = _compare(je, te, tuple(k for k in STATS_KEYS if k != "kv"))
    assert ts["dispatches"]["prefill_chunk"] == 0
    assert ts["dispatches"]["prefill"] >= 4        # runs of equal length
    assert ts["edge_hits"] >= 4 and ts["max_step_ladder"] <= 2


def test_swa_engine_refuses_paged_kv():
    _, jm, jp, tm = twin("h2o-danube3-4b", True)
    with pytest.raises(ValueError):
        JServe(jm, jp, JServing(kv_page=16))
    with pytest.raises(ValueError):
        TServe(tm, TServing(kv_page=16), device="cpu")


def test_batch_cache_insert_and_scatter_match_jax():
    """The slotted cache's writers, in place in the port: a B=1 cache and
    a bucket of rows, both shorter than the batch cache (the tail zeroed),
    land leaf for leaf where the reference puts them; duplicate target
    slots raise in both."""
    import jax.numpy as jnp
    import torch

    from repro.serving import kv_cache as J
    from repro_torch.serving import kv_cache as T
    _, jm, _, tm = twin("coic-paper")
    rng = np.random.default_rng(6)
    one = {k: rng.normal(size=(s[0], 1, 5) + s[3:]).astype(np.float32)
           for k, (s, _) in tm.cache_specs(1, 9).items()}
    many = {k: rng.normal(size=(s[0], 3, 7) + s[3:]).astype(np.float32)
            for k, (s, _) in tm.cache_specs(3, 9).items()}
    jc = J.init_batch_cache(jm, 4, 9)
    tc = T.init_batch_cache(tm, 4, 9)
    tc = {k: v + 1.0 for k, v in tc.items()}       # stale rows to overwrite
    jc = {k: v + 1.0 for k, v in jc.items()}
    jc = J.batch_cache_insert(jc, {k: jnp.asarray(v) for k, v in one.items()},
                              2)
    assert T.batch_cache_insert(tc, {k: torch.from_numpy(v)
                                     for k, v in one.items()}, 2) is tc
    jc = J.batch_cache_scatter(jc, {k: jnp.asarray(v)
                                    for k, v in many.items()},
                               jnp.asarray([3, 0, 1], jnp.int32))
    T.batch_cache_scatter(tc, {k: torch.from_numpy(v)
                               for k, v in many.items()}, [3, 0, 1])
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    for mod, cache, conv in ((J, jc, jnp.asarray), (T, tc, torch.from_numpy)):
        with pytest.raises(ValueError):
            mod.batch_cache_scatter(cache, {k: conv(v)
                                            for k, v in many.items()},
                                    np.array([1, 0, 1], np.int32))


def test_unported_paths_raise():
    from repro_torch.core.cluster import ClusterConfig, CooperativeEdgeCluster
    from repro_torch.parallel.sharding import surviving_topk_lookup
    _, _, _, tm = twin("coic-paper")
    with pytest.raises(NotImplementedError):         # the Pallas interpreter
        TServe(tm, TServing(kv_page=16, attn_impl="paged_interpret"),
               device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):   # a mesh
        CooperativeEdgeCluster(ClusterConfig(num_nodes=2), mesh=object(),
                               device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        surviving_topk_lookup(None, None, None, None, 1, mesh=object())
    # the slotted cache, several nodes and clusters are served now
    TServe(tm, TServing(), device="cpu")
    TServe(tm, TServing(kv_page=16, coic=TCoIC(num_nodes=4)), device="cpu")
    TServe(tm, TServing(kv_page=16, coic=TCoIC(num_clusters=2)),
           device="cpu")


def test_copy_on_write_matches_jax():
    """``ensure_private`` remaps a writer off a shared page to a copy, as
    the reference does (here in place on the pool)."""
    import jax.numpy as jnp
    import torch

    from repro.serving.kv_cache import PagedKVCache as JKV
    from repro_torch.serving.kv_cache import PagedKVCache as TKV
    _, _, _, tm = twin("coic-paper")
    prompt = np.arange(40, dtype=np.int32)
    kvs = []
    for KV, model in ((JKV, None), (TKV, tm)):
        kv = KV(model, max_batch=2, max_len=64, page_size=16)
        kv.admit(0, prompt)
        kv.register(0, prompt)
        kv.admit(1, prompt)
        kvs.append(kv)
    jkv, tkv = kvs
    base = np.arange(2 * tkv.num_pages * 16, dtype=np.float32).reshape(
        2, tkv.num_pages, 16)
    jpool = jkv.ensure_private({"k": jnp.asarray(base)}, 1, 0)
    tpool = tkv.ensure_private({"k": torch.from_numpy(base.copy())}, 1, 0)
    np.testing.assert_array_equal(tpool["k"].numpy(), np.asarray(jpool["k"]))
    np.testing.assert_array_equal(tkv.block_table, jkv.block_table)
    np.testing.assert_array_equal(tkv.refcount, jkv.refcount)
    assert tkv.stats.cow_copies == 1
    assert tkv.ensure_private(tpool, 1, 0) is tpool


def _chaos_engine_run(make, mb, vocab, kills, K=3, N=2, PLEN=12, POOL=8):
    """tests/test_chaos.py::_engine_run's stream (sketch descriptor, 3
    clusters x 2 nodes, four rounds of six requests) on the paged pool:
    {(round, scene, cluster, node): (source, tokens)}."""
    eng = make(mb)
    prompts = np.random.default_rng(11).integers(
        1, vocab, size=(POOL, PLEN)).astype(np.int32)
    rng = np.random.default_rng(12)
    out = {}
    for round_ in range(4):
        for op, c in kills.get(round_, []):
            (mb.kill_cluster if op == "kill" else mb.revive_cluster)(c)
        rid_of = {}
        for _ in range(6):
            sid = int(rng.integers(POOL))
            k, n = int(rng.integers(K)), int(rng.integers(N))
            rid_of[eng.submit(prompts[sid], node_id=n, cluster_id=k)] = \
                (round_, sid, k, n)
        eng.run_until_drained()
        for r in eng.results[len(out):]:
            out[rid_of[r.req_id]] = (r.source,
                                     tuple(int(t) for t in r.tokens))
    return eng, out


def test_federated_engine_under_churn_matches_jax():
    """A cluster killed at round 1 and revived at round 3: tokens, source
    per request, ``stats()["membership"]`` and the ladder block equal."""
    from repro.core.membership import ClusterMembership as JMember
    from repro_torch.core.membership import ClusterMembership as TMember
    cfg, jm, jp, tm = twin("coic-paper")
    kw = dict(max_batch=16, max_len=32, max_new_tokens=8, kv_page=8)
    ckw = dict(capacity=16, threshold=0.98, descriptor="sketch",
               descriptor_dim=128, num_nodes=2, num_clusters=3,
               digest_size=4, digest_interval=1)
    kills = {1: [("kill", 1)], 3: [("revive", 1)]}
    je, jout = _chaos_engine_run(
        lambda mb: JServe(jm, jp, JServing(coic=JCoIC(**ckw), **kw),
                          membership=mb),
        JMember(3, 2, timeout_s=60.0), cfg.vocab_size, kills)
    te, tout = _chaos_engine_run(
        lambda mb: TServe(tm, TServing(coic=TCoIC(**ckw), **kw),
                          membership=mb, device="cpu"),
        TMember(3, 2, timeout_s=60.0), cfg.vocab_size, kills)
    assert tout == jout
    js, ts = je.stats(), te.stats()
    for key in STATS_KEYS + ("membership",):
        assert ts[key] == js[key], key
    assert ts["membership"]["cluster_kills"] == 1
    assert ts["remote_hits"] > 0 and ts["peer_hits"] > 0
    assert ts["max_step_ladder"] <= 2
