"""The slice as a whole: the PyTorch ``ServingEngine`` and ``CoICEngine``
against the JAX ones (CPU, fp32 ``coic-paper``, same weights).

The seeded shared-prefix stream of tests/test_kv_paged.py runs in two
waves through both serving engines (paged pool, ``kv_page=16,
prefill_chunk=32``, CoIC front at ``capacity=64, threshold=0.98``), for
both attention reads: decoded tokens and ``source`` per request,
prefill-token counts, ``stats()["kv"]``, hit counts, dispatch counters
and the ladder block must be equal.
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
              "semantic", "ladder", "digest")


def _waves(vocab, n1=7, n2=3):
    rng = np.random.default_rng(0)
    wave1 = shared_prefix_prompts(rng, vocab, n1)
    wave2 = wave1[:4] + shared_prefix_prompts(rng, vocab, n2)
    return wave1, wave2


def _serve_both(attn_impl, waves=(7, 3), **extra):
    cfg, jm, jp, tm = twin("coic-paper")
    kw = dict(max_batch=4, max_len=96, max_new_tokens=6, kv_page=16,
              prefill_chunk=32, attn_impl=attn_impl, **extra)
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


def test_unported_paths_raise():
    _, _, _, tm = twin("coic-paper")
    with pytest.raises(NotImplementedError):                 # slotted KV
        TServe(tm, TServing(), device="cpu")
    with pytest.raises(NotImplementedError):                 # 4-node cluster
        TServe(tm, TServing(kv_page=16, coic=TCoIC(num_nodes=4)),
               device="cpu")
    with pytest.raises(NotImplementedError):                 # federation
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
