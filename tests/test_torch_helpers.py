"""Three public helpers of the PyTorch port against the JAX package (CPU):
``ModelConfig.param_count`` and the models' ``param_specs`` for every
config of the reference's registry at its published widths (both sides
shape-only: ``jax.eval_shape`` there, the ``meta`` device here), the
paged-attention byte model ``obs.profile.attention_bytes`` on a seeded
grid, and ``PagedKVCache.table_rows`` along a seeded admit / register /
copy-on-write / free sequence.

Counts, specs, bytes and block tables are integers or exact sums, so they
must be equal, not close.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_model
from repro.obs import profile as jprof
from repro.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.obs import profile as tprof
from repro_torch.serving.kv_cache import PagedKVCache

CONFIGS = sorted(ARCH_IDS) + ["coic_paper"]
IMPLS = ("gather", "paged")


@pytest.mark.parametrize("name", CONFIGS)
def test_param_count_matches_jax(name):
    n = get_config(name).param_count()
    assert isinstance(n, int)
    assert n == jax_config(name).param_count()


@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_match_jax(name):
    def spec(sp):
        return tuple(sp.shape), tuple(sp.axes), sp.init, sp.dtype

    model = build_model(get_config(name), device="meta")
    ours = {k: spec(sp) for k, sp in model.param_specs().items()}
    ref = {k: spec(sp)
           for k, sp in jax_model(jax_config(name)).param_specs().items()}
    assert ours == ref
    assert {k: (sp[0], sp[1]) for k, sp in ours.items()} == {
        k: (tuple(s.shape), model.logical_axes()[k])
        for k, s in model.init_shapes().items()}


def _byte_grid(seed):
    rng = np.random.default_rng(seed)
    for _ in range(24):
        page = int(rng.choice([1, 8, 16, 64]))
        max_len = page * int(rng.integers(1, 65))
        rows = int(rng.integers(1, 9))
        kv_len = rng.integers(0, max_len + 1, size=rows)
        kv_len[rng.random(rows) < 0.25] = 0           # idle rows
        yield (kv_len, dict(page_size=page, max_len=max_len,
                            kv_heads=int(rng.choice([1, 2, 8, 32])),
                            head_dim=int(rng.choice([64, 80, 128, 192])),
                            dtype_bytes=int(rng.choice([1, 2, 4]))))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("impl", IMPLS)
def test_attention_bytes_matches_jax(impl, seed):
    for kv_len, kw in _byte_grid(seed):
        for lens in (kv_len, kv_len.tolist(), int(kv_len[0])):
            ours = tprof.attention_bytes(lens, impl=impl, **kw)
            ref = jprof.attention_bytes(lens, impl=impl, **kw)
            assert type(ours) is float
            np.testing.assert_allclose(ours, ref, rtol=0, atol=0)


def test_attention_bytes_rejects_what_jax_rejects():
    kw = dict(page_size=16, max_len=64, kv_heads=2, head_dim=64,
              dtype_bytes=2)
    for impl in ("auto", "cuda", "ref", "pallas"):
        for mod in (jprof, tprof):
            with pytest.raises(ValueError):
                mod.attention_bytes([3, 17], impl=impl, **kw)


def _caches(**kw):
    model = types.SimpleNamespace(device=torch.device("cpu"))
    return (PagedKVCache(model, **kw), JaxPagedKVCache(None, **kw))


def _same_rows(ours, ref, slots):
    got, want = ours.table_rows(slots), ref.table_rows(slots)
    assert type(got) is np.ndarray and got.dtype == want.dtype == np.int32
    assert got.shape == (len(slots), ref.pages_per_slot)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("prefix_share", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_table_rows_matches_jax(seed, prefix_share):
    """Admit prompts that share prefixes, publish their pages, copy a
    shared page on write, free and readmit, and hold ``table_rows`` of
    random slot lists (empty, repeated, unordered) equal after every
    step."""
    rng = np.random.default_rng(seed)
    B, page, max_len = 4, 8, 32
    ours, ref = _caches(max_batch=B, max_len=max_len, page_size=page,
                        prefix_share=prefix_share)
    stems = [rng.integers(0, 50, size=2 * page, dtype=np.int32)
             for _ in range(2)]
    live = {}
    pool_t = {"k": torch.zeros((1, ours.num_pages, page, 1, 2))}
    pool_j = {"k": jnp.zeros((1, ref.num_pages, page, 1, 2))}
    for step in range(24):
        free = [s for s in range(B) if s not in live]
        if free and (not live or rng.random() < 0.6):
            slot = int(rng.choice(free))
            tail = rng.integers(0, 50, size=int(rng.integers(1, 2 * page)),
                                dtype=np.int32)
            prompt = np.concatenate([stems[int(rng.integers(2))], tail])
            shared = ours.admit(slot, prompt)
            assert shared == ref.admit(slot, prompt)
            assert (ours.register(slot, prompt, shared // page)
                    == ref.register(slot, prompt, shared // page))
            live[slot] = prompt
        elif rng.random() < 0.3:
            slot = int(rng.choice(list(live)))
            j = int(rng.integers(ours.pages_per_slot))
            pool_t = ours.ensure_private(pool_t, slot, j)
            pool_j = ref.ensure_private(pool_j, slot, j)
        else:
            slot = int(rng.choice(list(live)))
            ours.free_slot(slot)
            ref.free_slot(slot)
            del live[slot]
        for slots in ([], [slot], [slot, slot],
                      rng.integers(0, B, size=int(rng.integers(1, 7)))):
            _same_rows(ours, ref, list(slots))
        assert ours.stats_dict() == ref.stats_dict()


def test_table_rows_is_a_copy():
    ours, ref = _caches(max_batch=2, max_len=16, page_size=4)
    prompt = np.arange(9, dtype=np.int32)
    for kv in (ours, ref):
        kv.admit(1, prompt)
    rows = _same_rows(ours, ref, [1, 1])
    rows[:] = -1
    assert (ours.block_table[1] != -1).all()
    _same_rows(ours, ref, [1, 1])
