"""The port's logical-axis sharding rules against the JAX package's, in
process: ``ShardingRules.spec_for`` on every leaf of every config (full
and reduced) under ``RULES_TRAIN``, ``RULES_SERVE`` and
``RULES_SERVE_LONG`` on meshes of (16, 16), (2, 16, 16), (2, 2) and (1, 1)
(shape-only stand-ins, as ``tests/test_sharding_rules.py``'s
``FakeMesh``: the rules read only the mesh's axis sizes), the models'
``logical_axes()`` / ``init_shapes()`` (the port's built on the ``meta``
device, so a full config allocates nothing), the reference's own rule
cases, the placements a spec gives, the activation hook without a mesh,
the mesh constructors without a process group, and the single-process parts
of ``optim/grad_compress.py``.  Specs, axes, shapes and quantized
payloads must be equal; dequantized values and residuals within 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced_config
from repro.models import build_model as jax_build
from repro.optim import grad_compress as JG
from repro.parallel import sharding as JS
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import build_model as torch_build
from repro_torch.optim import grad_compress as TG
from repro_torch.parallel import sharding as TS

CONFIGS = ("coic-paper",) + tuple(ARCH_IDS)
RULES = ("RULES_TRAIN", "RULES_SERVE", "RULES_SERVE_LONG")
MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "2x2": dict(data=2, model=2), "1x1": dict(data=1, model=1)}


class FakeMesh:
    """Shape-only stand-in so rule logic tests don't need real devices."""

    def __init__(self, **shape):
        self.shape = shape


@functools.lru_cache(maxsize=None)
def models(name: str, reduced: bool):
    jcfg, tcfg = get_config(name), tget(name)
    if reduced:
        jcfg, tcfg = reduced_config(jcfg), treduced(tcfg)
    return jax_build(jcfg), torch_build(tcfg, device="meta")


@functools.lru_cache(maxsize=None)
def layouts(name: str, reduced: bool):
    jm, tm = models(name, reduced)
    return (jm.logical_axes(), jm.init_shapes(), tm.logical_axes(),
            tm.init_shapes())


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", CONFIGS)
def test_logical_axes_and_shapes_match_reference(name, reduced):
    ja, js, ta, ts = layouts(name, reduced)
    assert ta == ja
    assert set(ts) == set(js)
    for k, v in js.items():
        assert ts[k].shape == tuple(v.shape), k
        assert str(ts[k].dtype) == f"torch.{v.dtype}", k


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", CONFIGS)
def test_spec_for_matches_reference(name, reduced, rules, mesh):
    ja, js, _, _ = layouts(name, reduced)
    fake = FakeMesh(**MESHES[mesh])
    jr, tr = getattr(JS, rules), getattr(TS, rules)
    for k in ja:
        shape = tuple(js[k].shape)
        assert tr.spec_for(ja[k], shape, fake) == tuple(
            jr.spec_for(ja[k], shape, fake)), k


# tests/test_sharding_rules.py's cases: (rules, axes, shape, mesh, spec)
RULE_CASES = {
    "divisible_dims_shard": ("RULES_TRAIN", ("vocab", "embed"),
                             (32000, 4096), "16x16", ("model", "data")),
    "indivisible_dim_replicates": (
        "RULES_TRAIN", ("experts", "embed", "mlp"), (40, 1536, 512),
        "16x16", (None, "data", "model")),
    "axis_conflict_first_dim_wins": ("RULES_TRAIN", ("heads", "mlp"),
                                     (64, 29568), "16x16", ("model",)),
    "kv_cache_seq_sharding_when_heads_indivisible": (
        "RULES_SERVE", ("layers", "batch", "cache_seq", "kv_heads",
                        "qk_dim"), (80, 128, 32768, 8, 128), "16x16",
        (None, "data", "model")),
    "long_context_rules_spread_cache": (
        "RULES_SERVE_LONG", ("layers", "batch", "cache_seq", "kv_heads",
                             "qk_dim"), (4, 1, 524288, 8, 128), "2x16x16",
        (None, None, ("pod", "data", "model"))),
    "batch_prefers_pod_data": ("RULES_TRAIN", ("batch", None, None),
                               (256, 4096, 1), "2x16x16",
                               (("pod", "data"),)),
    "batch_falls_back_without_pod": ("RULES_TRAIN", ("batch", None),
                                     (256, 4096), "16x16", ("data",)),
    "trailing_nones_trimmed": ("RULES_TRAIN", (None, None), (8, 8),
                               "16x16", ()),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_reference_rule_cases(case):
    rules, axes, shape, mesh, want = RULE_CASES[case]
    fake = FakeMesh(**MESHES[mesh])
    got = getattr(TS, rules).spec_for(axes, shape, fake)
    assert got == want
    assert got == tuple(getattr(JS, rules).spec_for(axes, shape, fake))


def test_rule_tables_equal_reference():
    for name in RULES:
        assert getattr(TS, name).rules == getattr(JS, name).rules, name


@pytest.mark.parametrize("spec,mesh,want", [
    (("model", "data"), "16x16", ["S(1)", "S(0)"]),
    ((("pod", "data"),), "2x16x16", ["S(0)", "S(0)", "R"]),
    ((None, ("pod", "data", "model")), "2x16x16", ["S(1)"] * 3),
    ((), "2x2", ["R", "R"]),
])
def test_placements_for(spec, mesh, want):
    got = TS.placements_for(spec, FakeMesh(**MESHES[mesh]))
    assert [str(p) for p in got] == want


def test_placements_refuse_minor_axis_first():
    with pytest.raises(AssertionError):
        TS.placements_for((("data", "pod"),), FakeMesh(**MESHES["2x16x16"]))


def test_logical_to_sharding_uses_spec_for():
    ja, js, _, ts = layouts("llama3.2-1b", False)
    fake = FakeMesh(**MESHES["16x16"])
    out = TS.logical_to_sharding(ja, ts, fake, TS.RULES_TRAIN)
    assert set(out) == set(ja)
    for k, sh in out.items():
        assert sh.spec == tuple(JS.RULES_TRAIN.spec_for(ja[k], js[k].shape,
                                                        fake))
        assert sh.placements == TS.placements_for(sh.spec, fake)


def test_constrain_without_mesh_is_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert TS.constrain(x, ("batch", "act_embed")) is x
    assert TS.current_sharder() is None and TS.model_sharder() is None
    fake = FakeMesh(data=2, model=2)
    with TS.set_activation_sharder(fake) as sh:
        assert TS.current_sharder() is sh and TS.model_sharder() is sh
        # every rank holds its own slices: the hook returns them as they are
        assert TS.constrain(x, ("batch", "act_embed")) is x
        with TS.set_activation_sharder(None):
            assert TS.current_sharder() is None
        assert TS.current_sharder() is sh
    assert TS.current_sharder() is None


def test_meshes_need_a_process_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import (CacheMeshConfig, make_cache_mesh,
                                         make_mesh, make_production_mesh)
    assert not dist.is_initialized()
    for call in (lambda: make_mesh((2, 2), ("data", "model"), "cpu"),
                 lambda: make_production_mesh(device="cpu"),
                 lambda: make_cache_mesh(4, device="cpu"),
                 lambda: CacheMeshConfig(num_shards=4, device="cpu").mesh):
        with pytest.raises(RuntimeError, match="process group"):
            call()
    cm = CacheMeshConfig(num_shards=4)             # lazy: nothing built yet
    assert cm._mesh is None


# ---------------------------------------------------------------------------
# optim/grad_compress.py, one process
# ---------------------------------------------------------------------------


def _grads(seed, shape=(4, 33)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (0.01 * rng.standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ef_int8_matches_reference(seed):
    g, e = _grads(seed)
    jq, js, je = JG.ef_int8_compress(jnp.asarray(g), jnp.asarray(e))
    tq, ts, te = TG.ef_int8_compress(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6)
    np.testing.assert_allclose(
        TG.ef_int8_decompress(tq, ts).numpy(),
        np.asarray(JG.ef_int8_decompress(jq, js)), atol=1e-6)


@pytest.mark.parametrize("k_ratio", [0.01, 0.1, 0.5])
def test_topk_compress_matches_reference(k_ratio):
    g, e = _grads(3, (16, 40))
    jk, je = JG.topk_compress(jnp.asarray(g), jnp.asarray(e), k_ratio)
    tk, te = TG.topk_compress(torch.from_numpy(g), torch.from_numpy(e),
                              k_ratio)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_init_compression_state_matches_reference():
    g = {"a": np.zeros((3, 4), np.float32), "b": np.zeros((5,), np.float32)}
    js = JG.init_compression_state({k: jnp.asarray(v) for k, v in g.items()})
    ts = TG.init_compression_state({k: torch.from_numpy(v)
                                    for k, v in g.items()})
    for k in g:
        assert ts.error[k].shape == js.error[k].shape
        assert ts.error[k].dtype == torch.float32 and not ts.error[k].any()


def compressed_mean_reference(g, err):
    """The reference's ``compressed_cross_pod_mean`` over a leading pod
    axis, run by ``jax.vmap`` with that axis named "pod" (its psum/pmax
    reduce over the mapped axis: one device, the collective's semantics)."""
    def f(gp, ep):
        out, st = JG.compressed_cross_pod_mean(
            {"w": gp}, JG.CompressionState(error={"w": ep}), "pod")
        return out["w"], st.error["w"]
    mean, new_err = jax.vmap(f, axis_name="pod")(jnp.asarray(g),
                                                 jnp.asarray(err))
    return np.asarray(mean), np.asarray(new_err)


def test_moe_ep_without_a_sharder_is_dropless():
    """The reference's rule: ``ep`` with no sharder installed runs the
    dropless dispatch (``moe_apply_dropless_ep``'s first branch)."""
    import types

    from repro_torch.models import layers as L
    from torch_multicard_cases import moe_cfg, moe_inputs
    for E in (8, 6):
        p, x = moe_inputs(E)
        w = types.SimpleNamespace(**{k: torch.from_numpy(v)
                                     for k, v in p.items()})
        cfg = moe_cfg(E)
        ye, ae = L.moe_apply(cfg, w, torch.from_numpy(x), impl="ep")
        yd, ad = L.moe_apply_dropless(cfg, w, torch.from_numpy(x))
        assert torch.equal(ye, yd) and torch.equal(ae, ad)
