"""The port's mixture-of-experts layer vs ``repro.models.layers`` (CPU, fp32).

``moe_router``, ``moe_apply_dense`` and ``moe_apply_dropless`` run on the
same seeded weights and tokens in both packages: random inputs, an exact
router tie (two equal router columns: the lower expert id must come
first), an overflow that drops assignments (a router that sends most
tokens to one expert, so the capacity buffer fills) and shared experts.
Expert ids, drop masks and capacities exact; weights, outputs and the aux
loss within ``atol=1e-4, rtol=1e-4``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JConfig
from repro.configs import MoEConfig as JMoE
from repro.models import layers as JL
from repro_torch.configs import ModelConfig as TConfig
from repro_torch.configs import MoEConfig as TMoE
from repro_torch.models import layers as TL

TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(E=4, k=2, shared=0, D=32, F=16):
    kw = dict(name="moe-test", family="moe", num_layers=1, d_model=D,
              num_heads=4, num_kv_heads=2, d_ff=F, vocab_size=64,
              dtype="float32")
    moe = dict(num_experts=E, top_k=k, d_ff_expert=F,
               num_shared_experts=shared, d_ff_shared=F if shared else 0)
    return (JConfig(moe=JMoE(**moe), **kw), TConfig(moe=TMoE(**moe), **kw))


def _weights(cfg, seed=0):
    """Seeded numpy weights in the reference's leaf names."""
    m = cfg.moe
    D, E, F = cfg.d_model, m.num_experts, m.d_ff_expert
    rng = np.random.default_rng(seed)
    shapes = {"router": (D, E), "we_gate": (E, D, F), "we_up": (E, D, F),
              "we_down": (E, F, D)}
    if m.num_shared_experts:
        Fs = m.d_ff_shared
        shapes.update({"shared/w_gate": (D, Fs), "shared/w_up": (D, Fs),
                       "shared/w_down": (Fs, D)})
    return {k: (0.2 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _both(w):
    """(reference params dict under prefix "moe", the port's weights)."""
    jp = {f"moe/{k}": jnp.asarray(v) for k, v in w.items()}
    tw = types.SimpleNamespace(**{k.replace("/", "_"): torch.from_numpy(v)
                                  for k, v in w.items()})
    return jp, tw


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check_router(jcfg, w, x):
    jp, tw = _both(w)
    k = jcfg.moe.top_k
    jw, ji, ja = JL.moe_router(jp, "moe", jnp.asarray(x), k)
    tw_, ti, ta = TL.moe_router(torch.from_numpy(x), tw.router, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw_.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    return ti.numpy()


def _check_apply(jcfg, tcfg, w, x):
    jp, tw = _both(w)
    for jfn, tfn in ((JL.moe_apply_dense, TL.moe_apply_dense),
                     (JL.moe_apply_dropless, TL.moe_apply_dropless)):
        jo, ja = jfn(jcfg, jp, "moe", jnp.asarray(x))
        to, ta = tfn(tcfg, tw, torch.from_numpy(x))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(float(ta), float(ja), **TOL)


def _dropped(tcfg, ids):
    """Drop mask of the dropless dispatch over token-major ``ids`` (N, k):
    an assignment past its expert's capacity."""
    flat = ids.reshape(-1)
    C = TL.moe_capacity(ids.shape[0], tcfg)
    seen = np.zeros(tcfg.moe.num_experts, np.int64)
    out = []
    for e in flat:
        out.append(seen[e] >= C)
        seen[e] += 1
    return np.array(out)


@pytest.mark.parametrize("E,k,B,S", [(4, 2, 2, 7), (8, 3, 3, 5),
                                     (40, 8, 2, 9)])
def test_random_inputs_match(E, k, B, S):
    jcfg, tcfg = _configs(E=E, k=k)
    w = _weights(jcfg)
    x = _x((B, S, jcfg.d_model))
    _check_router(jcfg, w, x.reshape(B * S, -1))
    _check_apply(jcfg, tcfg, w, x)


def test_router_tie_goes_to_the_lower_expert_id():
    """Experts 1 and 3 share a router column, as do 0 and 2: every token
    scores them equally, and both packages list the lower id first."""
    jcfg, tcfg = _configs(E=4, k=3)
    w = _weights(jcfg)
    w["router"][:, 3] = w["router"][:, 1]
    w["router"][:, 2] = w["router"][:, 0]
    x = _x((2, 6, jcfg.d_model))
    ids = _check_router(jcfg, w, x.reshape(12, -1))
    for row in ids:
        for lo, hi in ((0, 2), (1, 3)):
            if lo in row and hi in row:
                assert list(row).index(lo) < list(row).index(hi), row
    assert any(1 in r and 3 in r for r in ids), ids
    _check_apply(jcfg, tcfg, w, x)


def test_overflow_drops_assignments():
    """A router biased to expert 0: more than C assignments go there, the
    dropless dispatch drops the rest (their weight lost), exactly where
    the reference drops them."""
    jcfg, tcfg = _configs(E=4, k=2)
    w = _weights(jcfg)
    w["router"][:, 0] += 2.0
    x = _x((4, 8, jcfg.d_model)) + 1.0
    ids = _check_router(jcfg, w, x.reshape(32, -1))
    drop = _dropped(tcfg, ids)
    assert drop.sum() > 0, "no assignment dropped"
    assert TL.moe_capacity(32, tcfg) == 20
    _check_apply(jcfg, tcfg, w, x)
    # a dropped assignment contributes nothing: zeroing its weight by hand
    # in a dense combine gives the dropless output
    _, tw = _both(w)
    out, _ = TL.moe_apply_dropless(tcfg, tw, torch.from_numpy(x))
    xf = torch.from_numpy(x.reshape(32, -1))
    wts, tids, _ = TL.moe_router(xf, tw.router, 2)
    wts = wts * torch.from_numpy(~drop.reshape(32, 2))
    y = torch.zeros_like(xf)
    for e in range(4):
        h = (torch.nn.functional.silu(xf @ tw.we_gate[e])
             * (xf @ tw.we_up[e])) @ tw.we_down[e]
        y += h * (wts * (tids == e)).sum(1, keepdim=True)
    np.testing.assert_allclose(out.reshape(32, -1).numpy(), y.numpy(), **TOL)


def test_shared_experts_match():
    jcfg, tcfg = _configs(E=4, k=2, shared=1)
    w = _weights(jcfg)
    x = _x((2, 5, jcfg.d_model))
    _check_apply(jcfg, tcfg, w, x)
    jp, tw = _both(w)
    for impl in ("dense", "dropless"):
        jo, _ = JL.moe_apply(jcfg, jp, "moe", jnp.asarray(x), impl=impl)
        to, _ = TL.moe_apply(tcfg, tw, torch.from_numpy(x), impl=impl)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_ep_without_a_sharder_matches_reference():
    """``moe_apply(impl="ep")`` with no sharder installed against the
    reference's: both run the dropless dispatch (the reference's
    ``moe_apply_dropless_ep`` falls back exactly there)."""
    jcfg, tcfg = _configs(E=4, k=2, shared=1)
    jp, tw = _both(_weights(jcfg))
    x = _x((2, 5, jcfg.d_model))
    jo, ja = JL.moe_apply(jcfg, jp, "moe", jnp.asarray(x), impl="ep")
    to, ta = TL.moe_apply(tcfg, tw, torch.from_numpy(x), impl="ep")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)


@pytest.mark.parametrize("impl,error", [("sparse", ValueError),
                                         ("", ValueError)])
def test_unported_moe_impl_refused(impl, error):
    """``moe_apply`` and the model refuse an impl other than dense,
    dropless or ep, rather than running ``dense`` in its place."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.transformer import DecoderLM
    _, tcfg = _configs()
    _, tw = _both(_weights(tcfg))
    with pytest.raises(error):
        TL.moe_apply(tcfg, tw, torch.zeros((1, 2, tcfg.d_model)), impl=impl)
    cfg = reduced_config(get_config("granite-moe-3b-a800m"))
    if impl:                               # "" picks the reference's rule
        with pytest.raises(error):
            DecoderLM(cfg, device="cpu", moe_impl=impl)


def test_ep_model_without_a_sharder_equals_dropless():
    """The reference's rule at model level: a model built with
    ``moe_impl="ep"`` and run with no sharder computes the dropless
    model's logits (the case that replaced ``ep`` among the refused
    impls)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.transformer import DecoderLM
    cfg = dataclasses.replace(reduced_config(
        get_config("granite-moe-3b-a800m")), dtype="float32")
    models = [DecoderLM(cfg, device="cpu", moe_impl=impl).init(
        torch.Generator().manual_seed(0)) for impl in ("ep", "dropless")]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 9)))
    a, b = (m(tokens) for m in models)
    assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_overflow_at_granite_routing(seed):
    """granite-moe's routing (40 experts, top-8) over 48 tokens leaning to
    experts 0-3: their buffers overflow (C = 12), and every assignment's
    slot, drop and output are the reference's."""
    jcfg, tcfg = _configs(E=40, k=8)
    w = _weights(jcfg, seed=seed)
    w["router"][:, :4] += 1.5
    x = _x((3, 16, jcfg.d_model), seed=seed + 1) + 1.0
    ids = _check_router(jcfg, w, x.reshape(48, -1))
    assert TL.moe_capacity(48, tcfg) == 12
    assert _dropped(tcfg, ids).sum() > 0, "no assignment dropped"
    _check_apply(jcfg, tcfg, w, x)


def test_capacity_is_the_references():
    """C = max(8, ceil(N k 1.25 / E)): granite-moe's decode step at B = 8
    (64 assignments: 8) and its B = 8 chunk of 128 (8192: 256)."""
    tcfg = _configs(E=40, k=8)[1]
    assert TL.moe_capacity(8, tcfg) == 8
    assert TL.moe_capacity(8 * 128, tcfg) == 256
