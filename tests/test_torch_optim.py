"""The port's optimiser, schedule and tree utilities against the JAX
package's, on identical numpy inputs (CPU, fp32).

``AdamW.update`` runs five steps on the same params and gradients in both
packages: a matrix, a vector, a stacked norm weight (R, D) — rank 2 in
the reference's layout, so it decays — and a scalar, with the global-norm
clip active (gradients scaled up) or not.  Params, moments, grad norm and
lr within rtol 1e-6 + atol 1e-7 at every step; the count exact.
``cosine_with_warmup`` at steps 0, mid-warmup, warmup, mid-decay, total
and past it within rtol 1e-6.  ``tree_param_count``, ``tree_size_bytes``
and ``map_with_paths`` equal to the reference's on the same nested
dicts, named tuples and lists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWConfig as JConfig
from repro.optim.adamw import OptState as JOptState
from repro.optim.schedule import cosine_with_warmup as jcosine
from repro.utils import tree as jtree
from repro_torch.optim import AdamW, AdamWConfig, OptState, cosine_with_warmup
from repro_torch.utils import tree

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"w": (6, 5), "bias": (5,), "blocks/0/attn_norm": (3, 8),
          "scale": ()}


def _params(rng):
    return {k: np.asarray(rng.standard_normal(s), np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("grad_scale", [0.01, 100.0], ids=["unclipped",
                                                           "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.default_rng(0)
    cfg = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               grad_clip_norm=1.0)
    ours = AdamW(AdamWConfig(**cfg), cosine_with_warmup(3e-3, 2, 10))
    ref = JAdamW(JConfig(**cfg), jcosine(3e-3, 2, 10))
    p = _params(rng)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ts, js = ours.init(tp), ref.init(jp)
    for _ in range(5):
        g = {k: np.asarray(grad_scale * rng.standard_normal(s), np.float32)
             for k, s in SHAPES.items()}
        tp, ts, tm = ours.update({k: torch.from_numpy(v) for k, v in
                                  g.items()}, ts, tp)
        jp, js, jm = ref.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
        assert int(ts.count) == int(js.count)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
        for k in SHAPES:
            for a, b in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                         (ts.nu[k], js.nu[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           err_msg=k, **TOL)
    if grad_scale > 1:
        assert float(tm["grad_norm"]) > 1.0            # reported pre-clip


def test_adamw_decays_by_reference_rank():
    """With zero gradients only decay moves a leaf: the stacked norm
    weight (R, D) and the matrix decay, the vector and scalar do not."""
    opt = AdamW(AdamWConfig(weight_decay=0.5), lambda s: torch.tensor(0.1))
    p = {k: torch.ones(s) for k, s in SHAPES.items()}
    new, _, _ = opt.update({k: torch.zeros_like(v) for k, v in p.items()},
                           opt.init(p), p)
    assert float(new["w"][0, 0]) < 1.0
    assert float(new["blocks/0/attn_norm"][0, 0]) < 1.0
    assert float(new["bias"][0]) == 1.0 and float(new["scale"]) == 1.0


def test_adamw_minimizes_quadratic():
    opt = AdamW(AdamWConfig(weight_decay=0.0), lambda s: torch.tensor(0.1))
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].norm()) < 1e-2
    assert isinstance(state, OptState) and state._fields == JOptState._fields


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 55, 100, 130])
def test_cosine_with_warmup_matches_reference(step):
    ours, ref = cosine_with_warmup(1.0, 10, 100), jcosine(1.0, 10, 100)
    a = ours(torch.tensor(step, dtype=torch.int32))
    assert a.dtype == torch.float32 and a.shape == ()
    np.testing.assert_allclose(float(a), float(ref(jnp.asarray(step))),
                               rtol=1e-6, atol=0)
    assert float(ours(step)) == float(a)                # a plain int too


def _trees():
    rng = np.random.default_rng(0)
    arrays = {"b": rng.standard_normal((3, 4)).astype(np.float32),
              "a": {"y": np.zeros((2,), np.int32),
                    "x": np.ones((5, 1), np.float16)}}
    state = JOptState(mu=arrays, nu=[arrays["b"], None],
                      count=np.zeros((), np.int32))
    return arrays, state


def test_tree_utils_match_reference():
    for t in _trees():
        assert tree.tree_param_count(t) == jtree.tree_param_count(t)
        assert tree.tree_size_bytes(t) == jtree.tree_size_bytes(t)
        seen, jseen = [], []
        tree.map_with_paths(lambda p, x: seen.append((p, x.shape)), t)
        jtree.map_with_paths(lambda p, x: jseen.append((p, x.shape)), t)
        assert sorted(seen) == sorted(jseen)
    # torch leaves count and size alike, and the structure is kept
    _, state = _trees()
    tt = tree.map_with_paths(lambda p, x: torch.from_numpy(np.asarray(x)),
                             state)
    assert type(tt) is JOptState and tt.nu[1] is None
    assert tree.tree_size_bytes(tt) == jtree.tree_size_bytes(state)
    assert [p for p, _ in tree.leaves_with_paths(tt)][0] == ("mu", "a", "x")
