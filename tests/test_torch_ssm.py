"""The port's Mamba-2 SSD block (``repro_torch/models/ssm.py``) vs
``repro.models.ssm`` (CPU, fp32), at the reduced ``mamba2-2.7b`` widths
(d_model 64, 16 SSD heads of 8, d_state 16, conv 4, chunk 16).

The same seeded weights and inputs go through both: the chunked scan with
and without an initial state, the whole block at a length that is a
chunk multiple and one that is not (the dt = 0 tail), several decode
steps after a prefill against the block over the whole sequence, and a
decay large enough that exp(cs_i - cs_j) overflows above the diagonal.
Within ``atol=rtol=1e-4``.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs import reduced_config
from repro.models import ssm as J
from repro_torch.models import ssm as T

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dataclasses.replace(reduced_config(get_config("mamba2-2.7b")),
                          dtype="float32")


def _params(seed=0, **const):
    """Random block weights: the reference's dict under prefix ``s`` and
    the port's attribute holder; ``const`` sets a leaf to a constant."""
    rng = np.random.default_rng(seed)
    raw = {}
    for k, shape in T.ssm_specs(CFG).items():
        base = {"a_log": 1.0, "d_skip": 1.0, "norm_w": 1.0}.get(k, 0.0)
        scale = 0.2 if k in ("w_in", "w_out", "conv_w") else 0.1
        raw[k] = (base + scale * rng.standard_normal(shape)).astype(
            np.float32)
        if k in const:
            raw[k] = np.full(shape, const[k], np.float32)
    jp = {f"s/{k}": jnp.asarray(v) for k, v in raw.items()}
    tp = types.SimpleNamespace(**{T.SSM_LEAVES[k][0]: torch.from_numpy(v)
                                  for k, v in raw.items()})
    return jp, tp


def _x(B, L, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, L, CFG.d_model))).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches(with_h0):
    rng = np.random.default_rng(2)
    B, L, H, P, G, N = 2, 48, 4, 8, 1, 16
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((H,))).astype(np.float32)
    b = rng.standard_normal((B, L, G, N)).astype(np.float32)
    c = rng.standard_normal((B, L, G, N)).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_h0 else None)
    jy, jh = J.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), 16,
                           None if h0 is None else jnp.asarray(h0))
    ty, th = T.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), 16,
                           None if h0 is None else torch.from_numpy(h0))
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("L", [32, 37])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_apply_matches(L, with_state):
    """L 32 is two chunks of 16; L 37 pads its tail to 48 with dt = 0.
    With states: the block continues from a conv and an SSD state."""
    jp, tp = _params()
    x = _x(2, L)
    kw_j, kw_t = {}, {}
    if with_state:
        _, H, conv_dim = T.ssm_dims(CFG)
        s = CFG.ssm
        rng = np.random.default_rng(3)
        conv = rng.standard_normal((2, s.d_conv - 1, conv_dim)).astype(
            np.float32)
        st = rng.standard_normal((2, H, s.head_dim, s.d_state)).astype(
            np.float32)
        kw_j = dict(conv_state=jnp.asarray(conv), ssd_state=jnp.asarray(st))
        kw_t = dict(conv_state=torch.from_numpy(conv),
                    ssd_state=torch.from_numpy(st))
    jy, (jc, jh) = J.ssm_apply(CFG, jp, "s", jnp.asarray(x),
                               return_state=True, **kw_j)
    ty, (tc, th) = T.ssm_apply(CFG, tp, torch.from_numpy(x),
                               return_state=True, **kw_t)
    _close(ty, jy)
    _close(tc, jc)
    _close(th, jh)
    assert th.dtype == torch.float32


def test_decode_steps_match_the_whole_sequence():
    """A 21-token prefill, then 5 decode steps: each step equals the
    reference's step and, in both packages, the block over the whole
    sequence at that position."""
    jp, tp = _params(seed=4)
    x = _x(2, 26, seed=5)
    _, (jc, jh) = J.ssm_apply(CFG, jp, "s", jnp.asarray(x[:, :21]),
                              return_state=True)
    _, (tc, th) = T.ssm_apply(CFG, tp, torch.from_numpy(x[:, :21]),
                              return_state=True)
    jfull = J.ssm_apply(CFG, jp, "s", jnp.asarray(x))
    tfull = T.ssm_apply(CFG, tp, torch.from_numpy(x))
    for t in range(21, 26):
        jy, jc, jh = J.ssm_decode_step(CFG, jp, "s",
                                       jnp.asarray(x[:, t:t + 1]), jc, jh)
        ty, tc, th = T.ssm_decode_step(CFG, tp, torch.from_numpy(
            x[:, t:t + 1]), tc, th)
        _close(ty, jy)
        _close(tc, jc)
        _close(th, jh)
        _close(ty, jfull[:, t:t + 1])
        np.testing.assert_allclose(np.asarray(jy),
                                   np.asarray(jfull[:, t:t + 1]), **TOL)
        np.testing.assert_allclose(ty.numpy(), tfull[:, t:t + 1].numpy(),
                                   **TOL)


def test_decay_overflow_above_the_diagonal_stays_finite():
    """a_log 5 and dt_bias 5 give a decay of about -740 a token: above
    the diagonal exp(cs_i - cs_j) is inf, which the select drops; the
    output is finite and equal to the reference's."""
    jp, tp = _params(seed=6, a_log=5.0, dt_bias=5.0)
    x = _x(2, 32, seed=7)
    a = -np.exp(5.0)
    assert a * np.log1p(np.exp(4.0)) * 16 < -np.log(np.finfo(np.float32).max)
    jy, (_, jh) = J.ssm_apply(CFG, jp, "s", jnp.asarray(x),
                              return_state=True)
    ty, (_, th) = T.ssm_apply(CFG, tp, torch.from_numpy(x),
                              return_state=True)
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()
    _close(ty, jy)
    _close(th, jh)
