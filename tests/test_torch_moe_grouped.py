"""The port's drop-free MoE route, its unrenormalised router and MLA's
YaRN (port only: the reference has none of them).

CPU cases in fp32: the ``grouped`` route (assignments sorted by expert,
grouped GEMMs, no capacity) equals the dense dispatch on a router leaning
to one expert, where ``dropless`` drops; a token's output does not depend
on the tokens batched with it; the router keeps the top-k softmax weights
as they are under ``moe_norm_topk_prob`` false; YaRN's frequencies and
softmax scale against the formulas written out from DeepSeek-V2-Lite's
published ``rope_scaling``; and the new fields' defaults reproduce the
arithmetic the reference twins hold (plain RoPE, 1/sqrt(dn + dr),
renormalised weights, capacity 1.25).  Tolerances: 1e-6 where two fp32
routes sum the same products in another order, 1e-5 where a product of
one row meets one of many (the BLAS takes another kernel); exact where
they sum the same products in the same order.

One ``gpu`` case holds the card's grouped GEMMs (``torch._grouped_mm``,
bf16) to one matrix product per expert, and the MoE layer of a decode
step to the dense dispatch, within 2e-2 (both accumulate in fp32 and
round to bf16; the dense dispatch sums k products in another order), and
runs that layer under ``torch.cuda.set_sync_debug_mode("error")``: it
does not wait for the device.  No JAX here (the card's machine has none):

    python -m pytest -q --noconftest -m gpu tests/test_torch_moe_grouped.py
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import (ModelConfig, MoEConfig, get_config,
                                 reduced_config)
from repro_torch.configs.base import PORTED_CONFIGS
from repro_torch.models import layers as L
from repro_torch.models.transformer import DecoderLM

DSV2 = get_config("deepseek-v2-lite-16b")
# DeepSeek-V2-Lite's published rope_scaling factor (the rest of it is
# ``L.YARN_*``)
YARN = dict(yarn_factor=40.0)


def _moe_cfg(E=8, k=2, D=32, F=16, shared=1, **kw):
    return ModelConfig(
        name="moe-test", family="moe", num_layers=1, d_model=D,
        num_heads=4, num_kv_heads=2, d_ff=F, vocab_size=64, dtype="float32",
        moe=MoEConfig(num_experts=E, top_k=k, d_ff_expert=F,
                      num_shared_experts=shared,
                      d_ff_shared=F if shared else 0), **kw)


def _weights(cfg, seed=0, lean=0.0, device="cpu", dtype=torch.float32):
    """Seeded expert weights; ``lean`` added to expert 0's router column."""
    m = cfg.moe
    D, E, F = cfg.d_model, m.num_experts, m.d_ff_expert
    g = torch.Generator().manual_seed(seed)
    shapes = {"router": (D, E), "we_gate": (E, D, F), "we_up": (E, D, F),
              "we_down": (E, F, D), "shared_w_gate": (D, F),
              "shared_w_up": (D, F), "shared_w_down": (F, D)}
    w = {n: 0.2 * torch.randn(s, generator=g) for n, s in shapes.items()}
    w["router"][:, 0] += lean
    return types.SimpleNamespace(**{n: t.to(device, dtype)
                                    for n, t in w.items()})


def _x(shape, seed=1, shift=0.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) + shift


def _drops(cfg, ids) -> int:
    """Assignments past their expert's dropless capacity."""
    C = L.moe_capacity(ids.shape[0], cfg)
    load = torch.bincount(ids.reshape(-1), minlength=cfg.moe.num_experts)
    return int((load - C).clamp(min=0).sum())


@pytest.mark.parametrize("renorm", [True, False])
def test_grouped_equals_dense_where_dropless_drops(renorm):
    """E = 8, k = 2, a router leaning to expert 0 over 48 tokens: the
    dropless buffers overflow, the grouped route keeps every assignment
    and computes the dense dispatch's output."""
    cfg = _moe_cfg(E=8, k=2, moe_norm_topk_prob=renorm)
    w = _weights(cfg, lean=1.0)
    x = _x((3, 16, cfg.d_model), shift=1.0)
    _, ids, _ = L.moe_router(x.reshape(48, -1), w.router, 2, renorm)
    assert _drops(cfg, ids) > 0, "no assignment dropped"
    dense, aux_d = L.moe_apply_dense(cfg, w, x)
    grouped, aux_g = L.moe_apply_grouped(cfg, w, x)
    dropless, _ = L.moe_apply_dropless(cfg, w, x)
    torch.testing.assert_close(grouped, dense, atol=1e-6, rtol=1e-6)
    assert torch.equal(aux_g, aux_d)
    assert not torch.allclose(dropless, dense, atol=1e-3)
    via = L.moe_apply(cfg, w, x, impl="grouped")[0]
    assert torch.equal(via, grouped)


def test_grouped_token_does_not_depend_on_its_batch():
    """Each token's output alone equals its output among 47 others (the
    dropless route's does not: its capacity belongs to the call)."""
    cfg = _moe_cfg(E=8, k=2)
    w = _weights(cfg, lean=1.0)
    x = _x((1, 48, cfg.d_model), shift=1.0)
    whole = L.moe_apply_grouped(cfg, w, x)[0]
    alone = torch.cat([L.moe_apply_grouped(cfg, w, x[:, i:i + 1])[0]
                       for i in range(48)], dim=1)
    # a product of one row and one of many rows sum in another order (the
    # BLAS takes another kernel): outputs near 1 within a few fp32 steps
    torch.testing.assert_close(alone, whole, atol=1e-5, rtol=1e-5)
    d_whole = L.moe_apply_dropless(cfg, w, x)[0]
    d_alone = torch.cat([L.moe_apply_dropless(cfg, w, x[:, i:i + 1])[0]
                         for i in range(48)], dim=1)
    assert not torch.allclose(d_alone, d_whole, atol=1e-3)


def test_router_without_renormalisation():
    """``moe_norm_topk_prob`` false: the top-k weights are the softmax's own
    (summing below 1); true: the same divided by their sum.  The ids and
    the aux loss do not change."""
    g = torch.Generator().manual_seed(3)
    x, router = torch.randn(10, 32, generator=g), torch.randn(32, 64,
                                                             generator=g)
    raw, ids, aux = L.moe_router(x, router, 6, renorm=False)
    norm, ids2, aux2 = L.moe_router(x, router, 6)
    probs = torch.softmax(x @ router, -1)
    want, want_ids = torch.topk(probs, 6)
    assert torch.equal(ids, want_ids) and torch.equal(ids, ids2)
    assert torch.equal(raw, want) and torch.equal(aux, aux2)
    assert (raw.sum(-1) < 1).all()
    torch.testing.assert_close(norm, raw / raw.sum(-1, keepdim=True),
                               atol=0, rtol=0)


def test_drop_free_config_takes_the_grouped_route():
    """``moe_drop_free`` picks ``grouped`` (a model of any width),
    and refuses a route with a capacity; the registered configs keep the
    reference's rule.  YaRN without MLA is refused."""
    base = reduced_config(DSV2)
    free = dataclasses.replace(base, moe_drop_free=True)
    assert DecoderLM(free, device="cpu").moe_impl == "grouped"
    assert DecoderLM(free, device="cpu", moe_impl="dense").moe_impl == "dense"
    for impl in ("dropless", "ep"):
        with pytest.raises(ValueError, match="capacity"):
            DecoderLM(free, device="cpu", moe_impl=impl)
    assert DecoderLM(base, device="cpu").moe_impl == "dense"
    wide = DecoderLM(DSV2, device="meta")
    assert wide.moe_impl == "dropless"
    assert DecoderLM(get_config("granite-moe-3b-a800m"),
                     device="meta").moe_impl == "dropless"
    with pytest.raises(ValueError, match="MLA"):
        DecoderLM(dataclasses.replace(reduced_config(get_config(
            "llama3.2-1b")), yarn_factor=40.0), device="cpu")


def test_yarn_against_the_published_formulas():
    """DeepSeek-V2-Lite's rope dims (64) under factor 40 from 4096
    positions: correction dims floor(64 ln(4096 / (32 2 pi)) / (2 ln
    10000)) = 10 and ceil(64 ln(4096 / (2 pi)) / (2 ln 10000)) = 23; dims
    below 10 keep base^(-2i/64), dims from 23 take it / 40, a linear ramp
    between; cos and sin unscaled (mscale = mscale_all_dim); the softmax
    scale 192^-1/2 x (0.1 x 0.707 x ln 40 + 1)^2."""
    assert (L.YARN_ORIGINAL_MAX_POSITION, L.YARN_BETA_FAST, L.YARN_BETA_SLOW,
            L.YARN_MSCALE_ALL_DIM) == (4096, 32, 1, 0.707)
    cfg = dataclasses.replace(DSV2, **YARN)
    i = np.arange(32, dtype=np.float64)
    extra = 10000.0 ** (-2 * i / 64)
    low = math.floor(64 * math.log(4096 / (32 * 2 * math.pi))
                     / (2 * math.log(10000)))
    high = math.ceil(64 * math.log(4096 / (1 * 2 * math.pi))
                     / (2 * math.log(10000)))
    assert (low, high) == (10, 23)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    got = L.yarn_frequencies(cfg, "cpu").double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[:10], extra[:10], rtol=1e-6)
    np.testing.assert_allclose(got[23:], extra[23:] / 40, rtol=1e-6)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert L.yarn_mscale(40.0) == pytest.approx(mscale)
    assert L.mla_scale(cfg) == pytest.approx(192 ** -0.5 * mscale ** 2)
    assert mscale ** 2 == pytest.approx(1.5896, abs=1e-4)
    # the rotation: YaRN's angles, cos and sin unscaled here
    x = _x((1, 5, 2, 64))
    pos = torch.arange(5)[None, :]
    ang = pos[..., None].double() * torch.from_numpy(want)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.double().chunk(2, -1)
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    torch.testing.assert_close(L.mla_rope(cfg, x, pos).double(), rot,
                               atol=1e-5, rtol=1e-5)


def test_defaults_keep_the_references_arithmetic():
    """Every registered config leaves the new fields at their defaults,
    which compute what the reference twins hold: plain RoPE and 1/sqrt(dn
    + dr) (bit for bit), renormalised top-k weights, capacity 1.25."""
    new = [f for f in dataclasses.fields(ModelConfig)
           if f.name.startswith(("yarn_", "moe_"))]
    assert len(new) == 3
    for name in PORTED_CONFIGS:
        cfg = get_config(name)
        assert all(getattr(cfg, f.name) == f.default for f in new), name
    assert (ModelConfig.moe_norm_topk_prob, ModelConfig.moe_drop_free,
            ModelConfig.yarn_factor) == (True, False, 1.0)
    cfg = reduced_config(DSV2)
    m = cfg.mla
    x = _x((2, 7, 3, m.qk_rope_head_dim))
    pos = torch.arange(3, 10)[None, :].expand(2, 7)
    assert torch.equal(L.mla_rope(cfg, x, pos),
                       L.apply_rope(x, pos, cfg.rope_theta))
    assert L.mla_scale(cfg) == 1.0 / np.sqrt(m.qk_nope_head_dim
                                             + m.qk_rope_head_dim)
    assert L.moe_capacity(48, cfg) == L.moe_capacity(48, cfg, 1.25)


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch._grouped_mm's route runs on "
                    "the card only)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N", [64, 4096])
def test_grouped_gemm_on_the_card(cuda, N):
    """DeepSeek-V2-Lite's expert widths (E 64, D 2048, Fe 1408, top-6) at
    the decode (64 tokens) and prefill (4096) shapes: the card's grouped
    GEMM against one product per expert, in bf16."""
    E, D, F, k = 64, 2048, 1408, 6
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, E, (N * k,), generator=g, device=cuda)
    ends = L.expert_counts(ids, E).cumsum(0).to(torch.int32)
    x = torch.randn(N * k, D, generator=g, device=cuda).bfloat16()
    w = (torch.randn(E, D, F, generator=g, device=cuda) * 0.02).bfloat16()
    got = L.grouped_mm(x, w, ends)
    want = torch.empty_like(got)
    lo = 0
    for e, hi in enumerate(ends.tolist()):
        want[lo:hi] = x[lo:hi] @ w[e]
        lo = hi
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
def test_grouped_moe_layer_on_the_card_does_not_sync(cuda):
    """A reduced DeepSeek-V2 MoE layer (E 8, top-2, drop-free, no renorm)
    over a decode step's 16 rows in bf16: the grouped route equals the
    dense dispatch within 2e-2, and runs with no device-to-host sync."""
    cfg = dataclasses.replace(_moe_cfg(E=8, k=2, D=256, F=128,
                                       moe_norm_topk_prob=False,
                                       moe_drop_free=True),
                              dtype="bfloat16")
    w = _weights(cfg, device=cuda, dtype=torch.bfloat16)
    x = _x((16, 1, cfg.d_model)).to(cuda, torch.bfloat16)
    dense = L.moe_apply_dense(cfg, w, x)[0]
    L.moe_apply(cfg, w, x, impl="grouped")          # warm: no first-call
    torch.cuda.synchronize()                        # allocations in sight
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = L.moe_apply(cfg, w, x, impl="grouped")[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(got.float(), dense.float(), atol=2e-2,
                               rtol=2e-2)
