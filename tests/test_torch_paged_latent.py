"""The absorbed MLA decode over the paged latent (port only; no JAX, so the
card can run the ``gpu`` cases).

CPU: the plain version (``kernels/paged_latent/ref.py``) with w_uk folded
into the query and w_uv into the output, against ``layers.mla_attention``'s
expanded form over the same keys, fp32, with the latent scattered over the
pool's pages: visible counts 1, 15, 16, 17 and the table's whole width at
pages of 16, under YaRN x40 too; a row whose table maps no page gives exact
zeros.  ``DecoderLM.decode_step`` at the reduced DeepSeek-V2-Lite (r 32,
dr 8, 4 heads) reads the same logits through ``attn_impl="ref"`` (the
absorbed route) as through ``"gather"`` (the expanded one), expands
nothing, and counts its (row, visible key) pairs in ``mla_absorbed``.

Card (``-m gpu``): the kernel against its plain version in bf16 at the
cell's decode shape (64 rows of 16 heads, r 512, dr 64, 260-page tables,
1-4160 keys, idle rows) and at the tiny one, and in fp32; DeepSeek-V2-Lite
whole (27 layers, bf16): a decode step through the kernel against the
gathered, expanded route, 27 launches a step; the wrapper's refusals.

    python -m pytest -q --noconftest -m gpu tests/test_torch_paged_latent.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.paged_attention import paged_gather_view
from repro_torch.kernels.paged_latent import paged_latent, paged_latent_ref
from repro_torch.kernels.paged_latent.kernel import paged_latent_cuda
from repro_torch.models import build_model
from repro_torch.models import layers as L

PAGE, N_PAGES, P = 16, 3, 12          # tables of 48 keys over 12 pages
WIDTH = PAGE * N_PAGES


def _model(yarn_factor=1.0, device="cpu", dtype="float32", full=False):
    """The reduced DeepSeek-V2-Lite, or (``full``) the whole one as the
    benchmark's cell runs it: YaRN, top-6 unrenormalised, drop-free."""
    cfg = get_config("deepseek-v2-lite-16b")
    if full:
        cfg = dataclasses.replace(cfg, moe_norm_topk_prob=False,
                                  moe_drop_free=True, norm_eps=1e-6)
    else:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, dtype=dtype, yarn_factor=yarn_factor)
    return build_model(cfg, device=device,
                       generator=torch.Generator(device=device).manual_seed(0))


def _tables(B, gen, n_pages=N_PAGES, pool=P):
    """Each row's pages, drawn without repeat from the pool."""
    return torch.randperm(pool, generator=gen)[:B * n_pages].reshape(
        B, n_pages).to(torch.int32)


def _absorbed(cfg, blk, x, positions, ckv, krope, bt, n_vis):
    """The absorbed layer: q_lat = q_nope w_uk, the plain version, then
    w_uv and wo."""
    dn = cfg.mla.qk_nope_head_dim
    q = torch.einsum("bsd,dhe->bshe", x, blk.wq)
    q_rope = L.mla_rope(cfg, q[..., dn:], positions)[:, 0]
    q_lat = torch.einsum("bhe,rhe->bhr", q[:, 0, :, :dn], blk.w_uk)
    o = paged_latent_ref(q_lat, q_rope, ckv, krope, bt, n_vis,
                         L.mla_scale(cfg))
    attn = torch.einsum("bhr,rhe->bhe", o, blk.w_uv)
    return torch.einsum("bhe,hed->bd", attn, blk.wo)


@pytest.mark.parametrize("yarn_factor", [1.0, 40.0])
@pytest.mark.parametrize("n", [1, 15, 16, 17, WIDTH])
def test_plain_absorbed_matches_expanded(n, yarn_factor):
    model = _model(yarn_factor)
    cfg, blk = model.cfg, model.layers[0]
    r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    gen = torch.Generator().manual_seed(n)
    B = 3
    bt = _tables(B, gen)
    ckv = torch.randn(P, PAGE, r, generator=gen)
    krope = torch.randn(P, PAGE, dr, generator=gen)
    x = torch.randn(B, 1, cfg.d_model, generator=gen)
    n_vis = torch.tensor([n, max(1, n - 1), min(WIDTH, n + 2)],
                         dtype=torch.int32)
    positions = (n_vis.long() - 1)[:, None]
    kpos = torch.arange(WIDTH)[None, None, :]
    want = L.mla_attention(cfg, blk, x, paged_gather_view(ckv, bt),
                           paged_gather_view(krope, bt), positions,
                           mask=kpos <= positions[:, :, None])[:, 0]
    got = _absorbed(cfg, blk, x, positions, ckv, krope, bt, n_vis)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_plain_row_without_a_mapped_page_gives_zeros():
    gen = torch.Generator().manual_seed(3)
    bt = _tables(3, gen)
    bt[1] = P                                    # an idle row: all INVALID
    bt[2, 1] = P                                 # a hole mid-table
    q_lat, q_rope = torch.randn(3, 4, 32), torch.randn(3, 4, 8)
    ckv, krope = torch.randn(P, PAGE, 32), torch.randn(P, PAGE, 8)
    n_vis = torch.tensor([20, 40, 40], dtype=torch.int32)
    out = paged_latent(q_lat, q_rope, ckv, krope, bt, n_vis, 0.3)
    assert torch.isfinite(out).all()
    assert (out[1] == 0).all()
    # the hole's keys are skipped: the same as the row without them
    keep = torch.cat([torch.arange(16), torch.arange(32, 40)])
    seq_ckv = paged_gather_view(ckv, bt[2:].clamp(max=P - 1))[0, keep]
    seq_kr = paged_gather_view(krope, bt[2:].clamp(max=P - 1))[0, keep]
    logits = (q_lat[2] @ seq_ckv.T + q_rope[2] @ seq_kr.T) * 0.3
    torch.testing.assert_close(out[2], logits.softmax(-1) @ seq_ckv,
                               rtol=1e-5, atol=1e-6)


def test_decode_step_absorbed_matches_gather_and_counts():
    """A paged decode step of 4 rows (visible 1, 16, 17 and an idle row
    with an all-INVALID table) through both routes: the same pool writes
    and logits on the live rows (to fp32 rounding, which the second
    layer's input already carries); the absorbed route expands nothing
    and tallies rows x visible keys x MLA layers."""
    model = _model()
    gen = torch.Generator().manual_seed(5)
    pool = {k: torch.randn(s, generator=gen).to(d)
            for k, (s, d) in model.paged_cache_specs(P, PAGE).items()}
    bt = torch.cat([_tables(3, gen), torch.full((1, N_PAGES), P,
                                                dtype=torch.int32)])
    lengths = torch.tensor([0, 15, 16, 7], dtype=torch.int32)
    tokens = torch.tensor([3, 1, 4, 1])
    n_mla = sum(b.kind == "mla" for b in model.layers)
    out = {}
    for impl in ("ref", "gather"):
        model.mla_expanded = model.mla_absorbed = 0
        cache = {k: v.clone() for k, v in pool.items()}
        logits, cache, n = model.decode_step(cache, tokens, lengths,
                                             block_table=bt, attn_impl=impl)
        out[impl] = (logits, cache, model.mla_expanded,
                     int(model.mla_absorbed))
    (la, ca, ea, aa), (lg, cg, eg, ag) = out["ref"], out["gather"]
    torch.testing.assert_close(la[:3], lg[:3], rtol=1e-4, atol=1e-5)
    for k in ca:
        torch.testing.assert_close(ca[k], cg[k], rtol=1e-4, atol=1e-5)
    assert (ea, aa) == (0, (1 + 16 + 17) * n_mla)
    assert (eg, ag) == (4 * WIDTH * n_mla, 0)


def test_wrapper_refuses_a_cpu_tensor():
    q = torch.zeros(2, 4, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_latent_cuda(q, torch.zeros(2, 4, 8), torch.zeros(P, PAGE, 32),
                          torch.zeros(P, PAGE, 8),
                          torch.zeros(2, N_PAGES, dtype=torch.int32),
                          torch.ones(2, dtype=torch.int32), 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_latent(q, torch.zeros(2, 4, 8), torch.zeros(P, PAGE, 32),
                     torch.zeros(P, PAGE, 8),
                     torch.zeros(2, N_PAGES, dtype=torch.int32),
                     torch.ones(2, dtype=torch.int32), 0.1, impl="cuda")


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU route)")
    return torch.device("cuda")


# bf16 outputs against the plain version run in fp32 on the same values:
# the tolerance the paged-attention kernel's card tests use
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _kernel_case(cuda, B, H, r, dr, n_pages, P_, n_vis, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)
    bt = torch.randperm(P_, generator=gen, device=cuda)[:B * n_pages]
    bt = bt.reshape(B, n_pages).to(torch.int32)
    return (rnd(B, H, r) * 0.1, rnd(B, H, dr) * 0.1, rnd(P_, PAGE, r),
            rnd(P_, PAGE, dr), bt, n_vis.to(cuda, torch.int32))


def _hold(args, scale, live):
    n0 = LAUNCHES["paged_latent"]
    out = paged_latent(*args, scale)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_latent"] == n0 + 1
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ref = paged_latent(*wide, scale, impl="ref")
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[live].float(), ref[live],
                               atol=TOL[out.dtype], rtol=0)
    assert (out[~live] == 0).all()              # rows that see no key


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_at_the_cells_decode_shape(cuda, dtype):
    """64 rows, 16 heads, r 512, dr 64, tables of 260 pages of 16 in a
    pool of 16640, visible counts from 1 to 4160; rows 5 and 40 idle."""
    B, n_pages = 64, 260
    gen = torch.Generator().manual_seed(1)
    n_vis = torch.randint(1, n_pages * PAGE + 1, (B,), generator=gen)
    n_vis[:4] = torch.tensor([1, 16, 17, n_pages * PAGE])
    args = _kernel_case(cuda, B, 16, 512, 64, n_pages, 16640, n_vis, dtype)
    args[4][[5, 40]] = 16640
    live = torch.ones(B, dtype=torch.bool, device=cuda)
    live[[5, 40]] = False
    _hold(args, L.mla_scale(get_config("deepseek-v2-lite-16b")), live)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H", [(3, 4), (2, 20)])
def test_kernel_at_the_tiny_shape(cuda, B, H, dtype):
    """r 32, dr 8 (a k-tile padded from 40 to 48); 20 heads take two head
    groups; one row with a hole mid-table."""
    n_vis = torch.tensor([1, 17, 48][:B])
    args = _kernel_case(cuda, B, H, 32, 8, N_PAGES, P, n_vis, dtype)
    args[4][B - 1, 1] = P
    _hold(args, 0.25, torch.ones(B, dtype=torch.bool, device=cuda))


@pytest.mark.gpu
def test_wrapper_refuses_what_it_does_not_take(cuda):
    n_vis = torch.tensor([5, 9])
    q, qr, ckv, kr, bt, nv = _kernel_case(cuda, 2, 16, 512, 64, 4, 16, n_vis,
                                          torch.bfloat16)
    with pytest.raises(ValueError, match="r=520"):
        paged_latent_cuda(torch.zeros(2, 16, 520, device=cuda,
                                      dtype=torch.bfloat16), qr,
                          torch.zeros(16, PAGE, 520, device=cuda,
                                      dtype=torch.bfloat16), kr, bt, nv, 0.1)
    with pytest.raises(ValueError, match="dr=12"):
        paged_latent_cuda(q, qr[..., :12].contiguous(), ckv,
                          kr[..., :12].contiguous(), bt, nv, 0.1)
    with pytest.raises(TypeError, match="float16"):
        paged_latent_cuda(q.half(), qr.half(), ckv.half(), kr.half(), bt, nv,
                          0.1)
    with pytest.raises(TypeError, match="int32"):
        paged_latent_cuda(q, qr, ckv, kr, bt.long(), nv, 0.1)
    with pytest.raises(ValueError, match="shape"):
        paged_latent_cuda(q, qr, ckv, kr, bt[:1], nv, 0.1)


@pytest.mark.gpu
def test_deepseek_v2_lite_decode_through_the_kernel(cuda):
    """DeepSeek-V2-Lite whole (27 layers, bf16, random weights, as the
    cell configures it): 8 rows
    prefilled in paged chunks of 512 to 1-2048 tokens, then a decode step
    through the kernel (27 launches) against the gathered, expanded route
    on the same pool: each row's served token lies within the cell's
    ``served_gap_max`` (0.8) of the expanded route's best logit."""
    model = _model(40.0, device="cuda", dtype="bfloat16", full=True)
    B, n_pages, P_ = 8, 128, 1024
    gen = torch.Generator().manual_seed(2)
    lens = torch.tensor([1, 16, 17, 300, 511, 1000, 1600, 2047])
    bt = torch.randperm(P_, generator=gen)[:B * n_pages].reshape(
        B, n_pages).to(torch.int32).to(cuda)
    pool = {k: torch.zeros(s, dtype=d, device=cuda)
            for k, (s, d) in model.paged_cache_specs(P_, PAGE).items()}
    V = model.cfg.vocab_size
    lengths = torch.zeros(B, dtype=torch.int32, device=cuda)
    for c0 in range(0, int(lens.max()), 512):
        widths = (lens - c0).clamp(0, 512).to(torch.int32).to(cuda)
        toks = torch.randint(0, V, (B, 512), generator=gen).to(cuda)
        _, pool, lengths = model.prefill_chunk(
            toks, pool, lengths, widths, block_table=bt, attn_impl="auto")
    assert lengths.tolist() == lens.tolist()
    tokens = torch.randint(0, V, (B,), generator=gen).to(cuda)
    got = {}
    for impl in ("auto", "gather"):
        cache = {k: v.clone() for k, v in pool.items()}
        n0 = LAUNCHES["paged_latent"]
        logits, _, _ = model.decode_step(cache, tokens, lengths,
                                         block_table=bt, attn_impl=impl)
        torch.cuda.synchronize()
        got[impl] = (logits.float(), LAUNCHES["paged_latent"] - n0)
    (la, na), (lg, ng) = got["auto"], got["gather"]
    assert (na, ng) == (27, 0)
    assert torch.isfinite(la).all()
    served = la.argmax(-1)
    gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
    assert float(gap.max()) <= 0.8, gap.tolist()
