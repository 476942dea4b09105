"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports no JAX, so it runs on a GPU
machine that has none:

    python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: similarity scores within 1e-5 with identical indices, counts,
``last_used`` and ``freq``; paged attention 1e-5 in fp32 and 2e-2 in bf16
(the plain version rounds logits and probabilities to bf16, the kernel
keeps fp32), compared on rows that see at least one key; rows that see
none are checked against the kernels' own conventions.  Flash attention
(K8) and flash-decode (K7) 1e-5 in fp32 and 2e-2 in bf16 (both versions
keep fp32 softmax and PV; bf16 inputs, sums in another order, and the
output rounded to bf16); a decode row with kv_len 0 is exact zeros in the
kernel (the plain version averages V).  The IVF-PQ probe
sums its scores in another order than the plain version (a lookup table
per subspace): scores within 1e-4; probed lists and indices equal except
on rows whose plain scores lie closer than 1e-5, but not equal, where the
order is decided.  Its inputs and that check are ``chip_smoke.py``'s, so
the smoke run and these tests hold the kernel to one rule.
"""
import pytest
import torch

from chip_smoke import ivf_inputs, ivf_pq_check
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ivf_pq import ivf_pq_probe
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.similarity import (similarity_lookup,
                                            similarity_topk,
                                            similarity_topk_batched,
                                            similarity_topk_touch)

INVALID = 2 ** 30
pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _sim(gen, N, Q, C, D, case):
    keys = torch.randn(N, C, D, generator=gen, device="cuda")
    keys = keys / keys.norm(dim=-1, keepdim=True)
    valid = torch.rand(N, C, generator=gen, device="cuda") < (
        0.0 if case == "all_invalid" else 0.6 if case == "partly" else 1.1)
    if case == "duplicate":
        keys[:, C // 2:2 * (C // 2)] = keys[:, :C // 2]
    pick = torch.randint(0, C, (N, Q), generator=gen, device="cuda")
    q = torch.gather(keys, 1, pick[..., None].expand(N, Q, D)) + 0.05 * \
        torch.randn(N, Q, D, generator=gen, device="cuda")
    return (q / q.norm(dim=-1, keepdim=True)).contiguous(), keys, valid


CASES = ("random", "duplicate", "partly", "all_invalid")


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("N,Q,C,D", [(1, 16, 512, 2048), (3, 5, 37, 24),
                                     (2, 33, 300, 256)])
def test_topk_batched(gen, N, Q, C, D, case, k):
    if k > C:
        pytest.skip("k <= C")
    q, keys, valid = _sim(gen, N, Q, C, D, case)
    n0 = LAUNCHES["similarity_topk_batched"]
    ci, cs = similarity_topk_batched(q, keys, valid, k)
    assert LAUNCHES["similarity_topk_batched"] == n0 + 1
    ri, rs = similarity_topk_batched(q, keys, valid, k, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(ci, ri)
    torch.testing.assert_close(cs, rs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("Q,C,D", [(1, 2048, 2048), (16, 2048, 2048),
                                   (5, 37, 24)])
def test_topk_single(gen, Q, C, D, case, k):
    """K4, the single-matrix top-k (its own C entry and counter)."""
    q, keys, valid = _sim(gen, 1, Q, C, D, case)
    n0 = LAUNCHES["similarity_topk"]
    ci, cs = similarity_topk(q[0], keys[0], valid[0], k)
    assert LAUNCHES["similarity_topk"] == n0 + 1
    ri, rs = similarity_topk(q[0], keys[0], valid[0], k, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(ci, ri)
    torch.testing.assert_close(cs, rs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 4])
def test_topk_batched_shared_keys(gen, k):
    """Groups probing one shared key matrix under their own masks (the
    digest board) equal the same probe over a per-group copy."""
    q, keys, _ = _sim(gen, 3, 7, 40, 32, "duplicate")
    valid = torch.rand(3, 40, generator=gen, device="cuda") < 0.7
    ci, cs = similarity_topk_batched(q, keys[0], valid, k)
    ri, rs = similarity_topk_batched(q, keys[0].expand(3, 40, 32), valid, k,
                                     impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(ci, ri)
    torch.testing.assert_close(cs, rs, atol=1e-5, rtol=0)


def _planted_ties(keys, q, pairs):
    """Copy key a onto key b for each (a, b) in ``pairs``, and make query i
    equal to key a of pair i: its best slots tie exactly."""
    for i, (a, b) in enumerate(pairs):
        keys[:, b] = keys[:, a]
        q[:, i] = keys[:, a]


@pytest.mark.parametrize("k", [1, 2, 16, 32])
@pytest.mark.parametrize("N,Q,C,D", [
    (1, 3, 5, 64),          # C below one key tile
    (2, 40, 37, 24),        # Q above one block's query chunk, ragged C
    (1, 16, 300, 256),      # ragged last tile; k above a tile's rows
    (1, 16, 100, 7),        # D % 4 != 0 (the 4-byte load path)
])
def test_topk_batched_tiles(gen, N, Q, C, D, k):
    """The score pass over key tiles and the merge of their partial lists:
    tiles with fewer rows than k, a ragged last tile, more queries than a
    block holds, and exact ties whose copies lie in different tiles (and
    straddle a tile boundary): the lower index must win."""
    if k > C:
        pytest.skip("k <= C")
    q, keys, valid = _sim(gen, N, Q, C, D, "partly")
    pairs = [(a, b) for a, b in ((0, C - 1), (7, 8), (3, 70), (1, 2))
             if b < C][:Q]
    _planted_ties(keys, q, pairs)
    ci, cs = similarity_topk_batched(q, keys, valid, k)
    ri, rs = similarity_topk_batched(q, keys, valid, k, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(ci, ri)
    torch.testing.assert_close(cs, rs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("D", [60000, 60002])
def test_topk_batched_wide_rows(gen, D):
    """Rows wider than a block's shared memory held (60000 fp32 values):
    the score pass stages queries in slices, so any D works."""
    q, keys, valid = _sim(gen, 1, 4, 40, D, "duplicate")
    ci, cs = similarity_topk_batched(q, keys, valid, 4)
    ri, rs = similarity_topk_batched(q, keys, valid, 4, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(ci, ri)
    torch.testing.assert_close(cs, rs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 4, 32])
def test_topk_batched_shared_keys_groups(gen, k):
    """The digest board: N = 3 groups, 40 queries each (the flat query
    chunks straddle groups), one shared key matrix under three different
    valid rows, exact ties across tiles."""
    q, keys, _ = _sim(gen, 3, 40, 90, 64, "random")
    _planted_ties(keys, q, [(0, 89), (7, 8), (3, 70)])
    valid = torch.rand(3, 90, generator=gen, device="cuda") < torch.tensor(
        [[0.9], [0.5], [0.2]], device="cuda")
    ci, cs = similarity_topk_batched(q, keys[0], valid, k)
    ri, rs = similarity_topk_batched(q, keys[0].expand(3, 90, 64), valid, k,
                                     impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(ci, ri)
    torch.testing.assert_close(cs, rs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_lookup(gen, case):
    q, keys, valid = _sim(gen, 1, 16, 300, 256, case)
    ci, cs = similarity_lookup(q[0], keys[0], valid[0])
    ri, rs = similarity_lookup(q[0], keys[0], valid[0], impl="ref")
    torch.cuda.synchronize()
    if case == "all_invalid":          # the kernel's convention: idx 0, -1e30
        assert bool((ci == 0).all()) and bool((cs == -1e30).all())
        return
    assert torch.equal(ci, ri)
    torch.testing.assert_close(cs, rs, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("case", CASES)
def test_topk_touch(gen, case, k):
    C = 300
    q, keys, valid = _sim(gen, 1, 16, C, 256, case)
    q[0, 3] = q[0, 2]                  # two winners on one slot accumulate
    lu = torch.randint(0, 50, (C,), generator=gen, device="cuda",
                       dtype=torch.int32)
    fr = torch.randint(0, 5, (C,), generator=gen, device="cuda",
                       dtype=torch.int32)
    mask = torch.rand(16, generator=gen, device="cuda") < 0.7
    clock = torch.tensor(60, dtype=torch.int32, device="cuda")
    args = (q[0], keys[0], valid[0], k, lu, fr, clock)
    # queries sit at cosine ~0.78 from their key (noise 0.05 per dim at
    # D=256): a threshold of 0.5 makes the masked-in rows touch
    out = similarity_topk_touch(*args, threshold=0.5, mask=mask)
    ref = similarity_topk_touch(*args, threshold=0.5, mask=mask, impl="ref")
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            assert torch.equal(a, b)
    assert bool((out[3] != fr).any()) == (case != "all_invalid")


def test_topk_touch_duplicate_winners(gen):
    """40 queries (three query chunks) over few slots: many queries win the
    same slot, and their freq adds and last_used maxes all land."""
    C = 20
    q, keys, valid = _sim(gen, 1, 40, C, 128, "random")
    q[0, 20:] = q[0, :20]
    lu = torch.randint(0, 50, (C,), generator=gen, device="cuda",
                       dtype=torch.int32)
    fr = torch.randint(0, 5, (C,), generator=gen, device="cuda",
                       dtype=torch.int32)
    mask = torch.rand(40, generator=gen, device="cuda") < 0.8
    clock = torch.tensor(70, dtype=torch.int32, device="cuda")
    args = (q[0], keys[0], valid[0], 2, lu, fr, clock)
    out = similarity_topk_touch(*args, threshold=0.5, mask=mask)
    ref = similarity_topk_touch(*args, threshold=0.5, mask=mask, impl="ref")
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            assert torch.equal(a, b)
    assert int((out[3] - fr).max()) >= 2       # a slot won twice or more


def test_topk_side_stream(gen):
    """The wrappers launch on the current stream, each stream with its own
    workspace: calls on a side stream, between calls on the default one,
    equal the plain version."""
    q, keys, valid = _sim(gen, 2, 9, 300, 256, "partly")
    side = torch.cuda.Stream()
    ref = similarity_topk_batched(q, keys, valid, 4, impl="ref")
    similarity_topk_batched(q, keys, valid, 4)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = similarity_topk_batched(q, keys, valid, 4)
        single = similarity_topk(q[0], keys[0], valid[0], 4)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(out[0], ref[0]) and torch.equal(single[0], ref[0][0])
    torch.testing.assert_close(out[1], ref[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("Q", [0, 5, 40])
def test_topk_touch_leaves_inputs(gen, Q):
    """The op is functional: the kernel copies last_used and freq into new
    tensors and touches those; the inputs keep their values, and with no
    query the results equal them."""
    C = 50
    q, keys, valid = _sim(gen, 1, max(Q, 1), C, 64, "random")
    q = q[:, :Q].contiguous()
    lu = torch.randint(0, 50, (C,), generator=gen, device="cuda",
                       dtype=torch.int32)
    fr = torch.randint(0, 5, (C,), generator=gen, device="cuda",
                       dtype=torch.int32)
    lu0, fr0 = lu.clone(), fr.clone()
    clock = torch.tensor(80, dtype=torch.int32, device="cuda")
    args = (q[0], keys[0], valid[0], 1, lu, fr, clock)
    out = similarity_topk_touch(*args, threshold=0.5)
    ref = similarity_topk_touch(*args, threshold=0.5, impl="ref")
    torch.cuda.synchronize()
    assert torch.equal(lu, lu0) and torch.equal(fr, fr0)
    assert out[2].data_ptr() != lu.data_ptr()
    assert out[3].data_ptr() != fr.data_ptr()
    for a, b in zip(out, ref):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            assert torch.equal(a, b)


def _paged(gen, C, G, D, dtype, B=5, K=2, page=16, n_pages=6):
    P = B * n_pages
    H = K * G
    q = 0.5 * torch.randn(B, C, H, D, generator=gen, device="cuda")
    kp = 0.5 * torch.randn(P, page, K, D, generator=gen, device="cuda")
    vp = torch.randn(P, page, K, D, generator=gen, device="cuda")
    lens = [min(n, n_pages * page - C) for n in (20, 33, 0, 57, 0)]
    bt = torch.full((B, n_pages), INVALID, dtype=torch.int32, device="cuda")
    perm = torch.randperm(P, generator=gen, device="cuda").int()
    for b in range(B - 1):             # the last row is idle
        mapped = -(-(lens[b] + C) // page)
        bt[b, :mapped] = perm[b * n_pages:b * n_pages + mapped]
    bt[1, :1] = bt[0, :1]              # a shared page
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return [t.to(dtype) for t in (q, kp, vp)] + [bt, ln]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("C", [1, 8, 40])
def test_paged_attention(gen, C, G, D, dtype):
    q, kp, vp, bt, ln = _paged(gen, C, G, D, dtype)
    n0 = LAUNCHES["paged_attention"]
    out = paged_attention(q, kp, vp, bt, ln)
    assert LAUNCHES["paged_attention"] == n0 + 1
    ref = paged_attention(q, kp, vp, bt, ln, impl="ref")
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out[:4].float(), ref[:4].float(), atol=tol,
                               rtol=0)
    assert int(torch.count_nonzero(out[4])) == 0   # idle row: exact zeros


TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _paged_rows(gen, lens, C, G, D, dtype, K=2, page=16, n_pages=32,
                idle=()):
    """One row per entry of ``lens``: a row maps the pages its chunk can
    see, in a random order; rows listed in ``idle`` have an all-INVALID
    table (an idle decode slot or a pad row of a prefill chunk)."""
    B = len(lens)
    P = B * n_pages
    q = 0.5 * torch.randn(B, C, K * G, D, generator=gen, device="cuda")
    kp = 0.5 * torch.randn(P, page, K, D, generator=gen, device="cuda")
    vp = torch.randn(P, page, K, D, generator=gen, device="cuda")
    bt = torch.full((B, n_pages), INVALID, dtype=torch.int32, device="cuda")
    perm = torch.randperm(P, generator=gen, device="cuda").int()
    for b, n in enumerate(lens):
        if b not in idle:
            mapped = -(-(n + C) // page)
            bt[b, :mapped] = perm[b * n_pages:b * n_pages + mapped]
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return [t.to(dtype) for t in (q, kp, vp)] + [bt, ln]


def _paged_check(q, kp, vp, bt, ln, idle=(), ref_args=None):
    """One launch against the plain version (on ``ref_args`` when given)
    at the dtype's tolerance; rows in ``idle`` are exact zeros."""
    n0 = LAUNCHES["paged_attention"]
    out = paged_attention(q, kp, vp, bt, ln)
    assert LAUNCHES["paged_attention"] == n0 + 1
    ref = paged_attention(*(ref_args or (q, kp, vp, bt, ln)), impl="ref")
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    live = [b for b in range(q.shape[0]) if b not in idle]
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=TOL[q.dtype], rtol=0)
    for b in idle:
        assert int(torch.count_nonzero(out[b])) == 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("C", [1, 4, 40])
def test_paged_attention_split_edges(gen, C, G, dtype):
    """Rows whose last visible key ends a 64-key split exactly (keys 0..63,
    0..127) and rows one key past it (0..64, 0..128), beside an idle row;
    the rows share their first page."""
    lens = [64 - C, 65 - C, 128 - C, 129 - C, 0]
    q, kp, vp, bt, ln = _paged_rows(gen, lens, C, G, 64, dtype, idle=(4,))
    bt[1:4, 0] = bt[0, 0]              # a page shared by four rows
    _paged_check(q, kp, vp, bt, ln, idle=(4,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 128])
def test_paged_attention_invalid_mid_table(gen, C, dtype):
    """An INVALID entry in the middle of a row's table (slot 1, whose keys
    16..31 all lie before the row's first query) is skipped, as the TPU
    kernel skips it: the same as the plain version over the table without
    that slot (later slots shift left) and the length one page shorter."""
    page = 16
    q, kp, vp, bt, ln = _paged_rows(gen, [40, 200, 0], C, 4, 64, dtype,
                                    page=page, idle=(2,))
    ref_bt = bt.clone()
    ref_ln = ln.clone()
    for b in (0, 1):
        ref_bt[b, 1:-1] = bt[b, 2:].clone()
        ref_bt[b, -1] = INVALID
        ref_ln[b] -= page
        bt[b, 1] = INVALID
    _paged_check(q, kp, vp, bt, ln, idle=(2,),
                 ref_args=(q, kp, vp, ref_bt, ref_ln))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [0, 15, 16, 17, 300])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_paged_attention_serve_chunk(gen, D, length, dtype):
    """A prefill chunk as the serve path issues it with one mid-prefill
    row: B = 1, C = 128, G = 4, starting on and beside page and tile
    boundaries."""
    q, kp, vp, bt, ln = _paged_rows(gen, [length], 128, 4, D, dtype, K=8)
    _paged_check(q, kp, vp, bt, ln)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_ragged_rows_and_pad_row(gen, dtype):
    """C = 40, G = 1: 40 query rows, not a multiple of a 64-row tile; then
    a B = 2 chunk whose second row is a pad row (all-INVALID table)."""
    q, kp, vp, bt, ln = _paged_rows(gen, [23, 90], 40, 1, 64, dtype)
    _paged_check(q, kp, vp, bt, ln)
    q, kp, vp, bt, ln = _paged_rows(gen, [37, 0], 128, 4, 64, dtype, K=8,
                                    idle=(1,))
    _paged_check(q, kp, vp, bt, ln, idle=(1,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C", [(8, 1), (1, 128), (8, 128)])
def test_paged_attention_run_to_run(gen, B, C, dtype):
    """Two launches on the same inputs give bit-equal outputs: the splits
    merge in a fixed order, with no atomics."""
    lens = [64, 96, 200, 300, 131, 17, 40, 0][:B] if B > 1 else [128]
    q, kp, vp, bt, ln = _paged_rows(gen, lens, C, 4, 64, dtype, K=8)
    a = paged_attention(q, kp, vp, bt, ln)
    b = paged_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _flash(gen, B, S, H, K, D, dtype):
    return [torch.randn(B, S, n, D, generator=gen, device="cuda").to(dtype)
            for n in (H, K, K)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 120, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("S,window", [(1, 0), (77, 0), (77, 20),
                                      (200, 64), (300, 0)])
def test_flash_attention(gen, S, window, G, D, dtype):
    """K8: ragged S (no multiple of the row or key tile), the window band
    and causal tile skipping, GQA groups of 1, 4 and 8; bf16 runs on the
    tensor-core kernel, fp32 on the FMA kernel."""
    q, k, v = _flash(gen, 2, S, 2 * G, 2, D, dtype)
    n0 = LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=window)
    assert LAUNCHES["flash_attention"] == n0 + 1
    ref = flash_attention(q, k, v, window=window, impl="ref")
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("window", [0, 30])
def test_flash_attention_non_causal(gen, window):
    q, k, v = _flash(gen, 1, 150, 8, 2, 64, torch.float32)
    out = flash_attention(q, k, v, causal=False, window=window)
    ref = flash_attention(q, k, v, causal=False, window=window, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("window", [0, 30])
def test_flash_attention_non_causal_bf16(gen, window):
    """The non-causal mode on the tensor-core route."""
    q, k, v = _flash(gen, 1, 150, 8, 2, 64, torch.bfloat16)
    out = flash_attention(q, k, v, causal=False, window=window)
    ref = flash_attention(q, k, v, causal=False, window=window, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [15, 16, 17, 4608])
def test_flash_attention_swa_shapes(gen, S, dtype):
    """h2o-danube3-4b's attention (H = 32, K = 8, head_dim 120, padded to
    128 in shared memory) under its 4096-key window: lengths around a
    16-row fragment and the path's long prompt, past the window."""
    q, k, v = _flash(gen, 1, S, 32, 8, 120, dtype)
    out = flash_attention(q, k, v, window=4096)
    ref = flash_attention(q, k, v, window=4096, impl="ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)


def _bf16_steps(out, ref):
    """The largest |out - ref| in bf16 steps at the larger magnitude."""
    a, b = out.float(), ref.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8))
                 .max())


@pytest.mark.parametrize("route", ["tensor_cores", "fma"])
@pytest.mark.parametrize("S,G,D", [(17, 4, 120), (300, 1, 64),
                                   (4608, 4, 120)])
def test_flash_attention_bf16_v_in_4_8(gen, S, G, D, route):
    """V drawn from [4, 8), so every output lies in [4, 8), where one bf16
    step is 2^-5, more than the 2e-2 the other bf16 cases hold to: each
    output within one bf16 step of the plain version's, on the
    tensor-core route (bf16 inputs) and on the FMA route (the same inputs
    widened to fp32, the output rounded to bf16)."""
    q, k, _ = _flash(gen, 1, S, 8 * G, 8, D, torch.bfloat16)
    v = (4 + 4 * torch.rand(k.shape, generator=gen, device="cuda")).to(
        torch.bfloat16)
    ref = flash_attention(q, k, v, window=4096, impl="ref")
    if route == "fma":
        out = flash_attention(q.float(), k.float(), v.float(),
                              window=4096).to(torch.bfloat16)
    else:
        out = flash_attention(q, k, v, window=4096)
    torch.cuda.synchronize()
    assert float(ref.float().min()) >= 4
    assert _bf16_steps(out, ref) <= 1


def _decode(gen, B, S, H, K, D, dtype, lens):
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, K, D, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 120, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("lens", [(1, 1, 1), (1, 300, 599), (600, 600, 600)])
def test_decode_attention(gen, lens, G, D, dtype):
    """K7 over a 600-slot cache (three splits, the last ragged): kv_len 1,
    ragged and full."""
    q, k, v, kv_len = _decode(gen, 3, 600, 2 * G, 2, D, dtype, lens)
    n0 = LAUNCHES["decode_attention"]
    out = decode_attention(q, k, v, kv_len)
    assert LAUNCHES["decode_attention"] == n0 + 1
    ref = decode_attention(q, k, v, kv_len, impl="ref")
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=0)


def test_decode_attention_empty_row_is_zeros(gen):
    q, k, v, kv_len = _decode(gen, 2, 100, 8, 2, 64, torch.float32, (0, 37))
    out = decode_attention(q, k, v, kv_len)
    ref = decode_attention(q, k, v, kv_len, impl="ref")
    torch.cuda.synchronize()
    assert int(torch.count_nonzero(out[0])) == 0    # the kernel's convention
    torch.testing.assert_close(out[1], ref[1], atol=1e-5, rtol=0)


def test_attention_wrappers_reject_bad_inputs(gen):
    q, k, v = _flash(gen, 1, 8, 4, 2, 20, torch.float32)
    with pytest.raises(ValueError):                # head_dim % 8 != 0
        flash_attention(q, k, v)
    q, k, v = _flash(gen, 1, 8, 4, 2, 136, torch.float32)
    with pytest.raises(ValueError):                # head_dim above 128
        flash_attention(q, k, v)
    q, k, v, kv_len = _decode(gen, 1, 8, 34, 2, 64, torch.float32, (8,))
    with pytest.raises(ValueError):                # 17 heads per KV head
        decode_attention(q, k, v, kv_len)
    q, k, v, kv_len = _decode(gen, 1, 8, 4, 2, 64, torch.float32, (8,))
    with pytest.raises(TypeError):                 # mixed dtypes
        decode_attention(q, k.bfloat16(), v, kv_len)


def test_wrappers_reject_bad_inputs(gen):
    q, kp, vp, bt, ln = _paged(gen, 1, 4, 64, torch.float32)
    with pytest.raises(TypeError):                 # mixed dtypes
        paged_attention(q, kp.bfloat16(), vp, bt, ln)
    with pytest.raises(ValueError):                # head_dim above 128
        big = torch.zeros(5, 1, 8, 256, device="cuda")
        pool = torch.zeros(30, 16, 2, 256, device="cuda")
        paged_attention(big, pool, pool, bt, ln)
    qs, keys, valid = _sim(gen, 1, 4, 40, 16, "random")
    with pytest.raises(ValueError):                # k above the kernel's 32
        similarity_topk_batched(qs, keys, valid, 33)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("Q,L,cap,S,D,n_probe", [
    (8, 16, 24, 4, 64, 4), (5, 64, 40, 8, 256, 16), (3, 8, 8, 2, 16, 8)])
def test_ivf_pq_probe(gen, Q, L, cap, S, D, n_probe, k):
    """K6 against its plain version, by the smoke run's own check: query 0
    is candidate-free (indices 0..k-1 at -1e30, as lax.top_k gives over the
    masked row) and the last query's best two slots tie exactly (lower
    index first)."""
    args, twin = ivf_inputs(torch, gen, Q, L, cap, S, D, n_probe)
    n0 = LAUNCHES["ivf_pq_probe"]
    out = ivf_pq_probe(*args, k=k, n_probe=n_probe)
    assert LAUNCHES["ivf_pq_probe"] == n0 + 1
    torch.cuda.synchronize()
    ivf_pq_check(torch, args, twin, k, n_probe, out)


def test_ivf_pq_probe_refuses_oversized_shared_memory(gen):
    """The C entry owns the shared-memory layout: 60000 coarse scores do not
    fit a block, and the launch error is raised, nothing launched."""
    args, _ = ivf_inputs(torch, gen, 2, 60000, 2, 2, 8, 2)
    n0 = LAUNCHES["ivf_pq_probe"]
    with pytest.raises(RuntimeError, match="ivf_pq_probe"):
        ivf_pq_probe(*args, k=1, n_probe=2)
    assert LAUNCHES["ivf_pq_probe"] == n0
