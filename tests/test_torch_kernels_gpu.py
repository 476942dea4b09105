"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports no JAX, so it runs on a GPU
machine that has none:

    python -m pytest -q --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: similarity scores within 1e-5 with identical indices, counts,
``last_used`` and ``freq``; paged attention 1e-5 in fp32 and 2e-2 in bf16
(the plain version rounds logits and probabilities to bf16, the kernel
keeps fp32), compared on rows that see at least one key; rows that see
none are checked against the kernels' own conventions.  The IVF-PQ probe
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
