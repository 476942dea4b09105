#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

  1. build   — compile every CUDA kernel from ``src/repro_torch/csrc`` with
               nvcc for sm_90a (all sources at once) and load them;
  2. kernels — each kernel against its plain PyTorch version at the main
               path's shapes (f32, and bf16 where it takes bf16), plus the
               kernels' own conventions on empty rows; times the kernel,
               the plain version and a one-call PyTorch yardstick;
  3. serve   — the main path at full width: llama3.2-1b (random weights
               from a seed, bf16) behind the CoIC edge cache in
               ``ServingEngine`` (paged KV, paged attention), two waves of
               requests, then the edge cache's own lookup API (fused and
               unfused).  The kernels' launch counters are zeroed just
               before and read just after: every kernel must have run;
  4. e2e     — coic-paper in fp32 (TF32 off) through the kernel path
               (attn_impl="paged") and the plain path ("gather"): decoded
               tokens and sources must be identical.

Then it prints the card (nvidia-smi name, power limit) before the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
It exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM, data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITERS = 50


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    kernels = phase_kernels(torch)
    launches, serve = phase_serve(torch)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main "
                                 "path")
    phase_e2e(torch)
    for k in kernels:
        k["launches_per_request"] = k["launches"] / serve["completed"]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


class Timer:
    """Mean ms of one call over ``ITERS`` calls, each timed with CUDA
    events after a write of 64 MiB that evicts the 50 MB L2 (the main path
    finds the cache keys and KV pages cold between steps)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(16 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(ITERS)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / ITERS


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True)


def sim_inputs(torch, g, N, Q, C, D, case, dev="cuda"):
    """Unit keys; queries near cached keys; ``duplicate`` copies half the
    keys (exact ties), ``all_invalid`` masks every slot."""
    keys = _unit(torch.randn(N, C, D, generator=g, device=dev))
    valid = torch.ones(N, C, dtype=torch.bool, device=dev)
    if case == "duplicate":
        keys[:, C // 2:2 * (C // 2)] = keys[:, :C // 2]
    if case == "all_invalid":
        valid[:] = False
    if case == "partly_invalid":
        valid = torch.rand(N, C, generator=g, device=dev) < 0.5
    pick = torch.randint(0, C, (N, Q), generator=g, device=dev)
    q = _unit(torch.gather(keys, 1, pick[..., None].expand(N, Q, D))
              + 0.05 * torch.randn(N, Q, D, generator=g, device=dev))
    if case == "duplicate":
        q[:, 0] = keys[:, 0]
    return q.contiguous(), keys.contiguous(), valid


def phase_kernels(torch):
    from repro_torch.kernels import build_all
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.similarity import (similarity_lookup,
                                                similarity_topk_batched,
                                                similarity_topk_touch)

    t0 = time.perf_counter()
    build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)",
          flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    C, D = 512, 2048                       # the main path's edge cache
    cases = ("random", "duplicate", "partly_invalid", "all_invalid")
    err = {"similarity_topk_batched": 0.0, "similarity_lookup": 0.0,
           "similarity_topk_touch": 0.0}

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.

    for case in cases:
        for Q in (1, 16):
            q, keys, valid = sim_inputs(torch, g, 1, Q, C, D, case)
            for k in (1, 4):
                ri, rs = similarity_topk_batched(q, keys, valid, k,
                                                 impl="ref")
                ci, cs = similarity_topk_batched(q, keys, valid, k)
                torch.cuda.synchronize()
                assert torch.equal(ci, ri), ("topk_batched idx", case, Q, k)
                e = max_err(cs, rs)
                assert e <= 1e-5, ("topk_batched score", case, Q, k, e)
                err["similarity_topk_batched"] = max(
                    err["similarity_topk_batched"], e)

                lu = torch.randint(0, 50, (C,), generator=g, device="cuda",
                                   dtype=torch.int32)
                fr = torch.randint(0, 5, (C,), generator=g, device="cuda",
                                   dtype=torch.int32)
                m = torch.rand(Q, generator=g, device="cuda") < 0.7
                clk = torch.tensor(60, dtype=torch.int32, device="cuda")
                ref = similarity_topk_touch(q[0], keys[0], valid[0], k, lu,
                                            fr, clk, threshold=0.9, mask=m,
                                            impl="ref")
                out = similarity_topk_touch(q[0], keys[0], valid[0], k, lu,
                                            fr, clk, threshold=0.9, mask=m)
                torch.cuda.synchronize()
                for name, a, b in zip(("idx", "score", "last_used", "freq"),
                                      out, ref):
                    if name == "score":
                        e = max_err(a, b)
                        assert e <= 1e-5, ("touch score", case, Q, k, e)
                        err["similarity_topk_touch"] = max(
                            err["similarity_topk_touch"], e)
                    else:
                        assert torch.equal(a, b), ("touch", name, case, Q, k)
            ci, cs = similarity_lookup(q[0], keys[0], valid[0])
            ri, rs = similarity_lookup(q[0], keys[0], valid[0], impl="ref")
            torch.cuda.synchronize()
            if case == "all_invalid":
                # the kernel's own convention (the plain version says -inf)
                assert bool((ci == 0).all() and (cs == -1e30).all()), case
            else:
                assert torch.equal(ci, ri), ("lookup idx", case, Q)
                e = max_err(cs, rs)
                assert e <= 1e-5, ("lookup score", case, Q, e)
                err["similarity_lookup"] = max(err["similarity_lookup"], e)

    # timings at the main path's probe shape: N=1, Q=16, C=512, D=2048, k=1
    Q = 16
    q, keys, valid = sim_inputs(torch, g, 1, Q, C, D, "random")
    lu = torch.zeros(C, dtype=torch.int32, device="cuda")
    fr = torch.zeros(C, dtype=torch.int32, device="cuda")
    clk = torch.tensor(1, dtype=torch.int32, device="cuda")
    m = torch.ones(Q, dtype=torch.bool, device="cuda")
    in_bytes = Q * D * 4 + C * D * 4 + C
    flops = 2.0 * Q * C * D
    kt = keys[0].t().contiguous()
    kernels = []
    src = "src/repro_torch/csrc/similarity.cu"
    tpu = "src/repro/kernels/similarity/kernel.py"
    rows = [
        ("similarity_topk_batched", f"{tpu}:177",
         lambda impl: similarity_topk_batched(q, keys, valid, 1, impl=impl),
         lambda: torch.topk(torch.bmm(q, keys.transpose(1, 2)), 1),
         in_bytes + Q * 8),
        ("similarity_lookup", f"{tpu}:328",
         lambda impl: similarity_lookup(q[0], keys[0], valid[0], impl=impl),
         lambda: torch.topk(q[0] @ kt, 1),
         in_bytes + Q * 8),
        ("similarity_topk_touch", f"{tpu}:270",
         lambda impl: similarity_topk_touch(q[0], keys[0], valid[0], 1, lu,
                                            fr, clk, threshold=0.98, mask=m,
                                            impl=impl),
         lambda: torch.topk(q[0] @ kt, 1),
         in_bytes + Q * 9 + C * 4 * 2 * 2),
    ]
    for name, replaces, fn, lib, nbytes in rows:
        b_ms, b_by = bound(nbytes, flops, "float32")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0,
            "max_abs_err": err[name],
            "ms": timer(lambda: fn("auto")),
            "plain_ms": timer(lambda: fn("ref")),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(lib),
            "shape": "N=1 Q=16 C=512 D=2048 k=1 fp32"})

    kernels.append(check_paged(torch, g, timer, paged_attention))
    for k in kernels:
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}, "
              f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library "
              f"{k['library_ms']:.4f}, bound {k['bound_ms']:.5f} by "
              f"{k['bound_by']})", flush=True)
    return kernels


def paged_inputs(torch, g, C, dtype, *, B=8, H=32, K=8, D=64, page=16,
                 n_pages=32, dev="cuda"):
    """A pool with shared pages, INVALID tail entries and an idle row (the
    last), at the main path's attention shapes."""
    INVALID = 2 ** 30
    P = 2 * B * n_pages
    q = 0.5 * torch.randn(B, C, H, D, generator=g, device=dev)
    kp = 0.5 * torch.randn(P, page, K, D, generator=g, device=dev)
    vp = torch.randn(P, page, K, D, generator=g, device=dev)
    # row 0 maps >= 4 pages, which row 1 shares as its head; the last row
    # is idle (length 0, an all-INVALID table row)
    lens = [min(n, n_pages * page - C)
            for n in [64, 96, 200, 300, 131, 17, 40, 0][:B]]
    bt = torch.full((B, n_pages), INVALID, dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=g, device=dev).int()
    for b in range(B - 1):
        mapped = -(-(lens[b] + C) // page)
        bt[b, :mapped] = perm[b * n_pages:b * n_pages + mapped]
    bt[1, :4] = bt[0, :4]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return [t.to(dtype) for t in (q, kp, vp)] + [bt, lengths]


def paged_work(torch, q, kp, bt, lengths, page):
    """(bytes, flops) the paged attention call must move and do: q and
    the output once, every distinct page a row can see (K and V, every KV
    head) once, the block table and lengths; 4 * D flops per (query head,
    visible key)."""
    B, C, H, D = q.shape
    P, _, K, _ = kp.shape
    es = q.element_size()
    pages, visible = set(), 0
    for row, n in zip(bt.tolist(), lengths.tolist()):
        for j, pid in enumerate(row):
            if pid < P and j * page <= n + C - 1:
                pages.add(pid)
        if row[0] < P:                              # an idle row sees none
            visible += sum(n + c + 1 for c in range(C))
    nbytes = (2 * q.numel() * es + len(pages) * page * K * D * es * 2
              + bt.numel() * 4 + lengths.numel() * 4)
    return nbytes, 4.0 * D * H * visible


def check_paged(torch, g, timer, paged_attention):
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    worst = 0.0
    shapes = {}
    for dtype in (torch.float32, torch.bfloat16):
        for C in (1, 128):
            q, kp, vp, bt, ln = paged_inputs(torch, g, C, dtype)
            ref = paged_attention(q, kp, vp, bt, ln, impl="ref")
            out = paged_attention(q, kp, vp, bt, ln)
            torch.cuda.synchronize()
            live = slice(0, q.shape[0] - 1)         # rows that see a key
            e = float((out[live].float() - ref[live].float()).abs().max())
            assert e <= tol[dtype], ("paged_attention", dtype, C, e)
            # the kernel's own convention: a row with no visible key -> 0
            assert int(torch.count_nonzero(out[-1])) == 0, (dtype, C)
            worst = max(worst, e) if dtype == torch.bfloat16 else worst
            shapes[(dtype, C)] = (q, kp, vp, bt, ln, e)

    entries = []
    for C in (1, 128):                  # decode, then chunked prefill
        q, kp, vp, bt, ln, e = shapes[(torch.bfloat16, C)]
        nbytes, flops = paged_work(torch, q, kp, bt, ln, kp.shape[1])
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        B, _, H, D = q.shape
        K = kp.shape[2]
        S = bt.shape[1] * kp.shape[1]
        # yardstick: one SDPA call over the gathered, GQA-expanded view
        from repro_torch.kernels.paged_attention import paged_gather_view
        kv = [paged_gather_view(x, bt).repeat_interleave(H // K, dim=2)
              .transpose(1, 2).contiguous() for x in (kp, vp)]
        qpos = ln.long()[:, None] + torch.arange(C, device="cuda")
        mask = (torch.arange(S, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        qh = q.transpose(1, 2).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        entries.append({
            "C": C, "max_abs_err": e,
            "ms": timer(lambda: paged_attention(q, kp, vp, bt, ln)),
            "plain_ms": timer(lambda: paged_attention(q, kp, vp, bt, ln,
                                                      impl="ref")),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(lambda: sdpa(qh, kv[0], kv[1],
                                             attn_mask=mask)),
            "shape": f"B=8 C={C} H=32 K=8 D=64 page=16 n_pages=32 bf16"})
    decode, prefill = entries
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:96",
            "launches": 0, "max_abs_err": worst,
            **{k: decode[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "shape")},
            "f32_max_abs_err": max(shapes[(torch.float32, C)][-1]
                                   for C in (1, 128)),
            "prefill": prefill}


# ---------------------------------------------------------------------------
# 3. the main path at full width
# ---------------------------------------------------------------------------


def stream(rng, vocab, heads, n, lo=96, hi=320):
    import numpy as np
    return [np.concatenate([heads[i % len(heads)],
                            rng.integers(0, vocab, size=(int(L) - 64,))
                            .astype(np.int32)])
            for i, L in enumerate(rng.integers(lo, hi + 1, size=n))]


def phase_serve(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.coic import CoICConfig
    from repro_torch.core.descriptor import PrefixDescriptor
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"serve: built {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    scfg = ServingConfig(max_batch=8, max_len=512, max_new_tokens=16,
                         kv_page=16, prefill_chunk=128, attn_impl="paged",
                         coic=CoICConfig(capacity=512, threshold=0.98,
                                         k_layers=2))
    eng = ServingEngine(model, scfg, device="cuda")
    rng = np.random.default_rng(0)
    heads = [rng.integers(0, cfg.vocab_size, size=(64,)).astype(np.int32)
             for _ in range(2)]
    wave1 = stream(rng, cfg.vocab_size, heads, 8)
    wave2 = wave1 + stream(rng, cfg.vocab_size, heads, 8)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()                       # the main path starts here
    for w, wave in enumerate((wave1, wave2), 1):
        hits0, steps0, n0 = eng.stats()["edge_hits"], eng.step_count, \
            len(eng.results)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in wave:
            eng.submit(p)
        eng.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        new = eng.results[n0:]
        gen = sum(len(r.tokens) for r in new if r.source == "cloud")
        steps = eng.step_count - steps0
        hits = eng.stats()["edge_hits"] - hits0
        print(f"serve: wave {w}: {len(new)} requests, {hits} edge hits, "
              f"{gen} tokens generated in {dt:.3f} s ({gen / dt:.1f} tok/s), "
              f"{steps} steps, mean step {dt / max(1, steps) * 1e3:.2f} ms",
              flush=True)
        if w == 2:
            assert hits >= 8, ("wave 2 edge hits", hits)

    # the edge cache's own lookup API on the served descriptors, unfused
    # (similarity_lookup) and fused (similarity_topk_touch)
    S = max(len(p) for p in wave2)
    toks = np.full((len(wave2), S), -1, np.int32)
    for i, p in enumerate(wave2):
        toks[i, :len(p)] = p
    desc = PrefixDescriptor(model, k_layers=2)(torch.as_tensor(toks,
                                                               device="cuda"))
    state = eng.sem_cluster.states[0]
    res = {}
    for fuse in (False, True):
        cache = dataclasses.replace(eng.semantic, fuse_touch=fuse)
        res[fuse] = cache.lookup(state, desc)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)              # ... and ends here
    (s0, r0), (s1, r1) = res[False], res[True]
    assert bool(r0.hit.all()), "every served prompt is cached"
    assert torch.equal(r0.index, r1.index) and torch.equal(r0.hit, r1.hit)
    assert torch.equal(s0.last_used, s1.last_used)
    assert torch.equal(s0.freq, s1.freq)

    st = eng.stats()
    toks_out = np.concatenate([r.tokens for r in eng.results])
    assert st["completed"] == 24, st["completed"]
    assert st["prefill_tokens"]["shared"] > 0, st["prefill_tokens"]
    assert st["max_step_ladder"] <= 2, st["max_step_ladder"]
    assert ((toks_out >= 0) & (toks_out < cfg.vocab_size)).all()
    print(f"serve: {st['completed']} completed, edge hits "
          f"{st['edge_hits']}, prefill tokens {st['prefill_tokens']}, "
          f"max_step_ladder {st['max_step_ladder']}, dispatches "
          f"{st['dispatches']}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"launches {launches}", flush=True)
    profile_wave(torch, eng, stream(rng, cfg.vocab_size, heads, 8))
    del eng, model
    torch.cuda.empty_cache()
    return launches, st


def profile_wave(torch, eng, wave):
    """Where a serving wave's time goes: one more wave of misses (after the
    main path's launch counts were read) under ``torch.profiler``; prints
    the wall time, the device's busy and idle shares, and the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in wave:
            eng.submit(p)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if busy_us <= 0:
        print("serve: profile: device time not measured (the profiler saw "
              "no kernel)", flush=True)
        return
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    print(f"serve: profile wave 3 ({len(wave)} misses): wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"(idle share {1 - busy_us / wall_us:.3f}); top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms"
                      f" x{e.count}" for e in top), flush=True)


# ---------------------------------------------------------------------------
# 4. kernel path vs plain path, end to end
# ---------------------------------------------------------------------------


def phase_e2e(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.coic import CoICConfig
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    cfg = dataclasses.replace(get_config("coic-paper"), dtype="float32")
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    out = {}
    for attn in ("paged", "gather"):
        eng = ServingEngine(model, ServingConfig(
            max_batch=8, max_len=512, max_new_tokens=16, kv_page=16,
            prefill_chunk=128, attn_impl=attn,
            coic=CoICConfig(capacity=512, threshold=0.98)), device="cuda")
        rng = np.random.default_rng(0)
        heads = [rng.integers(0, cfg.vocab_size, size=(64,)).astype(np.int32)
                 for _ in range(2)]
        wave1 = stream(rng, cfg.vocab_size, heads, 8)
        for wave in (wave1, wave1 + stream(rng, cfg.vocab_size, heads, 8)):
            for p in wave:
                eng.submit(p)
            eng.run_until_drained()
        out[attn] = {r.req_id: (r.tokens.tolist(), r.source)
                     for r in eng.results}
    assert out["paged"] == out["gather"], "paged and gather paths differ"
    n_hit = sum(src == "edge" for _, src in out["paged"].values())
    print(f"e2e: coic-paper fp32, {len(out['paged'])} requests ({n_hit} edge "
          "hits): tokens and sources identical through the paged kernel and "
          "the gather path", flush=True)


if __name__ == "__main__":
    main()
