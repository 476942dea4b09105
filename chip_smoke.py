#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

  1. build   — compile every CUDA kernel from ``src/repro_torch/csrc`` with
               nvcc for sm_90a (all sources at once) and load them;
  2. kernels — each kernel against its plain PyTorch version at the main
               path's shapes (f32, and bf16 where it takes bf16), plus the
               kernels' own conventions on empty rows; times the kernel,
               the plain version and a one-call PyTorch yardstick (K7 and
               K8 at the swa path's shapes), and beside each kernel's and
               yardstick's time (``ms``, called eagerly) the device time
               of one call and the host time of issuing it; K8's bf16
               route beside its FMA route, also on a V whose outputs lie
               in [4, 8);
  3. serve   — the main path at full width: llama3.2-1b (random weights
               from a seed, bf16) behind the CoIC edge cache in
               ``ServingEngine`` (paged KV, paged attention), two waves of
               requests, then the edge cache's own lookup API (fused and
               unfused);
  4. fed     — the federated path at full width: the same model behind a
               2-cluster x 2-node federation with an IVF-PQ digest board
               and a membership plane; three waves (misses; peer and
               remote hits; a cluster killed and its requests rerouted),
               once at the default ANN floor (hits read, not gated),
               then gated; every K6 launch of the gated run is held
               against the plain version on the same tensors; then a
               profiled fourth wave after a revive;
  5. k4      — the membership-aware pooled lookup (surviving_topk_lookup)
               over the federation's surviving shards, kernel vs plain;
  6. swa     — sliding-window serving at full width on the slotted KV
               path: h2o-danube3-4b (random weights, bf16, window 4096)
               behind the CoIC edge cache in ``ServingEngine(kv_page=0)``;
               wave 1 is 8 prompts of 512 tokens, then 2 of 4608 (longer
               than the window: the prefill rolls the ring, flash attention
               skips the keys left of the window, decode wraps the slots),
               wave 2 repeats them (edge hits) with 4 new; one flash-
               attention launch (S = 4608) and one flash-decode launch
               (4096 slots) of the path are held against their plain
               versions on the same tensors and timed beside their SDPA
               yardsticks; then a profiled wave;
  7. e2e     — the kernel path against the plain path, in fp32 (TF32
               off), decoded tokens and sources identical: coic-paper
               attn_impl "paged" vs "gather" on one cluster, lookup_impl
               "auto" vs "ref" on the federated waves, then the slotted
               cache with the model's attention_impl "auto" (flash
               attention and flash-decode kernels) vs "ref", for
               coic-paper (chunked admission) and h2o-danube3-4b at full
               width cut to 2 layers.

Each path's kernel launch counters are zeroed just before it is driven
and read just after: every kernel of the path must have run.

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
SPIN_CYCLES = 2_000_000                          # ~1 ms at the H100's clock


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
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model: built {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches, serve = phase_serve(torch, model)
    fed_launches, fed_eng, fed_prompts, k6_path = phase_federated(torch,
                                                                  model)
    k4_launches = phase_surviving(torch, model, fed_eng, fed_prompts)
    del fed_eng, model
    torch.cuda.empty_cache()
    swa_launches, swa_requests, swa_on_path = phase_swa(torch)
    # each kernel's launches on the path that runs it: the single-cluster
    # serve path (K1-K3, K5), the federated path (K6), the surviving-shard
    # lookup (K4), the sliding-window slotted path (K7, K8)
    paths = {"similarity_topk": (k4_launches, None),
             "ivf_pq_probe": (fed_launches, FED_REQUESTS),
             "decode_attention": (swa_launches, swa_requests),
             "flash_attention": (swa_launches, swa_requests)}
    for k in kernels:
        counts, n_req = paths.get(k["name"], (launches, serve["completed"]))
        k["launches"] = counts[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
        if n_req:
            k["launches_per_request"] = k["launches"] / n_req
        if k["name"] == "ivf_pq_probe":
            k["on_path"] = k6_path
        if k["name"] in swa_on_path:
            k["on_path"] = swa_on_path[k["name"]]
    for name in ("similarity_topk_batched", "paged_attention",
                 "ivf_pq_probe", "flash_attention"):
        if fed_launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the federated "
                                 "path")
    # the descriptor prefix of the single-cluster path runs K8 too
    if launches["flash_attention"] <= 0:
        raise AssertionError("flash_attention never launched on the serve "
                             "path")
    next(k for k in kernels if k["name"] == "flash_attention")[
        "launches_serve"] = launches["flash_attention"]
    phase_e2e(torch)
    phase_federated_e2e(torch)
    phase_slotted_e2e(torch)
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
    finds the cache keys and KV pages cold between steps).  A call is
    issued eagerly, as a caller issues it, so a call whose kernels take
    less time than the host takes to issue it reads the host's time.

    ``device`` holds the device in a ~1 ms spin after the flush, so the
    host has issued the whole call before the start event runs: the events
    read the call's device time alone.  ``host`` is the host's time to
    issue one call, its wall time when it synchronises."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(16 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, spin: bool = False) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(ITERS)]
        for start, end in ev:
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / ITERS

    def device(self, fn) -> float:
        return self(fn, spin=True)

    def host(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / ITERS
        torch.cuda.synchronize()
        return ms


def times(timer, fn, lib=None) -> dict:
    """A kernel's and its one-call yardstick's times: ``ms`` and
    ``library_ms`` eager, ``device_ms`` and ``library_device_ms`` the
    device's, ``host_ms`` and ``library_host_ms`` the host's to issue the
    call (``Timer``).  No yardstick: the library keys are None."""
    out = {"ms": timer(fn), "device_ms": timer.device(fn),
           "host_ms": timer.host(fn)}
    for key, t in (("library_ms", timer), ("library_device_ms",
                                           timer.device),
                   ("library_host_ms", timer.host)):
        out[key] = None if lib is None else t(lib)
    return out


def times_text(r) -> str:
    """``times`` of a row as printed: eager, then device and host."""
    lib = ("none" if r["library_ms"] is None else
           f"{r['library_ms']:.4f} (device {r['library_device_ms']:.4f}, "
           f"host {r['library_host_ms']:.4f})")
    return (f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}, host "
            f"{r['host_ms']:.4f}; plain {r['plain_ms']:.4f}; library {lib}; "
            f"bound {r['bound_ms']:.5f} by {r['bound_by']})")


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
    q0, k0, v0 = q[0], keys[0], valid[0]      # 2-D views, made once
    kernels = []
    src = "src/repro_torch/csrc/similarity.cu"
    tpu = "src/repro/kernels/similarity/kernel.py"
    rows = [
        ("similarity_topk_batched", f"{tpu}:177",
         lambda impl: similarity_topk_batched(q, keys, valid, 1, impl=impl),
         lambda: torch.topk(torch.bmm(q, keys.transpose(1, 2)), 1),
         in_bytes + Q * 8),
        ("similarity_lookup", f"{tpu}:328",
         lambda impl: similarity_lookup(q0, k0, v0, impl=impl),
         lambda: torch.topk(q0 @ kt, 1),
         in_bytes + Q * 8),
        ("similarity_topk_touch", f"{tpu}:270",
         lambda impl: similarity_topk_touch(q0, k0, v0, 1, lu, fr, clk,
                                            threshold=0.98, mask=m,
                                            impl=impl),
         lambda: torch.topk(q0 @ kt, 1),
         in_bytes + Q * 9 + C * 4 * 2 * 2),
    ]
    for name, replaces, fn, lib, nbytes in rows:
        b_ms, b_by = bound(nbytes, flops, "float32")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0,
            "max_abs_err": err[name],
            **times(timer, lambda: fn("auto"), lib),
            "plain_ms": timer(lambda: fn("ref")),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": "N=1 Q=16 C=512 D=2048 k=1 fp32"})

    kernels.append(check_paged(torch, g, timer, paged_attention))
    kernels.append(check_topk(torch, g, timer))
    kernels.append(check_ivf_pq(torch, g, timer))
    kernels.append(check_decode(torch, g, timer))
    kernels.append(check_flash(torch, g, timer))
    for k in kernels:
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}, "
              f"{times_text(k)}",
              flush=True)
        for sub in ("prefill", "prefill_b1"):
            if sub in k:
                print(f"kernel {k['name']} {sub} ({k[sub]['shape']}): "
                      f"max_abs_err {k[sub]['max_abs_err']:.3g}, "
                      f"{times_text(k[sub])}", flush=True)
    return kernels


def paged_inputs(torch, g, C, dtype, *, B=8, H=32, K=8, D=64, page=16,
                 n_pages=32, lens=(64, 96, 200, 300, 131, 17, 40, 0),
                 idle=True, dev="cuda"):
    """A pool with shared pages, INVALID tail entries and (``idle``) an
    idle last row, at the main path's attention shapes."""
    INVALID = 2 ** 30
    P = 2 * B * n_pages
    q = 0.5 * torch.randn(B, C, H, D, generator=g, device=dev)
    kp = 0.5 * torch.randn(P, page, K, D, generator=g, device=dev)
    vp = torch.randn(P, page, K, D, generator=g, device=dev)
    # row 0 maps >= 4 pages, which row 1 shares as its head; the last row
    # is idle (length 0, an all-INVALID table row)
    lens = [min(n, n_pages * page - C) for n in lens[:B]]
    bt = torch.full((B, n_pages), INVALID, dtype=torch.int32, device=dev)
    perm = torch.randperm(P, generator=g, device=dev).int()
    for b in range(B - 1 if idle else B):
        mapped = -(-(lens[b] + C) // page)
        bt[b, :mapped] = perm[b * n_pages:b * n_pages + mapped]
    if B > 1:
        bt[1, :4] = bt[0, :4]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return [t.to(dtype) for t in (q, kp, vp)] + [bt, lengths]


# check_paged's timed shapes: decode and a prefill chunk of the smoke's
# batch, and a chunk as the serve path issues it with one mid-prefill row
# (the second chunk of a 320-token prompt)
PAGED_SHAPES = {"decode": dict(C=1), "prefill": dict(C=128),
                "prefill_b1": dict(C=128, B=1, lens=(128,), idle=False)}


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
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    shapes = {}
    for dtype in (torch.float32, torch.bfloat16):
        for key, kw in PAGED_SHAPES.items():
            q, kp, vp, bt, ln = paged_inputs(torch, g, dtype=dtype, **kw)
            ref = paged_attention(q, kp, vp, bt, ln, impl="ref")
            out = paged_attention(q, kp, vp, bt, ln)
            torch.cuda.synchronize()
            idle = kw.get("idle", True)
            live = slice(0, q.shape[0] - int(idle))  # rows that see a key
            e = float((out[live].float() - ref[live].float()).abs().max())
            assert e <= tol[dtype], ("paged_attention", dtype, key, e)
            if idle:
                # the kernel's own convention: a row with no visible key -> 0
                assert int(torch.count_nonzero(out[-1])) == 0, (dtype, key)
            worst[dtype] = max(worst[dtype], e)
            shapes[(dtype, key)] = (q, kp, vp, bt, ln, e)

    entries = {}
    for key in PAGED_SHAPES:
        q, kp, vp, bt, ln, e = shapes[(torch.bfloat16, key)]
        nbytes, flops = paged_work(torch, q, kp, bt, ln, kp.shape[1])
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        B, C, H, D = q.shape
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
        entries[key] = {
            "max_abs_err": e,
            **times(timer, lambda: paged_attention(q, kp, vp, bt, ln),
                    lambda: sdpa(qh, kv[0], kv[1], attn_mask=mask)),
            "plain_ms": timer(lambda: paged_attention(q, kp, vp, bt, ln,
                                                      impl="ref")),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B={B} C={C} H={H} K={K} D={D} page={kp.shape[1]} "
                     f"n_pages={bt.shape[1]} lengths={ln.tolist()} bf16"}
    decode = entries.pop("decode")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:96",
            "launches": 0, "max_abs_err": worst[torch.bfloat16],
            **{k: v for k, v in decode.items() if k != "max_abs_err"},
            "f32_max_abs_err": worst[torch.float32], **entries}


def check_topk(torch, g, timer):
    """K4, the single-matrix top-k, at the pooled-shard shape of the
    membership lookup: C = 4 shards x 512, D = 2048; indices exact, scores
    within 1e-5."""
    from repro_torch.kernels.similarity import similarity_topk

    C, D = 2048, 2048
    err = 0.0
    for case in ("random", "duplicate", "all_invalid"):
        for Q in (1, 16):
            q, keys, valid = sim_inputs(torch, g, 1, Q, C, D, case)
            for k in (1, 4):
                ci, cs = similarity_topk(q[0], keys[0], valid[0], k)
                ri, rs = similarity_topk(q[0], keys[0], valid[0], k,
                                         impl="ref")
                torch.cuda.synchronize()
                assert torch.equal(ci, ri), ("similarity_topk idx", case, Q,
                                             k)
                e = float((cs - rs).abs().max())
                assert e <= 1e-5, ("similarity_topk score", case, Q, k, e)
                err = max(err, e)
    Q = 16
    q, keys, valid = sim_inputs(torch, g, 1, Q, C, D, "random")
    q, keys, valid = q[0], keys[0], valid[0]
    kt = keys.t().contiguous()
    b_ms, b_by = bound(Q * D * 4 + C * D * 4 + C + Q * 8, 2.0 * Q * C * D,
                       "float32")
    return {"name": "similarity_topk", "route": "cuda",
            "source": "src/repro_torch/csrc/similarity.cu",
            "replaces": "src/repro/kernels/similarity/kernel.py:139",
            "launches": 0, "max_abs_err": err,
            **times(timer, lambda: similarity_topk(q, keys, valid, 1),
                    lambda: torch.topk(q @ kt, 1)),
            "plain_ms": timer(lambda: similarity_topk(q, keys, valid, 1,
                                                      impl="ref")),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": "Q=16 C=2048 (4x512) D=2048 k=1 fp32"}


def ivf_inputs(torch, g, Q, L, cap, S, D, n_probe, dev="cuda"):
    """A random IVF-PQ index, made directly (no k-means): unit queries and
    centroids, a random codebook and uint8 codes, ~10% dead slots, owners
    uniform over 4 clusters, every max(7, L // 10)-th list invalid, slots 0
    and 1 of every list with equal codes, homes in 4 blocks of queries.
    Query 0 is made candidate-free (its probed lists' slots all owned by
    its home).  The last query is planted on a twin pair: it equals the
    centroid of list 1, whose slots 0 and 1 hold the codes that maximise
    each subspace's term, so no other slot scores as high and the two tie
    exactly; the lower flat index must come first.  Returns the kernel's
    arguments and the pair's (row, flat index)."""
    from repro_torch.kernels.ivf_pq import ivf_pq_probe

    assert Q >= 2 and L >= 2 and cap >= 2, (Q, L, cap)
    q = _unit(torch.randn(Q, D, generator=g, device=dev))
    cent = _unit(torch.randn(L, D, generator=g, device=dev))
    cent_valid = torch.ones(L, dtype=torch.bool, device=dev)
    cent_valid[::max(7, L // 10)] = False
    codes = torch.randint(0, 256, (L, cap, S), generator=g, device=dev,
                          dtype=torch.uint8)
    codes[:, 1] = codes[:, 0]
    slot_valid = torch.rand(L, cap, generator=g, device=dev) < 0.9
    owner = torch.randint(0, 4, (L, cap), generator=g, device=dev,
                          dtype=torch.int32)
    cb = 0.02 * torch.randn(S, 256, D // S, generator=g, device=dev)
    home = (torch.arange(Q, device=dev) * 4 // Q).to(torch.int32)
    args = [q, home, cent, cent_valid, codes, slot_valid, owner, cb]
    _, _, sel = ivf_pq_probe(*args, k=1, n_probe=n_probe, impl="ref")
    owner[sel[0].long()] = home[0]
    # the twin pair (owned by query 0's home, so query 0 stays
    # candidate-free; homes differ between the first and the last query)
    row, j = Q - 1, 1
    q[row] = cent[j]
    lut = torch.einsum("sd,scd->sc", q[row].reshape(S, D // S), cb)
    codes[j, 0] = codes[j, 1] = lut.argmax(dim=1).to(torch.uint8)
    slot_valid[j, :2] = True
    owner[j, :2] = home[0]
    return args, (row, j * cap)


def _near_tie(torch, scores, tol=1e-5):
    """Rows whose sorted real scores (masked ones, -1e30, are left out)
    have two neighbours closer than ``tol`` but not equal: the order of an
    exact tie (lower index first) is checked, not excused."""
    gaps = scores[:, :-1] - scores[:, 1:]
    return ((gaps > 0) & (gaps < tol) & (scores[:, 1:] > -1e29)).any(dim=1)


def ivf_pq_agree(torch, args, k, n_probe, out):
    """The kernel's (idx, score, sel) against the plain version on the same
    arguments: scores within 1e-4; sel and idx equal on every row whose
    plain order is not decided by a near tie (coarse scores at the n_probe
    boundary, or fine scores at the k boundary, 0 < gap < 1e-5).  Returns
    (max score error, rows excused)."""
    from repro_torch.kernels.ivf_pq import ivf_pq_probe

    L, cap = args[4].shape[:2]
    ri, rs, rsel = ivf_pq_probe(*args, k=min(k + 1, L * cap),
                                n_probe=n_probe, impl="ref")
    ci, cs, csel = out
    e = float((cs - rs[:, :k]).abs().max()) if cs.numel() else 0.0
    assert e <= 1e-4, ("ivf_pq_probe score", k, e)
    q, _, cent, cent_valid = args[:4]
    coarse = torch.where(cent_valid.bool()[None], q.float() @ cent.float().T,
                         -1e30)
    top = torch.sort(coarse, dim=1, descending=True).values[:, :n_probe + 1]
    tie = _near_tie(torch, top) | _near_tie(torch, rs)
    bad = (csel != rsel).any(dim=1) | (ci != ri[:, :k]).any(dim=1)
    assert not bool((bad & ~tie).any()), ("ivf_pq_probe idx/sel",
                                          torch.nonzero(bad & ~tie))
    return e, int((bad & tie).sum())


def ivf_pq_check(torch, args, twin, k, n_probe, out):
    """``ivf_pq_agree`` on inputs from ``ivf_inputs``, plus the kernel's
    conventions: the candidate-free query 0 gets indices 0..k-1 at -1e30,
    and the planted twin pair comes lower index first."""
    e, excused = ivf_pq_agree(torch, args, k, n_probe, out)
    idx, score, _ = out
    assert idx[0].tolist() == list(range(k)), "candidate-free row"
    assert bool((score[0] == -1e30).all()), "candidate-free row"
    row, flat = twin
    pair = [flat, flat + 1][:k]
    assert idx[row, :len(pair)].tolist() == pair, ("twin pair", idx[row])
    if k > 1:
        assert float(score[row, 0]) == float(score[row, 1]), "twin scores"
    return e, excused


def ivf_pq_bound(torch, args, sel):
    """(bound_ms, bound_by, probed lists) of one K6 call: each input read
    once in the port's storage types (codes u8, slot validity 1 byte,
    owner int32, over the lists some query probes, ``sel``), the outputs
    written once; the coarse scores, the lookup table and the S table
    reads per probed slot."""
    Q, D = args[0].shape
    L, cap, S = args[4].shape
    n_probe = sel.shape[1]
    n_lists = int(torch.unique(sel).numel())
    nbytes = (Q * D * 4 + Q * 4 + L * D * 4 + L + S * 256 * (D // S) * 4
              + n_lists * cap * (S + 1 + 4) + Q * 8 + Q * n_probe * 4)
    flops = 2.0 * Q * L * D + 2.0 * Q * 256 * D + Q * n_probe * cap * S
    return (*bound(nbytes, flops, "float32"), n_lists)


def check_ivf_pq(torch, g, timer):
    """K6 at the region-board scale: Q = 4 home clusters x 64, D = 2048,
    L = 1024 lists x cap 984 (~1M slots), S = 8, n_probe = 16."""
    from repro_torch.kernels.ivf_pq import ivf_pq_probe

    Q, L, cap, S, D, n_probe = 256, 1024, 984, 8, 2048, 16
    args, twin = ivf_inputs(torch, g, Q, L, cap, S, D, n_probe)
    err, excused = 0.0, 0
    for k in (1, 4):
        out = ivf_pq_probe(*args, k=k, n_probe=n_probe)
        torch.cuda.synchronize()
        e, x = ivf_pq_check(torch, args, twin, k, n_probe, out)
        err, excused = max(err, e), excused + x
    print(f"kernel ivf_pq_probe: {excused} rows excused by near ties "
          "(0 < gap < 1e-5); the candidate-free row and the exact twin tie "
          "checked", flush=True)
    _, _, sel = ivf_pq_probe(*args, k=1, n_probe=n_probe, impl="ref")
    b_ms, b_by, n_lists = ivf_pq_bound(torch, args, sel)
    return {"name": "ivf_pq_probe", "route": "cuda",
            "source": "src/repro_torch/csrc/ivf_pq.cu",
            "replaces": "src/repro/kernels/ivf_pq/kernel.py:113",
            "launches": 0, "max_abs_err": err,
            **times(timer, lambda: ivf_pq_probe(*args, k=1,
                                                n_probe=n_probe)),
            "plain_ms": timer(lambda: ivf_pq_probe(*args, k=1,
                                                   n_probe=n_probe,
                                                   impl="ref")),
            "bound_ms": b_ms, "bound_by": b_by,
            "rows_excused": excused, "probed_lists": n_lists,
            "shape": "Q=256 L=1024 cap=984 S=8 D=2048 n_probe=16 k=1"}


ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SWA = {"B": 8, "S": 4608, "Sk": 4096, "window": 4096, "H": 32, "K": 8,
       "D": 120}                          # the swa path's attention shapes


def _dt(dtype):
    return str(dtype).replace("torch.", "")


def flash_inputs(torch, g, B, S, H, K, D, dtype, dev="cuda"):
    return [torch.randn(B, S, n, D, generator=g, device=dev).to(dtype)
            for n in (H, K, K)]


def flash_work(q, k, window):
    """(bytes, flops) one flash-attention call must move and do: q, k, v
    read once and the output written once; 4 * D flops per (query head,
    visible key), the visible keys of position p being min(p + 1, window)
    (p + 1 without a window)."""
    B, S, H, D = q.shape
    es = q.element_size()
    seen = sum(min(p + 1, window) if window > 0 else p + 1
               for p in range(S))
    nbytes = (2 * q.numel() + 2 * k.numel()) * es
    return nbytes, 4.0 * D * H * B * seen


def flash_agree(torch, q, k, v, out, window):
    """Max error of a flash-attention output against the plain version
    on the same tensors, one batch row at a time (the plain version holds
    (K, G, S, S) fp32 logits per row)."""
    from repro_torch.kernels.flash_attention import flash_attention
    err = 0.0
    for b in range(q.shape[0]):
        ref = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                              window=window, impl="ref")
        err = max(err, float((out[b:b + 1].float() - ref.float()).abs()
                             .max()))
    tol = ATTN_TOL[_dt(q.dtype)]
    assert err <= tol, ("flash_attention", tuple(q.shape), window, err)
    return err


def sdpa_band(torch, q, k, v, window):
    """K8's yardstick: one SDPA call over the GQA-expanded view of q (B, S,
    H, D), k/v (B, S, K, D), the causal band of ``window`` keys as a
    boolean mask."""
    S, H, K = q.shape[1], q.shape[2], k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    p = torch.arange(S, device=q.device)
    band = (p[None, :] <= p[:, None]) & (p[None, :] > p[:, None] - window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kh, vh, attn_mask=band)


def sdpa_slots(torch, q, k, v, kv_len):
    """K7's yardstick: one SDPA call over the GQA-expanded cache (q (B, H,
    D), k/v (B, S, K, D)), the valid slots (< kv_len) as a boolean mask."""
    S, H, K = k.shape[1], q.shape[1], k.shape[2]
    kh, vh = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    mask = (torch.arange(S, device=q.device)[None, :]
            < kv_len[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q[:, :, None], kh, vh, attn_mask=mask)


def check_flash(torch, g, timer):
    """K8: f32 and bf16, head_dim 64 and 120, GQA groups of 1 and 4, a
    ragged S, no window and two windows; then timed at the swa path's
    long-prompt row (S = 4608, window 4096, bf16), beside the FMA route
    (the fp32 kernel) on the same inputs widened to fp32, its output
    rounded to bf16: the computation the bf16 route made before it moved
    to the tensor cores.  Both routes also run on a V drawn from [4, 8),
    whose outputs lie where one bf16 step (2^-5) exceeds the 2e-2
    tolerance: there each output must lie within one bf16 step of the
    plain version's."""
    from repro_torch.kernels.flash_attention import flash_attention
    err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 120):
            for G in (1, 4):
                for S, window in ((333, 0), (333, 100), (1000, 256)):
                    q, k, v = flash_inputs(torch, g, 2, S, 8 * G, 8, D,
                                           dtype)
                    out = flash_attention(q, k, v, window=window)
                    torch.cuda.synchronize()
                    e = flash_agree(torch, q, k, v, out, window)
                    err[_dt(dtype)] = max(err[_dt(dtype)], e)
    S, W, H, K, D = SWA["S"], SWA["window"], SWA["H"], SWA["K"], SWA["D"]
    q, k, v = flash_inputs(torch, g, 1, S, H, K, D, torch.bfloat16)
    b_ms, b_by = bound(*flash_work(q, k, W), "bfloat16")
    qf, kf, vf = q.float(), k.float(), v.float()
    mma_err = flash_agree(torch, q, k, v, flash_attention(q, k, v, window=W),
                          W)
    fma_err = flash_agree(torch, q, k, v, flash_attention(
        qf, kf, vf, window=W).to(torch.bfloat16), W)
    v4 = (4 + 4 * torch.rand(v.shape, generator=g, device="cuda")).to(
        torch.bfloat16)
    ref4 = flash_attention(q, k, v4, window=W, impl="ref")
    scaled = {}
    for route, out4 in (("mma", flash_attention(q, k, v4, window=W)),
                        ("fma", flash_attention(qf, kf, v4.float(),
                                                window=W).to(torch.bfloat16))):
        scaled[f"{route}_max_abs_err"] = float((out4.float() - ref4.float())
                                               .abs().max())
        scaled[f"{route}_bf16_steps"] = bf16_steps(torch, out4, ref4)
        assert scaled[f"{route}_bf16_steps"] <= 1, ("flash_attention V in "
                                                    "[4, 8)", route, scaled)
    del ref4
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
           "launches": 0, "max_abs_err": err["bfloat16"],
           "f32_max_abs_err": err["float32"],
           **times(timer, lambda: flash_attention(q, k, v, window=W),
                   sdpa_band(torch, q, k, v, W)),
           "plain_ms": timer(lambda: flash_attention(q, k, v, window=W,
                                                     impl="ref")),
           "bound_ms": b_ms, "bound_by": b_by,
           "v_in_4_8": scaled,
           "fma_route": {"ms": timer(lambda: flash_attention(qf, kf, vf,
                                                             window=W)),
                         "max_abs_err": fma_err, "mma_max_abs_err": mma_err},
           "shape": f"B=1 S={S} H={H} K={K} D={D} window={W} bf16"}
    print(f"kernel flash_attention: bf16 at {row['shape']}: tensor cores "
          f"max_abs_err {mma_err:.3g}, {row['ms']:.4f} ms; the FMA route "
          f"on the same inputs max_abs_err {fma_err:.3g}, "
          f"{row['fma_route']['ms']:.4f} ms; V in [4, 8): tensor cores "
          f"max_abs_err {scaled['mma_max_abs_err']:.3g} "
          f"({scaled['mma_bf16_steps']:.3g} bf16 steps), the FMA route "
          f"{scaled['fma_max_abs_err']:.3g} ({scaled['fma_bf16_steps']:.3g} "
          f"steps); each within one step", flush=True)
    return row


def bf16_steps(torch, out, ref) -> float:
    """The largest |out - ref| in bf16 steps (units in the last place) at
    the larger of the two magnitudes."""
    a, b = out.float(), ref.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8))
                 .max())


def decode_inputs(torch, g, B, S, H, K, D, dtype, lens, dev="cuda"):
    q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, S, K, D, generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


def decode_work(q, k, kv_len):
    """(bytes, flops) one flash-decode call must move and do: q read and
    the output written once, the k and v of every valid slot once, kv_len;
    4 * D flops per (query head, valid slot)."""
    B, H, D = q.shape
    K = k.shape[2]
    es = q.element_size()
    valid = int(kv_len.clamp(max=k.shape[1]).sum())
    nbytes = 2 * q.numel() * es + 2 * valid * K * D * es + 4 * B
    return nbytes, 4.0 * D * H * valid


def decode_agree(torch, q, k, v, kv_len, out):
    from repro_torch.kernels.decode_attention import decode_attention
    ref = decode_attention(q, k, v, kv_len, impl="ref")
    err = float((out.float() - ref.float()).abs().max())
    tol = ATTN_TOL[_dt(q.dtype)]
    assert err <= tol, ("decode_attention", tuple(k.shape), err)
    return err


def check_decode(torch, g, timer):
    """K7: f32 and bf16, head_dim 64 and 120, GQA groups of 1 and 4,
    kv_len 1, ragged and full over 1000 slots (four splits, the last
    ragged), and the kernel's own convention for kv_len 0 (exact zeros);
    then timed at the swa path's decode (B = 8, a full 4096-slot ring,
    bf16)."""
    from repro_torch.kernels.decode_attention import decode_attention
    err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for D in (64, 120):
            for G in (1, 4):
                for lens in ((1, 1, 1), (1, 517, 999), (1000,) * 3):
                    q, k, v, ln = decode_inputs(torch, g, 3, 1000, 8 * G, 8,
                                                D, dtype, lens)
                    out = decode_attention(q, k, v, ln)
                    torch.cuda.synchronize()
                    e = decode_agree(torch, q, k, v, ln, out)
                    err[_dt(dtype)] = max(err[_dt(dtype)], e)
    q, k, v, ln = decode_inputs(torch, g, 2, 300, 32, 8, 120, torch.float32,
                                (0, 300))
    out = decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert int(torch.count_nonzero(out[0])) == 0, "kv_len 0 row"
    B, S, H, K, D = SWA["B"], SWA["Sk"], SWA["H"], SWA["K"], SWA["D"]
    q, k, v, ln = decode_inputs(torch, g, B, S, H, K, D, torch.bfloat16,
                                (S,) * B)
    b_ms, b_by = bound(*decode_work(q, k, ln), "bfloat16")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:65",
            "launches": 0, "max_abs_err": err["bfloat16"],
            "f32_max_abs_err": err["float32"],
            **times(timer, lambda: decode_attention(q, k, v, ln),
                    sdpa_slots(torch, q, k, v, ln)),
            "plain_ms": timer(lambda: decode_attention(q, k, v, ln,
                                                       impl="ref")),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B={B} Sk={S} H={H} K={K} D={D} kv_len={S} bf16"}


# ---------------------------------------------------------------------------
# 3. the main path at full width
# ---------------------------------------------------------------------------


def stream(rng, vocab, heads, n, lo=96, hi=320):
    import numpy as np
    return [np.concatenate([heads[i % len(heads)],
                            rng.integers(0, vocab, size=(int(L) - 64,))
                            .astype(np.int32)])
            for i, L in enumerate(rng.integers(lo, hi + 1, size=n))]


def phase_serve(torch, model):
    import numpy as np

    from repro_torch.core.coic import CoICConfig
    from repro_torch.core.descriptor import PrefixDescriptor
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    cfg = model.cfg
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
    profile_wave(torch, eng, [(p, 0, 0) for p in
                              stream(rng, cfg.vocab_size, heads, 8)])
    del eng
    torch.cuda.empty_cache()
    return launches, st


def profile_wave(torch, eng, wave, label="serve: profile wave 3"):
    """Where a serving wave's time goes: one more wave (after the path's
    launch counts were read) of (prompt, node, cluster) requests under
    ``torch.profiler``; prints the wall time, the device's busy and idle
    shares, and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p, node, clu in wave:
            eng.submit(p, node_id=node, cluster_id=clu)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if busy_us <= 0:
        print(f"{label}: device time not measured (the profiler saw no "
              "kernel)", flush=True)
        return
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    # K5's kernels (csrc/paged_attention.cu names each paged_*_kernel)
    k5 = [e for e in kern if "paged_" in e.key]
    print(f"{label} ({len(wave)} requests): wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"(idle share {1 - busy_us / wall_us:.3f}); top kernels: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms"
                      f" x{e.count}" for e in top)
          + "; K5 (paged attention) "
          f"{sum(e.self_device_time_total for e in k5) / 1e3:.2f} ms: "
          + ", ".join(f"{e.key.split('<')[0].split('::')[-1]} "
                      f"{e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                      for e in k5), flush=True)


# ---------------------------------------------------------------------------
# 4. the federated path at full width
# ---------------------------------------------------------------------------


# The floor from which IVF-PQ candidates go to the exact confirm.  No
# CoICConfig field sets it; the smoke sets 0.0, the value of the
# reference's own IVF-PQ tests (tests/test_digest.py, _ANN), because at
# the federation's default, 0.5, the waves below serve none of the 8
# remote prompts on an H100 (PERF.md, Findings): the codebook is trained
# on the first cluster's 8 digest rows alone, so the PQ scores of the
# other cluster's rows carry no calibrated scale.  phase_federated reads
# the default's hits first, every run.  The confirm at the serve
# threshold decides every serve either way: the floor moves recall, never
# correctness.
ANN_ADMISSION = 0.0


def federated_engine(torch, model, lookup_impl="auto", dev="cuda",
                     ann_admission=ANN_ADMISSION):
    """``ServingEngine`` behind a 2-cluster x 2-node federation (IVF-PQ
    digest board of 4 lists, 8 subspaces) with a membership plane; its
    IVF-PQ candidates go to the exact confirm from a score of
    ``ann_admission`` (None: the federation's default, 0.5)."""
    from repro_torch.core.coic import CoICConfig
    from repro_torch.core.membership import ClusterMembership
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    mb = ClusterMembership(2, 2, timeout_s=60)
    eng = ServingEngine(model, ServingConfig(
        max_batch=8, max_len=512, max_new_tokens=16, kv_page=16,
        prefill_chunk=128, attn_impl="paged",
        coic=CoICConfig(capacity=512, threshold=0.98, k_layers=2,
                        num_nodes=2, num_clusters=2, digest_size=64,
                        digest_interval=1, digest_ann="ivfpq",
                        digest_ann_lists=4, digest_ann_sub=8,
                        digest_ann_probe=4, lookup_impl=lookup_impl)),
        membership=mb, device=dev)
    if ann_admission is not None:
        eng.sem_fed.cfg = dataclasses.replace(eng.sem_fed.cfg,
                                              ann_admission=ann_admission)
    return eng, mb


FED_PLAN = [[("A", 0, 0), ("B", 1, 0)], [("A", 0, 1), ("B", 0, 0)],
            [("B", 1, 1)]]                 # per wave: (set, cluster, node)
FED_REQUESTS = 8 * sum(map(len, FED_PLAN))  # 8 prompts per set: 40


def federated_waves(torch, eng, mb, vocab, host=None):
    """Three waves through a federated engine: (1) 8 prompts A at (cluster
    0, node 0) and 8 prompts B at (1, 0), all misses; (2) A at (0, 1), peer
    hits, and B at (0, 0), remote hits through the digest board; then
    cluster 1 is killed and (3) B at (1, 1) reroutes to cluster 0.  Returns
    the prompts and, per wave, {(set, i): (source, tokens)} with its wall
    time, step count and the host times gathered in ``host`` (emptied
    after each wave)."""
    import numpy as np

    rng = np.random.default_rng(1)
    sets = {name: [rng.integers(0, vocab, size=(int(n),)).astype(np.int32)
                   for n in rng.integers(96, 321, size=8)]
            for name in ("A", "B")}
    waves = []
    for w, groups in enumerate(FED_PLAN):
        if w == 2:
            mb.kill_cluster(1)
        n0, steps0 = len(eng.results), eng.step_count
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        key_of = {}
        for name, clu, node in groups:
            for i, p in enumerate(sets[name]):
                key_of[eng.submit(p, node_id=node, cluster_id=clu)] = (name,
                                                                      i)
        eng.run_until_drained()
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        waves.append({"dt": time.perf_counter() - t0,
                      "steps": eng.step_count - steps0,
                      "recs": {key_of[r.req_id]: (r.source,
                                                  tuple(r.tokens.tolist()))
                               for r in eng.results[n0:]},
                      "host": dict(host or {})})
        if host:
            host.clear()
    return sets, waves


def _timed(store, name, fn):
    """Wrap ``fn`` to append its host wall ms to ``store[name]``."""
    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        store.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out
    return call


def _recorded(store, fn):
    """Wrap a kernel wrapper to keep each call's arguments and outputs."""
    def call(*args):
        out = fn(*args)
        store.append((args, out))
        return out
    return call


def phase_federated(torch, model):
    import repro_torch.kernels.ivf_pq.ops as ivf_ops
    from repro_torch.kernels import LAUNCHES, reset_launches

    # the remote rung's recall at the federation's default ANN floor
    eng, mb = federated_engine(torch, model, ann_admission=None)
    federated_waves(torch, eng, mb, model.cfg.vocab_size)
    st, fed = eng.stats(), eng.sem_fed
    print(f"fed: default ANN floor {fed.cfg.ann_admission}: peer "
          f"{st['peer_hits']}, remote {st['remote_hits']}, cloud "
          f"{st['cloud']}, digest false hits {fed.digest_false_hits}, tier "
          f"counts {fed.tier_counts}", flush=True)
    del eng, mb, fed
    torch.cuda.empty_cache()

    eng, mb = federated_engine(torch, model)
    fed = eng.sem_fed
    host = {}
    fed.refresh_digests = _timed(host, "refresh_digests",
                                 fed.refresh_digests)
    fed.board.ann_index = _timed(host, "ann_index", fed.board.ann_index)
    probes = []                            # K6 as the remote rung calls it
    kernel_fn = ivf_ops.ivf_pq_probe_cuda
    ivf_ops.ivf_pq_probe_cuda = _recorded(probes, kernel_fn)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                       # the federated path starts here
    sets, waves = federated_waves(torch, eng, mb, model.cfg.vocab_size,
                                  host)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)              # ... and ends here
    ivf_ops.ivf_pq_probe_cuda = kernel_fn
    on_path = check_ivf_pq_on_path(torch, probes, launches["ivf_pq_probe"])
    st = eng.stats()
    for w, wave in enumerate(waves, 1):
        h = wave["host"]
        srcs = [src for src, _ in wave["recs"].values()]
        gen = sum(len(t) for src, t in wave["recs"].values()
                  if src == "cloud")
        dt = wave["dt"]
        print(f"fed: wave {w}: {len(srcs)} requests ("
              + ", ".join(f"{n} {srcs.count(n)}" for n in sorted(set(srcs)))
              + f"), {gen} tokens generated in {dt:.3f} s "
              f"({gen / dt:.1f} tok/s), {wave['steps']} steps, mean step "
              f"{dt / max(1, wave['steps']) * 1e3:.2f} ms; host "
              + ", ".join(f"{k} {len(v)} calls {sum(v):.2f} ms (max "
                          f"{max(v):.2f})" for k, v in sorted(h.items())),
              flush=True)
    # every hit serves exactly the tokens wave 1 computed for its prompt
    first = waves[0]["recs"]
    assert all(src == "cloud" for src, _ in first.values()), "wave 1"
    n_req = sum(len(w["recs"]) for w in waves)
    assert n_req == FED_REQUESTS == st["completed"], (n_req, st["completed"])
    for wave in waves[1:]:
        for key, (src, toks) in wave["recs"].items():
            assert src == "cloud" or toks == first[key][1], ("phantom", key,
                                                             src)
    assert st["peer_hits"] >= 1 and st["remote_hits"] >= 1, st
    assert fed.board.tombstones == 1, fed.board.tombstones
    assert fed.max_ladder_dispatches <= 4, fed.max_ladder_dispatches
    assert st["max_step_ladder"] <= 2, st["max_step_ladder"]
    probe_ms = {r.name: fed.metrics.histogram(
        f"ladder/probe_ms/{r.name}").snapshot() for r in fed.ladder.rungs}
    print(f"fed: {st['completed']} completed (edge {st['edge_hits']}, peer "
          f"{st['peer_hits']}, remote {st['remote_hits']}, cloud "
          f"{st['cloud']}), tier counts {fed.tier_counts}, tombstones "
          f"{fed.board.tombstones}, max_ladder_dispatches "
          f"{fed.max_ladder_dispatches}, max_step_ladder "
          f"{st['max_step_ladder']}, membership {st['membership']}, "
          "probe_ms " + ", ".join(
              f"{n} mean {v['mean']:.3f} max {v['max']:.3f} x{v['count']}"
              for n, v in probe_ms.items())
          + f", peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB, launches {launches}", flush=True)

    # a profiled fourth wave (after the path's counts were read): cluster 1
    # revives cold; 8 new prompts miss at (1, 0) while B at (1, 1) is
    # served remotely from cluster 0
    import numpy as np
    mb.revive_cluster(1)
    rng = np.random.default_rng(2)
    fresh = [rng.integers(0, model.cfg.vocab_size, size=(int(n),))
             .astype(np.int32) for n in rng.integers(96, 321, size=8)]
    host.clear()
    profile_wave(torch, eng, [(p, 0, 1) for p in fresh]
                 + [(p, 1, 1) for p in sets["B"]], label="fed: profile wave 4")
    srcs = [r.source for r in eng.results[FED_REQUESTS:]]
    print("fed: profile wave 4 sources "
          + ", ".join(f"{n} {srcs.count(n)}" for n in sorted(set(srcs)))
          + "; host " + ", ".join(f"{k} {len(v)} calls {sum(v):.2f} ms"
                                  for k, v in sorted(host.items())),
          flush=True)
    return launches, eng, sets["A"] + sets["B"], on_path


def check_ivf_pq_on_path(torch, probes, n_launches):
    """K6 at the shape the federated path gave it: each launch the remote
    rung made, held against the plain version on the same tensors (scores
    within 1e-4, sel and idx equal but for near ties), then timed there."""
    assert len(probes) == n_launches > 0, (len(probes), n_launches)
    from repro_torch.kernels.ivf_pq.kernel import ivf_pq_probe_cuda
    from repro_torch.kernels.ivf_pq.ref import ivf_pq_probe_ref

    err, excused = 0.0, 0
    for args, out in probes:
        e, x = ivf_pq_agree(torch, list(args[:8]), args[8], args[9], out)
        err, excused = max(err, e), excused + x
    args, out = probes[0]
    timer = Timer(torch)
    (Q, D), (L, cap, S), k, n_probe = (args[0].shape, args[4].shape,
                                       args[8], args[9])
    b_ms, b_by, _ = ivf_pq_bound(torch, args, out[2])
    on_path = {
        "shape": f"Q={Q} L={L} cap={cap} S={S} D={D} n_probe={n_probe} k={k}",
        "launches": n_launches, "max_abs_err": err, "rows_excused": excused,
        **times(timer, lambda: ivf_pq_probe_cuda(*args)),
        "plain_ms": timer(lambda: ivf_pq_probe_ref(*args[:8], k=k,
                                                   n_probe=n_probe)),
        "bound_ms": b_ms, "bound_by": b_by}
    print(f"fed: K6 on the path ({on_path['shape']}): {n_launches} launch(es) "
          f"== plain (max score err {err:.3g}, {excused} rows excused by "
          f"near ties); {times_text(on_path)}", flush=True)
    return on_path


# ---------------------------------------------------------------------------
# 5. K4 on its path: the membership-aware pooled lookup
# ---------------------------------------------------------------------------


def phase_surviving(torch, model, eng, prompts):
    """``surviving_topk_lookup`` over cluster 0's shard stacks with node 1
    marked dead, through the kernel and the plain version: equal indices,
    scores within 1e-5; every A and B prompt (cached at node 0) is found
    there."""
    import numpy as np

    from repro_torch.core.descriptor import PrefixDescriptor
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.parallel.sharding import surviving_topk_lookup

    S = max(len(p) for p in prompts)
    toks = np.full((len(prompts), S), -1, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    keys, valid, _ = eng.sem_fed.clusters[0]._stacks()
    desc = PrefixDescriptor(model, k_layers=2)(torch.as_tensor(
        toks, device=keys.device))
    alive = np.array([True, False])
    C = keys.shape[1]
    torch.cuda.synchronize()
    reset_launches()                       # the K4 path starts here
    out = {k: surviving_topk_lookup(desc, keys, valid, alive, k)
           for k in (1, 4)}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)              # ... and ends here
    err = 0.0
    for k, (ci, cs) in out.items():
        ri, rs = surviving_topk_lookup(desc, keys, valid, alive, k,
                                       impl="ref")
        assert torch.equal(ci, ri), ("surviving_topk_lookup idx", k)
        err = max(err, float((cs - rs).abs().max()))
        assert err <= 1e-5, ("surviving_topk_lookup score", k, err)
    idx, score = out[1]
    assert bool((score[:, 0] >= 0.98).all()), score[:, 0]
    assert bool((idx[:, 0] < C).all()), "a hit from the dead node"
    print(f"k4: surviving_topk_lookup over {keys.shape[0]} shards x {C} "
          f"(node 1 dead), Q={len(prompts)}, k=1,4: kernel == plain "
          f"(max score err {err:.3g}), all {len(prompts)} found on node 0, "
          f"launches {launches['similarity_topk']}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# 6. sliding-window serving on the slotted KV path
# ---------------------------------------------------------------------------


def _keep_first(store, fn, pred, clone=()):
    """Wrap a kernel wrapper to keep the arguments (the positional ones in
    ``clone`` copied: the cache is written in place later) and the output
    of its first call for which ``pred(*args, **kw)`` holds."""
    def call(*args, **kw):
        out = fn(*args, **kw)
        if not store and pred(*args, **kw):
            store.append(([a.clone() if i in clone else a
                           for i, a in enumerate(args)], kw, out))
        return out
    return call


def swa_prompts(rng, vocab, heads, n, length):
    import numpy as np
    return [np.concatenate([heads[i % len(heads)],
                            rng.integers(0, vocab, size=(length - 64,))
                            .astype(np.int32)]) for i in range(n)]


def phase_swa(torch):
    """h2o-danube3-4b at its published widths (bf16, random weights from
    seed 0) behind the CoIC edge cache on the slotted KV path.  Returns
    the path's launch counts, its request count and, for K7 and K8, the
    check and times of one launch of the path on its own tensors."""
    import numpy as np

    import repro_torch.kernels.decode_attention.ops as dec_ops
    import repro_torch.kernels.flash_attention.ops as fa_ops
    from repro_torch.configs import get_config
    from repro_torch.core.coic import CoICConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    cfg = get_config("h2o-danube3-4b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"swa: built {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, head_dim {cfg.head_dim}, window "
          f"{cfg.sliding_window}, {cfg.dtype}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # prefill_chunk is set and ignored: a ring never chunks
    eng = ServingEngine(model, ServingConfig(
        max_batch=8, max_len=8192, max_new_tokens=16, kv_page=0,
        prefill_chunk=128, coic=CoICConfig(capacity=512, threshold=0.98,
                                           k_layers=2)), device="cuda")
    Sk = eng.cache["blocks/0/k"].shape[2]
    assert Sk == cfg.sliding_window, Sk
    rng = np.random.default_rng(3)
    V = cfg.vocab_size
    heads = [rng.integers(0, V, size=(64,)).astype(np.int32)
             for _ in range(2)]
    long_len = SWA["S"]
    wave1 = (swa_prompts(rng, V, heads, 8, 512)
             + swa_prompts(rng, V, heads, 2, long_len))
    wave2 = wave1 + swa_prompts(rng, V, heads, 4, 512)

    # one K8 launch at the long prompts' length and one K7 launch over a
    # full ring (a decode step with a long prompt active, read from the
    # engine's host state: no device sync), as the path makes them
    fa_seen, dec_seen = [], []
    fa_fn, dec_fn = fa_ops.flash_attention_cuda, dec_ops.decode_attention_cuda
    fa_ops.flash_attention_cuda = _keep_first(
        fa_seen, fa_fn, lambda q, k, v, **kw: q.shape[1] == long_len)
    dec_ops.decode_attention_cuda = _keep_first(
        dec_seen, dec_fn,
        lambda *args: any(len(eng._prompts.get(a.req_id, ())) >= Sk
                          for a in eng.active.values()), clone=(1, 2))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                       # the swa path starts here
    first = {}
    for w, wave in enumerate((wave1, wave2), 1):
        hits0, steps0, n0 = (eng.stats()["edge_hits"], eng.step_count,
                             len(eng.results))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rid_of = {eng.submit(p): i for i, p in enumerate(wave)}
        eng.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        new = eng.results[n0:]
        gen = sum(len(r.tokens) for r in new if r.source == "cloud")
        steps = eng.step_count - steps0
        hits = eng.stats()["edge_hits"] - hits0
        print(f"swa: wave {w}: {len(new)} requests, {hits} edge hits, "
              f"{gen} tokens generated in {dt:.3f} s ({gen / dt:.1f} tok/s), "
              f"{steps} steps, mean step {dt / max(1, steps) * 1e3:.2f} ms",
              flush=True)
        for r in new:
            i = rid_of[r.req_id]
            if w == 1:
                assert r.source == "cloud", ("wave 1", i, r.source)
                first[i] = r.tokens.tolist()
            elif i < len(wave1):
                # a repeated prompt is an edge hit serving its own tokens
                assert r.source == "edge", ("wave 2 repeat", i, r.source)
                assert r.tokens.tolist() == first[i], ("phantom", i)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)              # ... and ends here
    fa_ops.flash_attention_cuda = fa_fn
    dec_ops.decode_attention_cuda = dec_fn
    st = eng.stats()
    n_req = st["completed"]
    toks_out = np.concatenate([r.tokens for r in eng.results])
    assert n_req == len(wave1) + len(wave2), n_req
    assert st["max_step_ladder"] <= 2, st["max_step_ladder"]
    assert st["dispatches"]["prefill_chunk"] == 0, st["dispatches"]
    assert st["dispatches"]["prefill"] >= 3, st["dispatches"]
    assert ((toks_out >= 0) & (toks_out < V)).all()
    for name in ("flash_attention", "decode_attention"):
        assert launches[name] > 0, (name, launches)
    assert fa_seen and dec_seen, "no launch at the long prompts' shapes"
    print(f"swa: {n_req} completed (edge {st['edge_hits']}, cloud "
          f"{st['cloud']}), prefill tokens {st['prefill_tokens']}, "
          f"max_step_ladder {st['max_step_ladder']}, dispatches "
          f"{st['dispatches']}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"per request: flash_attention "
          f"{launches['flash_attention'] / n_req:.2f}, decode_attention "
          f"{launches['decode_attention'] / n_req:.2f}; launches "
          f"{launches}", flush=True)
    on_path = swa_on_path(torch, fa_seen[0], dec_seen[0], cfg.sliding_window)
    profile_wave(torch, eng, [(p, 0, 0) for p in
                              swa_prompts(rng, V, heads, 4, 512)
                              + swa_prompts(rng, V, heads, 2, long_len)],
                 label="swa: profile wave 3")
    del eng, model
    torch.cuda.empty_cache()
    return launches, n_req, on_path


def swa_on_path(torch, fa_call, dec_call, window):
    """K8's first launch at S = 4608 (a layer of the long prompts' prefill)
    and K7's first launch over a full ring (a decode step while the long
    prompts decode), each held against its plain version on the same
    tensors (bf16, 2e-2), then timed there beside its SDPA yardstick: K8
    on one row of the launch, K7 on the whole launch."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    timer = Timer(torch)
    (q, k, v), kw, out = fa_call
    fa_err = flash_agree(torch, q, k, v, out, window)
    q1, k1, v1 = q[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous()
    b_ms, b_by = bound(*flash_work(q1, k1, window), _dt(q.dtype))
    B, S, H, D = q.shape
    K = k.shape[2]
    fa = {"shape": f"B={B} S={S} H={H} K={K} D={D} window={window} "
                   f"{_dt(q.dtype)} (timed on row 0)",
          "max_abs_err": fa_err,
          **times(timer, lambda: flash_attention_cuda(q1, k1, v1, **kw),
                  sdpa_band(torch, q1, k1, v1, window)),
          "plain_ms": timer(lambda: flash_attention_ref(q1, k1, v1,
                                                        window=window)),
          "bound_ms": b_ms, "bound_by": b_by}
    (q, k, v, ln), _, out = dec_call
    dec_err = decode_agree(torch, q, k, v, ln, out)
    b_ms, b_by = bound(*decode_work(q, k, ln), _dt(q.dtype))
    dec = {"shape": f"B={q.shape[0]} Sk={k.shape[1]} H={q.shape[1]} "
                    f"K={k.shape[2]} D={q.shape[2]} kv_len "
                    f"{ln.tolist()} {_dt(q.dtype)}",
           "max_abs_err": dec_err,
           **times(timer, lambda: decode_attention_cuda(q, k, v, ln),
                   sdpa_slots(torch, q, k, v, ln)),
           "plain_ms": timer(lambda: decode_attention_ref(q, k, v, ln)),
           "bound_ms": b_ms, "bound_by": b_by}
    for name, r in (("flash_attention", fa), ("decode_attention", dec)):
        print(f"swa: {name} on the path ({r['shape']}): == plain (max err "
              f"{r['max_abs_err']:.3g}); {times_text(r)}", flush=True)
    return {"flash_attention": fa, "decode_attention": dec}


# ---------------------------------------------------------------------------
# 7. kernel path vs plain path, end to end
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


def phase_federated_e2e(torch):
    """coic-paper fp32 through the federated waves, lookup_impl "auto"
    (the similarity and IVF-PQ kernels) vs "ref" (their plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("coic-paper"), dtype="float32")
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    out = {}
    for impl in ("auto", "ref"):
        eng, mb = federated_engine(torch, model, lookup_impl=impl)
        _, waves = federated_waves(torch, eng, mb, cfg.vocab_size)
        out[impl] = ([w["recs"] for w in waves],
                     eng.sem_fed.tier_counts)
    assert out["auto"] == out["ref"], "federated kernel and plain paths differ"
    recs, tiers = out["auto"]
    print(f"e2e: coic-paper fp32 federated, {sum(map(len, recs))} requests "
          f"(tier counts {tiers}): tokens, sources and tier counts identical "
          "through the kernels and the plain versions", flush=True)



def phase_slotted_e2e(torch):
    """The slotted cache (kv_page=0) with the model's attention_impl
    "auto" (flash attention K8 for the descriptor prefix and prefill,
    flash-decode K7 for decode) vs "ref" (their plain versions), fp32:
    coic-paper with prefill_chunk 128 (prompts past 128 tokens go through
    _advance_chunk) and h2o-danube3-4b at its full widths cut to 2 layers
    (equal-length prefill runs).  Tokens and sources must be identical."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.coic import CoICConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    for name, cut, lens in (("coic-paper", {}, None),
                            ("h2o-danube3-4b", {"num_layers": 2},
                             (128, 256))):
        cfg = dataclasses.replace(get_config(name), dtype="float32", **cut)
        out = {}
        for impl in ("auto", "ref"):
            model = build_model(
                cfg, attention_impl=impl, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
            eng = ServingEngine(model, ServingConfig(
                max_batch=8, max_len=512, max_new_tokens=16, kv_page=0,
                prefill_chunk=128,
                coic=CoICConfig(capacity=512, threshold=0.98)),
                device="cuda")
            rng = np.random.default_rng(0)
            heads = [rng.integers(0, cfg.vocab_size, size=(64,))
                     .astype(np.int32) for _ in range(2)]

            def prompts(n):
                if lens is None:
                    return stream(rng, cfg.vocab_size, heads, n)
                # equal-length halves: prefill runs of n / 2 rows
                return [swa_prompts(rng, cfg.vocab_size, heads, 1,
                                    lens[2 * i // n])[0] for i in range(n)]
            wave1 = prompts(8)
            reset_launches()
            for wave in (wave1, wave1 + prompts(8)):
                for p in wave:
                    eng.submit(p)
                eng.run_until_drained()
            torch.cuda.synchronize()
            n = dict(LAUNCHES)
            if impl == "auto":
                assert n["flash_attention"] > 0 and \
                    n["decode_attention"] > 0, n
            out[impl] = {r.req_id: (r.tokens.tolist(), r.source)
                         for r in eng.results}
            disp = eng.stats()["dispatches"]
            del eng, model
            torch.cuda.empty_cache()
        assert out["auto"] == out["ref"], f"{name}: slotted paths differ"
        n_hit = sum(src == "edge" for _, src in out["auto"].values())
        print(f"e2e: {name} fp32 slotted ({cfg.num_layers} layers), "
              f"{len(out['auto'])} requests ({n_hit} edge hits, dispatches "
              f"{disp}): tokens and sources identical through flash "
              "attention + flash-decode and their plain versions",
              flush=True)


if __name__ == "__main__":
    main()
