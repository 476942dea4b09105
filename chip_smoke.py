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
  6. reuse   — per-layer KV-block reuse (``core/layer_reuse.py``) on the
               same model: ``BlockReuseCache(block_size=64)`` over a
               ``SharedPrefixWorkload`` stream (4 sessions, a 384-token
               prefix, 128-token suffixes, 12 requests); a request of an
               earlier session reuses exactly its 6 prefix blocks;
               every K2 launch (the per-offset sketch index) held;
  7. swa     — sliding-window serving at full width on the slotted KV
               path: h2o-danube3-4b (random weights, bf16, window 4096)
               behind the CoIC edge cache in ``ServingEngine(kv_page=0)``;
               wave 1 is 8 prompts of 512 tokens, then 2 of 4608 (longer
               than the window: the prefill rolls the ring, flash attention
               skips the keys left of the window, decode wraps the slots),
               wave 2 repeats them (edge hits) with 4 new; one flash-
               attention launch (S = 4608) and one flash-decode launch
               (4096 slots) of the path are held against their plain
               versions run in fp32 on the same values (``path_agree``,
               the rule of every held attention launch) and timed beside
               their SDPA yardsticks; then a profiled wave;
  8. moe     — granite-moe-3b-a800m at full width and depth (40 experts
               top-8, ``dropless``) on the paged path behind the edge
               cache: 8 prompts of a ``SharedPrefixWorkload``, then those
               8 (edge hits) and 8 new of the same sessions (shared
               prefix pages); every K1-K3 launch held, K5 (the G = 3 FMA
               route) and K8 held;
  9. mqa     — granite-20b at full width and depth (48 query heads on 1
               KV head, head_dim 128, GELU MLP): a paged wave (K5's decode
               on its bf16 mma route) and a slotted wave of 512-token
               prompts (K8, K7 at G = 48); every K1-K3 launch held; one
               launch each of K5, K7 and K8 held against its plain
               version and timed beside SDPA and its bound;
 10. qkvb    — qwen2-72b at full width (QKV biases), depth cut to 8 of 80
               layers (the full depth does not fit the card), one paged
               wave; K1-K3, K5 and K8 held;
 11. mla     — deepseek-v2-lite-16b at full width and depth (27 layers,
               MLA, 64 experts top-6 and 2 shared, ``dropless``) on the
               paged path: the serve phase's waves; K1-K3 held; every
               launch of the absorbed MLA decode (27 a decode step) held;
               K5, K7 and K8 launch 0 times (the chunks gather and expand
               the latent, as in the reference); the latent pages of the
               session heads shared;
 12. ssm     — mamba2-2.7b at full width and depth (64 SSD layers) on the
               slotted path, exact-length prefill runs: 4 prompts of 256
               and 4 of 512 tokens, then those 8 and 8 new; K1-K3 held, no
               attention kernel, every cache leaf finite;
 13. hybrid  — jamba-v0.1-52b at full width, depth cut to 16 of 32 layers
               (two repeats of its 8-layer pattern; the full depth's
               ~102 GB of bf16 weights exceed the card), the ssm waves;
               K1-K3 held; one launch each of K7 and K8 at G = 4, D = 128
               held and timed beside SDPA and its bound;
 14. llava   — llava-next-34b at full width (56/8 heads of 128: G = 7),
               depth cut to 8 of 60 layers, bf16: a paged serve wave
               (text only, as the reference's engine serves it; K1-K3
               held, K5's G = 7 decode and K8 held and timed), then a
               model-level prefill of 576 image patches + 128 tokens
               (B = 2) against ``forward``, its K8 launch (S = 704) held
               and timed beside SDPA;
 15. train   — llama3.2-1b at its published widths and depth, fp32
               master and bf16 compute, remat "full", loss_chunk 256:
               8 ``Trainer.fit`` steps of ``SyntheticLMData(seq_len=1025,
               global_batch=8)`` in 2 microbatches under the profiler;
               finite and falling loss, a gradient for every layer of
               every leaf, K8 launched (its forward; the backward is the
               plain version's) and held; a checkpoint at step 4 restored
               into a fresh state reruns step 5 to the same loss;
 16. whisper — whisper-small at its published widths and depth: fp32
               encode (4 x 1500 frames), prefill and 32 decode steps
               against ``decode_full``; 4 bf16 ``Trainer`` steps of
               ``EncDecLM.loss``; no kernel (plain attention, as in the
               reference);
 17. mesh    — the multi-card slice on 4 gloo ranks sharing the card
               (spawned; their collectives of CUDA tensors staged through
               host memory): (a) a 4-node cooperative cluster on a cache
               mesh (llama3.2-1b's 2048-wide descriptors, 512 slots,
               threshold 0.98; 3 waves, a node kill, a surviving lookup on
               a 3-rank mesh) against the same cluster without a mesh
               (hits, tiers, owners, scores, payloads and stats equal, bit
               for bit) and every collective peer probe bit-equal to one
               pooled K4 launch; (b) sharded training of llama3.2-1b (full
               width, 2 layers) on (data 2, model 2), fp32 within 1e-5 of
               the one-rank step, bf16 within 2e-2 / 2e-3, every K8
               launch at 16/4 local heads held; (c) elastic 4 -> 2 data
               shards at step 3 with a resharded restore from a checkpoint
               under the git-ignored ``build/``; (d) the compressed
               cross-pod step on (pod 2, data 1, model 2), coic-paper,
               within 0.05 of the exact loss, where the untrained weights
               end more than 0.05 from it; (e)
               granite-moe's expert-parallel MoE layer at full width
               against the dense dispatch; K4 and K8 timed at the phase's
               shapes;
 18. launch  — the launchers as a user starts them: ``launch.serve`` at
               llama3.2-1b's full width and depth with the reference's
               defaults (64 Zipf requests over 16 prompts of 64 tokens,
               16 new; the slotted cache), then the edge cache's lookup
               API over the prompts it served: K1-K3, K7 and K8 launched
               and every launch held; ``launch.train`` on one card (6
               steps, batch 8 x 256, full depth; K8 launched); the train
               launcher on (data 2, model 2) as 4 gloo ranks sharing the
               card under ``torchrun --standalone`` (reduced config, 3
               steps) against a one-card run of the same config: losses,
               the first step's gradient and update (rank 0's checkpoint
               against the one-card run's), and an untrained run of the
               same batches that the update rule must refuse; one
               dry-run cell (llama3.2-1b x train_4k, single pod) in a
               subprocess;
 19. e2e     — the kernel path against the plain path, in fp32 (TF32
               off), decoded tokens and sources identical: coic-paper
               attn_impl "paged" vs "gather" on one cluster, lookup_impl
               "auto" vs "ref" on the federated waves, then the slotted
               cache with the model's attention_impl "auto" (flash
               attention and flash-decode kernels) vs "ref", for
               coic-paper (chunked admission) and h2o-danube3-4b at full
               width cut to 2 layers; then granite-20b (paged and
               slotted), granite-moe-3b-a800m (paged, ``dropless``),
               qwen2-72b (paged), deepseek-v2-lite-16b (paged) and
               mamba2-2.7b (slotted) at full width cut to 2 layers and
               jamba-v0.1-52b (slotted) cut to one 8-layer pattern, every
               kernel against every plain version, tier counts equal too;
               a train step of llama3.2-1b (2 layers) through K8 against
               its plain version (loss, gradients, parameters), and K8's
               ``FlashAttention`` gradients at the train path's shape
               against plain autograd.
 20. shard   — (run after mesh, before e2e) the sharded prefill and the
               sequence-sharded decode (``serving/sharded.py``) on 4 gloo
               ranks sharing the card as (data 2, model 2), each rank
               holding its rows' range of every cache leaf's slots and
               merging the ranks' partial softmaxes by K7's log-sum-exp:
               (a) llama3.2-1b at full width under ``RULES_SERVE``, 4
               right-padded prompts of 200-512 tokens over 1024 slots,
               fp32 at 2 layers for 16 greedy steps against one card
               (tokens identical, logits within 1e-4), then bf16 at full
               depth for 8 steps with every K7 (lse) and K8 launch held;
               (b) h2o-danube3-4b (2 layers, fp32) under
               ``RULES_SERVE_LONG``, a 6140-token prompt past its window,
               8 steps, tokens identical to one card; (c)
               deepseek-v2-lite-16b (MLA) and mamba2-2.7b (SSM), 2 layers,
               fp32, 4 prompts of 256, 4 steps, tokens identical; each
               part's seconds, peak memory per rank, launches per rank and
               the steps' collectives (count and bytes).
 21. coic    — (run after reuse, on its llama3.2-1b) the paper's own
               engine, ``CoICEngine``: (a) Fig. 2a's loop on coic-paper
               (full width, bf16), Zipf(1.1) over 16 prompts of 32 tokens,
               12 batches of 8, under its five (mobile->edge, edge->cloud)
               Mbps conditions, each printing hits, the mean modeled
               latency of CoIC and of the origin baseline and the
               reduction; (b) Fig. 2b's ``load_asset`` of 1-64 MiB float32
               blobs (np.load, then a copy to the card), 8 loads each: the
               first "cloud", every repeat "edge" at 0.0 ms, then a bf16
               CUDA tensor as the key; (c) the cooperative and federated
               ladder on llama3.2-1b (2 clusters x 2 nodes, greedy
               generation of 8 tokens as the cloud through K8 and K7):
               waves of 8 prompts of 128 tokens that miss, then hit a peer,
               then a remote cluster, then hit locally beside 8 new
               misses; K1, K7 and K8 launched and every launch held
               against its plain version; the e2e phase runs (a)'s stream
               in fp32 through the kernels and through the plain versions
               (sources and tiers identical, payloads within 1e-5);
 22. dev     — ``scripts/torch_dev_smoke.py`` on the card: every arch of
               ``ARCH_IDS`` at ``reduced_config`` (loss, prefill, one
               decode step) in bf16, then in fp32 with the attention
               kernels and with their plain versions (decode logits within
               1e-4, argmax equal); every K7 and K8 launch (head_dim 16,
               h2o-danube3's 16-token window) held.

Each phase prints its seconds.

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
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM, data sheet
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
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

    t_phase = time.perf_counter()

    def lap(label):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"{label}: phase {now - t_phase:.1f} s", flush=True)
        t_phase = now

    kernels = phase_kernels(torch)
    lap("build + kernels")
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
    hold_param_count(cfg, model, "model")
    launches, serve = phase_serve(torch, model)
    lap("serve")
    fed_launches, fed_eng, fed_prompts, k6_path = phase_federated(torch,
                                                                  model)
    lap("fed")
    k4_launches = phase_surviving(torch, model, fed_eng, fed_prompts)
    del fed_eng
    lap("k4")
    reuse_launches, reuse_held = phase_reuse(torch, model)
    lap("reuse")
    coic = phase_coic(torch, model)
    del model
    torch.cuda.empty_cache()
    lap("coic")
    dev_launches, dev_held = phase_dev(torch)
    lap("dev")
    swa_launches, swa_requests, swa_on_path = phase_swa(torch)
    lap("swa")
    # the model families; each path's launches and its held launches
    families = {"reuse": (reuse_launches, None,
                          {"similarity_lookup": reuse_held}),
                "coic": coic, "dev": (dev_launches, None, dev_held)}
    for path, fn in (("moe", phase_moe), ("mqa", phase_mqa),
                     ("qkvb", phase_qkvb), ("mla", phase_mla),
                     ("ssm", phase_ssm), ("hybrid", phase_hybrid),
                     ("llava", phase_llava)):
        families[path] = fn(torch)
    train_launches, train_held = phase_train(torch)
    families["train"] = (train_launches, None, train_held)
    phase_whisper(torch)
    families["launch"] = phase_launch(torch)
    mesh_paths = phase_mesh(torch)
    t_phase = time.perf_counter()
    shard_launches, shard_paths = phase_shard(torch)
    lap("shard")
    # each kernel's launches on the path that runs it: the single-cluster
    # serve path (K1-K3, K5), the federated path (K6), the surviving-shard
    # lookup (K4), the sliding-window slotted path (K7, K8)
    paths = {"similarity_topk": (k4_launches, None),
             "ivf_pq_probe": (fed_launches, FED_REQUESTS),
             "decode_attention": (swa_launches, swa_requests),
             "flash_attention": (swa_launches, swa_requests),
             "decode_attention_lse": (shard_launches, None)}
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
    for k in kernels:
        k["paths"] = {}
        for path, (counts, n_req, held) in families.items():
            if counts[k["name"]]:
                k["paths"][path] = {"launches": counts[k["name"]],
                                    "requests": n_req,
                                    **held.get(k["name"], {})}
        if k["name"] in mesh_paths:
            k["paths"]["mesh"] = mesh_paths[k["name"]]
        if k["name"] in shard_paths:
            k["paths"]["shard"] = shard_paths[k["name"]]
    phase_e2e(torch)
    phase_coic_e2e(torch)
    phase_federated_e2e(torch)
    phase_slotted_e2e(torch)
    phase_family_e2e(torch)
    phase_train_e2e(torch)
    lap("e2e")
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
    kernels.append(check_decode_lse(torch, g, timer))
    kernels.append(check_flash(torch, g, timer))
    for k in kernels:
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}, "
              f"{times_text(k)}",
              flush=True)
        for sub in ("prefill", "prefill_b1", "switch"):
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
        entries[key] = {
            "max_abs_err": e,
            **times(timer, lambda: paged_attention(q, kp, vp, bt, ln),
                    sdpa_paged(torch, q, kp, vp, bt, ln)),
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


def sdpa_paged(torch, q, kp, vp, bt, ln):
    """K5's yardstick: one SDPA call over the gathered, GQA-expanded view
    of the pool, the causal mask of each row's chunk as a boolean mask."""
    from repro_torch.kernels.paged_attention import paged_gather_view
    B, C, H, D = q.shape
    K = kp.shape[2]
    S = bt.shape[1] * kp.shape[1]
    kv = [paged_gather_view(x, bt).repeat_interleave(H // K, dim=2)
          .transpose(1, 2).contiguous() for x in (kp, vp)]
    qpos = ln.long()[:, None] + torch.arange(C, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]
    qh = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kv[0], kv[1], attn_mask=mask)


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
    written once; the operations at the rates of the units K6 runs them
    on: the coarse scores and the lookup table as 3xTF32 on the tensor
    cores (three TF32 products per fp32 product), then the S table reads
    added per probed slot in fp32, which need the table first."""
    Q, D = args[0].shape
    L, cap, S = args[4].shape
    n_probe = sel.shape[1]
    n_lists = int(torch.unique(sel).numel())
    nbytes = (Q * D * 4 + Q * 4 + L * D * 4 + L + S * 256 * (D // S) * 4
              + n_lists * cap * (S + 1 + 4) + Q * 8 + Q * n_probe * 4)
    gemm = 3 * (2.0 * Q * L * D + 2.0 * Q * 256 * D)
    flops = (gemm * PEAK_FLOPS["float32"] / PEAK_FLOPS["tf32"]
             + Q * n_probe * cap * S)             # in fp32-rate operations
    return (*bound(nbytes, flops, "float32"), n_lists)

# the federation's default switch to the IVF-PQ board: FederationConfig's
# 64 lists at ann_min_rows = 4096 live rows, cap 96 from the index's 1.5
# slack, 8 probed, and 32 queries
K6_SWITCH = {"Q": 32, "L": 64, "cap": 96, "S": 8, "D": 2048, "n_probe": 8}


def check_ivf_pq_shape(torch, g, Q, L, cap, S, D, n_probe):
    """K6 against its plain version by ``ivf_pq_check`` at k = 1 and 4;
    returns (inputs, max score error, rows excused)."""
    from repro_torch.kernels.ivf_pq import ivf_pq_probe

    args, twin = ivf_inputs(torch, g, Q, L, cap, S, D, n_probe)
    err, excused = 0.0, 0
    for k in (1, 4):
        out = ivf_pq_probe(*args, k=k, n_probe=n_probe)
        torch.cuda.synchronize()
        e, x = ivf_pq_check(torch, args, twin, k, n_probe, out)
        err, excused = max(err, e), excused + x
    return args, err, excused


def ivf_pq_times(torch, timer, args, n_probe):
    """K6's and its plain version's times at k = 1, and the bound."""
    from repro_torch.kernels.ivf_pq import ivf_pq_probe

    _, _, sel = ivf_pq_probe(*args, k=1, n_probe=n_probe, impl="ref")
    b_ms, b_by, n_lists = ivf_pq_bound(torch, args, sel)
    return {**times(timer, lambda: ivf_pq_probe(*args, k=1,
                                                n_probe=n_probe)),
            "plain_ms": timer(lambda: ivf_pq_probe(*args, k=1,
                                                   n_probe=n_probe,
                                                   impl="ref")),
            "bound_ms": b_ms, "bound_by": b_by, "probed_lists": n_lists}


def check_ivf_pq(torch, g, timer):
    """K6 at the region-board scale (Q = 4 home clusters x 64, D = 2048,
    L = 1024 lists x cap 984, ~1M slots, S = 8, n_probe = 16) and at the
    federation's default switch shape (``K6_SWITCH``)."""
    Q, L, cap, S, D, n_probe = 256, 1024, 984, 8, 2048, 16
    args, err, excused = check_ivf_pq_shape(torch, g, Q, L, cap, S, D,
                                            n_probe)
    sw = K6_SWITCH
    sw_args, sw_err, sw_excused = check_ivf_pq_shape(
        torch, g, sw["Q"], sw["L"], sw["cap"], sw["S"], sw["D"],
        sw["n_probe"])
    print(f"kernel ivf_pq_probe: board and switch shapes == plain at k = 1 "
          f"and 4 (max score err {err:.3g} / {sw_err:.3g}); "
          f"{excused + sw_excused} rows excused by near ties (0 < gap < "
          "1e-5); the candidate-free row and the exact twin tie checked",
          flush=True)
    switch = {"shape": " ".join(f"{k}={v}" for k, v in sw.items()) + " k=1",
              "max_abs_err": sw_err, "rows_excused": sw_excused,
              **ivf_pq_times(torch, timer, sw_args, sw["n_probe"])}
    return {"name": "ivf_pq_probe", "route": "cuda",
            "source": "src/repro_torch/csrc/ivf_pq.cu",
            "replaces": "src/repro/kernels/ivf_pq/kernel.py:113",
            "launches": 0, "max_abs_err": max(err, sw_err),
            **ivf_pq_times(torch, timer, args, n_probe),
            "rows_excused": excused,
            "shape": "Q=256 L=1024 cap=984 S=8 D=2048 n_probe=16 k=1",
            "switch": switch}


ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# bf16 outputs from this magnitude up are held within one bf16 step
# (2^-5 in [4, 8)) rather than ATTN_TOL, which the rounding alone can break
BF16_STEP_FROM = 4.0
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
    H, D), k/v (B, S, K, D), the causal band of ``window`` keys (0: every
    earlier key) as a boolean mask."""
    S, H, K = q.shape[1], q.shape[2], k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    p = torch.arange(S, device=q.device)
    band = p[None, :] <= p[:, None]
    if window > 0:
        band &= p[None, :] > p[:, None] - window
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
    """K7: f32 and bf16, head_dim 64 and 120 with GQA groups of 1 and 4 on
    8 KV heads, and granite-20b's grouping (48 query heads on 1 KV head,
    head_dim 128); kv_len 1, ragged and full over 1000 slots (several
    splits, the last ragged), and the kernel's own convention for kv_len 0
    (exact zeros); then timed at the swa path's decode (B = 8, a full
    4096-slot ring, bf16)."""
    from repro_torch.kernels.decode_attention import decode_attention
    err = {"float32": 0.0, "bfloat16": 0.0}
    groups = [(G, 8, D) for D in (64, 120) for G in (1, 4)] + [(48, 1, 128)]
    for dtype in (torch.float32, torch.bfloat16):
        for G, K, D in groups:
            for lens in ((1, 1, 1), (1, 517, 999), (1000,) * 3):
                q, k, v, ln = decode_inputs(torch, g, 3, 1000, K * G, K, D,
                                            dtype, lens)
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


def check_decode_lse(torch, g, timer):
    """K7's lse route (``return_lse``: the sequence-sharded decode's):
    out and lse against the plain version, fp32 and bf16, with one split
    (32 slots, one tile) and several (1000 slots), a row with kv_len 0
    (exact zeros, lse -inf) beside partial and full rows; then timed at
    the swa path's decode shape beside the default route's time there.
    Its bound moves the default route's bytes plus the lse written (B * H
    * 4)."""
    from repro_torch.kernels.decode_attention import decode_attention
    err = {"float32": 0.0, "bfloat16": 0.0}
    lse_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for G, K, D in ((4, 8, 120), (48, 1, 128)):
            for S in (32, 1000):
                q, k, v, ln = decode_inputs(torch, g, 3, S, K * G, K, D,
                                            dtype, (0, S // 2 + 1, S))
                out, lse = decode_attention(q, k, v, ln, return_lse=True)
                ref, ref_lse = decode_attention(q, k, v, ln, impl="ref",
                                                return_lse=True)
                torch.cuda.synchronize()
                assert int(torch.count_nonzero(out[0])) == 0, "kv_len 0"
                assert bool(torch.isneginf(lse[0]).all()), "kv_len 0 lse"
                e = float((out[1:].float() - ref[1:].float()).abs().max())
                assert e <= ATTN_TOL[_dt(dtype)], ("lse route out", S, e)
                el = float((lse[1:] - ref_lse[1:]).abs().max())
                assert el <= SHARD_LSE_TOL, ("lse route lse", S, el)
                err[_dt(dtype)] = max(err[_dt(dtype)], e)
                lse_err = max(lse_err, el)
    B, S, H, K, D = SWA["B"], SWA["Sk"], SWA["H"], SWA["K"], SWA["D"]
    q, k, v, ln = decode_inputs(torch, g, B, S, H, K, D, torch.bfloat16,
                                (S,) * B)
    nbytes, flops = decode_work(q, k, ln)
    b_ms, b_by = bound(nbytes + B * H * 4, flops, "bfloat16")
    return {"name": "decode_attention_lse", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:65",
            "launches": 0, "max_abs_err": err["bfloat16"],
            "f32_max_abs_err": err["float32"], "lse_max_abs_err": lse_err,
            **times(timer, lambda: decode_attention(q, k, v, ln,
                                                    return_lse=True),
                    sdpa_slots(torch, q, k, v, ln)),
            "plain_ms": timer(lambda: decode_attention(
                q, k, v, ln, impl="ref", return_lse=True)),
            "k7_ms": timer(lambda: decode_attention(q, k, v, ln)),
            "k7_device_ms": timer.device(lambda: decode_attention(q, k, v,
                                                                  ln)),
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


def run_waves(torch, eng, waves, label, pace=()):
    """Each wave of prompts submitted to ``eng`` and drained; prints its
    requests, edge hits, tokens generated, tok/s, steps and mean step.
    Waves whose number is in ``pace`` arrive one prompt per engine step
    (users arriving over time) rather than all at once.  Returns each
    wave's new results."""
    out = []
    for w, wave in enumerate(waves, 1):
        hits0, steps0, n0 = eng.stats()["edge_hits"], eng.step_count, \
            len(eng.results)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in wave:
            eng.submit(p)
            if w in pace:
                eng.step()
        eng.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        new = eng.results[n0:]
        gen = sum(len(r.tokens) for r in new if r.source == "cloud")
        steps = eng.step_count - steps0
        hits = eng.stats()["edge_hits"] - hits0
        print(f"{label}: wave {w}: {len(new)} requests, {hits} edge hits, "
              f"{gen} tokens generated in {dt:.3f} s ({gen / dt:.1f} tok/s), "
              f"{steps} steps, mean step {dt / max(1, steps) * 1e3:.2f} ms",
              flush=True)
        out.append(new)
    return out


def edge_lookups(torch, eng, model, prompts, must_hit=None):
    """The edge cache's own lookup API on the served prompts' descriptors,
    unfused (similarity_lookup, K2) and fused (similarity_topk_touch, K3):
    both give the same hits, indices and LRU state, and every prompt hits
    (``must_hit``: the first ``must_hit`` prompts).  Returns each prompt's
    hit."""
    import numpy as np

    from repro_torch.core.descriptor import PrefixDescriptor

    S = max(len(p) for p in prompts)
    toks = np.full((len(prompts), S), -1, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    desc = PrefixDescriptor(model, k_layers=2)(torch.as_tensor(toks,
                                                               device="cuda"))
    state = eng.sem_cluster.states[0]
    res = {}
    for fuse in (False, True):
        cache = dataclasses.replace(eng.semantic, fuse_touch=fuse)
        res[fuse] = cache.lookup(state, desc)
    torch.cuda.synchronize()
    (s0, r0), (s1, r1) = res[False], res[True]
    assert bool(r0.hit[:must_hit].all()), ("served prompts miss", r0.hit)
    assert torch.equal(r0.index, r1.index) and torch.equal(r0.hit, r1.hit)
    assert torch.equal(s0.last_used, s1.last_used)
    assert torch.equal(s0.freq, s1.freq)
    return r0.hit.tolist()


def serving_engine(torch, model, **kw):
    """The smoke's engine: ``ServingEngine(max_batch=8, max_len=512,
    max_new_tokens=16, kv_page=16, prefill_chunk=128, attn_impl="paged")``
    behind the CoIC edge cache (capacity 512, threshold 0.98, 2-layer
    prefix descriptors), ``kw`` replacing serving fields."""
    from repro_torch.core.coic import CoICConfig
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    scfg = dict(max_batch=8, max_len=512, max_new_tokens=16, kv_page=16,
                prefill_chunk=128, attn_impl="paged",
                coic=CoICConfig(capacity=512, threshold=0.98, k_layers=2))
    scfg.update(kw)
    return ServingEngine(model, ServingConfig(**scfg), device="cuda")


def phase_serve(torch, model):
    import numpy as np

    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = model.cfg
    eng = serving_engine(torch, model)
    rng = np.random.default_rng(0)
    heads = [rng.integers(0, cfg.vocab_size, size=(64,)).astype(np.int32)
             for _ in range(2)]
    wave1 = stream(rng, cfg.vocab_size, heads, 8)
    wave2 = wave1 + stream(rng, cfg.vocab_size, heads, 8)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()                       # the main path starts here
    _, new2 = run_waves(torch, eng, (wave1, wave2), "serve")
    hits = sum(r.source == "edge" for r in new2)
    assert hits >= 8, ("wave 2 edge hits", hits)
    edge_lookups(torch, eng, model, wave2)
    launches = dict(LAUNCHES)              # ... and ends here

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


def device_summary(prof, wall_us):
    """A profile's CUDA kernels, their busy time (us) and a line: the wall
    time, the device's busy time and idle share, the six kernels that took
    the most device time."""
    from torch.autograd import DeviceType

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return kern, busy_us, (
        f"wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"(idle share {1 - busy_us / wall_us:.3f}); top kernels: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms"
                    f" x{e.count}" for e in top))


def profile_wave(torch, eng, wave, label="serve: profile wave 3"):
    """Where a serving wave's time goes: one more wave (after the path's
    launch counts were read) of (prompt, node, cluster) requests under
    ``torch.profiler``; prints the wall time, the device's busy and idle
    shares, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import LAUNCHES

    torch.cuda.synchronize()
    k7_calls = LAUNCHES["decode_attention"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p, node, clu in wave:
            eng.submit(p, node_id=node, cluster_id=clu)
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    k7_calls = LAUNCHES["decode_attention"] - k7_calls
    kern, busy_us, text = device_summary(prof, wall_us)
    if busy_us <= 0:
        print(f"{label}: device time not measured (the profiler saw no "
              "kernel)", flush=True)
        return
    # K5's and K7's kernels (csrc/paged_attention.cu names each
    # paged_*_kernel, csrc/decode_attention.cu each decode_*_kernel)
    def share(name, prefix):
        ks = [e for e in kern if prefix in e.key]
        busy = sum(e.self_device_time_total for e in ks)
        return (f"; {name} {busy / 1e3:.2f} ms ({busy / busy_us:.3f} of "
                "device busy): "
                + ", ".join(f"{e.key.split('<')[0].split('::')[-1]} "
                            f"{e.self_device_time_total / 1e3:.2f} ms "
                            f"x{e.count}" for e in ks))

    print(f"{label} ({len(wave)} requests): {text}"
          + share("K5 (paged attention)", "paged_")
          + share(f"K7 (flash-decode, {k7_calls} calls)", "decode_"),
          flush=True)


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
# 6. per-layer KV-block reuse on the serving model
# ---------------------------------------------------------------------------


def phase_reuse(torch, model):
    """``BlockReuseCache(block_size=64)`` on llama3.2-1b over a
    ``SharedPrefixWorkload`` stream: 4 sessions, a 384-token prefix (6
    blocks) and 128-token suffixes, 12 requests of 512 tokens.  A request
    whose session came earlier reuses its 6 prefix blocks exactly, any
    other none; prints the semantic reuses, the reuse rate and the largest
    logit difference between a reused pass and ``model.prefill`` on the
    same prompt (after the path's launch counts were read).  Every K2
    launch (the per-offset sketch index) is held against its plain
    version (``hold_similarity``).  Returns those counts and the held
    row."""
    from repro_torch.core.layer_reuse import BlockReuseCache
    from repro_torch.data.workload import SharedPrefixWorkload
    from repro_torch.kernels import LAUNCHES, reset_launches

    wl = SharedPrefixWorkload(num_sessions=4, prefix_len=384,
                              suffix_min=128, suffix_max=128,
                              vocab_size=model.cfg.vocab_size, seed=0)
    brc = BlockReuseCache(model, block_size=64)
    t0 = time.perf_counter()
    store, restore = capture_similarity()
    torch.cuda.synchronize()
    reset_launches()                       # the reuse path starts here
    seen, per_req, reused = set(), [], []
    try:
        for sess, prompt in wl.stream(12, seed=1):
            logits, _, lengths, st = brc.prefill(prompt)
            assert st["blocks_exact"] == (6 if sess in seen else 0), (sess,
                                                                      st)
            assert int(lengths[0]) == len(prompt) == 512
            if sess in seen:
                reused.append((prompt, logits))
            seen.add(sess)
            per_req.append((sess, st["blocks_exact"], st["blocks_semantic"],
                            st["blocks_computed"]))
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(LAUNCHES)              # ... and ends here
    assert launches["similarity_lookup"] > 0, launches
    held = hold_similarity(torch, "similarity_lookup",
                           store["similarity_lookup"])
    diff = 0.0
    for prompt, logits in reused:
        ref, _, _ = model.prefill(torch.as_tensor(prompt[None],
                                                  device="cuda"))
        d = float((logits.float() - ref[0].float()).abs().max())
        assert d < float("inf"), d                # finite (and not NaN)
        diff = max(diff, d)
    print(f"reuse: {model.cfg.name} bf16, 12 requests of 512 tokens, "
          f"blocks of 64: (session, exact, semantic, computed) {per_req}; "
          f"blocks_semantic {brc.stats.blocks_semantic}, reuse rate "
          f"{brc.stats.reuse_rate:.4f}; max |logit| difference of a reused "
          f"pass against model.prefill {diff:.4g}; "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    print(f"reuse: similarity_lookup on the path ({held['shape']}): "
          f"{held['held']} launch(es) == plain (max score err "
          f"{held['max_abs_err']:.3g}; indices equal)", flush=True)
    return launches, held


# ---------------------------------------------------------------------------
# 7. sliding-window serving on the slotted KV path
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
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model

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
    eng = serving_engine(torch, model, max_len=8192, kv_page=0,
                         attn_impl="gather")
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
    values (``path_agree``), then timed there beside its SDPA yardstick:
    K8 on one row of the launch, K7 on the whole launch."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    timer = Timer(torch)
    (q, k, v), kw, out = fa_call
    fa_err = path_agree(torch, "flash_attention", out, lambda *a:
                        flash_attention_ref(*a, window=window), (q, k, v))
    q1, k1, v1 = q[:1].contiguous(), k[:1].contiguous(), v[:1].contiguous()
    b_ms, b_by = bound(*flash_work(q1, k1, window), _dt(q.dtype))
    B, S, H, D = q.shape
    K = k.shape[2]
    fa = {"shape": f"B={B} S={S} H={H} K={K} D={D} window={window} "
                   f"{_dt(q.dtype)} (timed on row 0)",
          **fa_err,
          **times(timer, lambda: flash_attention_cuda(q1, k1, v1, **kw),
                  sdpa_band(torch, q1, k1, v1, window)),
          "plain_ms": timer(lambda: flash_attention_ref(q1, k1, v1,
                                                        window=window)),
          "bound_ms": b_ms, "bound_by": b_by}
    (q, k, v, ln), _, out = dec_call
    dec_err = path_agree(torch, "decode_attention", out,
                         decode_attention_ref, (q, k, v, ln))
    b_ms, b_by = bound(*decode_work(q, k, ln), _dt(q.dtype))
    dec = {"shape": f"B={q.shape[0]} Sk={k.shape[1]} H={q.shape[1]} "
                    f"K={k.shape[2]} D={q.shape[2]} kv_len "
                    f"{ln.tolist()} {_dt(q.dtype)}",
           **dec_err,
           **times(timer, lambda: decode_attention_cuda(q, k, v, ln),
                   sdpa_slots(torch, q, k, v, ln)),
           "plain_ms": timer(lambda: decode_attention_ref(q, k, v, ln)),
           "bound_ms": b_ms, "bound_by": b_by}
    for name, r in (("flash_attention", fa), ("decode_attention", dec)):
        print(f"swa: {name} on the path ({r['shape']}): == plain "
              f"({agree_text(r)}); {times_text(r)}", flush=True)
    return {"flash_attention": fa, "decode_attention": dec}


# ---------------------------------------------------------------------------
# 8-10. the model families: MoE, multi-query GELU, QKV bias
# ---------------------------------------------------------------------------


def build_full(torch, name, label, **cut):
    """``name`` at its published widths (bf16, random weights from seed 0),
    depth cut by ``cut`` when given; prints the build and the cut."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(name)
    full = cfg.num_layers
    cfg = dataclasses.replace(cfg, **cut)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    depth = (f"{cfg.num_layers} of {full} layers (depth cut)"
             if cfg.num_layers != full else f"{full} layers")
    print(f"{label}: built {cfg.name} ({depth}, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
          f"{cfg.head_dim}, {cfg.dtype}"
          + (f", moe_impl {model.moe_impl}" if cfg.moe else "")
          + f") in {time.perf_counter() - t0:.1f} s", flush=True)
    hold_param_count(cfg, model, label)
    return model


def hold_param_count(cfg, model, label):
    """``cfg.param_count()`` (the model rebuilt on the ``meta`` device)
    against the parameters of ``model``, built on the card; raises if they
    differ."""
    counted = cfg.param_count()
    built = sum(p.numel() for p in model.parameters())
    print(f"{label}: param_count() {counted}, built on the card {built}",
          flush=True)
    if counted != built:
        raise AssertionError(f"{cfg.name}: param_count() {counted} != "
                             f"{built} parameters built")


SIM_KERNELS = ("similarity_topk_batched", "similarity_lookup",
               "similarity_topk_touch")


def capture_similarity(names=SIM_KERNELS):
    """Patch the similarity kernels' wrappers (K1-K3 by default) to keep
    every launch of the path about to run: its arguments copied (the
    cache's keys and LRU state change later) and its outputs.  Returns
    (store, restore)."""
    import repro_torch.kernels.similarity.ops as sim_ops

    store = {name: [] for name in names}
    orig = {name: getattr(sim_ops, f"{name}_cuda") for name in names}

    def keep(kept, fn):
        def call(*args):
            out = fn(*args)
            kept.append(([a.clone() if hasattr(a, "clone") else a
                          for a in args], out))
            return out
        return call
    for name, fn in orig.items():
        setattr(sim_ops, f"{name}_cuda", keep(store[name], fn))

    def restore():
        for name, fn in orig.items():
            setattr(sim_ops, f"{name}_cuda", fn)
    return store, restore


def _max(t) -> float:
    """The largest element of ``t``, 0.0 when it is empty."""
    return float(t.max()) if t.numel() else 0.0


def exact_scores(torch, q, keys, idx):
    """The fp64 dot product of each query with the key at each slot the
    kernel returned: q (..., D) against keys (C, D) shared or (N, C, D)
    per node, at idx (N?, Q, k?)."""
    idx = idx.long()
    if keys.dim() == 3:                    # per node: idx (N, Q, k)
        n = torch.arange(keys.shape[0], device=idx.device).view(
            -1, *([1] * (idx.dim() - 1)))
        kk = keys[n, idx]
    else:
        kk = keys[idx]
    extra = idx.dim() - (q.dim() - 1)
    qq = q.reshape(q.shape[:-1] + (1,) * extra + q.shape[-1:])
    return (qq.double() * kk.double()).sum(-1)


def hold_similarity(torch, name, calls):
    """Every launch of K1-K4 (``name``) a path made, held against the
    plain version on the same tensors: indices and LRU state equal; each
    score of a slot the kernel returned within 1e-6 of the exact (fp64)
    dot product of its query and that key, and every other score (a
    masked slot) equal to the plain version's within 1e-6; a K2 row with
    no valid slot at the kernel's own convention (index 0, score -1e30).
    The fp32 plain version's own score gap from the kernel is reported
    beside (``plain_max_abs_err``): two fp32 summation orders of a
    2048-long dot product near 1 differ by a few 1e-6."""
    from repro_torch.kernels.similarity.ref import (
        similarity_lookup_ref, similarity_topk_batched_ref,
        similarity_topk_ref, similarity_topk_touch_ref)

    err, gap = 0.0, 0.0
    for args, out in calls:
        q, keys = (args[0], args[2] if name.endswith("touch") else args[1])
        if name == "similarity_topk_batched":
            ref = similarity_topk_batched_ref(*args)
        elif name == "similarity_topk":
            ref = similarity_topk_ref(*args)
        elif name == "similarity_lookup":
            ri, rs = similarity_lookup_ref(*args)
            empty = torch.isinf(rs)
            assert bool((out[0][empty] == 0).all()
                        and (out[1][empty] == -1e30).all()), name
            ref = (torch.where(empty, out[0], ri),
                   torch.where(empty, out[1], rs))
        else:
            qmask, valid, lu, fr, clock, k, threshold = args[1:2] + args[3:]
            ref = similarity_topk_touch_ref(q, keys, valid, k, lu, fr, clock,
                                            threshold, mask=qmask)
        for i, (a, b) in enumerate(zip(out, ref)):
            if i != 1:
                assert torch.equal(a, b), (name, "on the path", i)
                continue
            slot = a > -1e29                   # a slot the kernel returned
            d = (a - b).abs()
            e = _max((a.double() - exact_scores(torch, q, keys, out[0]))
                     .abs()[slot])
            assert e <= 1e-6 and _max(d[~slot]) <= 1e-6, (
                name, "score on the path", e, _max(d[~slot]))
            err, gap = max(err, e), max(gap, _max(d[slot]))
    q, keys = calls[0][0][0], calls[0][0][2 if name.endswith("touch")
                                            else 1]
    return {"held": len(calls), "max_abs_err": err, "plain_max_abs_err": gap,
            "shape": f"first: Q={q.shape[-2]} C={keys.shape[-2]} "
                     f"D={keys.shape[-1]} fp32"}


def capture_calls(eng, slotted=False):
    """Patch the kernels' wrappers to keep, of the path about to run,
    every launch of K1-K3 (``capture_similarity``), K8's first launch (the
    descriptor prefix) and the first decode launch of K5 (paged) or K7
    (slotted) made while every batch row decodes (read from the engine's
    host state: no sync), the cache they read copied.  Returns (store,
    restore)."""
    import repro_torch.kernels.decode_attention.ops as dec_ops
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.kernels.paged_attention.ops as pa_ops

    store, sim_restore = capture_similarity()
    store.update({"flash_attention": [], "paged_attention": [],
                  "decode_attention": []})
    orig = (fa_ops.flash_attention_cuda, pa_ops.paged_attention_cuda,
            dec_ops.decode_attention_cuda)
    fa_ops.flash_attention_cuda = _keep_first(
        store["flash_attention"], orig[0], lambda *a, **kw: True)
    if slotted:
        dec_ops.decode_attention_cuda = _keep_first(
            store["decode_attention"], orig[2],
            lambda *a: bool(eng.row_active.all()), clone=(1, 2))
    else:
        pa_ops.paged_attention_cuda = _keep_first(
            store["paged_attention"], orig[1],
            lambda q, *a: q.shape[1] == 1 and bool(eng.row_active.all()),
            clone=(1, 2))

    def restore():
        (fa_ops.flash_attention_cuda, pa_ops.paged_attention_cuda,
         dec_ops.decode_attention_cuda) = orig
        sim_restore()
    return store, restore


def path_agree(torch, name, out, plain, args, shared=(), live=None):
    """Max abs error of a launch a serving path made against its plain
    version run in fp32 on the same values (bf16 arguments widened), one
    batch row at a time (``shared``: the argument positions every row
    reads whole, the page pools; ``live``: the rows that see a key): it
    must lie within ``ATTN_TOL`` of the launch's dtype.  For a bf16 launch
    the plain version also runs in bf16, where it rounds the logits to
    bf16 as the reference does, an error that grows with their magnitude:
    the kernel's distance from that result and that result's own distance
    from the fp32 one are reported beside.  A bf16 output of magnitude
    ``BF16_STEP_FROM`` (4) or more, where one bf16 step (2^-5) exceeds
    2e-2 and the output's own rounding can break it, is held within one
    bf16 step of the fp32 result instead, the rule the kernels phase holds
    K8 to on a V in [4, 8) (ROADMAP Queue 3); the report gives the largest
    output magnitude, the error below 4 and the steps from 4 up."""
    out = out.detach()
    bf16 = out.dtype != torch.float32
    wide = [x.float() if x.is_floating_point() else x for x in args]
    rep = {"max_abs_err": 0.0, "max_abs_out": 0.0}
    if bf16:
        rep.update(dtype_plain_max_abs_err=0.0, plain_max_abs_err=0.0,
                   max_abs_err_below_4=0.0, bf16_steps_from_4=0.0,
                   n_from_4=0)
    for b in range(out.shape[0]):
        if live is not None and not bool(live[b]):
            continue
        def row(xs):
            return [x if i in shared else x[b:b + 1]
                    for i, x in enumerate(xs)]
        o = out[b:b + 1].float()
        exact = plain(*row(wide)).float()
        d = (o - exact).abs()
        rep["max_abs_err"] = max(rep["max_abs_err"], float(d.max()))
        rep["max_abs_out"] = max(rep["max_abs_out"], float(o.abs().max()))
        if bf16:
            big = torch.maximum(o.abs(), exact.abs()) >= BF16_STEP_FROM
            if not bool(big.all()):
                rep["max_abs_err_below_4"] = max(rep["max_abs_err_below_4"],
                                                 float(d[~big].max()))
            if bool(big.any()):
                rep["bf16_steps_from_4"] = max(
                    rep["bf16_steps_from_4"],
                    bf16_steps(torch, o[big], exact[big]))
                rep["n_from_4"] += int(big.sum())
            p = plain(*row(args)).float()
            for key, e in (("dtype_plain_max_abs_err", o - p),
                           ("plain_max_abs_err", p - exact)):
                rep[key] = max(rep[key], float(e.abs().max()))
    ok = (rep["max_abs_err_below_4"] <= ATTN_TOL["bfloat16"]
          and rep["bf16_steps_from_4"] <= 1.0) if bf16 else (
        rep["max_abs_err"] <= ATTN_TOL["float32"])
    assert ok, (name, "on the path", rep)
    return rep


def agree_text(row) -> str:
    """``path_agree``'s report as printed."""
    return (f"max err {row['max_abs_err']:.3g} against the plain version "
            f"in fp32 (max |out| {row['max_abs_out']:.3g}"
            + ("" if not row.get("n_from_4") else
               f"; {row['n_from_4']} outputs from 4 up within "
               f"{row['bf16_steps_from_4']:.3g} bf16 step, the rest within "
               f"{row['max_abs_err_below_4']:.3g}")
            + ")" + ("" if "plain_max_abs_err" not in row else
                     f"; {row['dtype_plain_max_abs_err']:.3g} against "
                     f"it in bf16, itself "
                     f"{row['plain_max_abs_err']:.3g} from fp32"))


def hold_on_path(torch, name, call, timed=False):
    """One launch a serving path made, held against the plain version on
    the same values (``path_agree``; rows that see a key); with
    ``timed``, its times beside SDPA's over the same view and the bound
    worked out from its bytes and operations."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    args, kw, out = call
    args = [a.detach() if hasattr(a, "detach") else a for a in args]
    q = args[0]
    shared, live = (), None
    if name == "flash_attention":
        B, S, H, D = q.shape
        shape = f"B={B} S={S} H={H} K={args[1].shape[2]} D={D}"
        kern = lambda: flash_attention_cuda(*args, **kw)       # noqa: E731
        plain_fn = lambda *a: flash_attention_ref(*a, **kw)    # noqa: E731
        lib, work = sdpa_band(torch, *args, 0), flash_work(q, args[1], 0)
    elif name == "decode_attention":
        B, H, D = q.shape
        shape = (f"B={B} Sk={args[1].shape[1]} H={H} K={args[1].shape[2]} "
                 f"D={D} kv_len {args[3].tolist()}")
        kern = lambda: decode_attention_cuda(*args)            # noqa: E731
        plain_fn = decode_attention_ref
        lib, work = sdpa_slots(torch, *args), decode_work(q, args[1],
                                                          args[3])
    else:
        kp, bt = args[1], args[3]
        B, C, H, D = q.shape
        shape = (f"B={B} C={C} H={H} K={kp.shape[2]} D={D} page="
                 f"{kp.shape[1]} lengths {args[4].tolist()}")
        kern = lambda: paged_attention_cuda(*args)             # noqa: E731
        plain_fn = paged_attention_ref
        lib = sdpa_paged(torch, *args)
        work = paged_work(torch, q, kp, bt, args[4], kp.shape[1])
        shared, live = (1, 2), bt[:, 0] < kp.shape[0]  # rows that see a key
    rep = path_agree(torch, name, out, plain_fn, args, shared, live)
    row = {"shape": f"{shape} {_dt(q.dtype)}", **rep}
    if timed:
        timer = Timer(torch)
        b_ms, b_by = bound(*work, _dt(q.dtype))
        row.update(**times(timer, kern, lib),
                   plain_ms=timer(lambda: plain_fn(*args)),
                   bound_ms=b_ms, bound_by=b_by)
    return row


def serve_family(torch, model, label, waves, paths_kernels, slotted=False,
                 timed=False, pace=(), profile=(), must_hit=None,
                 lookups=None, **kw):
    """One engine (``serving_engine`` + ``kw``) over ``waves`` of prompts
    (``run_waves``), then the edge cache's lookup API on the last wave
    (``edge_lookups``, ``must_hit``; by default on the paged path only,
    ``lookups`` says otherwise): launch counts zeroed before and read
    after; every kernel of ``paths_kernels`` must have launched; its
    captured launches (``capture_calls``) are held against their plain
    versions (K5, K7 and K8 timed with ``timed``); every cache leaf is
    finite.  Then, with ``profile`` prompts, a profiled wave
    (``profile_wave``).  Returns (launches, stats, held rows, results)."""
    import numpy as np

    from repro_torch.kernels import LAUNCHES, reset_launches

    eng = serving_engine(torch, model, **kw)
    store, restore = capture_calls(eng, slotted)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                       # the path starts here
    t0 = time.perf_counter()
    try:
        res = run_waves(torch, eng, waves, label, pace)
        if lookups if lookups is not None else not slotted:
            hit = edge_lookups(torch, eng, model, waves[-1], must_hit)
            print(f"{label}: the edge cache's lookup API: {sum(hit)} of "
                  f"{len(hit)} prompts hit (misses at "
                  f"{[i for i, h in enumerate(hit) if not h]}), fused == "
                  "unfused", flush=True)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(LAUNCHES)              # ... and ends here
    st = eng.stats()
    toks = np.concatenate([r.tokens for r in eng.results])
    assert st["completed"] == sum(map(len, waves)), st["completed"]
    assert st["max_step_ladder"] <= 2, st["max_step_ladder"]
    assert ((toks >= 0) & (toks < model.cfg.vocab_size)).all()
    for k, v in eng.cache.items():
        assert bool(torch.isfinite(v).all()), (label, "cache leaf", k)
    for name in paths_kernels:
        assert launches[name] > 0, (label, name, launches)
    held = {}
    for name, calls in store.items():
        if name in paths_kernels:
            assert calls, (label, "no launch captured", name)
            held[name] = (hold_similarity(torch, name, calls)
                          if name in SIM_KERNELS else
                          hold_on_path(torch, name, calls[0], timed))
    print(f"{label}: {st['completed']} completed (edge {st['edge_hits']}, "
          f"cloud {st['cloud']}), prefill tokens "
          + (f"{st['prefill_tokens']}, " if "prefill_tokens" in st else "")
          + f"dispatches {st['dispatches']}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    for name, row in held.items():
        text = (f"{row['held']} launch(es) == plain (max score err "
                f"{row['max_abs_err']:.3g}; indices and LRU state equal)"
                if name in SIM_KERNELS else
                f"== plain ({agree_text(row)})"
                + (f"; {times_text(row)}" if timed else ""))
        print(f"{label}: {name} on the path ({row['shape']}): {text}",
              flush=True)
    if profile:
        profile_wave(torch, eng, [(p, 0, 0) for p in profile],
                     label=f"{label}: profile wave")
    del eng
    torch.cuda.empty_cache()
    return launches, st, held, res


PAGED_KERNELS = ("similarity_topk_batched", "similarity_lookup",
                 "similarity_topk_touch", "paged_attention",
                 "flash_attention")


def phase_moe(torch):
    """granite-moe-3b-a800m at full width and depth (32 layers, 40 experts
    top-8, ``dropless`` by the d_model rule), bf16, on the paged path
    behind the CoIC edge
    cache: wave 1 is 8 prompts of a ``SharedPrefixWorkload`` (4 sessions,
    a 256-token prefix, 16-64-token suffixes) arriving one per step, so a
    later prompt of a session maps the prefix pages an earlier one
    registered (before any retires into the edge cache); wave 2 is those
    8 (edge hits) and 8 new of the same sessions (edge hits too wherever
    the shared prefix carries the descriptor past the threshold); then a
    profiled wave of 8 prompts of 4 new sessions."""
    from repro_torch.data.workload import SharedPrefixWorkload

    t0 = time.perf_counter()
    model = build_full(torch, "granite-moe-3b-a800m", "moe")
    wl = SharedPrefixWorkload(num_sessions=4, prefix_len=256, suffix_min=16,
                              suffix_max=64, vocab_size=model.cfg.vocab_size,
                              seed=0)
    prompts = [p for _, p in wl.stream(16, seed=1)]
    fresh = dataclasses.replace(wl, seed=2)      # new sessions: misses
    # a descriptor depends on the prompts batched with it (the dropless
    # capacity is the call's, as in the reference: ROADMAP Queue 3), so
    # the lookup API, which batches all 16, is held to the 8 served twice
    launches, st, held, res = serve_family(
        torch, model, "moe", (prompts[:8], prompts), PAGED_KERNELS,
        pace=(1,), profile=[p for _, p in fresh.stream(8, seed=3)],
        must_hit=8)
    assert model.moe_impl == "dropless", model.moe_impl
    assert st["prefill_tokens"]["shared"] > 0, st["prefill_tokens"]
    assert sum(r.source == "edge" for r in res[1]) >= 8, "wave 2 hits"
    del model
    torch.cuda.empty_cache()
    print(f"moe: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, st["completed"], held


def phase_mqa(torch):
    """granite-20b at full width and depth (52 layers, 48 query heads on 1
    KV head, head_dim 128, the GELU MLP), bf16: one paged wave of 8
    prompts of 96-320 tokens (K5's decode on its bf16 mma route), then a
    slotted wave (``kv_page=0``, bucketed prefill) of 8 prompts of 512
    tokens (K8 at 512 positions, K7).  One launch each of K5 (decode), K7
    and K8 is held against its plain version and timed beside SDPA; the
    paged engine then serves a profiled wave of 8 new prompts."""
    import numpy as np

    t0 = time.perf_counter()
    model = build_full(torch, "granite-20b", "mqa")
    V = model.cfg.vocab_size
    rng = np.random.default_rng(4)
    heads = [rng.integers(0, V, size=(64,)).astype(np.int32)
             for _ in range(2)]
    paged = serve_family(torch, model, "mqa paged",
                         (stream(rng, V, heads, 8),), PAGED_KERNELS,
                         timed=True, profile=stream(rng, V, heads, 8))
    slotted = serve_family(
        torch, model, "mqa slotted", (swa_prompts(rng, V, heads, 8, 512),),
        ("similarity_topk_batched", "flash_attention", "decode_attention"),
        slotted=True, timed=True, kv_page=0, prefill_chunk=0, max_len=1024,
        attn_impl="gather")
    del model
    torch.cuda.empty_cache()
    print(f"mqa: phase {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {k: paged[0][k] + slotted[0][k] for k in paged[0]}
    held = {"paged_attention": paged[2]["paged_attention"],
            "flash_attention": slotted[2]["flash_attention"],
            "decode_attention": slotted[2]["decode_attention"]}
    # every K1-K3 launch of both engines was held (``hold_similarity``)
    for name in SIM_KERNELS:
        rows = [w[2][name] for w in (paged, slotted) if name in w[2]]
        if rows:
            held[name] = dict(rows[0], held=sum(r["held"] for r in rows),
                              max_abs_err=max(r["max_abs_err"]
                                              for r in rows))
    return launches, paged[1]["completed"] + slotted[1]["completed"], held


def phase_qkvb(torch):
    """qwen2-72b at full width (64/8 heads, head_dim 128, QKV biases, d_ff
    29568, vocab 152064), depth cut to 8 of 80 layers (the full depth's
    ~145 GB of bf16 weights exceed the card), bf16: one paged wave of 8
    prompts of 96-320 tokens; every token finite, K5 and K8 launched and
    held against their plain versions; then a profiled wave."""
    import numpy as np

    t0 = time.perf_counter()
    model = build_full(torch, "qwen2-72b", "qkvb", num_layers=8)
    V = model.cfg.vocab_size
    rng = np.random.default_rng(5)
    heads = [rng.integers(0, V, size=(64,)).astype(np.int32)
             for _ in range(2)]
    launches, st, held, _ = serve_family(
        torch, model, "qkvb", (stream(rng, V, heads, 8),), PAGED_KERNELS,
        profile=stream(rng, V, heads, 8))
    del model
    torch.cuda.empty_cache()
    print(f"qkvb: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, st["completed"], held


def hold_latent_launches(torch):
    """Patch the absorbed MLA decode's wrapper so that every launch is held,
    as it is made, against the plain version run in fp32 on the same values
    (the pools as the launch read them): a row whose table maps a first
    page within ``ATTN_TOL`` of the launch's dtype (bf16 outputs from
    ``BF16_STEP_FROM`` up within one bf16 step), any other row exact
    zeros.  Returns (report, restore)."""
    import repro_torch.kernels.paged_latent.ops as pl_ops
    from repro_torch.kernels.paged_latent.ref import paged_latent_ref

    orig = pl_ops.paged_latent_cuda
    rep = {"held": 0, "max_abs_err_below_4": 0.0, "bf16_steps_from_4": 0.0,
           "max_abs_out": 0.0}

    def held(q_lat, q_rope, ckv, krope, bt, n_vis, scale):
        out = orig(q_lat, q_rope, ckv, krope, bt, n_vis, scale)
        exact = paged_latent_ref(q_lat.float(), q_rope.float(), ckv.float(),
                                 krope.float(), bt, n_vis, scale)
        live = bt[:, 0] < ckv.shape[0]
        o = out.float()
        assert bool((o[~live] == 0).all()), ("paged_latent", "idle row")
        o, exact = o[live], exact[live]
        big = torch.maximum(o.abs(), exact.abs()) >= (
            BF16_STEP_FROM if out.dtype == torch.bfloat16 else float("inf"))
        if bool((~big).any()):
            rep["max_abs_err_below_4"] = max(
                rep["max_abs_err_below_4"],
                float((o - exact)[~big].abs().max()))
        if bool(big.any()):
            rep["bf16_steps_from_4"] = max(
                rep["bf16_steps_from_4"],
                bf16_steps(torch, o[big], exact[big]))
        rep["max_abs_out"] = max(rep["max_abs_out"],
                                 float(o.abs().max()) if o.numel() else 0.0)
        tol = ATTN_TOL[_dt(out.dtype)]
        assert (rep["max_abs_err_below_4"] <= tol
                and rep["bf16_steps_from_4"] <= 1.0), ("paged_latent", rep)
        rep["held"] += 1
        return out

    pl_ops.paged_latent_cuda = held

    def restore():
        pl_ops.paged_latent_cuda = orig
    return rep, restore


def phase_mla(torch):
    """deepseek-v2-lite-16b at full width and depth (27 layers: the dense
    ``prefix0``, then 26 MoE layers of 64 experts top-6 and 2 shared; MLA
    with a 512-wide latent and 64 rope dims), bf16, ``dropless``, on the
    serve path's paged engine: 8 prompts of 96-320 tokens over 2 session
    heads, then those 8 and 8 new, then a profiled wave.  The chunks
    gather their latent pages and expand them, as in the reference; each
    decode step runs the absorbed MLA decode over the pages in place, 27
    launches, every one held (``hold_latent_launches``); K5, K7 and K8
    never launch; every K1-K3 launch is held; the latent pages of the
    session heads are shared."""
    import numpy as np

    t0 = time.perf_counter()
    model = build_full(torch, "deepseek-v2-lite-16b", "mla")
    V = model.cfg.vocab_size
    rng = np.random.default_rng(6)
    heads = [rng.integers(0, V, size=(64,)).astype(np.int32)
             for _ in range(2)]
    wave1 = stream(rng, V, heads, 8)
    # the descriptor's MoE layer depends on the prompts batched with it
    # (the call's dropless capacity, as in the reference), so the lookup
    # API's hits are read, not gated
    rep, restore = hold_latent_launches(torch)
    try:
        launches, st, held, _ = serve_family(
            torch, model, "mla", (wave1, wave1 + stream(rng, V, heads, 8)),
            SIM_KERNELS, must_hit=0)
    finally:
        restore()
    assert model.moe_impl == "dropless", model.moe_impl
    for name in ("paged_attention", "flash_attention", "decode_attention"):
        assert launches[name] == 0, (name, launches)
    n_mla = sum(b.kind == "mla" for b in model.layers)
    assert launches["paged_latent"] == rep["held"] > 0, (launches, rep)
    assert launches["paged_latent"] == n_mla * st["dispatches"]["decode"], (
        launches, st["dispatches"])
    assert st["kv"]["pages_shared"] > 0, st["kv"]
    print(f"mla: paged_latent launches {launches['paged_latent']} ({n_mla} "
          f"a decode step), each held against the plain version in fp32 "
          f"(max err {rep['max_abs_err_below_4']:.3g} below 4, "
          f"{rep['bf16_steps_from_4']:.3g} bf16 step from 4 up, max |out| "
          f"{rep['max_abs_out']:.3g}); K5 launches "
          f"{launches['paged_attention']}; latent pages shared: "
          f"{st['kv']['pages_shared']} ({st['kv']['tokens_shared']} "
          f"tokens)", flush=True)
    eng = serving_engine(torch, model)
    profile_wave(torch, eng, [(p, 0, 0) for p in stream(rng, V, heads, 8)],
                 label="mla: profile wave")
    del eng
    del model
    torch.cuda.empty_cache()
    print(f"mla: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, st["completed"], held


def recurrent_waves(rng, V, heads):
    """4 prompts of 256 tokens and 4 of 512 (exact-length prefill runs of
    4), then those 8 and 8 new of the same lengths; and a profiled wave
    of 4 of each."""
    def eight():
        return (swa_prompts(rng, V, heads, 4, 256)
                + swa_prompts(rng, V, heads, 4, 512))
    wave1 = eight()
    return (wave1, wave1 + eight()), eight()


def phase_ssm(torch):
    """mamba2-2.7b at full width and depth (64 SSD layers, d_inner 5120,
    80 heads, d_state 128, tied), bf16, on the slotted path (``kv_page=0``,
    exact-length prefill runs, ``max_len`` 1024): no attention kernel
    launches; every K1-K3 launch is held, every lookup of the served
    prompts hits; every cache leaf is finite."""
    import numpy as np

    t0 = time.perf_counter()
    model = build_full(torch, "mamba2-2.7b", "ssm")
    V = model.cfg.vocab_size
    rng = np.random.default_rng(7)
    heads = [rng.integers(0, V, size=(64,)).astype(np.int32)
             for _ in range(2)]
    waves, profile = recurrent_waves(rng, V, heads)
    launches, st, held, _ = serve_family(
        torch, model, "ssm", waves, SIM_KERNELS, slotted=True,
        lookups=True, profile=profile, kv_page=0, prefill_chunk=0,
        max_len=1024, attn_impl="gather")
    for name in ("paged_attention", "flash_attention", "decode_attention"):
        assert launches[name] == 0, (name, launches)
    assert st["dispatches"]["prefill_chunk"] == 0, st["dispatches"]
    del model
    torch.cuda.empty_cache()
    print(f"ssm: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, st["completed"], held


def phase_hybrid(torch):
    """jamba-v0.1-52b at full width, depth cut to 16 of 32 layers (two
    repeats of its 8-layer pattern, attention at positions 4 and 12,
    16-expert top-2 MoE on odd layers; about 52 GB of bf16 weights, the
    full depth about 102 GB), bf16, ``dropless``, on the slotted path as
    ``ssm``: every K1-K3 launch held; one launch each of K8 (the
    descriptor prefix, which runs both repeats) and K7 (a decode step of
    the full batch) held against its plain version and timed beside SDPA
    and its bound."""
    import numpy as np

    t0 = time.perf_counter()
    model = build_full(torch, "jamba-v0.1-52b", "hybrid", num_layers=16)
    V = model.cfg.vocab_size
    rng = np.random.default_rng(8)
    heads = [rng.integers(0, V, size=(64,)).astype(np.int32)
             for _ in range(2)]
    waves, profile = recurrent_waves(rng, V, heads)
    launches, st, held, _ = serve_family(
        torch, model, "hybrid", waves,
        SIM_KERNELS + ("flash_attention", "decode_attention"),
        slotted=True, timed=True, lookups=True, must_hit=0,
        profile=profile, kv_page=0, prefill_chunk=0, max_len=1024,
        attn_impl="gather")
    assert launches["paged_attention"] == 0, launches
    assert st["dispatches"]["prefill_chunk"] == 0, st["dispatches"]
    del model
    torch.cuda.empty_cache()
    print(f"hybrid: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, st["completed"], held


# ---------------------------------------------------------------------------
# 11. kernel path vs plain path, end to end
# ---------------------------------------------------------------------------


def phase_e2e(torch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("coic-paper"), dtype="float32")
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    out = {}
    for attn in ("paged", "gather"):
        eng = serving_engine(torch, model, attn_impl=attn)
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
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model

    for name, cut, lens in (("coic-paper", {}, None),
                            ("h2o-danube3-4b", {"num_layers": 2},
                             (128, 256))):
        cfg = dataclasses.replace(get_config(name), dtype="float32", **cut)
        out = {}
        for impl in ("auto", "ref"):
            model = build_model(
                cfg, attention_impl=impl, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
            eng = serving_engine(torch, model, kv_page=0,
                                 attn_impl="gather")
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


# the families' end-to-end runs: (config, moe_impl, KV layouts, depth);
# jamba keeps one whole 8-layer pattern (a cut below it drops its
# attention layer)
FAMILY_E2E = (("granite-20b", None, ("paged", "slotted"), 2),
              ("granite-moe-3b-a800m", "dropless", ("paged",), 2),
              ("qwen2-72b", None, ("paged",), 2),
              ("deepseek-v2-lite-16b", None, ("paged",), 2),
              ("mamba2-2.7b", None, ("slotted",), 2),
              ("jamba-v0.1-52b", None, ("slotted",), 8))


def router_margins(torch, model, tokens):
    """Each MoE layer's router top-k margin (the k-th largest probability
    less the (k+1)-th) at the last position of ``tokens``, through
    ``model.forward``."""
    import repro_torch.models.layers as L
    seen, orig = [], L.moe_router

    def rec(x, router, top_k):
        top = torch.softmax((x @ router).float(), -1).sort(
            -1, descending=True).values
        seen.append(float(top[-1, top_k - 1] - top[-1, top_k]))
        return orig(x, router, top_k)
    L.moe_router = rec
    try:
        model.forward(torch.as_tensor(tokens[None], device="cuda"))
    finally:
        L.moe_router = orig
    return seen


def phase_family_e2e(torch):
    """granite-20b (paged and slotted), granite-moe-3b-a800m (paged,
    ``dropless``), qwen2-72b (paged), deepseek-v2-lite-16b (paged: the
    dense prefix and one MoE layer) and mamba2-2.7b (slotted) at full
    width cut to 2 layers, and jamba-v0.1-52b (slotted) cut to one 8-layer
    pattern, fp32 (TF32 off), random weights from seed 0: the kernel path
    (the model's attention_impl "auto": K8, K7; attn_impl "paged": K5 and
    MLA's absorbed decode; lookup_impl "auto": K1) against the plain path ("ref", "gather",
    "ref") over two waves (8 prompts, then those 8 and 8 new; the
    recurrent models' of two lengths, 4 of each).  Each kernel that the
    model's layers reach must launch; tokens, sources and tier counts
    must be identical; where an MoE model's tokens diverge, the step, the
    tokens and the router's top-k margins there are printed first."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.coic import CoICConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model

    for name, moe_impl, modes, depth in FAMILY_E2E:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), dtype="float32",
                                  num_layers=depth)
        model = build_model(
            cfg, moe_impl=moe_impl, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
        V = cfg.vocab_size
        kinds = {sl.kind for seg in model.plan for sl in seg.pattern}
        for mode in modes:
            out = {}
            for impl in ("auto", "ref"):
                model.attention_impl = impl
                kw = dict(coic=CoICConfig(capacity=512, threshold=0.98,
                                          k_layers=2, lookup_impl=impl))
                if mode == "paged":
                    kw["attn_impl"] = "paged" if impl == "auto" else "gather"
                else:
                    kw.update(kv_page=0, prefill_chunk=0, attn_impl="gather")
                eng = serving_engine(torch, model, **kw)
                rng = np.random.default_rng(0)
                heads = [rng.integers(0, V, size=(64,)).astype(np.int32)
                         for _ in range(2)]
                if "ssm" in kinds:
                    waves, _ = recurrent_waves(rng, V, heads)
                else:
                    wave1 = stream(rng, V, heads, 8)
                    waves = (wave1, wave1 + stream(rng, V, heads, 8))
                prompts = {}
                reset_launches()
                for wave in waves:
                    for p in wave:
                        prompts[eng.submit(p)] = p
                    eng.run_until_drained()
                torch.cuda.synchronize()
                n = dict(LAUNCHES)
                if impl == "auto":
                    need = ("similarity_topk_batched",) + (
                        ("flash_attention", "paged_attention"
                         if mode == "paged" else "decode_attention")
                        if "attn" in kinds else ()) + (
                        ("paged_latent",)
                        if "mla" in kinds and mode == "paged" else ())
                    assert all(n[k] > 0 for k in need), (name, mode, n)
                out[impl] = ({r.req_id: (r.tokens.tolist(), r.source)
                              for r in eng.results},
                             dict(eng.sem_org.ladder.tier_counts))
                del eng
            model.attention_impl = "auto"
            if out["auto"] != out["ref"] and cfg.moe is not None:
                (ta, _), (tr, _) = out["auto"], out["ref"]
                rid = next(r for r in ta if ta[r] != tr[r])
                a, b = ta[rid][0], tr[rid][0]
                j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                seq = np.concatenate([prompts[rid],
                                      np.asarray(b[:j], np.int32)])
                print(f"e2e: {name} diverges at request {rid}, step {j}: "
                      f"token {a[j:j + 1]} (kernels) vs {b[j:j + 1]} "
                      f"(plain); router top-k margins there "
                      f"{router_margins(torch, model, seq)}", flush=True)
            assert out["auto"] == out["ref"], f"{name} {mode}: paths differ"
            n_hit = sum(src == "edge" for _, src in out["auto"][0].values())
            print(f"e2e: {name} fp32 {mode} (full width, {depth} of "
                  f"{get_config(name).num_layers} layers"
                  + (f", moe_impl {model.moe_impl}" if cfg.moe else "")
                  + f"), {len(out['auto'][0])} requests ({n_hit} edge hits, "
                  f"tier counts {out['auto'][1]}): tokens, sources and tier "
                  f"counts identical through the kernels and their plain "
                  f"versions; {time.perf_counter() - t0:.1f} s", flush=True)
        del model
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 15. training, llava's patches and whisper's encoder-decoder
# ---------------------------------------------------------------------------

# the train phase's settings: llama3.2-1b at its published widths and
# depth, random weights from seed 0, fp32 master, bf16 compute, remat
# "full" (the config's default), chunked CE
TRAIN = dict(loss_chunk=256, seq_len=1025, global_batch=8, microbatches=2,
             peak_lr=3e-4, warmup_steps=2, total_steps=16, steps=8, save_at=4)


def k8_device_ms(kern):
    """K8's device time (ms) among a profile's kernels
    (csrc/flash_attention.cu's are ``flash_kernel`` and
    ``flash_mma_kernel``) and its kernel count."""
    ks = [e for e in kern
          if "flash_kernel" in e.key or "flash_mma_kernel" in e.key]
    return (sum(e.self_device_time_total for e in ks) / 1e3,
            sum(e.count for e in ks))


def capture_flash(every=False):
    """Patch K8's wrapper to keep its first launch, or with ``every`` each
    launch (arguments and output); returns (store, restore)."""
    import repro_torch.kernels.flash_attention.ops as fa_ops

    store, orig = [], fa_ops.flash_attention_cuda

    def keep_every(*args, **kw):
        out = orig(*args, **kw)
        store.append((list(args), kw, out))
        return out
    fa_ops.flash_attention_cuda = keep_every if every else _keep_first(
        store, orig, lambda *a, **kw: True)

    def restore():
        fa_ops.flash_attention_cuda = orig
    return store, restore


def has_gradient(mu, stacked: bool) -> bool:
    """A leaf got a nonzero gradient, in every layer's slice when it is
    stacked: its AdamW first moment (0.1 x the clipped gradient after one
    step, a decaying sum of them after more) is nonzero there."""
    m = mu.reshape(mu.shape[0] if stacked else 1, -1)
    return bool((m.abs().amax(dim=1) > 0).all())


def phase_train(torch):
    """llama3.2-1b at its published widths and depth (16 layers, d_model
    2048, 32/8 heads, vocab 128256, tied), random weights from seed 0,
    fp32 master and bf16 compute, remat "full", ``loss_chunk`` 256
    (``dataclasses.replace``), ``SyntheticLMData(seq_len=1025,
    global_batch=8)`` in 2 microbatches, AdamW at peak lr 3e-4 (warmup 2,
    total 16): 8 steps of ``Trainer.fit`` under the profiler, a checkpoint
    at step 4 (``Checkpointer``, the reference's format, under the
    git-ignored ``build/``).  Gates: every loss and grad norm finite, the
    last loss below the first, every leaf's every layer slice with a
    nonzero gradient, K8 launched on the path (its first launch held
    against the plain version and timed beside SDPA); then step 4 restored
    into a fresh state reruns step 5 to the uninterrupted run's loss,
    exactly.  Returns (launches, held rows)."""
    import math
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           init_train_state)
    from repro_torch.utils.tree import tree_size_bytes

    t0 = time.perf_counter()
    T = TRAIN
    cfg = dataclasses.replace(get_config("llama3.2-1b"),
                              loss_chunk=T["loss_chunk"])
    model = build_model(cfg, device="cuda")
    tcfg = TrainerConfig(peak_lr=T["peak_lr"], warmup_steps=T["warmup_steps"],
                         total_steps=T["total_steps"],
                         microbatches=T["microbatches"])
    # a one-element list, popped into fit: no local keeps an old state
    # alive, so each step frees the one before (as the reference donates it)
    state = [init_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), tcfg)]
    print(f"train: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
          f"{cfg.vocab_size}, tied), remat {cfg.remat!r}, loss_chunk "
          f"{cfg.loss_chunk} (set with dataclasses.replace), fp32 master "
          f"({tree_size_bytes(state[0].params) / 2 ** 30:.2f} GiB) and "
          f"{tcfg.compute_dtype} compute; SyntheticLMData(seq_len="
          f"{T['seq_len']}, global_batch={T['global_batch']}), microbatches "
          f"{tcfg.microbatches}, peak_lr {tcfg.peak_lr}, warmup "
          f"{tcfg.warmup_steps}, total_steps {tcfg.total_steps}", flush=True)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=T["seq_len"],
                           global_batch=T["global_batch"])
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckpt = Checkpointer(str(ckdir), keep=1)
    trainer = Trainer(model, tcfg, checkpointer=ckpt, log_every=0)
    store, restore = capture_flash()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                       # the path starts here
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            mid, hist = trainer.fit(state.pop(), data.iterator(),
                                    T["save_at"],
                                    checkpoint_every=T["save_at"])
            stacked = {n for n, r, *_ in model.leaves() if r is not None}
            every = {k: has_gradient(m, k in stacked)
                     for k, m in mid.opt.mu.items()}
            state.append(mid)
            del mid
            end, rest = trainer.fit(state.pop(), data.iterator(T["save_at"]),
                                    T["steps"] - T["save_at"])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t1) * 1e6
    finally:
        restore()
    launches = dict(LAUNCHES)              # ... and ends here
    hist += rest
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = T["seq_len"] * T["global_batch"]
    for i, h in enumerate(hist, 1):
        print(f"train: step {i}: loss {h['loss']:.6f}, grad_norm "
              f"{h['grad_norm']:.6f}, lr {h['lr']:.6g}, "
              f"{h['seconds'] * 1e3:.1f} ms ({tokens / h['seconds']:.0f} "
              "tokens/s, under the profiler)", flush=True)
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist), hist
    assert hist[-1]["loss"] < hist[0]["loss"], [h["loss"] for h in hist]
    assert all(every.values()), [k for k, v in every.items() if not v]
    assert launches["flash_attention"] > 0, launches
    assert store, "no K8 launch captured on the train path"
    kern, _, text = device_summary(prof, wall_us)
    k8_ms, k8_kernels = k8_device_ms(kern)
    print(f"train: profile of the {T['steps']} steps (the checkpoint's "
          f"host copy at step {T['save_at']} included): {text}", flush=True)
    row = hold_on_path(torch, "flash_attention", store[0], timed=True)
    print(f"train: every loss and grad norm finite, loss {hist[0]['loss']:.4f}"
          f" -> {hist[-1]['loss']:.4f}; all {len(every)} leaves (every layer "
          f"slice) got a gradient; peak memory {peak:.2f} GiB; K8 launches "
          f"{launches['flash_attention']} ({k8_kernels} kernels profiled, "
          f"{k8_ms:.2f} ms device over {T['steps']} steps); launches "
          f"{launches}", flush=True)
    print(f"train: flash_attention on the path ({row['shape']}): == plain "
          f"({agree_text(row)}); {times_text(row)}", flush=True)
    # save at step 4, restore into a fresh state, rerun step 5
    ckpt.wait()
    assert ckpt.steps() == [T["save_at"]], ckpt.steps()
    nbytes = sum(f.stat().st_size for f in ckdir.rglob("*.npy"))
    t1 = time.perf_counter()
    restored = ckpt.restore(T["save_at"], end, device="cuda")
    t_restore = time.perf_counter() - t1
    assert int(restored.step) == T["save_at"]
    del end
    _, again = Trainer(model, tcfg, log_every=0).fit(
        restored, data.iterator(T["save_at"]), 1)
    ref5 = hist[T["save_at"]]["loss"]
    assert again[0]["loss"] == ref5, (again[0]["loss"], ref5)
    print(f"train: checkpoint at step {T['save_at']}: {nbytes / 2 ** 30:.2f} "
          f"GiB of .npy, written in {ckpt.save_seconds[-1]:.1f} s (a thread, "
          f"beside the next steps), restored in {t_restore:.1f} s; step "
          f"{T['save_at'] + 1} rerun from it: loss {again[0]['loss']:.6f} == "
          f"the uninterrupted run's {ref5:.6f}; "
          f"{again[0]['seconds'] * 1e3:.1f} ms ({tokens / again[0]['seconds']:.0f}"
          " tokens/s, no profiler)", flush=True)
    del restored, model
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"train: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, {"flash_attention": row}


def phase_train_e2e(torch):
    """fp32 (TF32 off), llama3.2-1b at full widths cut to 2 layers, random
    weights from seed 0, ``loss_chunk`` 256, one batch of
    ``SyntheticLMData(seq_len=1025, global_batch=4)``: the loss and every
    gradient through K8 (``attention_impl="auto"``: ``FlashAttention``,
    the kernel forward) against the plain version (``"ref"``, plain
    autograd): losses within 1e-5, each leaf's gradient within 1e-4 of
    the plain gradient's norm (||g_k - g_p|| <= 1e-4 ||g_p||); then one
    train step each, the parameters within 1e-6 where the gradient's
    magnitude is at least 1e-6 and within 2 x lr elsewhere.  Then K8's
    ``FlashAttention`` at the train path's shape (B=4 S=1025 H=32 K=8
    D=64 fp32) against plain autograd on the same cotangent: outputs
    within 1e-5, gradients within 1e-6 (the backward is the plain
    version's own, so they should be equal)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.convert import master_params
    from repro_torch.train.trainer import (TrainerConfig, TrainState,
                                           loss_and_grads, make_optimizer,
                                           make_train_step, to_device)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32",
                              loss_chunk=TRAIN["loss_chunk"])
    tcfg = TrainerConfig(peak_lr=TRAIN["peak_lr"],
                         warmup_steps=TRAIN["warmup_steps"],
                         total_steps=TRAIN["total_steps"],
                         compute_dtype="float32")
    batch = SyntheticLMData(vocab_size=cfg.vocab_size,
                            seq_len=TRAIN["seq_len"],
                            global_batch=4).batch_at(0)
    out = {}
    for impl in ("auto", "ref"):
        model = build_model(
            cfg, attention_impl=impl, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
        reset_launches()
        params = master_params(model)
        loss, _, grads = loss_and_grads(model, params,
                                        to_device(batch, "cuda"),
                                        torch.float32)
        state = TrainState(params, make_optimizer(tcfg).init(params),
                           torch.zeros((), dtype=torch.int32, device="cuda"))
        new, met = make_train_step(model, tcfg)(state, batch)
        torch.cuda.synchronize()
        assert (LAUNCHES["flash_attention"] > 0) == (impl == "auto"), (
            impl, dict(LAUNCHES))
        out[impl] = (float(loss), grads, new.params, new.opt.mu,
                     float(met["lr"]))
        del model, state, new
    (lk, gk, pk, mk, lr), (lp, gp, pp, _, _) = out["auto"], out["ref"]
    assert abs(lk - lp) <= 1e-5, (lk, lp)
    g_err = max(float((gk[k] - gp[k]).norm() / gp[k].norm()) for k in gp)
    assert g_err <= 1e-4, g_err
    p_err = small_err = 0.0
    for k in pp:
        d = (pk[k] - pp[k]).abs()
        small = mk[k].abs() / 0.1 < 1e-6           # |clipped gradient|
        p_err = max(p_err, float(d[~small].max()) if (~small).any() else 0)
        small_err = max(small_err, float(d[small].max()) if small.any()
                        else 0)
    assert p_err <= 1e-6 and small_err <= 2 * lr, (p_err, small_err, lr)
    print(f"e2e: train step, llama3.2-1b fp32 (full width, 2 layers): loss "
          f"{lk:.7f} through K8, {lp:.7f} plain (|diff| {abs(lk - lp):.3g}, "
          f"held 1e-5); gradients within {g_err:.3g} of the plain norm (held "
          f"1e-4); parameters within {p_err:.3g} (held 1e-6), {small_err:.3g}"
          f" where |g| < 1e-6 (held 2 x lr = {2 * lr:.3g})", flush=True)
    del out, gk, gp, pk, pp, mk
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, K, D = 4, TRAIN["seq_len"], 32, 8, 64
    q = torch.randn(B, S, H, D, generator=g, device="cuda")
    k, v = (torch.randn(B, S, K, D, generator=g, device="cuda")
            for _ in range(2))
    dout = torch.randn(B, S, H, D, generator=g, device="cuda")
    res = []
    for impl in ("cuda", "ref"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = flash_attention(*leaves, impl=impl)
        res.append((o.detach(), torch.autograd.grad(o, leaves, dout)))
    (ok, gk), (op, gp) = res
    o_err = float((ok - op).abs().max())
    d_err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    assert o_err <= ATTN_TOL["float32"] and d_err <= 1e-6, (o_err, d_err)
    print(f"e2e: K8's FlashAttention (B={B} S={S} H={H} K={K} D={D} fp32): "
          f"output within {o_err:.3g} of plain (held 1e-5), gradients within "
          f"{d_err:.3g} of plain autograd's (held 1e-6); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_llava(torch):
    """llava-next-34b at its published widths (60 layers of d_model 7168,
    56/8 heads of 128, d_ff 20480, vocab 64000, untied), depth cut to 8 of
    60 (the full ~69 GB of bf16 weights leave the serve path no room on
    the card), bf16, random weights from seed 0.  One paged serve wave of
    8 prompts through ``serve_family`` (text only, as the reference's
    engine serves it): K1-K3 held; K5 (decode at G = 7) and K8 held by
    ``path_agree`` and timed beside SDPA.  Then a model-level ``prefill``
    of B = 2 with 576 image patches (one anyres tile, standard normal)
    before 128 text tokens: its last logits against ``forward``'s within
    the reference's prefill-vs-forward rule (rtol 2e-2, atol 2e-2), and
    its K8 launch (S = 704, H = 56, K = 8, D = 128) held and timed beside
    SDPA.  Returns (launches, requests, held rows)."""
    import numpy as np

    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    model = build_full(torch, "llava-next-34b", "llava", num_layers=8)
    cfg = model.cfg
    V = cfg.vocab_size
    rng = np.random.default_rng(9)
    heads = [rng.integers(0, V, size=(64,)).astype(np.int32)
             for _ in range(2)]
    launches, st, held, _ = serve_family(
        torch, model, "llava", (stream(rng, V, heads, 8),), PAGED_KERNELS,
        timed=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    P = cfg.num_image_patches
    toks = torch.randint(0, V, (2, 128), generator=g, device="cuda")
    img = torch.randn(2, P, cfg.d_model, generator=g, device="cuda")
    store, restore = capture_flash()
    reset_launches()
    try:
        lg, cache, ln = model.prefill(toks, image_embeds=img,
                                      max_len=P + 128)
        torch.cuda.synchronize()
    finally:
        restore()
    n_pre = LAUNCHES["flash_attention"]
    full = model.forward(toks, image_embeds=img)[:, -1].float()
    assert ln.tolist() == [P + 128] * 2, ln
    err = float((lg.float() - full).abs().max())
    assert torch.allclose(lg.float(), full, rtol=2e-2, atol=2e-2), err
    assert n_pre == cfg.num_layers and store, n_pre
    row = hold_on_path(torch, "flash_attention", store[0], timed=True)
    print(f"llava: prefill with {P} image patches + 128 tokens (B=2, "
          f"{P + 128} positions): last logits within {err:.3g} of forward's "
          f"(held rtol 2e-2, atol 2e-2); K8 {n_pre} launches; "
          f"flash_attention at the patches ({row['shape']}): == plain "
          f"({agree_text(row)}); {times_text(row)}", flush=True)
    held["flash_attention"] = dict(held["flash_attention"],
                                   image_prefill=row)
    launches["flash_attention"] += n_pre
    del model, cache
    torch.cuda.empty_cache()
    print(f"llava: phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, st["completed"], held


def phase_whisper(torch):
    """whisper-small at its published widths and depth (12 encoder and 12
    decoder layers, d_model 768, 12 heads of 64, d_ff 3072, vocab 51865),
    random weights from seed 0.  fp32 (TF32 off): encode B = 4 x 1500
    frames (whisper's 30 s window; standard normal frame embeddings, the
    front end being a stub as in the reference), prefill 16 decoder
    tokens, then 32 greedy decode steps; each step's logits (and the
    prefill's) against ``decode_full`` over the 48 tokens within atol
    1e-3 + rtol 1e-3, as the reference's decode-consistency test holds
    them.  bf16: 4 ``Trainer`` steps of ``EncDecLM.loss`` on one batch of
    ``SyntheticLMData(encdec=True)`` (1500 frames, dec_len 375 from
    ``decoder_len_ratio`` 0.25, B = 4) repeated, finite and falling loss.
    Its attention is plain, as in the reference: no kernel launches."""
    import itertools
    import math

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           init_train_state)

    t0 = time.perf_counter()
    base = get_config("whisper-small")
    cfg = dataclasses.replace(base, dtype="float32")
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    print(f"whisper: built {cfg.name} ({cfg.encdec.num_encoder_layers} "
          f"encoder + {cfg.num_layers} decoder layers, d_model {cfg.d_model},"
          f" {cfg.num_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, fp32)", flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, S_enc, Sd, steps = 4, 1500, 16, 32
    enc = torch.randn(B, S_enc, cfg.d_model, generator=g, device="cuda")
    dec = torch.randint(0, cfg.vocab_size, (B, Sd), generator=g,
                        device="cuda")
    reset_launches()
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, cache, ln = model.prefill(enc, dec, max_len=Sd + steps)
        logits, cur = [lg], dec
        for _ in range(steps):
            nxt = lg.argmax(-1)
            lg, cache, ln = model.decode_step(cache, nxt, ln)
            cur = torch.cat([cur, nxt[:, None]], dim=1)
            logits.append(lg)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t1
        full = model.decode_full(model.encode(enc), cur)
    err = max(float((a - full[:, Sd - 1 + i]).abs().max())
              for i, a in enumerate(logits))
    for i, a in enumerate(logits):
        assert torch.allclose(a, full[:, Sd - 1 + i], rtol=1e-3,
                              atol=1e-3), (i, err)
    assert not any(LAUNCHES.values()), dict(LAUNCHES)
    print(f"whisper: fp32 encode B={B} x {S_enc} frames, prefill {Sd} "
          f"tokens, {steps} decode steps in {t_dec:.2f} s; every step's "
          f"logits within {err:.3g} of decode_full's (held atol 1e-3 + rtol "
          "1e-3); no kernel launches (plain attention, as in the "
          "reference)", flush=True)
    del model, cache, full, logits
    torch.cuda.empty_cache()
    model = build_model(base, device="cuda")
    tcfg = TrainerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=8)
    state = init_train_state(
        model, torch.Generator(device="cuda").manual_seed(0), tcfg)
    dec_len = int(S_enc * base.encdec.decoder_len_ratio)
    batch = SyntheticLMData(vocab_size=base.vocab_size, seq_len=S_enc,
                            global_batch=B, encdec=True, d_model=base.d_model,
                            dec_len=dec_len).batch_at(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    _, hist = Trainer(model, tcfg, log_every=0).fit(
        state, itertools.repeat(batch), 4)
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    assert not any(LAUNCHES.values()), dict(LAUNCHES)
    print(f"whisper: bf16 Trainer on EncDecLM.loss (B={B}, {S_enc} frames, "
          f"dec_len {dec_len}), one batch 4 times: losses "
          f"{[round(x, 4) for x in losses]}, step ms "
          f"{[round(h['seconds'] * 1e3, 1) for h in hist]}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    del model, state
    torch.cuda.empty_cache()
    print(f"whisper: phase {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# 18. mesh: four gloo ranks sharing the card
# ---------------------------------------------------------------------------

MESH_RANKS = 4
# the cache part: 4 nodes of the serve phase's edge cache (512 slots,
# threshold 0.98, llama3.2-1b's 2048-wide PrefixDescriptor), 8 prompts
# of 96 tokens per node per wave
MESH_CACHE = dict(N=4, C=512, B=8, P=16, prompt=96, threshold=0.98)
# the training parts: llama3.2-1b at its published widths cut to 2 layers
MESH_TRAIN = dict(seq_len=257, global_batch=4, steps=3, peak_lr=1e-3,
                  warmup_steps=2, total_steps=10)
MESH_ELASTIC = dict(seq_len=129, global_batch=4, checkpoint_every=2,
                    fail_at=3, steps=4)
MESH_COMPRESSED = dict(config="coic-paper", seq_len=129, global_batch=4,
                       steps=4)
MESH_EP = dict(B=4, S=128, capacity_factor=4.0)
MESH_DEADLINE_S = 900


def mesh_waves(rng, N, B, n_new):
    """Prompt ids of the cache part's three waves, (N, B) each: wave 1 all
    new; wave 2 node g re-serves node g + 1's wave-1 prompts (peer hits)
    beside new ones; wave 3 each node's own wave-1 prompts (local hits)
    and wave 2's new ones served by another node."""
    import numpy as np
    w1 = np.arange(N * B).reshape(N, B)
    w2 = np.roll(w1, -1, axis=0).copy()
    w2[:, B // 2:] = N * B + np.arange(N * (B - B // 2)).reshape(N, -1)
    w3 = w1.copy()
    w3[:, B // 2:] = np.roll(w2[:, B // 2:], 1, axis=0)
    assert n_new >= int(max(w.max() for w in (w1, w2, w3))) + 1
    return [w1, w2, w3]


def mesh_cache_inputs(torch):
    """The cache part's descriptors, made once here (llama3.2-1b at full
    width, random weights from seed 0, bf16, the descriptor prefix of 2
    layers: K8): (descriptors (n, 2048) fp32 numpy, payloads, waves, K8's
    launches and its first launch held)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.descriptor import PrefixDescriptor
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model

    c = MESH_CACHE
    N, B = c["N"], c["B"]
    n = N * B + N * (B - B // 2)
    model = build_model(get_config("llama3.2-1b"), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, model.cfg.vocab_size, size=(n, c["prompt"]))
    store, restore = capture_flash()
    reset_launches()
    desc = PrefixDescriptor(model, k_layers=2)(
        torch.as_tensor(tokens, device="cuda"))
    torch.cuda.synchronize()
    launches = LAUNCHES["flash_attention"]
    restore()
    assert launches > 0, "the descriptor prefix never launched K8"
    held = hold_on_path(torch, "flash_attention", store[0])
    payload = np.repeat(np.arange(n, dtype=np.float32)[:, None], c["P"], 1)
    del model
    torch.cuda.empty_cache()
    return (desc.cpu().numpy(), payload, mesh_waves(rng, N, B, n), launches,
            held)


def _mesh_cache(torch, rank, desc, payload, waves):
    """(a) The 4-node cluster on a 4-rank cache mesh, then the same cluster
    without a mesh, each through the waves, ``kill_node(1)`` and a
    surviving lookup of wave 1's prompts (a 3-rank cache mesh: ranks 0-2
    run the collective, rank 3 the pooled probe).  Returns both runs'
    results and the mesh run's launches and held K4 / K1 launches."""
    import numpy as np

    from repro_torch.core.cluster import ClusterConfig, CooperativeEdgeCluster
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_cache_mesh
    from repro_torch.parallel.sharding import surviving_topk_lookup

    c = MESH_CACHE
    mesh = make_cache_mesh(c["N"], device="cuda")
    mesh3 = make_cache_mesh(3, device="cuda")
    cfg = ClusterConfig(num_nodes=c["N"], node_capacity=c["C"],
                        key_dim=desc.shape[1], payload_dim=c["P"],
                        threshold=c["threshold"])
    import repro_torch.core.tiers as tiers
    from repro_torch.parallel.sharding import cluster_topk_lookup

    sharded = tiers.sharded_topk_lookup
    pooled = []                     # (collective == one pooled K4 launch)
    cur = {}

    def held_sharded(q, keys, valid, k, mesh_, axis, impl="auto"):
        out = sharded(q, keys, valid, k, mesh_, axis, impl=impl)
        kept = cur["store"]["similarity_topk"]
        n0 = len(kept)
        ref = cluster_topk_lookup(q, keys, valid, k, impl=impl)
        del kept[n0:]               # a launch to compare is not held
        pooled.append(all(torch.equal(a, b) for a, b in zip(out, ref)))
        return out
    runs = {}
    for on_mesh in (True, False):
        store, restore = capture_similarity(("similarity_topk",
                                             "similarity_topk_batched"))
        cur["store"] = store
        tiers.sharded_topk_lookup = held_sharded
        reset_launches()
        cl = CooperativeEdgeCluster(cfg, mesh=mesh if on_mesh else None,
                                    device="cuda")
        out = []
        for ids in waves:
            r = cl.lookup_grouped(desc[ids])
            out.append(tuple(np.asarray(getattr(r, f)) for f in
                             ("hit", "tier", "owner", "score", "value")))
            for g in range(c["N"]):
                miss = ~r.hit[g]
                if miss.any():
                    cl.insert(g, desc[ids[g][miss]], payload[ids[g][miss]])
        cl.kill_node(1)
        keys, valid, _ = cl._stacks()
        q = torch.as_tensor(desc[waves[0].reshape(-1)], device="cuda")
        idx, score = surviving_topk_lookup(
            q, keys, valid, cl.node_alive, 1,
            mesh3 if (on_mesh and rank < 3) else None)
        out.append((idx.cpu().numpy(), score.cpu().numpy()))
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        restore()
        tiers.sharded_topk_lookup = sharded
        # the pooled launches made to compare do not count
        launches["similarity_topk"] -= len(pooled)
        held = {k: hold_similarity(torch, k, v) for k, v in store.items()
                if v}
        runs[on_mesh] = (out, cl.stats(), launches, held, list(pooled))
        pooled.clear()
    return runs


def _mesh_state(torch, model, tcfg):
    """A fresh whole train state of ``model``'s weights."""
    from repro_torch.models.convert import master_params
    from repro_torch.train.trainer import TrainState, make_optimizer
    p = master_params(model)
    return TrainState(params=p, opt=make_optimizer(tcfg).init(p),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def _mesh_llama(torch, dtype="float32"):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2,
                              dtype=dtype)
    return build_model(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))


def _mesh_train(torch, rank):
    """(b) The sharded step on (data 2, model 2): 3 fp32 steps, then 3
    with bf16 compute; rank 0 also runs the one-rank step on the same
    batches.  K8's launches per rank, each held against its plain
    version at the rank's local heads."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import (TrainerConfig, make_train_step,
                                           place_state, state_shardings)

    t = MESH_TRAIN
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    model = _mesh_llama(torch)
    data = SyntheticLMData(vocab_size=model.cfg.vocab_size,
                           seq_len=t["seq_len"],
                           global_batch=t["global_batch"])
    out = {}
    for dtype in ("float32", "bfloat16"):
        tcfg = TrainerConfig(peak_lr=t["peak_lr"],
                             warmup_steps=t["warmup_steps"],
                             total_steps=t["total_steps"],
                             compute_dtype=dtype)
        sh = state_shardings(model, mesh)
        state = place_state(_mesh_state(torch, model, tcfg), sh)
        step = make_train_step(model, tcfg, mesh, sh)
        store, restore = capture_flash(every=True)
        reset_launches()
        losses = []
        for i in range(t["steps"]):
            state, m = step(state, data.batch_at(i))
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        row = {"loss": losses, "launches": LAUNCHES["flash_attention"],
               "heads": tuple(store[0][0][0].shape[2:3])
               + tuple(store[0][0][1].shape[2:3])}
        restore()
        held = [hold_on_path(torch, "flash_attention", c) for c in store]
        row["held"] = {"held": len(held), "max_abs_err": max(
            h["max_abs_err"] for h in held)}
        del state, store, held
        if rank == 0:
            one = make_train_step(model, tcfg)
            s1 = _mesh_state(torch, model, tcfg)
            l1 = []
            for i in range(t["steps"]):
                s1, m = one(s1, data.batch_at(i))
                l1.append(float(m["loss"]))
            row["one_rank"] = l1
            del s1
        torch.cuda.empty_cache()
        out[dtype] = row
    return out


def _mesh_elastic(torch, rank):
    """(c) ``ElasticTrainer``: 4 data shards, a checkpoint every 2 steps
    under the git-ignored ``build/``, a failure at step 3 that shrinks to
    2 shards, a restore of step 2 resharded, 4 steps in all."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.elastic import ElasticConfig, ElasticTrainer
    from repro_torch.train.trainer import TrainerConfig

    e = MESH_ELASTIC
    model = _mesh_llama(torch)
    tcfg = TrainerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20,
                         compute_dtype="float32")
    et = ElasticTrainer(
        model, tcfg,
        ElasticConfig(data_shards=4, model_shards=1,
                      checkpoint_every=e["checkpoint_every"],
                      checkpoint_dir=str(ROOT / "build" / "chip_mesh"
                                         / "elastic")),
        SyntheticLMData(vocab_size=model.cfg.vocab_size,
                        seq_len=e["seq_len"], global_batch=e["global_batch"]),
        failure_schedule={e["fail_at"]: 2}, device="cuda")
    state, history = et.run(e["steps"])
    out = {"events": et.events, "loss": [h["loss"] for h in history],
           "step": None if state is None else int(state.step)}
    del et, state
    torch.cuda.empty_cache()
    return out


def _mesh_compressed(torch, rank):
    """(d) The compressed cross-pod step on (pod 2, data 1, model 2), 4
    steps (the state whole on every rank, as the reference's), then on
    rank 0 the exact one-rank step on the same batches and the initial
    weights' loss on each (a run that does not train).  The paper's own
    model (coic-paper at its published widths and depth): at llama3.2-1b's
    width the per-tensor int8 scale rounds nearly all of the 262 M-entry
    tied embedding's gradient to zero, and 4 steps of error feedback do
    not catch up (``scripts/compress_probe.py``, PERF.md §6)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import (TrainerConfig,
                                           init_compression_errors,
                                           loss_and_grads, make_train_step,
                                           make_train_step_compressed,
                                           to_device)

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    c = MESH_COMPRESSED
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="cuda")
    model = build_model(
        dataclasses.replace(get_config(c["config"]), dtype="float32"),
        device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    tcfg = TrainerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20,
                         compute_dtype="float32")
    data = SyntheticLMData(vocab_size=model.cfg.vocab_size,
                           seq_len=c["seq_len"],
                           global_batch=c["global_batch"])
    step_c = make_train_step_compressed(model, tcfg, mesh)
    err = init_compression_errors(model, mesh, 2)
    state = _mesh_state(torch, model, tcfg)
    lc = []
    for i in range(c["steps"]):
        state, err, m = step_c(state, err, data.batch_at(i))
        lc.append(float(m["loss"]))
    del state, err
    out = {"loss": lc}
    if rank == 0:
        exact, s1, lr = make_train_step(model, tcfg), _mesh_state(
            torch, model, tcfg), []
        for i in range(c["steps"]):
            s1, m = exact(s1, data.batch_at(i))
            lr.append(float(m["loss"]))
        out["exact"] = lr
        p0 = _mesh_state(torch, model, tcfg).params
        out["still"] = [float(loss_and_grads(
            model, p0, to_device(data.batch_at(i), model.device),
            torch.float32)[1]["loss"]) for i in range(c["steps"])]
        del s1, p0
    torch.cuda.empty_cache()
    return out


def _mesh_ep(torch, rank):
    """(e) granite-moe-3b-a800m's MoE layer at full width (40 experts,
    top-8, d_model 1536, d_ff_expert 512), fp32, random weights from seed
    0: ``moe_apply_dropless_ep`` on (data 2, model 2) (40 % 2 == 0: the
    expert-sharded route) against ``moe_apply_dense`` on one rank, and the
    gradients of its output's sum finite."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import set_activation_sharder

    p = MESH_EP
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              dtype="float32")
    m = cfg.moe
    E, D, F = m.num_experts, cfg.d_model, m.d_ff_expert
    g = torch.Generator(device="cuda").manual_seed(0)
    w = types.SimpleNamespace(
        router=L.init_leaf((D, E), "small_normal", torch.float32, g, "cuda"),
        we_gate=L.init_leaf((E, D, F), "normal", torch.float32, g, "cuda"),
        we_up=L.init_leaf((E, D, F), "normal", torch.float32, g, "cuda"),
        we_down=L.init_leaf((E, F, D), "normal", torch.float32, g, "cuda"))
    for t in vars(w).values():
        t.requires_grad_()
    x = torch.randn(p["B"], p["S"], D, generator=g, device="cuda")
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    with set_activation_sharder(mesh):
        y, aux = L.moe_apply_dropless_ep(cfg, w, x, p["capacity_factor"])
    grads = torch.autograd.grad(y.sum(), list(vars(w).values()))
    out = {"finite": all(bool(torch.isfinite(t).all()) for t in grads)}
    if rank == 0:
        with torch.no_grad():
            yd, auxd = L.moe_apply_dense(cfg, w, x)
        tol = (y.detach() - yd).abs() - 2e-4 * yd.abs()
        out.update(y_excess=float(tol.max()), y_err=float(
            (y.detach() - yd).abs().max()), aux=float(aux),
            aux_dense=float(auxd))
    return out


def mesh_rank(rank, world, init, out_dir, inputs):
    """One rank of the mesh phase: a gloo process on the card (the ranks
    share it; NCCL refuses two ranks on one device), every part in turn,
    each part's seconds; the results pickled for the parent."""
    import pickle

    import torch
    import torch.distributed as dist

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    res = {}
    for part, fn in (("cache", lambda: _mesh_cache(torch, rank, *inputs)),
                     ("train", lambda: _mesh_train(torch, rank)),
                     ("elastic", lambda: _mesh_elastic(torch, rank)),
                     ("compressed", lambda: _mesh_compressed(torch, rank)),
                     ("ep", lambda: _mesh_ep(torch, rank))):
        t0 = time.perf_counter()
        res[part] = fn()
        dist.barrier()
        res[part + "_s"] = time.perf_counter() - t0
        if rank == 0:
            print(f"mesh: part {part} done on every rank, "
                  f"{res[part + '_s']:.1f} s; peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
                  "rank 0", flush=True)
    dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _spawn(rank_fn, inputs, out_dir: Path, deadline_s: float):
    """Run ``rank_fn(rank, world, init, out_dir, inputs)`` on
    ``MESH_RANKS`` spawned processes and read back each rank's pickle; a
    failed rank, or the deadline, fails the phase (and every rank is
    stopped)."""
    import pickle

    import torch.multiprocessing as mp

    init = "file://" + str(out_dir / "store")
    ctx = mp.start_processes(rank_fn, args=(MESH_RANKS, init, str(out_dir),
                                            inputs),
                             nprocs=MESH_RANKS, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + deadline_s
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise AssertionError(f"{rank_fn.__name__}: ranks still "
                                     f"running after {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(MESH_RANKS):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def phase_mesh(torch):
    """The multi-card slice on the one card: 4 gloo ranks share it (their
    collectives of CUDA tensors staged through host memory, explicitly,
    ``parallel/collectives.py``), each running (a) the cooperative cluster
    on a cache mesh against the same cluster without one, bit-equal; (b)
    sharded training of llama3.2-1b (full width, 2 layers) on (data 2,
    model 2), fp32 losses within 1e-5 (relative) of the one-rank step and
    bf16 within 2e-2 / 2e-3, K8 launched on every rank at its local heads
    (16 of 32, 4 of 8 KV heads) and held; (c) an elastic 4 -> 2 shrink
    with a resharded restore; (d) the compressed cross-pod step
    (coic-paper) within 0.05 of the exact step's loss; (e)
    expert-parallel MoE at granite-moe's width against the dense
    dispatch.  Returns {kernel: the mesh path's launches per rank and
    held rows}."""
    import shutil

    import numpy as np

    from repro_torch.kernels.similarity import similarity_topk

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    desc, payload, waves, k8_parent, k8_held = mesh_cache_inputs(torch)
    print(f"mesh: {MESH_RANKS} gloo ranks share "
          f"{torch.cuda.get_device_name(0)}; their collectives of CUDA "
          "tensors are staged through host memory (.cpu(), the collective, "
          ".to(device))", flush=True)
    res = _spawn(mesh_rank, (desc, payload, waves), out_dir,
                 MESH_DEADLINE_S)

    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)

    # (a) the cache: every rank against the same cluster without a mesh
    k4, k1, score_err, n_pooled = [], [], 0.0, []
    for r, rr in enumerate(res):
        (m_out, m_stats, m_l, m_held, m_pool), (p_out, p_stats, _, _, _) = (
            rr["cache"][True], rr["cache"][False])
        for w, (a, b) in enumerate(zip(m_out, p_out)):
            names = (("hit", "tier", "owner", "score", "value")
                     if len(a) == 5 else ("idx", "score"))
            for f, x, y in zip(names, a, b):
                if f == "score":
                    both = np.isfinite(x) & np.isfinite(y)
                    score_err = max(score_err, float(np.max(
                        np.abs(x - y), where=both, initial=0)))
                check(np.array_equal(x, y), f"(a) rank {r} wave {w} {f}")
        check(m_stats == p_stats, f"(a) rank {r} stats")
        check(all(m_pool) and len(m_pool) > 0,
              f"(a) rank {r}: a collective probe differs from one pooled "
              f"K4 launch ({m_pool})")
        n_pooled.append(len(m_pool))
        check(m_l["similarity_topk"] > 0, f"(a) rank {r}: K4 never launched")
        k4.append((m_l["similarity_topk"], m_held.get("similarity_topk", {
            "held": 0, "max_abs_err": float("nan")})))
        k1.append((m_l["similarity_topk_batched"],
                   m_held["similarity_topk_batched"]))
        for a, b in zip(m_out, res[0]["cache"][True][0]):
            for x, y in zip(a, b):
                check(np.array_equal(x, y), f"(a) rank {r} differs from 0")
    tiers = res[0]["cache"][True][1]["ladder"]["tier_counts"]
    print(f"mesh: (a) cache: 4 nodes x {MESH_CACHE['C']} slots, D "
          f"{desc.shape[1]}, 3 waves + kill_node(1) + a surviving lookup: "
          f"tiers {tiers}; against the cluster without a mesh (K1 pooled): "
          f"hits, tiers, owners, payloads, stats "
          f"{'equal' if not problems else 'see below'}, scores bit-equal: "
          f"{score_err == 0.0} (max |diff| {score_err:.3g}); every "
          f"collective probe bit-equal to one pooled K4 launch: "
          f"{all(all(rr['cache'][True][4]) for rr in res)} "
          f"({n_pooled} probes per rank); K4 launches per rank "
          f"{[n for n, _ in k4]}, held {[h['held'] for _, h in k4]} (max "
          f"|score err| {max(h['max_abs_err'] for _, h in k4):.3g}); K1 per "
          f"rank {[n for n, _ in k1]}; {res[0]['cache_s']:.1f} s",
          flush=True)

    # (b) sharded training
    tr = [rr["train"] for rr in res]
    f32, one = tr[0]["float32"], tr[0]["float32"]["one_rank"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(f32["loss"], one))
    for r, t in enumerate(tr):
        check(t["float32"]["loss"] == f32["loss"], f"(b) rank {r} fp32 "
              "losses differ from rank 0's")
        check(t["bfloat16"]["loss"] == tr[0]["bfloat16"]["loss"],
              f"(b) rank {r} bf16 losses differ from rank 0's")
        check(t["float32"]["heads"] == (16, 4),
              f"(b) rank {r} K8 heads {t['float32']['heads']}")
        check(t["float32"]["launches"] > 0 and t["bfloat16"]["launches"] > 0,
              f"(b) rank {r}: K8 never launched")
        check(all(np.isfinite(t[d]["loss"]).all() for d in t),
              f"(b) rank {r}: a loss is not finite")
    check(rel <= 1e-5, f"(b) fp32 losses {rel:.3g} from one rank (1e-5)")
    for a, b in zip(tr[0]["bfloat16"]["loss"], tr[0]["bfloat16"]["one_rank"]):
        check(abs(a - b) <= 2e-3 + 2e-2 * abs(b), f"(b) bf16 {a} vs {b}")
    for r, t in enumerate(tr):
        for d in t:
            check(t[d]["held"]["held"] == t[d]["launches"],
                  f"(b) rank {r} {d}: {t[d]['held']['held']} of "
                  f"{t[d]['launches']} K8 launches held")
    k8 = [(t["float32"]["launches"] + t["bfloat16"]["launches"],
           {"held": t["float32"]["held"]["held"]
            + t["bfloat16"]["held"]["held"],
            "max_abs_err": max(t[d]["held"]["max_abs_err"] for d in t)})
          for t in tr]
    print(f"mesh: (b) train: llama3.2-1b (full width, 2 layers) on (data 2, "
          f"model 2): fp32 losses {f32['loss']} vs one rank {one} (max rel "
          f"{rel:.3g}, held 1e-5); bf16 {tr[0]['bfloat16']['loss']} vs "
          f"{tr[0]['bfloat16']['one_rank']} (held 2e-2 / 2e-3); K8 at "
          f"{tr[0]['float32']['heads']} local heads, launches per rank "
          f"{[n for n, _ in k8]}, held {[h['held'] for _, h in k8]} (fp32 "
          f"within {max(t['float32']['held']['max_abs_err'] for t in tr):.3g}"
          f", bf16 within "
          f"{max(t['bfloat16']['held']['max_abs_err'] for t in tr):.3g}); "
          f"{res[0]['train_s']:.1f} s", flush=True)

    # (c) elastic
    el = [rr["elastic"] for rr in res]
    e = MESH_ELASTIC
    for r, x in enumerate(el):
        check(x["events"][0] == (f"step {e['fail_at']}: reconfigure to 2 "
                                 "data shards"), f"(c) rank {r} {x['events']}")
        if r < 2:
            check(x["step"] == e["steps"] and x["events"][1] ==
                  f"restored step {e['fail_at'] - 1} onto new mesh"
                  and np.isfinite(x["loss"]).all(), f"(c) rank {r} {x}")
        else:
            check(x["step"] is None and "outside" in x["events"][1],
                  f"(c) rank {r} {x}")
    lo = el[0]["loss"]
    replay = abs(lo[e["fail_at"]] - lo[e["fail_at"] - 1]) / abs(
        lo[e["fail_at"] - 1]) if len(lo) > e["fail_at"] else float("nan")
    check(replay <= 1e-5, f"(c) the replayed step {replay:.3g} from its "
          "first run (1e-5)")
    print(f"mesh: (c) elastic: events {el[0]['events']} (ranks 2, 3: "
          f"{el[2]['events'][1:]!r}); losses {lo} (the restored step's "
          f"replay within {replay:.3g} of its first run, held 1e-5); "
          f"{res[0]['elastic_s']:.1f} s", flush=True)

    # (d) compressed
    cp = res[0]["compressed"]
    diff = abs(cp["loss"][-1] - cp["exact"][-1])
    check(all(rr["compressed"]["loss"] == cp["loss"] for rr in res),
          "(d) ranks differ")
    check(diff < 0.05, f"(d) compressed {diff:.3g} from exact (0.05)")
    # the limit must be able to fail a step that does not train
    still = abs(cp["still"][-1] - cp["exact"][-1])
    check(still > 0.05, f"(d) a run that does not train ends {still:.3g} "
          "from exact, inside the 0.05 limit")
    print(f"mesh: (d) compressed: {MESH_COMPRESSED['config']} on (pod 2, "
          f"data 1, model 2): losses "
          f"{cp['loss']} vs exact {cp['exact']} (last |diff| {diff:.3g}, held "
          f"0.05); the initial weights on the same batches {cp['still']} "
          f"(last {still:.3g} from exact, must exceed 0.05); "
          f"{res[0]['compressed_s']:.1f} s", flush=True)

    # (e) expert-parallel MoE
    ep = res[0]["ep"]
    check(all(rr["ep"]["finite"] for rr in res), "(e) a gradient not finite")
    check(ep["y_excess"] <= 2e-5, f"(e) output {ep}")
    check(abs(ep["aux"] - ep["aux_dense"]) <= 1e-4 * abs(ep["aux_dense"]),
          f"(e) aux {ep}")
    print(f"mesh: (e) ep: granite-moe (40 experts top-8, d_model 1536) on "
          f"(data 2, model 2), expert-sharded: output within "
          f"{ep['y_err']:.3g} of the dense dispatch (held 2e-4 rel + 2e-5), "
          f"aux {ep['aux']:.7f} vs {ep['aux_dense']:.7f}; gradients finite; "
          f"{res[0]['ep_s']:.1f} s", flush=True)
    for p in problems:
        print(f"mesh: FAILED {p}", flush=True)
    assert not problems, f"mesh: {len(problems)} checks failed"

    # K4 and K8 at the mesh path's shapes, timed here (one process)
    timer = Timer(torch)
    c = MESH_CACHE
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.as_tensor(desc[waves[0].reshape(-1)], device="cuda")
    keys = torch.nn.functional.normalize(torch.randn(
        c["C"], desc.shape[1], generator=g, device="cuda"), dim=1)
    valid = torch.ones(c["C"], dtype=torch.bool, device="cuda")
    Q, C, D = q.shape[0], c["C"], desc.shape[1]
    kt = keys.t().contiguous()
    b_ms, b_by = bound(Q * D * 4 + C * D * 4 + C + Q * 8, 2.0 * Q * C * D,
                       "float32")
    k4_row = {"shape": f"Q={Q} C={C} D={D} k=1 fp32 (one shard)",
              **times(timer, lambda: similarity_topk(q, keys, valid, 1),
                      lambda: torch.topk(q @ kt, 1)),
              "plain_ms": timer(lambda: similarity_topk(q, keys, valid, 1,
                                                        impl="ref")),
              "bound_ms": b_ms, "bound_by": b_by}
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    t = MESH_TRAIN
    B = t["global_batch"] // 2
    qa = torch.randn(B, t["seq_len"], 16, 64, generator=g, device="cuda")
    ka, va = (torch.randn(B, t["seq_len"], 4, 64, generator=g,
                          device="cuda") for _ in range(2))
    kw = dict(causal=True, window=0)
    k8_row = hold_on_path(torch, "flash_attention",
                          ((qa, ka, va), kw, flash_attention_cuda(
                              qa, ka, va, **kw)), timed=True)
    print(f"mesh: K4 at the cache part's shape ({k4_row['shape']}): "
          f"{times_text(k4_row)}; K8 at a train rank's shape "
          f"({k8_row['shape']}): {times_text(k8_row)}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"similarity_topk": {
                "launches_per_rank": [n for n, _ in k4],
                "held_per_rank": [h["held"] for _, h in k4],
                "max_abs_err": max(h["max_abs_err"] for _, h in k4),
                **k4_row},
            "similarity_topk_batched": {
                "launches_per_rank": [n for n, _ in k1],
                "held_per_rank": [h["held"] for _, h in k1],
                "max_abs_err": max(h["max_abs_err"] for _, h in k1)},
            "flash_attention": {
                "launches_per_rank": [n for n, _ in k8],
                "held_per_rank": [h["held"] for _, h in k8],
                "launches_parent": k8_parent,
                "held_parent": k8_held,
                "max_abs_err": max(h["max_abs_err"] for _, h in k8),
                **{k: v for k, v in k8_row.items() if k != "max_abs_err"}}}


# ---------------------------------------------------------------------------
# 19. launch: the launchers and the dry run, started as a user starts them
# ---------------------------------------------------------------------------

# the serve launcher at the reference's defaults: 64 requests of a Zipf
# stream over a pool of 16 prompts of 64 tokens, 16 new tokens each
LAUNCH_SERVE = ["--arch", "llama3.2-1b"]
# the train launcher on one card at its default batch (8) and sequence
# (256), full depth; then the reduced config on (data 2, model 2)
LAUNCH_TRAIN = ["--arch", "llama3.2-1b", "--steps", "6", "--log-every", "1"]
LAUNCH_MESH = ["--arch", "llama3.2-1b", "--reduced", "--steps", "3",
               "--log-every", "1"]
LAUNCH_DRYRUN = ["--arch", "llama3.2-1b", "--shape", "train_4k",
                 "--mesh", "single"]
LAUNCH_KERNELS = SIM_KERNELS + ("decode_attention", "flash_attention")
LAUNCH_DEADLINE_S = 300
# the (2, 2) run's first step against the one-card run's, in bf16 compute:
# each leaf's first moment (0.1 x the clipped gradient) within
# LAUNCH_GRAD_TOL of the one-card one's norm; AdamW's first step is
# lr x g / (|g| + eps), so where the one-card |g| is at least LAUNCH_BIG of
# the leaf's rms gradient the parameters agree within LAUNCH_STEP_TOL, and
# elsewhere, where bf16's noise may flip the gradient's sign, within 2 x lr
LAUNCH_GRAD_TOL = 3e-2
LAUNCH_BIG = 0.1
LAUNCH_STEP_TOL = 1e-6


def capture_every():
    """Patch the wrappers of K1-K3 (``capture_similarity``), K7 and K8 to
    keep every launch of the path about to run: its arguments copied (the
    cache is written in place later) and its output.  Returns (store,
    restore)."""
    import repro_torch.kernels.decode_attention.ops as dec_ops
    import repro_torch.kernels.flash_attention.ops as fa_ops

    store, sim_restore = capture_similarity()
    mods = {"decode_attention": dec_ops, "flash_attention": fa_ops}
    orig = {n: getattr(m, f"{n}_cuda") for n, m in mods.items()}

    def keep(name):
        def call(*args, **kw):
            out = orig[name](*args, **kw)
            store[name].append(([a.clone() for a in args], kw, out))
            return out
        return call
    for name, mod in mods.items():
        store[name] = []
        setattr(mod, f"{name}_cuda", keep(name))

    def restore():
        for name, mod in mods.items():
            setattr(mod, f"{name}_cuda", orig[name])
        sim_restore()
    return store, restore


def hold_attention(torch, name, calls):
    """Every launch of K7 or K8 (``name``) a path made, held against its
    plain version on the same values (``path_agree``); a K7 row with
    ``kv_len`` 0 (a free slot) sees no key, and the kernel gives exact
    zeros there (its convention).  Returns the worst of each figure."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    worst = {}
    for args, kw, out in calls:
        if name == "flash_attention":
            rep = path_agree(torch, name, out,
                             lambda *a: flash_attention_ref(*a, **kw), args)
        else:
            live = args[3] > 0
            assert bool((out[~live] == 0).all()), (name, "free slot")
            rep = path_agree(torch, name, out, decode_attention_ref, args,
                             live=live)
        for k, v in rep.items():
            worst[k] = max(worst.get(k, v), v)
    q = calls[0][0][0]
    return {"held": len(calls), **worst,
            "shape": f"first: {'x'.join(map(str, q.shape))} {_dt(q.dtype)}"}


def run_group(cmd, timeout):
    """``cmd`` from the repository's root with ``src`` on the path, in a
    session of its own: killed whole at the deadline.  Returns its
    stdout; a non-zero exit fails the phase."""
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"{cmd[2:5]} still running after {timeout} s")
    assert p.returncode == 0, (cmd, p.returncode, err[-4000:])
    return out


def first_step_gaps(got, one, lr, b1):
    """``got``'s state after the first step against the one-card run's
    ``one`` (AdamW's ``b1``) by the rule above the constants
    ``LAUNCH_*``: (the worst leaf's first-moment error relative to its
    norm, the share of elements held to ``LAUNCH_STEP_TOL``, their largest
    gap, the largest gap elsewhere, whether every element keeps its bound,
    and the largest |g| / rms of an element off by more than
    ``LAUNCH_STEP_TOL``)."""
    grad = held = n = 0
    big_gap = small_gap = off = 0.0
    for k, mu in one.opt.mu.items():
        grad = max(grad, ((got.opt.mu[k] - mu).norm() / mu.norm()).item())
        g = mu.abs() / (1 - b1)
        rel = g / g.pow(2).mean().sqrt()
        big = rel >= LAUNCH_BIG
        gap = (got.params[k] - one.params[k]).abs()
        held, n = held + int(big.sum()), n + big.numel()
        big_gap = max(big_gap, gap[big].max().item() if big.any() else 0)
        small_gap = max(small_gap,
                        gap[~big].max().item() if (~big).any() else 0)
        bad = gap > LAUNCH_STEP_TOL
        off = max(off, rel[bad].max().item() if bad.any() else 0)
    keeps = big_gap <= LAUNCH_STEP_TOL and small_gap <= 2 * lr
    return grad, held / n, big_gap, small_gap, keeps, off


def phase_launch(torch):
    """The launchers as a user starts them.  (a) ``launch.serve.main`` at
    llama3.2-1b's full width and depth with the reference's defaults (the
    slotted cache), then the edge cache's own lookup API over the prompts
    it served (K2, K3): K1-K3, K7 and K8 launched, every launch held
    against its plain version (``hold_similarity``; ``path_agree``); (b)
    ``launch.train.main`` at llama3.2-1b's full depth on one card (mesh
    1x1), 6 steps: finite losses, K8 launched; (c) the train launcher on
    (data 2, model 2) as 4 gloo ranks sharing the card, started with
    ``torchrun --standalone``, on the reduced config, against a one-card
    launcher run of the same config: its printed losses within 1e-3
    (relative; the step computes in bf16), and rank 0's checkpoint of the
    first step against the one-card run's by ``first_step_gaps``; a run
    of the same batches at lr 0 must break that rule, and the last
    checkpoint must be of step 3; (d)
    ``python -m repro_torch.launch.dryrun`` for llama3.2-1b x train_4k on
    the single-pod mesh in a subprocess (the meta device: no kernel, no
    allocation).  Returns (the serve path's launches, its requests, held
    rows)."""
    import re
    import shutil

    import numpy as np

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import cosine_with_warmup

    t0 = time.perf_counter()
    store, restore = capture_every()
    reset_launches()                       # the serve path starts here
    try:
        eng = lserve.main(LAUNCH_SERVE)
        args = lserve.parser().parse_args(LAUNCH_SERVE)
        pool, draws = lserve.zipf_stream(args, eng.model.cfg.vocab_size)
        hit = edge_lookups(torch, eng, eng.model,
                           [pool[i] for i in sorted(set(draws))])
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(LAUNCHES)              # ... and ends here
    st = eng.stats()
    assert st["completed"] == args.requests, st["completed"]
    toks = np.concatenate([r.tokens for r in eng.results])
    assert ((toks >= 0) & (toks < eng.model.cfg.vocab_size)).all()
    for name in LAUNCH_KERNELS:
        assert launches[name] > 0, ("launch", name, launches)
        assert len(store[name]) == launches[name], (name, len(store[name]))
    del eng
    held = {name: (hold_similarity(torch, name, store[name])
                   if name in SIM_KERNELS else
                   hold_attention(torch, name, store[name]))
            for name in LAUNCH_KERNELS}
    del store
    torch.cuda.empty_cache()
    print(f"launch: (a) launch.serve {' '.join(LAUNCH_SERVE)}: "
          f"{st['completed']} served (edge {st['edge_hits']}, cloud "
          f"{st['cloud']}), the lookup API hit all {len(hit)} prompts "
          f"served; launches {launches}; every launch held: "
          + "; ".join(f"{n} {h['held']} (max err {h['max_abs_err']:.3g})"
                      for n, h in held.items()), flush=True)

    reset_launches()
    _, losses = ltrain.main(LAUNCH_TRAIN)
    torch.cuda.synchronize()
    k8 = LAUNCHES["flash_attention"]
    assert k8 > 0 and all(np.isfinite(losses)), (k8, losses)
    torch.cuda.empty_cache()
    print(f"launch: (b) launch.train {' '.join(LAUNCH_TRAIN)}: losses "
          f"{losses}, K8 {k8} launches", flush=True)

    ck = ROOT / "build" / "chip_launch_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    save = ["--ckpt-every", "1", "--ckpt-dir"]
    out = run_group([sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc-per-node", "4", "-m",
                     "repro_torch.launch.train", *LAUNCH_MESH,
                     "--mesh", "2x2", *save, str(ck / "mesh")],
                    LAUNCH_DEADLINE_S)
    mesh = [float(x) for _, x in re.findall(r"step +(\d+) loss ([\d.]+)",
                                            out)]
    one_state, one = ltrain.main(LAUNCH_MESH + save + [str(ck / "one")])
    _, frozen = ltrain.main(LAUNCH_MESH + ["--lr", "0"] + save
                            + [str(ck / "frozen")])
    assert len(mesh) == len(one), (mesh, one)
    for a, b in zip(mesh, one):
        assert abs(a - b) <= 1e-3 * abs(b), ("2x2 vs 1x1", mesh, one)
    args = ltrain.parser().parse_args(LAUNCH_MESH)
    lr = float(cosine_with_warmup(args.lr, max(10, args.steps // 10),
                                  args.steps)(1))
    first = {d: Checkpointer(str(ck / d)).restore(1, one_state)
             for d in ("mesh", "one", "frozen")}
    last = Checkpointer(str(ck / "mesh")).restore(args.steps, one_state)
    assert int(last.step) == int(one_state.step) == args.steps, last.step
    b1 = AdamWConfig().b1
    grad, share, big_gap, small_gap, keeps, off = first_step_gaps(
        first["mesh"], first["one"], lr, b1)
    assert grad <= LAUNCH_GRAD_TOL and share > 0.5 and keeps, (
        "2x2 vs 1x1 first step", grad, share, big_gap, small_gap)
    _, _, f_big, _, f_keeps, _ = first_step_gaps(
        first["frozen"], first["one"], lr, b1)
    assert not f_keeps, ("the untrained run keeps the rule", f_big)
    del first, last, one_state
    print(f"launch: (c) torchrun --standalone --nproc-per-node 4 "
          f"launch.train {' '.join(LAUNCH_MESH)} --mesh 2x2: "
          f"losses {mesh} (printed, 4 decimals) vs one card {one}, max "
          f"diff {max(abs(a - b) for a, b in zip(mesh, one)):.3g} (held "
          f"1e-3 relative, bf16 compute); the lr-0 run's {frozen}; first "
          f"step (lr {lr:.3g}): first moment within {grad:.3g} of the "
          f"one-card norm (held {LAUNCH_GRAD_TOL}), {share:.4f} of the "
          f"elements (|g| >= {LAUNCH_BIG} rms) within {big_gap:.3g} (held "
          f"{LAUNCH_STEP_TOL}), the rest within {small_gap:.3g} (held 2 x "
          f"lr), the elements off by more than {LAUNCH_STEP_TOL} at |g| <= "
          f"{off:.3g} rms; the lr-0 run's first step {f_big:.3g} off there "
          "(refused, as it must be)", flush=True)

    out_dir = ROOT / "build" / "chip_dryrun"
    out = run_group([sys.executable, "-m", "repro_torch.launch.dryrun",
                     *LAUNCH_DRYRUN, "--out", str(out_dir)],
                    LAUNCH_DEADLINE_S)
    line = next(ln for ln in out.splitlines() if ln.startswith("[OK]"))
    rec = json.loads((out_dir / "llama3_2-1b__train_4k__single.json")
                     .read_text())
    assert rec["ok"] and rec["cost_analysis"]["flops"] > 0, rec
    print(f"launch: (d) dryrun {' '.join(LAUNCH_DRYRUN)}: {line}; "
          f"{rec['collectives']['per_kind']['all-gather']['count']} "
          f"all-gathers, {rec['collectives']['per_kind']['all-reduce']['count']}"
          f" all-reduces; phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, st["completed"], held


# ---------------------------------------------------------------------------
# 20. shard: the sharded prefill and the sequence-sharded decode on 4 ranks
# ---------------------------------------------------------------------------

# Every decode step gathers its weights over 'data' through host memory
# (gloo: 0.5 GiB/s between the card's ranks), so the steps are few: each
# part crosses a rank's slot range a few steps in.
# (a) llama3.2-1b: 4 right-padded prompts, a cache of 1024 slots (512 a
# 'model' rank; the 500-token row crosses into the second range at step 12)
SHARD_A = dict(lengths=(200, 384, 500, 512), max_len=1024, steps=16,
               bf16_steps=8)
# (b) h2o-danube3-4b: one prompt past the 4096 window, the ring's slots over
# (data, model), 1024 a rank; the written slot crosses 2048 at step 4
SHARD_B = dict(prompt=6140, steps=8)
# (c) MLA and SSM: 4 prompts of 256, 512 slots (256 a 'model' rank; the
# first step writes the second range's first slot)
SHARD_C = dict(B=4, prompt=256, max_len=512, steps=4)
SHARD_LOGIT_TOL = 1e-4
SHARD_LSE_TOL = 1e-4
SHARD_DEADLINE_S = 600


def _shard_model(torch, name, layers, dtype):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                              dtype=dtype)
    return build_model(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))


def capture_decode_lse():
    """Patch K7's wrapper to keep every launch of its lse route (the
    arguments, the cache copied: it is written in place later, and the
    output); returns (store, restore)."""
    import repro_torch.kernels.decode_attention.ops as dec_ops

    store, orig = [], dec_ops.decode_attention_cuda

    def keep(*args, **kw):
        out = orig(*args, **kw)
        if kw.get("return_lse", False):
            store.append(([a.clone() if i in (1, 2) else a
                           for i, a in enumerate(args)], kw, out))
        return out
    dec_ops.decode_attention_cuda = keep

    def restore():
        dec_ops.decode_attention_cuda = orig
    return store, restore


def hold_lse(torch, call) -> dict:
    """One launch of K7's lse route held against the plain version on the
    same values: out by ``path_agree`` on the rows with a valid slot, lse
    within ``SHARD_LSE_TOL`` of the plain version's in fp32 there and
    exactly -inf on the rows with none (a rank whose slots are past the
    row's length)."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    args, _, (out, lse) = call
    args = list(args[:4])
    live = args[3] > 0
    rep = path_agree(torch, "decode_attention_lse", out,
                     decode_attention_ref, args, live=live)
    wide = [x.float() if x.is_floating_point() else x for x in args]
    _, ref = decode_attention_ref(*wide, return_lse=True)
    err = float((lse - ref)[live].abs().max()) if bool(live.any()) else 0.0
    assert bool(torch.isneginf(lse[~live]).all()), "lse of an empty row"
    assert err <= SHARD_LSE_TOL, ("decode_attention_lse", "lse", err)
    return {"max_abs_err": rep["max_abs_err"], "lse_max_abs_err": err,
            "empty_rows": int((~live).sum())}


def _shard_run(torch, model, mesh, rules, tokens, lengths, max_len, steps,
               one_card):
    """The sharded prefill of ``tokens`` (B, S) (numpy, right-padded when
    ``lengths`` is given) and ``steps`` greedy decode steps, each step's
    tokens gathered whole over the rows; the launches and collectives of
    the steps alone.  ``one_card``: also the unsharded ``prefill`` and
    ``decode_step`` on the model's own weights, its tokens against the
    sharded ones and the largest logit gap while they agree."""
    import numpy as np

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.parallel.collectives import record_collectives
    from repro_torch.serving.sharded import (gather_batch, place_params,
                                             serve_shardings,
                                             sharded_decode_step,
                                             sharded_prefill_step)

    B = tokens.shape[0]
    sh = serve_shardings(model, mesh, rules, B, max_len)
    weights = place_params(model, sh.params)
    pre = sharded_prefill_step(model, mesh, rules)
    dec = sharded_decode_step(model, mesh, rules, max_len=max_len)
    ln0 = (np.full((B,), tokens.shape[1], np.int32) if lengths is None
           else np.asarray(lengths, np.int32))
    ln, coll = ln0, []
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    reset_launches()                       # the path starts here
    with record_collectives() as rec:
        lg, cache, _ = pre(weights, {"tokens": tokens}, max_len=max_len,
                           lengths=None if lengths is None else ln0)
    coll += rec
    logits, toks = [gather_batch(lg, mesh, rules, B).float()], []
    for _ in range(steps):
        tok = gather_batch(lg.argmax(-1).to(torch.int32), mesh, rules, B)
        toks.append(tok)
        with record_collectives() as rec:
            lg, cache, _ = dec(weights, cache, tok, torch.from_numpy(ln))
        coll += rec
        ln = ln + 1
        logits.append(gather_batch(lg, mesh, rules, B).float())
    sync()
    launches = dict(LAUNCHES)              # ... and ends here
    out = {"seconds": time.perf_counter() - t0, "launches": launches,
           "collectives": (len(coll), sum(c.bytes for c in coll)),
           "finite": all(bool(torch.isfinite(x).all()) for x in logits),
           "tokens": torch.stack(toks).cpu().numpy()}
    del cache, weights
    if one_card:
        t = torch.as_tensor(tokens, device=model.device)
        n1 = None if lengths is None else torch.as_tensor(
            ln0, device=model.device)
        lg1, c1, n1 = model.prefill(t, max_len=max_len, lengths=n1)
        gap, same = float((lg1.float() - logits[0]).abs().max()), 0
        for i in range(steps):
            tok1 = lg1.argmax(-1).to(torch.int32)
            if not torch.equal(tok1, toks[i]):
                break
            same += 1
            lg1, c1, n1 = model.decode_step(c1, tok1, n1)
            gap = max(gap, float((lg1.float() - logits[i + 1]).abs().max()))
        out.update(same_tokens=same, gap=gap)
        del c1
    if model.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _shard_part_a(torch, rank, mesh):
    """(a) llama3.2-1b: fp32 at 2 layers; bf16 at full depth, every K7
    (lse) and K8 launch held."""
    import numpy as np

    from repro_torch.parallel.sharding import RULES_SERVE

    a = SHARD_A
    out = {}
    for dtype, layers, steps in (("float32", 2, a["steps"]),
                                 ("bfloat16", 0, a["bf16_steps"])):
        model = _shard_model(torch, "llama3.2-1b", layers, dtype)
        rng = np.random.default_rng(11)
        tokens = rng.integers(0, model.cfg.vocab_size,
                              size=(4, max(a["lengths"]))).astype(np.int32)
        held = dtype == "bfloat16"
        if held:
            k7, k7_restore = capture_decode_lse()
            k8, k8_restore = capture_flash(every=True)
        try:
            row = _shard_run(torch, model, mesh, RULES_SERVE, tokens,
                             np.asarray(a["lengths"], np.int32),
                             a["max_len"], steps, rank == 0)
        finally:
            if held:
                k7_restore()
                k8_restore()
        if held:
            # the sharded path's launches (rank 0's one-card run follows)
            h7 = [hold_lse(torch, c) for c in k7]
            h8 = [hold_on_path(torch, "flash_attention", c)
                  for c in k8[:row["launches"]["flash_attention"]]]
            row["held"] = {
                "decode_attention_lse": {
                    "held": len(h7),
                    "max_abs_err": max(h["max_abs_err"] for h in h7),
                    "lse_max_abs_err": max(h["lse_max_abs_err"]
                                           for h in h7),
                    "empty_rows": sum(h["empty_rows"] for h in h7)},
                "flash_attention": {
                    "held": len(h8),
                    "max_abs_err": max(h["max_abs_err"] for h in h8),
                    "shape": h8[0]["shape"]}}
            del k7, k8
        out[dtype] = row
        del model
        torch.cuda.empty_cache()
    return out


def _shard_part_b(torch, rank, mesh):
    """(b) h2o-danube3-4b, 2 layers, fp32, ``RULES_SERVE_LONG``: one prompt
    past the window."""
    import numpy as np

    from repro_torch.parallel.sharding import RULES_SERVE_LONG

    b = SHARD_B
    model = _shard_model(torch, "h2o-danube3-4b", 2, "float32")
    tokens = np.random.default_rng(12).integers(
        0, model.cfg.vocab_size, size=(1, b["prompt"])).astype(np.int32)
    row = _shard_run(torch, model, mesh, RULES_SERVE_LONG, tokens, None,
                     b["prompt"] + b["steps"], b["steps"], rank == 0)
    row["window"] = model.cfg.sliding_window
    del model
    torch.cuda.empty_cache()
    return row


def _shard_part_c(torch, rank, mesh):
    """(c) deepseek-v2-lite-16b (MLA) and mamba2-2.7b (SSM), 2 layers,
    fp32, ``RULES_SERVE``: 4 prompts of 256."""
    import numpy as np

    from repro_torch.parallel.sharding import RULES_SERVE

    c = SHARD_C
    out = {}
    for name in ("deepseek-v2-lite-16b", "mamba2-2.7b"):
        model = _shard_model(torch, name, 2, "float32")
        tokens = np.random.default_rng(13).integers(
            0, model.cfg.vocab_size, size=(c["B"], c["prompt"])).astype(
                np.int32)
        out[name] = _shard_run(torch, model, mesh, RULES_SERVE, tokens, None,
                               c["max_len"], c["steps"], rank == 0)
        del model
        torch.cuda.empty_cache()
    return out


def shard_rank(rank, world, init, out_dir, _inputs=None):
    """One rank of the shard phase: a gloo process on the card, parts (a),
    (b) and (c) in turn, each part's seconds and peak memory; the results
    pickled for the parent."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    res = {}
    for part, fn in (("a", _shard_part_a), ("b", _shard_part_b),
                     ("c", _shard_part_c)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        res[part] = fn(torch, rank, mesh)
        dist.barrier()
        res[part + "_s"] = time.perf_counter() - t0
        res[part + "_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if rank == 0:
            print(f"shard: part {part} done on every rank, "
                  f"{res[part + '_s']:.1f} s", flush=True)
    dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _run_text(r) -> str:
    n, nbytes = r["collectives"]
    return (f"{r['seconds']:.1f} s, {n} collectives ({nbytes / 2 ** 30:.3f} "
            "GiB)")


def phase_shard(torch):
    """The sharded serve steps (``serving/sharded.py``) on 4 gloo ranks
    sharing the card as (data 2, model 2), each rank holding its rows'
    range of every cache leaf's slots: (a) llama3.2-1b at full width under
    ``RULES_SERVE``, fp32 at 2 layers against one card (``SHARD_A``'s
    greedy steps: tokens identical, logits within 1e-4), then bf16 at full
    depth (every K7 launch, out and lse, and every K8 launch held, the
    logit gap to one card printed); (b) h2o-danube3-4b (2 layers, fp32)
    under ``RULES_SERVE_LONG``, a prompt past its window, tokens
    identical; (c) deepseek-v2-lite-16b (MLA) and mamba2-2.7b (SSM), 2
    layers, fp32, 4 prompts of 256, tokens identical.  Returns ({kernel: launches summed over the ranks
    on the path}, {kernel: per-rank launches and held rows})."""
    import shutil

    import numpy as np

    out_dir = ROOT / "build" / "chip_shard"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    res = _spawn(shard_rank, None, out_dir, SHARD_DEADLINE_S)
    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)

    def same_everywhere(get, what):
        for r, rr in enumerate(res):
            check(np.array_equal(get(rr)["tokens"], get(res[0])["tokens"]),
                  f"{what}: rank {r}'s tokens differ from rank 0's")
            check(get(rr)["finite"], f"{what}: rank {r} logits not finite")

    a32, a16 = res[0]["a"]["float32"], res[0]["a"]["bfloat16"]
    same_everywhere(lambda rr: rr["a"]["float32"], "(a) fp32")
    same_everywhere(lambda rr: rr["a"]["bfloat16"], "(a) bf16")
    check(a32["same_tokens"] == SHARD_A["steps"],
          f"(a) fp32 tokens agree with one card for {a32['same_tokens']} "
          f"of {SHARD_A['steps']} steps")
    check(a32["gap"] <= SHARD_LOGIT_TOL,
          f"(a) fp32 logits {a32['gap']:.3g} from one card")
    k7 = [rr["a"]["bfloat16"]["launches"]["decode_attention_lse"]
          + rr["a"]["float32"]["launches"]["decode_attention_lse"]
          for rr in res]
    k8 = [rr["a"]["bfloat16"]["launches"]["flash_attention"]
          + rr["a"]["float32"]["launches"]["flash_attention"] for rr in res]
    for r, rr in enumerate(res):
        h = rr["a"]["bfloat16"]["held"]
        for name in ("decode_attention_lse", "flash_attention"):
            n = rr["a"]["bfloat16"]["launches"][name]
            check(n > 0 and h[name]["held"] == n,
                  f"(a) rank {r}: {h[name]['held']} of {n} {name} "
                  "launches held")
        check(rr["a"]["bfloat16"]["launches"]["decode_attention"] == 0,
              f"(a) rank {r}: K7 launched without its lse")
    h7 = [rr["a"]["bfloat16"]["held"]["decode_attention_lse"] for rr in res]
    h8 = [rr["a"]["bfloat16"]["held"]["flash_attention"] for rr in res]
    print(f"shard: (a) llama3.2-1b (full width) on (data 2, model 2), "
          f"RULES_SERVE, prompts {SHARD_A['lengths']}, {SHARD_A['max_len']} "
          f"slots ({SHARD_A['max_len'] // 2} a rank): fp32 2 layers, "
          f"{SHARD_A['steps']} steps: "
          f"tokens equal to one card for {a32['same_tokens']}, max logit "
          f"gap {a32['gap']:.3g} (held {SHARD_LOGIT_TOL}), "
          f"{_run_text(a32)} on rank 0; bf16 16 layers, "
          f"{SHARD_A['bf16_steps']} steps: {a16['same_tokens']} tokens "
          f"equal to one card, max logit gap {a16['gap']:.3g} while equal, "
          f"{_run_text(a16)} on rank 0; K7 (lse) launches per rank {k7}, "
          f"bf16 held {[h['held'] for h in h7]} (out within "
          f"{max(h['max_abs_err'] for h in h7):.3g}, lse within "
          f"{max(h['lse_max_abs_err'] for h in h7):.3g}, "
          f"{[h['empty_rows'] for h in h7]} rows with no slot on the rank: "
          f"lse -inf, zeros); K8 launches per rank {k8}, bf16 held "
          f"{[h['held'] for h in h8]} at {h8[0]['shape']} (within "
          f"{max(h['max_abs_err'] for h in h8):.3g}); {res[0]['a_s']:.1f} s,"
          f" peak {[round(rr['a_peak_gib'], 2) for rr in res]} GiB per rank",
          flush=True)

    b = res[0]["b"]
    same_everywhere(lambda rr: rr["b"], "(b)")
    check(b["same_tokens"] == SHARD_B["steps"],
          f"(b) tokens agree with one card for {b['same_tokens']} of "
          f"{SHARD_B['steps']} steps")
    print(f"shard: (b) h2o-danube3-4b (full width, 2 layers, fp32) on "
          f"(data 2, model 2), RULES_SERVE_LONG: a {SHARD_B['prompt']}-token "
          f"prompt past the {b['window']} window ({b['window'] // 4} of the "
          f"ring's slots a rank), {SHARD_B['steps']} steps: tokens equal to "
          f"one card for "
          f"{b['same_tokens']}, max logit gap {b['gap']:.3g}; "
          f"{_run_text(b)} on rank 0; K7 (lse) launches per rank "
          f"{[rr['b']['launches']['decode_attention_lse'] for rr in res]}, "
          f"K8 {[rr['b']['launches']['flash_attention'] for rr in res]}; "
          f"{res[0]['b_s']:.1f} s, peak "
          f"{[round(rr['b_peak_gib'], 2) for rr in res]} GiB per rank",
          flush=True)
    for name in ("deepseek-v2-lite-16b", "mamba2-2.7b"):
        c = res[0]["c"][name]
        same_everywhere(lambda rr: rr["c"][name], f"(c) {name}")
        check(c["same_tokens"] == SHARD_C["steps"],
              f"(c) {name}: tokens agree with one card for "
              f"{c['same_tokens']} of {SHARD_C['steps']} steps")
        print(f"shard: (c) {name} (full width, 2 layers, fp32), RULES_SERVE,"
              f" {SHARD_C['B']} prompts of {SHARD_C['prompt']}, "
              f"{SHARD_C['steps']} steps: tokens equal to one card for "
              f"{c['same_tokens']}, max logit gap {c['gap']:.3g}; "
              f"{_run_text(c)} on rank 0", flush=True)
    print(f"shard: (c) {res[0]['c_s']:.1f} s, peak "
          f"{[round(rr['c_peak_gib'], 2) for rr in res]} GiB per rank",
          flush=True)
    for p in problems:
        print(f"shard: FAILED {p}", flush=True)
    assert not problems, f"shard: {len(problems)} checks failed"
    counts = {"decode_attention_lse": sum(k7), "flash_attention": sum(k8)}
    paths = {"decode_attention_lse": {
                 "launches_per_rank": k7,
                 "held_per_rank": [h["held"] for h in h7],
                 "max_abs_err": max(h["max_abs_err"] for h in h7),
                 "lse_max_abs_err": max(h["lse_max_abs_err"] for h in h7)},
             "flash_attention": {
                 "launches_per_rank": k8,
                 "held_per_rank": [h["held"] for h in h8],
                 "max_abs_err": max(h["max_abs_err"] for h in h8)}}
    return counts, paths


# ---------------------------------------------------------------------------
# 21. coic — the paper's own engine (CoICEngine) on the card
# ---------------------------------------------------------------------------

# Fig. 2a's network conditions (benchmarks/recognition_latency.py): (name,
# mobile->edge Mbps, edge->cloud Mbps), RTTs 2 and 20 ms
COIC_CONDITIONS = (("400/100", 400.0, 100.0), ("400/50", 400.0, 50.0),
                   ("400/20", 400.0, 20.0), ("100/50", 100.0, 50.0),
                   ("50/20", 50.0, 20.0))
# Fig. 2a's engine on coic-paper; its cloud returns the first 64 logits
COIC_PAPER = dict(capacity=256, threshold=0.98, payload_dim=64,
                  descriptor="prefix", k_layers=2)
# Fig. 2b's blobs (benchmarks/load_latency.py): MiB of float32, loads each
COIC_BLOBS_MIB = (1, 4, 16, 64)
COIC_REPEATS = 8
# part (c): the cooperative and federated ladder on llama3.2-1b, 8 greedy
# tokens a miss; waves of 8 prompts of 128 tokens at (cluster, node)
COIC_LADDER = dict(capacity=512, threshold=0.98, payload_dim=8,
                   payload_dtype="int32", num_nodes=2, num_clusters=2,
                   digest_interval=1)
COIC_LADDER_WAVES = ((0, 0), (0, 1), (1, 0), (1, 0))
COIC_PROMPT = 128
COIC_PAYLOAD_TOL = 1e-5                 # the fp32 e2e, kernels vs plain


def coic_stream(vocab, steps=12):
    """Fig. 2a's requests as ``benchmarks/recognition_latency.py`` draws
    them (numpy, seed 0): ``steps`` batches of 8 prompts, Zipf(1.1) over
    a pool of 16 random prompts of 32 tokens."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab, size=(16, 32)).astype(np.int32)
    p = np.arange(1, 17, dtype=np.float64) ** -1.1
    p /= p.sum()
    return [prompts[rng.choice(16, size=8, p=p)] for _ in range(steps)]


def coic_paper_engine(model, network=None, lookup_impl="auto", dev="cuda"):
    """Fig. 2a's ``CoICEngine`` (``COIC_PAPER``, misses batched by 8)."""
    from repro_torch.core.coic import (CoICConfig, CoICEngine,
                                       recognition_cloud_fn)

    return CoICEngine(model, CoICConfig(lookup_impl=lookup_impl,
                                        **COIC_PAPER),
                      cloud_fn=recognition_cloud_fn(model, 64),
                      network=network, miss_bucket=8, device=dev)


def coic_fig2a(torch, model, dev="cuda"):
    """Part (a): the stream under each of Fig. 2a's conditions on a fresh
    engine; prints hits, the mean modeled latency of CoIC and of the
    origin baseline, and the reduction.  Returns the requests served."""
    import numpy as np

    from repro_torch.core.network import Link, NetworkModel

    n_req = 0
    for name, me, ec in COIC_CONDITIONS:
        eng = coic_paper_engine(model, NetworkModel(
            m_e=Link(me, rtt_ms=2.0), e_c=Link(ec, rtt_ms=20.0)), dev=dev)
        coic_ms, origin_ms, hits = [], [], 0
        t0 = time.perf_counter()
        for toks in coic_stream(model.cfg.vocab_size):
            for r in eng.process_batch(toks):
                assert r.payload.shape == (64,) and bool(
                    np.isfinite(r.payload).all()), (name, r.source)
                coic_ms.append(r.coic.total_ms)
                origin_ms.append(r.origin.total_ms)
                hits += r.source != "cloud"
        wall = time.perf_counter() - t0
        n = len(coic_ms)
        red = 100.0 * (1 - np.mean(coic_ms) / np.mean(origin_ms))
        assert 0 < hits < n and red > 0, (name, hits, red)
        print(f"coic: (a) {model.cfg.name} {name} Mbps: {hits} of {n} "
              f"requests hit, mean coic.total_ms {np.mean(coic_ms):.4f}, "
              f"mean origin.total_ms {np.mean(origin_ms):.4f}, reduction "
              f"{red:.2f}%; {wall:.2f} s ({wall / n * 1e3:.3f} ms a request"
              ", wall)", flush=True)
        n_req += n
    return n_req


def coic_fig2b(torch, model):
    """Part (b): ``load_asset`` of float32 blobs (np.load, then a copy to
    the card), the first load "cloud" with a positive time and every
    repeat "edge" at 0.0 ms; then a bf16 CUDA tensor as the key."""
    import shutil

    import numpy as np

    from repro_torch.core.hash_cache import content_hash

    eng = coic_paper_engine(model)
    tmp = ROOT / "build" / "chip_smoke_assets"
    tmp.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    try:
        for mb in COIC_BLOBS_MIB:
            blob = rng.standard_normal(mb * (1 << 20) // 4).astype(
                np.float32)
            path = tmp / f"asset_{mb}mib.npy"
            np.save(path, blob)

            def loader():
                return torch.from_numpy(np.load(path)).to("cuda")

            got = [eng.load_asset(f"asset_{mb}", loader)
                   for _ in range(COIC_REPEATS)]
            (v0, ms0, src0), rest = got[0], got[1:]
            assert src0 == "cloud" and ms0 > 0, (mb, src0, ms0)
            assert all(src == "edge" and ms == 0.0 and v is v0
                       for v, ms, src in rest), (mb, rest)
            assert torch.equal(v0.cpu(), torch.from_numpy(blob)), mb
            mean = (ms0 + sum(ms for _, ms, _ in rest)) / COIC_REPEATS
            print(f"coic: (b) {mb} MiB: first load {ms0:.3f} ms (cloud), "
                  f"{len(rest)} repeats at 0.0 ms (edge); load reduction "
                  f"{100.0 * (1 - mean / ms0):.2f}%", flush=True)
        g = torch.Generator(device="cuda").manual_seed(0)
        key = torch.randn((512, 512), generator=g, device="cuda").to(
            torch.bfloat16)
        assert content_hash(key) == content_hash(key.cpu())
        path = tmp / f"asset_{COIC_BLOBS_MIB[0]}mib.npy"
        loads = [eng.load_asset(k, lambda: torch.from_numpy(
            np.load(path)).to("cuda")) for k in (key, key.clone(), key + 1)]
        assert [s for _, _, s in loads] == ["cloud", "edge", "cloud"], loads
        assert loads[1][1] == 0.0 and loads[0][1] > 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    st = eng.stats()["asset_cache"]
    print(f"coic: (b) a bf16 CUDA tensor key (512 x 512): first load "
          f"{loads[0][1]:.3f} ms (cloud), its copy 0.0 ms (edge), the "
          f"tensor + 1 a new entry (cloud); asset_cache {st}", flush=True)
    assert st["hits"] == len(COIC_BLOBS_MIB) * (COIC_REPEATS - 1) + 1, st


def coic_ladder(torch, model, dev="cuda"):
    """Part (c): ``COIC_LADDER`` on ``model`` with greedy generation as
    the cloud: 8 prompts of 128 tokens at (0, 0) (all miss), the same at
    (0, 1) (peer hits), at (1, 0) (remote hits), then those and 8 new at
    (1, 0) (the remote hits re-admitted: local hits; the new ones miss).
    A hit returns the tokens the cloud generated for that prompt.  Returns
    the requests served."""
    import numpy as np

    from repro_torch.core.coic import (CoICConfig, CoICEngine,
                                       generation_cloud_fn)

    eng = CoICEngine(model, CoICConfig(**COIC_LADDER),
                     cloud_fn=generation_cloud_fn(model, 8), miss_bucket=8,
                     device=dev)
    V = model.cfg.vocab_size
    rng = np.random.default_rng(0)
    old, new = (rng.integers(0, V, size=(8, COIC_PROMPT)).astype(np.int32)
                for _ in range(2))
    want = (["cloud"] * 8, ["peer"] * 8, ["remote"] * 8,
            ["edge"] * 8 + ["cloud"] * 8)
    first, n_req = None, 0
    for w, ((k, n), expect) in enumerate(zip(COIC_LADDER_WAVES, want), 1):
        toks = old if w < 4 else np.concatenate([old, new])
        t0 = time.perf_counter()
        res = eng.process_batch(toks, node_id=n, cluster_id=k)
        dt = time.perf_counter() - t0
        src = [r.source for r in res]
        pay = np.stack([r.payload for r in res])
        assert pay.dtype == np.int32 and pay.shape == (len(toks), 8)
        assert ((pay >= 0) & (pay < V)).all(), w
        if first is None:
            first = pay
        assert (pay[:8] == first).all(), (w, "a hit's payload")
        tiers = {t: src.count(t) for t in ("edge", "peer", "remote",
                                           "cloud")}
        print(f"coic: (c) {model.cfg.name} wave {w} at (cluster {k}, node "
              f"{n}): {len(res)} requests, hits by tier {tiers}; {dt:.3f} s",
              flush=True)
        assert src == expect, (w, src)
        n_req += len(res)
    st = eng.stats()
    print(f"coic: (c) ladder tier counts {st['ladder']['tier_counts']}, "
          f"digest {st['digest']}", flush=True)
    return n_req


def phase_coic(torch, model):
    """The paper's engine on the card: (a) Fig. 2a's stream on coic-paper
    (bf16, full width) under its five network conditions, (b) Fig. 2b's
    asset loads, (c) the cooperative and federated ladder on ``model``
    (llama3.2-1b).  Launch counts zeroed before and read after; K1, K7
    and K8 must launch, and every launch of K1-K3, K7 and K8 is held
    against its plain version.  Returns (launches, requests, held)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model

    paper = build_model(get_config("coic-paper"), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(0))
    store, restore = capture_every()
    torch.cuda.synchronize()
    reset_launches()                       # the coic path starts here
    t0 = time.perf_counter()
    try:
        n_req = coic_fig2a(torch, paper)
        coic_fig2b(torch, paper)
        n_req += coic_ladder(torch, model)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(LAUNCHES)              # ... and ends here
    for name in ("similarity_topk_batched", "decode_attention",
                 "flash_attention"):
        assert launches[name] > 0, ("coic", name, launches)
    held = {}
    for name, calls in store.items():
        # a call on an empty input launches nothing
        assert len(calls) >= launches[name], (name, len(calls))
        if calls:
            held[name] = (hold_similarity(torch, name, calls)
                          if name in SIM_KERNELS else
                          hold_attention(torch, name, calls))
            print(f"coic: {name} on the path ({held[name]['shape']}): "
                  f"{held[name]['held']} launch(es) == plain (max err "
                  f"{held[name]['max_abs_err']:.3g})", flush=True)
    print(f"coic: {n_req} requests, {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}", flush=True)
    del paper, store
    torch.cuda.empty_cache()
    return launches, n_req, held


def phase_coic_e2e(torch):
    """Part (a)'s stream (400/100) on coic-paper in fp32 (TF32 off),
    through the kernels (``lookup_impl`` and ``attention_impl`` "cuda")
    and through their plain versions ("ref"): sources and hits by tier
    identical, payloads within ``COIC_PAYLOAD_TOL``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("coic-paper"), dtype="float32")
    out = {}
    for impl in ("cuda", "ref"):
        model = build_model(cfg, attention_impl=impl, device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(0))
        eng = coic_paper_engine(model, lookup_impl=impl)
        reset_launches()
        res = [r for toks in coic_stream(cfg.vocab_size)
               for r in eng.process_batch(toks)]
        torch.cuda.synchronize()
        n = dict(LAUNCHES)
        if impl == "cuda":
            assert n["similarity_topk_batched"] > 0 and \
                n["flash_attention"] > 0, n
        else:
            assert not any(n.values()), n
        out[impl] = ([r.source for r in res],
                     np.stack([r.payload for r in res]),
                     eng.stats()["ladder"]["tier_counts"])
        del eng, model
    assert out["cuda"][0] == out["ref"][0], "coic: sources differ"
    assert out["cuda"][2] == out["ref"][2], "coic: tier counts differ"
    err = float(np.abs(out["cuda"][1] - out["ref"][1]).max())
    assert err <= COIC_PAYLOAD_TOL, ("coic: payloads", err)
    print(f"e2e: coic-paper fp32 CoICEngine, {len(out['cuda'][0])} requests "
          f"(tier counts {out['cuda'][2]}): sources and tiers identical "
          f"through K1 + K8 and their plain versions, payloads within "
          f"{err:.3g}", flush=True)


# ---------------------------------------------------------------------------
# 22. dev — scripts/torch_dev_smoke.py on the card
# ---------------------------------------------------------------------------

DEV_LOGIT_TOL = 1e-4                    # fp32, K7 + K8 against plain


def phase_dev(torch):
    """``scripts/torch_dev_smoke.py``'s ``run_arch`` for every arch of
    ``ARCH_IDS`` at ``reduced_config`` on the card: in bf16 (``OK <arch>``
    lines), then in fp32 with ``attention_impl`` "cuda" and "ref", whose
    decode logits must agree within ``DEV_LOGIT_TOL`` with equal argmax.
    Every K7 and K8 launch (head_dim 16, padded to 32 by the kernels;
    h2o-danube3's 16-token window) is held against its plain version.
    Returns (launches, held)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_dev_smoke as dev

    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import LAUNCHES, reset_launches

    store, restore = capture_every()
    torch.cuda.synchronize()
    reset_launches()                       # the dev path starts here
    t0 = time.perf_counter()
    got = {}
    try:
        for arch in ARCH_IDS:
            loss, _ = dev.run_arch(arch, "cuda")
            print(f"dev: OK {arch:28s} loss={loss:.4f} (bf16)", flush=True)
        for arch in ARCH_IDS:
            got[arch] = dev.run_arch(arch, "cuda", "cuda", dtype="float32")
        torch.cuda.synchronize()
    finally:
        restore()
    launches = dict(LAUNCHES)              # ... and ends here
    print("dev: all smoke OK", flush=True)
    reset_launches()
    worst = 0.0
    for arch in ARCH_IDS:
        loss_r, ref = dev.run_arch(arch, "cuda", "ref", dtype="float32")
        loss_c, out = got[arch]
        err = float((out - ref).abs().max())
        same = bool(torch.equal(out.argmax(-1), ref.argmax(-1)))
        assert err <= DEV_LOGIT_TOL and same, (arch, err, same)
        worst = max(worst, err)
        print(f"dev: {arch} fp32: decode logits through K7 + K8 within "
              f"{err:.3g} of the plain versions', argmax equal; loss "
              f"{loss_c:.6f} / {loss_r:.6f}", flush=True)
    assert not any(LAUNCHES.values()), dict(LAUNCHES)
    for name in ("decode_attention", "flash_attention"):
        assert launches[name] > 0, ("dev", name, launches)
    held = {}
    for name in ("decode_attention", "flash_attention"):
        calls = store[name]
        assert len(calls) >= launches[name], (name, len(calls))
        held[name] = hold_attention(torch, name, calls)
        heads = sorted({(c[0][0].shape[-2], c[0][1].shape[-2],
                         c[0][0].shape[-1]) for c in calls})
        print(f"dev: {name}: {held[name]['held']} launch(es) held against "
              f"the plain version (max err {held[name]['max_abs_err']:.3g};"
              f" (H, K, D) {heads})", flush=True)
    print(f"dev: {time.perf_counter() - t0:.1f} s; fp32 worst logit gap "
          f"{worst:.3g}; launches {launches}", flush=True)
    return launches, held


if __name__ == "__main__":
    main()
