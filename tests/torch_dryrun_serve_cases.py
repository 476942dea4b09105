"""The dry run's serve cases: the sharded prefill and decode steps of
``serving/sharded.py`` on (data 2, model 2), once on real CPU tensors in a
world of 4 ``gloo`` ranks (``torch_multicard_cases.run_world``) and once
on the ``meta`` device as rank 0 of a fake process group of 4, and
``plan_cell`` of one serve cell per family kind.  This module imports
torch and ``repro_torch`` only, so the spawned processes never load
JAX."""
import os
import pickle
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from torch_dryrun_cases import _counting_dist

STEP_ARCHS = ("llama3.2-1b", "mamba2-2.7b", "deepseek-v2-lite-16b")
GEOM = dict(B=4, S=12, max_len=32)
# one cell per family kind: (arch, shape, multi-pod)
PLAN_CELLS = (("llama3.2-1b", "decode_32k", False),
              ("h2o-danube3-4b", "long_500k", True),
              ("jamba-v0.1-52b", "long_500k", False),
              ("whisper-small", "prefill_32k", False))


def serve_steps(arch, dev):
    """[(FLOPs, collective record, torch.distributed calls)] of the
    sharded prefill and of one decode step of the reduced ``arch`` with
    its tensors on ``dev`` (its own dtype, random weights on the CPU)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import RULES_SERVE
    from repro_torch.serving.sharded import (place_params, serve_shardings,
                                             sharded_decode_step,
                                             sharded_prefill_step)

    cfg = reduced_config(get_config(arch))
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    gen = torch.Generator().manual_seed(0) if dev == "cpu" else None
    model = build_model(cfg, device=dev, generator=gen)
    B, S, max_len = GEOM["B"], GEOM["S"], GEOM["max_len"]
    sh = serve_shardings(model, mesh, RULES_SERVE)
    if dev == "cpu":
        params = place_params(model, sh.params)
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(B, S)).astype(np.int32))
    else:
        params = {k: sh.params[k].place(torch.empty(
            v.shape, dtype=v.dtype, device="meta"))
            for k, v in model.init_shapes().items()}
        tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    prefill = sharded_prefill_step(model, mesh, RULES_SERVE)
    decode = sharded_decode_step(model, mesh, RULES_SERVE, max_len=max_len)
    out = []
    calls = {}
    undo = _counting_dist(calls)
    try:
        (_, cache, _), flops, rec = count_step(
            lambda p, b: prefill(p, b, max_len=max_len), params,
            {"tokens": tokens})
        out.append((flops, [tuple(r) for r in rec], dict(calls)))
        calls.clear()
        nxt = torch.zeros((B,), dtype=torch.int32, device=dev)
        ln = torch.full((B,), S, dtype=torch.int32, device=dev)
        _, flops, rec = count_step(decode, params, cache, nxt, ln)
        out.append((flops, [tuple(r) for r in rec], dict(calls)))
    finally:
        undo()
    return out


def cpu_steps(rank):
    """Every ``STEP_ARCHS`` serve step on this gloo rank's CPU tensors."""
    torch.manual_seed(0)
    return {arch: serve_steps(arch, "cpu") for arch in STEP_ARCHS}


def _meta_entry(rank, out_dir):
    from repro_torch.launch.dryrun import fake_world, plan_cell

    torch.set_num_threads(2)
    try:
        out = {}
        with fake_world(4):
            out["meta"] = {arch: serve_steps(arch, "meta")
                           for arch in STEP_ARCHS}
        out["plan"] = {cell: plan_cell(*cell) for cell in PLAN_CELLS}
    except Exception:                    # reported to the parent, not lost
        out = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, "meta.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_meta(tmp_dir: str) -> dict:
    mp.start_processes(_meta_entry, args=(tmp_dir,), nprocs=1, join=True,
                       start_method="spawn")
    with open(os.path.join(tmp_dir, "meta.pkl"), "rb") as f:
        out = pickle.load(f)
    if "error" in out:
        raise AssertionError(out["error"])
    return out

