#!/usr/bin/env python3
"""Where the int8 error-feedback cross-pod step parts from the exact step.

    python3 scripts/compress_probe.py [--configs llama3.2-1b coic-paper]
                                      [--out build/compress_probe.json]

Four ``gloo`` ranks share one CUDA card as a (pod 2, data 1, model 2)
mesh, the layout of ``chip_smoke.py``'s mesh part (d).  For each config
(llama3.2-1b at its published widths cut to 2 layers; coic-paper as
published), fp32, random weights from seed 0, TF32 off,
``SyntheticLMData(seq_len=129, global_batch=4)`` and AdamW at peak lr
1e-3 (warmup 2, total 20), 4 steps each of:

- ``make_train_step_compressed``.  At every step, per leaf, the share of
  this pod's int8 payload that is zero: the payload is recomputed beside
  the step's own ``compressed_cross_pod_mean`` from the same gradient,
  error-feedback residual and shared scale.  At step 0, the largest gap
  between the gradient that the step's intra-pod wiring hands to the
  compression and the one-rank gradient of the pod's rows, relative to
  that gradient's absmax;
- the same step with the vocabulary leaves (``embed/tokens``, and
  ``head/w`` where the output head is untied) averaged over the pods
  exactly, their residual left zero, and every other leaf compressed;
- on rank 0, the exact one-rank step, and the initial weights' loss on
  each batch (a run that does not train).

Prints the card (nvidia-smi name, power limit), one JSON object per
config, and writes them all to ``--out``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

RANKS = 4
STEPS = 4
DATA = dict(seq_len=129, global_batch=4)
CUTS = {"llama3.2-1b": dict(num_layers=2), "coic-paper": {}}
VOCAB_LEAVES = ("embed/tokens", "head/w")


def _model(torch, name):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(name), dtype="float32",
                              **CUTS[name])
    return build_model(cfg, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))


def rank_main(rank, world, init, names, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch.optim.grad_compress as gc
    from chip_smoke import _mesh_state as _state
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.collectives import all_reduce
    from repro_torch.train.trainer import (TrainerConfig,
                                           init_compression_errors,
                                           loss_and_grads, make_train_step,
                                           make_train_step_compressed,
                                           to_device)

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="cuda")
    pod = mesh.get_local_rank("pod")
    step_mean = gc.compressed_cross_pod_mean
    probe = {}

    def watched(grads, state, group):
        """The step's own mean, with the zero share of each leaf's int8
        payload recorded first; the leaves in ``probe["exact"]`` averaged
        exactly instead."""
        zero = {}
        for k in sorted(grads):
            g = grads[k].float() + state.error[k]
            absmax = all_reduce(torch.max(torch.abs(g)), group,
                                dist.ReduceOp.MAX)
            q = gc._quantize(g, torch.clamp(absmax / 127.0, min=1e-12))
            zero[k] = int((q == 0).sum()) / q.numel()
            del g, q
        probe["zero"].append(zero)
        ref = probe.pop("ref", None)
        if ref is not None:
            probe["wiring"] = max(
                float((grads[k] - ref[k]).abs().max() / ref[k].abs().max())
                for k in ref)
            del ref
        exact = probe["exact"] & set(grads)
        out, st = step_mean(
            {k: v for k, v in grads.items() if k not in exact},
            gc.CompressionState(error={k: v for k, v in state.error.items()
                                       if k not in exact}), group)
        for k in exact:
            out[k] = all_reduce(grads[k].float(), group) \
                / dist.get_world_size(group)
            st.error[k] = torch.zeros_like(state.error[k])
        return out, st

    gc.compressed_cross_pod_mean = watched   # read by the step's builder
    res = {"rank": rank, "pod": pod}
    for name in names:
        t0 = time.perf_counter()
        model = _model(torch, name)
        tcfg = TrainerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20,
                             compute_dtype="float32")
        data = SyntheticLMData(vocab_size=model.cfg.vocab_size, **DATA)
        batches = [data.batch_at(i) for i in range(STEPS)]
        row = {}
        for variant, exact in (("compressed", ()),
                               ("vocab_exact", VOCAB_LEAVES)):
            probe.update(zero=[], exact=set(exact))
            state = _state(torch, model, tcfg)
            if variant == "compressed":
                per = DATA["global_batch"] // 2
                rows = {k: np.asarray(v)[pod * per:(pod + 1) * per]
                        for k, v in batches[0].items()}
                probe["ref"] = loss_and_grads(
                    model, state.params, to_device(rows, model.device),
                    torch.float32)[2]
            step = make_train_step_compressed(model, tcfg, mesh)
            err = init_compression_errors(model, mesh, 2,
                                          device=model.device)
            losses = []
            for b in batches:
                state, err, m = step(state, err, b)
                losses.append(float(m["loss"]))
            row[variant] = {"loss": losses, "zero": probe["zero"]}
            del state, err, step
            torch.cuda.empty_cache()
        row["wiring"] = probe.pop("wiring")
        row["numel"] = {k: int(np.prod(v.shape))
                        for k, v in model.init_shapes().items()}
        if rank == 0:
            exact, state, le = make_train_step(model, tcfg), _state(
                torch, model, tcfg), []
            for b in batches:
                state, m = exact(state, b)
                le.append(float(m["loss"]))
            p0 = _state(torch, model, tcfg).params
            row["exact"] = le
            row["still"] = [float(loss_and_grads(
                model, p0, to_device(b, model.device),
                torch.float32)[1]["loss"]) for b in batches]
            del state, p0
        dist.barrier()
        row["seconds"] = time.perf_counter() - t0
        res[name] = row
        del model
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def summary(name, ranks) -> dict:
    """One config's results: losses of every run, the last step's gaps,
    the wiring gap and, per pod and step, each leaf's zero share and the
    element-weighted share over all leaves."""
    r0 = ranks[0][name]
    pods = {r["pod"]: r[name] for r in ranks}
    numel = r0["numel"]
    total = sum(numel.values())

    def weighted(z):
        return sum(z[k] * numel[k] for k in z) / total
    last = STEPS - 1
    return {
        "config": name, "cut": CUTS[name], **DATA, "steps": STEPS,
        "loss": {"compressed": r0["compressed"]["loss"],
                 "vocab_exact": r0["vocab_exact"]["loss"],
                 "exact": r0["exact"], "still": r0["still"]},
        "ranks_agree": all(r[name]["compressed"]["loss"]
                           == r0["compressed"]["loss"] for r in ranks),
        "last_gap": {
            "compressed": abs(r0["compressed"]["loss"][last]
                              - r0["exact"][last]),
            "vocab_exact": abs(r0["vocab_exact"]["loss"][last]
                               - r0["exact"][last]),
            "still": abs(r0["still"][last] - r0["exact"][last])},
        "wiring_max_rel": max(r[name]["wiring"] for r in ranks),
        "zero_share": {
            f"pod{p}": [{"all_leaves": weighted(z), **z}
                        for z in pods[p]["compressed"]["zero"]]
            for p in sorted(pods)},
        "numel": numel, "seconds": r0["seconds"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(CUTS),
                    choices=list(CUTS))
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "compress_probe.json"))
    args = ap.parse_args()

    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        raise SystemExit("compress_probe: needs a CUDA device")
    from repro_torch.kernels import build_all
    build_all()                      # once, before the ranks start
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    out_dir = ROOT / "build" / "compress_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    mp.start_processes(rank_main, args=(RANKS, "file://" + str(
        out_dir / "store"), args.configs, str(out_dir)), nprocs=RANKS,
        join=True, start_method="spawn")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(RANKS)]
    rows = [summary(n, ranks) for n in args.configs]
    for row in rows:
        print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "configs": rows},
                                         indent=1))


if __name__ == "__main__":
    main()
