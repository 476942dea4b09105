"""Training launcher — the port of ``repro/launch/train.py``.

Small scale (the CPU):   --arch coic-paper --steps 50 --device cpu
One card:                --arch llama3.2-1b --steps 6
A (data, model) mesh:    torchrun --standalone --nproc-per-node 4 -m
                         repro_torch.launch.train --mesh 2x2

Assembles the mesh, the sharded train state, the data pipeline and the
step, with a checkpoint every ``--ckpt-every`` steps, and prints the
reference's lines.  ``--mesh 1x1`` needs no process group; a larger mesh
joins the one its environment describes (``torchrun``'s ``env://``) over
``nccl``, or ``gloo`` on the CPU and where ranks share a card, builds
``make_mesh((d, m), ("data", "model"))``, and places the state by
``state_shardings``.  Each rank's batch rows are cut by the sharded
step (``shard_batch``); rank 0 prints and saves the whole state.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.train.trainer import (TrainerConfig, init_train_state,
                                       make_train_step, place_state,
                                       state_shardings, unshard_state)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="coic-paper")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config of the arch family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 16x16")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap


def _join_world(args):
    """Join the process group ``torchrun`` describes.  A CUDA rank takes
    the card of its local rank (modulo the cards present, so ranks may
    share one); the group runs over ``nccl``, or ``gloo`` on the CPU and
    where ranks share a card, which ``nccl`` refuses."""
    backend = "gloo"
    if args.device == "cuda":
        resolve_device("cuda")
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % cards)
        if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method="env://")


def run(args, state=None):
    """Train as ``args`` say from ``state`` (whole, on ``args.device``;
    by default ``init_train_state`` from seed 0).  Returns (the final
    state, this rank's slices with a mesh; the losses)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    d, m = (int(x) for x in args.mesh.split("x"))
    if d * m > 1:
        _join_world(args)
    dev = resolve_device(args.device)
    try:
        model = build_model(cfg, device=dev)
        tcfg = TrainerConfig(peak_lr=args.lr,
                             warmup_steps=max(10, args.steps // 10),
                             total_steps=args.steps,
                             microbatches=args.microbatches)
        if state is None:
            state = init_train_state(
                model, torch.Generator(device=dev).manual_seed(0), tcfg)
        if d * m > 1:
            mesh = make_mesh((d, m), ("data", "model"), device=dev)
            sh = state_shardings(model, mesh)
            state = place_state(state, sh)
            step_fn = make_train_step(model, tcfg, mesh, sh)
            lead = dist.get_rank() == 0
        else:
            sh, step_fn, lead = None, make_train_step(model, tcfg), True

        data = SyntheticLMData(
            vocab_size=cfg.vocab_size, seq_len=args.seq,
            global_batch=args.batch, image_patches=cfg.num_image_patches,
            d_model=cfg.d_model, encdec=cfg.family == "encdec",
            dec_len=max(8, args.seq // 4))
        ckpt = (Checkpointer(args.ckpt_dir, keep=3)
                if args.ckpt_dir and lead else None)

        losses = []
        for step in range(args.steps):
            batch = data.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            if lead and step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.1f} ms)",
                      flush=True)
            if args.ckpt_dir and args.ckpt_every \
                    and (step + 1) % args.ckpt_every == 0:
                whole = state if sh is None else unshard_state(state, sh)
                if ckpt:
                    ckpt.save(step + 1, whole)
        if ckpt:
            ckpt.wait()
        if lead:
            print(f"final loss {loss:.4f}")
        return state, losses
    finally:
        if d * m > 1:
            dist.destroy_process_group()


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
