"""Multi-pod dry run — the port of ``repro/launch/dryrun.py``: what one
rank of every (arch x shape x mesh) cell holds, computes and sends.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun

The reference compiles each cell with XLA for 512 fake host devices and
reads the compiled program.  PyTorch compiles no program: here ONE rank's
step runs on the ``meta`` device (shapes and dtypes, no storage) inside a
fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``, started by ``plan_cell``
and destroyed after it; nothing is set up at import).  The mesh is
``make_production_mesh(device="meta")``.  Nothing is allocated and no
kernel runs: every kernel wrapper sends a tensor that is not on a CUDA
device to its plain version, and a fake group's collectives move nothing.

Each cell's JSON artifact holds:

* ``memory_analysis.argument_size_in_bytes`` — the bytes of this rank's
  slices of every argument, placed by the sharding rules: train, the fp32
  master weights, both AdamW moments, the counters and the batch
  (``state_shardings`` and the batch rule of ``RULES_TRAIN``); prefill,
  the weights and the batch under ``RULES_SERVE``; decode, the weights,
  the cache (by the model's ``cache_axes``) and the step's inputs under
  ``RULES_SERVE``, or ``RULES_SERVE_LONG`` for ``long_500k``; and
  ``output_size_in_bytes``, the bytes of the step's outputs (this rank's
  part of them).
* ``cost_analysis.flops`` — ``FlopCounterMode`` over the rank's step:
  the train step (``make_train_step(model, tcfg, mesh)``: forward,
  backward and AdamW), or the sharded serve step of ``serving/sharded.py``
  (``sharded_prefill_step`` / ``sharded_decode_step``, the counterparts of
  the reference's SPMD programs of ``prefill`` / ``decode_step``).
* ``collectives`` — ``launch/collective_bytes.py::summarize`` of the
  collectives the step issued (``record_collectives``).
* ``num_devices``, ``seconds_build``, ``seconds_step``, ``seconds_total``,
  ``ok``, ``skipped`` (``supports_cell``), and ``error`` with
  ``traceback`` when a cell fails.

A serve step's collectives are the port's own choices, where XLA's
partitioner chose the reference's: each weight gathered at use over the
axes other than 'model' (``RULES_SERVE``'s ``embed`` over data makes
every decode step gather the weights), the query heads (and split kv
heads) gathered over 'model' and each rank's (out, log-sum-exp) gathered
over the cache's slot dims in a decode step, and an SSM layer's conv and
state gathered whole over 'model' at every decode step and sliced back (a
head-local SSM step would send none of that: for mamba2-2.7b x
decode_32k x single the record holds the whole fp32 states of its 64
layers, 8 rows x 80 heads x 64 x 128 each, 1.34 GB a rank a step).

What XLA reports and this run cannot is absent, never zero:
``temp_size_in_bytes``, ``generated_code_size_in_bytes``,
``alias_size_in_bytes``, ``bytes_accessed``, ``transcendentals`` and
``hlo_bytes``.  Three options of the reference have no counterpart:
``--unroll`` and the two-depth ``extrapolated`` costs (XLA's cost analysis
does not multiply a scan body by its trip count; an eager step runs and
counts every layer), and ``--no-act-sharding`` (the port's ``constrain``
is an identity and its sharded step places activations by hand).  The
reference's ``REPRO_REMAT`` and ``REPRO_MICROBATCHES`` variables are the
flags ``--remat`` and ``--microbatches`` here.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supports_cell
from repro_torch.launch.collective_bytes import shape_bytes, summarize
from repro_torch.launch.mesh import make_production_mesh, mesh_shape
from repro_torch.launch.specs import batch_specs, decode_specs
from repro_torch.models import build_model
from repro_torch.parallel.collectives import record_collectives
from repro_torch.parallel.sharding import (RULES_SERVE, RULES_SERVE_LONG,
                                           RULES_TRAIN)
from repro_torch.optim.adamw import OptState
from repro_torch.serving.sharded import (sharded_decode_step,
                                         sharded_prefill_step)
from repro_torch.train.trainer import (TrainerConfig, TrainState,
                                       make_train_step, place_state,
                                       state_shardings, train_state_shapes)
from repro_torch.utils.tree import leaves_with_paths


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0; its
    collectives move nothing.  Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


class StepFlops(FlopCounterMode):
    """``FlopCounterMode`` without its per-module tracker, whose backward
    hooks refuse ``torch.autograd.grad`` over leaf tensors (the train
    step's); the total is the same."""

    class _Global:
        parents = {"Global"}

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def __init__(self):
        super().__init__(display=False)
        self.mod_tracker = self._Global()


def count_step(fn, *args):
    """(outputs, FLOPs, collective record) of one call of ``fn``."""
    with record_collectives() as rec, StepFlops() as flops:
        out = fn(*args)
    return out, flops.get_total_flops(), list(rec)


def _meta(sd) -> torch.Tensor:
    return torch.empty(sd.shape, dtype=sd.dtype, device="meta")


def _metas(specs: dict) -> dict:
    return {k: _meta(v) for k, v in specs.items()}


def _place_all(specs: dict, shardings: dict) -> dict:
    return {k: shardings[k].place(_meta(v)) for k, v in specs.items()}


def _batch_shardings(specs: dict, mesh, rules) -> dict:
    return {k: rules.sharding_for(("batch",) + (None,) * (len(v.shape) - 1),
                                  v.shape, mesh) for k, v in specs.items()}


def _nbytes(tree) -> int:
    return sum(shape_bytes(t.shape, t.dtype)
               for _, t in leaves_with_paths(tree))


def train_arguments(model, mesh, tcfg: TrainerConfig) -> TrainState:
    """This rank's slices of the train state (``train_state_shapes``),
    ``meta`` tensors placed by ``state_shardings`` (whole without a
    ``mesh``)."""
    a = train_state_shapes(model, tcfg)
    state = TrainState(
        params=_metas(a.params),
        opt=OptState(mu=_metas(a.opt.mu), nu=_metas(a.opt.nu),
                     count=_meta(a.opt.count)),
        step=_meta(a.step))
    return state if mesh is None else place_state(
        state, state_shardings(model, mesh))


def cell_arguments(model, cfg, cell, mesh, tcfg: TrainerConfig) -> dict:
    """This rank's slices of the cell's step arguments, ``meta`` tensors
    placed by the sharding rules: {"state", "batch"} (train), {"params",
    "batch"} (prefill) or {"params", "cache", "inputs"} (decode)."""
    if cell.kind == "train":
        bspecs = batch_specs(cfg, cell)
        return {"state": train_arguments(model, mesh, tcfg),
                "batch": _place_all(bspecs, _batch_shardings(
                    bspecs, mesh, RULES_TRAIN))}
    rules = RULES_SERVE_LONG if cell.name == "long_500k" else RULES_SERVE
    axes, shapes = model.logical_axes(), model.init_shapes()
    params = _place_all(shapes, {k: rules.sharding_for(axes[k], v.shape, mesh)
                                 for k, v in shapes.items()})
    if cell.kind == "prefill":
        bspecs = batch_specs(cfg, cell)
        return {"params": params, "batch": _place_all(
            bspecs, _batch_shardings(bspecs, mesh, rules))}
    cache, inputs = decode_specs(model, cfg, cell)
    c_axes = model.cache_axes()
    return {"params": params,
            "cache": _place_all(cache, {
                k: rules.sharding_for(c_axes[k], v.shape, mesh)
                for k, v in cache.items()}),
            "inputs": _place_all(inputs,
                                 _batch_shardings(inputs, mesh, rules))}


def cell_step(model, cfg, cell, mesh, tcfg: TrainerConfig, args: dict):
    """(step, its arguments) of one cell on this rank: the train step, or
    the sharded prefill / decode step (the reference's ``prefill`` without
    ``max_len`` but llava's ``max_len=seq_len``, which is the same; an
    encoder-decoder's decode over a cross cache of ``seq_len``)."""
    if cell.kind == "train":
        return (make_train_step(model, tcfg, mesh), args["state"],
                _metas(batch_specs(cfg, cell)))
    rules = RULES_SERVE_LONG if cell.name == "long_500k" else RULES_SERVE
    if cell.kind == "prefill":
        step = sharded_prefill_step(model, mesh, rules)
        return step, args["params"], _metas(batch_specs(cfg, cell))
    _, inputs = decode_specs(model, cfg, cell)
    inputs = _metas(inputs)
    step = sharded_decode_step(
        model, mesh, rules, max_len=cell.seq_len,
        enc_len=cell.seq_len if cfg.family == "encdec" else None)
    return (step, args["params"], args["cache"], inputs["tokens"],
            inputs["lengths"])


def plan_cell(arch: str, shape: str, multi_pod: bool, *,
              moe_impl: str = "dropless", remat: str = "",
              microbatches: int = 1) -> dict:
    """One cell's record (see the module's docstring), in a fake group of
    256 (single pod) or 512 (multi-pod) ranks started and destroyed
    here."""
    cfg = get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    cell = SHAPES[shape]
    ok, reason = supports_cell(cfg, cell)
    if not ok:
        return {"ok": True, "skipped": reason}
    rec = {"skipped": None}
    with fake_world(512 if multi_pod else 256):
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        model = build_model(cfg, moe_impl=moe_impl, device="meta")
        tcfg = TrainerConfig(microbatches=microbatches)
        args = cell_arguments(model, cfg, cell, mesh, tcfg)
        rec["memory_analysis"] = {"argument_size_in_bytes": _nbytes(args)}
        rec["num_devices"] = math.prod(mesh_shape(mesh).values())
        rec["seconds_build"] = time.time() - t0
        t1 = time.time()
        # a step takes the host batch (inputs), whole on every rank, and
        # keeps its own rows (``shard_batch``): the slice counted above
        out, flops, records = count_step(
            *cell_step(model, cfg, cell, mesh, tcfg, args))
        rec["seconds_step"] = time.time() - t1
        rec["memory_analysis"]["output_size_in_bytes"] = _nbytes(out)
        rec["cost_analysis"] = {"flops": float(flops)}
        rec["collectives"] = summarize(records)
    rec["ok"] = True
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: Path, *,
             moe_impl: str = "dropless", suffix: str = "", remat: str = "",
             microbatches: int = 1) -> dict:
    """``plan_cell`` recorded as JSON under ``out_dir``; a failure is
    recorded, not raised, so the matrix goes on."""
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "ok": False,
           "moe_impl": moe_impl, "variant": suffix or "baseline",
           "remat": remat or None, "microbatches": microbatches}
    t0 = time.time()
    try:
        rec.update(plan_cell(arch, shape, mesh_kind == "multi",
                             moe_impl=moe_impl, remat=remat,
                             microbatches=microbatches))
    except Exception as e:  # noqa: BLE001 — record, don't crash the matrix
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        rec["seconds_total"] = time.time() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / _artifact(arch, shape, mesh_kind, suffix)
    path.write_text(json.dumps(rec, indent=1))
    status = "SKIP" if rec.get("skipped") else ("OK" if rec["ok"] else "FAIL")
    print(f"[{status}] {arch} x {shape} x {mesh_kind} "
          f"({rec['seconds_total']:.1f}s){_figures(rec)}", flush=True)
    return rec


def _artifact(arch, shape, mesh_kind, suffix) -> str:
    sfx = f"__{suffix}" if suffix else ""
    return f"{arch.replace('.', '_')}__{shape}__{mesh_kind}{sfx}.json"


def _figures(rec) -> str:
    """The three figures of a planned cell, as printed."""
    if not rec["ok"] or rec.get("skipped"):
        return ""
    gib = rec["memory_analysis"]["argument_size_in_bytes"] / 2 ** 30
    text = f": {gib:.4f} GiB of arguments per rank"
    return (text + f", {rec['cost_analysis']['flops'] / 1e12:.4f} TFLOPs per "
            f"rank, {rec['collectives']['total_wire_bytes'] / 2 ** 30:.4f} "
            "GiB on the wire per rank")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--moe-impl", default="dropless",
                    choices=["dense", "dropless", "ep"])
    ap.add_argument("--suffix", default="",
                    help="artifact name suffix (variants)")
    ap.add_argument("--remat", default="", choices=["", "full", "dots",
                                                    "nothing"],
                    help="override the config's remat policy")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        archs, shapes = list(ARCH_IDS), list(SHAPES)
    else:
        archs = [args.arch]
        shapes = [args.shape] if args.shape else list(SHAPES)

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                path = out_dir / _artifact(arch, shape, mk, args.suffix)
                if args.skip_existing and path.exists():
                    if json.loads(path.read_text()).get("ok"):
                        print(f"[CACHED] {arch} x {shape} x {mk}")
                        continue
                rec = run_cell(arch, shape, mk, out_dir,
                               moe_impl=args.moe_impl, suffix=args.suffix,
                               remat=args.remat,
                               microbatches=args.microbatches)
                n_fail += not rec["ok"]
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
