"""The dry run's cases, run in ONE spawned process that starts fake process
groups (``launch/dryrun.py::fake_world``): no communication, no network.
This module imports torch and ``repro_torch`` only, so the spawned
process never loads JAX; ``tests/test_torch_dryrun.py`` holds its results
against the JAX package in the parent."""
import os
import pickle
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the reduced configs whose (2, 2) train step runs on meta and on the CPU
STEP_CASES = (("llama3.2-1b", None), ("granite-moe-3b-a800m", "dropless"),
              ("mamba2-2.7b", None))
STEP_BATCH = dict(seq_len=33, global_batch=4)
# every torch.distributed function that moves data between ranks
DIST_CALLS = ("all_gather_into_tensor", "all_gather", "all_reduce",
              "reduce_scatter_tensor", "reduce_scatter", "all_to_all",
              "all_to_all_single", "broadcast", "reduce", "gather", "scatter",
              "send", "recv", "isend", "irecv")


def _counting_dist(counts):
    """Patch ``DIST_CALLS`` to count their calls; returns the undo."""
    orig = {n: getattr(dist, n) for n in DIST_CALLS}

    def wrap(name, fn):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call
    for n, fn in orig.items():
        setattr(dist, n, wrap(n, fn))

    def undo():
        for n, fn in orig.items():
            setattr(dist, n, fn)
    return undo


def _step_case(arch, moe_impl, dev):
    """(FLOPs, collective record, torch.distributed calls) of one (2, 2)
    train step of the reduced ``arch`` with its tensors on ``dev``."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.dryrun import count_step, train_arguments
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train.trainer import (TrainerConfig, init_train_state,
                                           make_train_step, place_state,
                                           state_shardings)

    cfg = reduced_config(get_config(arch))
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    model = build_model(cfg, device=dev, moe_impl=moe_impl)
    tcfg = TrainerConfig()
    batch = SyntheticLMData(vocab_size=cfg.vocab_size,
                            **STEP_BATCH).batch_at(0)
    if dev == "meta":
        state = train_arguments(model, mesh, tcfg)
        batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                                device="meta") for k, v in batch.items()}
    else:
        state = place_state(init_train_state(
            model, torch.Generator().manual_seed(0), tcfg),
            state_shardings(model, mesh))
    calls = {}
    undo = _counting_dist(calls)
    try:
        _, flops, rec = count_step(make_train_step(model, tcfg, mesh), state,
                                   batch)
    finally:
        undo()
    return flops, [tuple(r) for r in rec], calls


def _argument_bytes(arch, shape, multi_pod):
    """This rank's argument bytes of one cell as ``plan_cell`` counts them
    (``cell_arguments``), in the fake group that runs; None for a cell
    that ``supports_cell`` refuses."""
    from repro_torch.configs import SHAPES, get_config, supports_cell
    from repro_torch.launch.dryrun import _nbytes, cell_arguments
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.train.trainer import TrainerConfig

    cfg, cell = get_config(arch), SHAPES[shape]
    if not supports_cell(cfg, cell)[0]:
        return None
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    model = build_model(cfg, moe_impl="dropless", device="meta")
    return _nbytes(cell_arguments(model, cfg, cell, mesh, TrainerConfig()))


def _entry(rank, out_dir):
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch.dryrun import fake_world, plan_cell

    torch.set_num_threads(2)
    try:
        out = {"steps": {}, "bytes": {}}
        with fake_world(4):
            for arch, moe_impl in STEP_CASES:
                out["steps"][arch] = {dev: _step_case(arch, moe_impl, dev)
                                      for dev in ("meta", "cpu")}
        out["plan"] = plan_cell("llama3.2-1b", "train_4k", False)
        out["plan_decode"] = plan_cell("llama3.2-1b", "decode_32k", False)
        with fake_world(512):
            for arch in ARCH_IDS:
                for shape in SHAPES:
                    for mk in ("single", "multi"):
                        out["bytes"][arch, shape, mk] = _argument_bytes(
                            arch, shape, mk == "multi")
    except Exception:                    # reported to the parent, not lost
        out = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, "dryrun.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_cases(tmp_dir: str) -> dict:
    mp.start_processes(_entry, args=(tmp_dir,), nprocs=1, join=True,
                       start_method="spawn")
    with open(os.path.join(tmp_dir, "dryrun.pkl"), "rb") as f:
        out = pickle.load(f)
    if "error" in out:
        raise AssertionError(out["error"])
    return out
