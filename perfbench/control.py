"""The control of a cell's ``served_gap_max`` and ``descriptor_dist_max``,
and the program's own readings of every compared number, on several seeds
in one process.

    python3 perfbench/control.py --workload granite20b-unique \\
        --seconds 10 --seeds 101 102 103

For each seed: the benchmark's weights of that seed, a fresh engine, the
cell's traffic (its warm phase, then a short window at the cell's own
load), the engine freed, then one pass of the reference over the sampled
requests that reads both the program's widest gap and the control's (the
same reference with every matrix product in fp8, ``reference.py``).
Prints one JSON line per seed.  Each limit lies above every program
reading and below every control reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(workload, seeds, seconds, device="cuda", overrides=None,
             model=None):
    """[{seed, each compared number's program reading, the control's
    widest gap and descriptor distance, tokens checked}]."""
    import torch

    from perfbench import check as CK
    from perfbench import harness as H
    from perfbench.traffic import Traffic

    _, config, mix = H.cell_files(H.load_bench(), workload)
    ov = overrides or {}
    mix = {**mix, **ov.get("traffic", {})}
    config = {**config, "check": {**config["check"], **ov.get("check", {})}}
    spec = H.model_spec(config, ov)
    out = []
    with torch.no_grad():
        for seed in seeds:
            if model is None:
                model = H.build_model(spec, seed, device)
            else:
                H.load_weights(model, spec, seed)
            eng = H.make_engine(model, config, device, overrides=ov)
            traffic = Traffic(mix, spec["vocab_size"], seed)
            d = H.Driver(eng, traffic)
            *_, window = H.drive(d, mix, seconds)
            finished = [r for r in d.order if r.tokens is not None]
            del eng, d
            if device == "cuda":
                torch.cuda.empty_cache()
            checks, info = CK.judge(torch, spec, config, seed, traffic,
                                    finished, window, device, control=True)
            row = {"seed": seed}
            row.update((k, c["value"]) for k, c in checks.items())
            row.update(info)
            out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from repro_torch.kernels import build_all

    build_all()
    t = time.perf_counter()
    for row in readings(args.workload, args.seeds, args.seconds):
        print(json.dumps({"workload": args.workload, **row,
                          "elapsed_s": time.perf_counter() - t}),
              flush=True)

if __name__ == "__main__":
    main()
