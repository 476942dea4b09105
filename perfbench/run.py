"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perfbench/run.py --workload granite20b-unique --seed 7 \\
        --seconds 51 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared beside its
limit); the same numbers end standard error.  Without a CUDA device, with
fewer devices than the cell asks for, or with JAX or the JAX package
loaded at the end, it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the run at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    cell, _, _ = harness.cell_files(harness.load_bench(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, info = harness.run(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START)
    bad = harness.banned_modules()
    if bad:
        print(f"perfbench: modules loaded that the run may not load: {bad}",
              file=sys.stderr)
        return 3
    print(f"perfbench: {args.workload} seed {args.seed}: "
          + json.dumps(info), file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
