#!/usr/bin/env python3
"""Time the IVF-PQ digest probe (K6) of one or more checkouts on one GPU.

    python3 scripts/ivf_pq_bench.py [ROOT ...]

Each ROOT is a checkout of the repository (default: this one); each runs
in a process of its own (the checkouts share module names), in the order
given, so ``old new new old`` compares two trees on one card in turns.
Per tree and shape it prints one JSON line: the kernel's max score error
against its plain version (``chip_smoke.py``'s ``ivf_pq_agree``: scores
within 1e-4, lists and indices equal but for near ties), its eager,
device and host times (``Timer`` and ``times``, from that tree's own
``chip_smoke.py``), the bound from that run's inputs (``ivf_pq_bound``),
and the device time of each of the tree's K6 kernels under
``torch.profiler``.  Two stage yardsticks, timed beside it and used
nowhere in the port: cuBLAS's fp32 ``q @ cent.T`` (the coarse table) and
``torch.bmm`` of the lookup table, with TF32 off.  Shapes, from
``ivf_inputs`` at k = 1: the region board (Q = 256, L = 1024 lists x cap
984, S = 8, D = 2048, n_probe = 16), the federated path's launch (Q = 16,
L = 4, cap = 8, n_probe = 4) and the federation's default switch to the
IVF-PQ board (Q = 32, L = 64, cap = 96, n_probe = 8).  Needs a CUDA
device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = [("board", dict(Q=256, L=1024, cap=984, S=8, D=2048, n_probe=16)),
          ("fed_path", dict(Q=16, L=4, cap=8, S=8, D=2048, n_probe=4)),
          ("switch", dict(Q=32, L=64, cap=96, S=8, D=2048, n_probe=8))]
PROFILED_CALLS = 20


def stage_ms(torch, fn) -> dict:
    """Mean device ms per call that each kernel ``fn`` launches adds to the
    call, by name: its end less the later of its start and the previous
    kernel's end (a kernel launched early waits for its predecessor inside
    its own span, which is not its time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    out, prev_end = {}, float("-inf")
    for e in kern:
        own = e.time_range.end - max(e.time_range.start, prev_end)
        prev_end = max(prev_end, e.time_range.end)
        name = _short(e.name)
        out[name] = out.get(name, 0.0) + own / 1e3 / PROFILED_CALLS
    return out


def _short(name: str) -> str:
    """``void (anonymous namespace)::ivf_gemm_kernel<4>(Gemm, Gemm)`` ->
    ``ivf_gemm_kernel<4>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0] or "(unnamed)"


def one(root: Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ivf_pq.kernel import ivf_pq_probe_cuda

    if not torch.cuda.is_available():
        raise SystemExit("ivf_pq_bench: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer(torch)
    for name, sh in SHAPES:
        Q, L, cap, S, D, n_probe = (sh[x] for x in ("Q", "L", "cap", "S",
                                                     "D", "n_probe"))
        args, _ = cs.ivf_inputs(torch, g, Q, L, cap, S, D, n_probe)

        def fn():
            return ivf_pq_probe_cuda(*args, 1, n_probe)
        out = fn()
        torch.cuda.synchronize()
        err, excused = cs.ivf_pq_agree(torch, args, 1, n_probe, out)
        b_ms, b_by, n_lists = cs.ivf_pq_bound(torch, args, out[2])
        q, cent, cb = args[0], args[2], args[7]
        qs = q.reshape(Q, S, D // S).transpose(0, 1)      # (S, Q, dsub)
        cbt = cb.transpose(1, 2)                          # (S, dsub, 256)
        row = {"tree": str(root), "shape": name, **sh, "k": 1,
               "max_abs_err": err, "rows_excused": excused,
               "probed_lists": n_lists, "bound_ms": b_ms, "bound_by": b_by,
               **cs.times(timer, fn),
               "coarse_mm_device_ms": timer.device(lambda: q @ cent.T),
               "lut_bmm_device_ms": timer.device(lambda: torch.bmm(qs, cbt)),
               "kernels_device_ms": stage_ms(torch, fn)}
        print(json.dumps(row), flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(Path(sys.argv[2]).resolve())
        return
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)


if __name__ == "__main__":
    main()
