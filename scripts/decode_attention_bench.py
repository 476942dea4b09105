#!/usr/bin/env python3
"""Time the flash-decode kernel (K7) of one or more checkouts on one GPU.

    python3 scripts/decode_attention_bench.py [ROOT ...]

Each ROOT is a checkout of the repository (default: this one); each runs
in a process of its own (the checkouts share module names), in the order
given, so ``old new new old`` compares two trees on one card in turns.
Per tree and shape it prints one JSON line: the kernel's max error
against its plain version, its eager, device and host times and those of
its SDPA yardstick (``chip_smoke.py``'s ``Timer`` and ``times``, from
that tree's own ``chip_smoke.py``), and the bound from that run's
inputs.  Shapes: the swa path's decode launch (B = 8 over a 4096-slot
ring, kv_len 4096 x 2 and 528 x 6), a full ring, both bf16, the full
ring in fp32, granite-20b's grouping (48 query heads on one KV head,
head_dim 128) where the tree's kernel takes it, and a ring of the full
ring's bytes and blocks whose slots are contiguous in memory (64 rows of
one KV head); then, as a calibration, one ``torch.add`` over the full
ring's K and V.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SWA = dict(B=8, S=4096, H=32, K=8, D=120)
SHAPES = [("swa_launch", SWA, (4096, 4096) + (528,) * 6, "bfloat16"),
          ("full_ring", SWA, (4096,) * 8, "bfloat16"),
          ("full_ring_f32", SWA, (4096,) * 8, "float32"),
          ("granite_ring", dict(B=8, S=4096, H=48, K=1, D=128), (4096,) * 8,
           "bfloat16"),
          # the full ring's grid, blocks and bytes, with each block's slots
          # contiguous in memory (one KV head: no 1920-byte slot stride)
          ("contiguous_ring", dict(B=64, S=4096, H=4, K=1, D=120),
           (4096,) * 64, "bfloat16")]


class ReadFlush:
    """A stand-in for ``Timer.flush`` whose ``zero_`` reads the buffer
    (evicting the L2 as the write does, but leaving its lines clean)."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.sum()


def one(root: Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_bench: needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer(torch)
    clean = cs.Timer(torch)
    clean.flush = ReadFlush(clean.flush)
    for name, sh, lens, dt in SHAPES:
        if sh["H"] // sh["K"] > dk.G_MAX:
            continue
        dtype = getattr(torch, dt)
        q, k, v, ln = cs.decode_inputs(torch, g, sh["B"], sh["S"], sh["H"],
                                       sh["K"], sh["D"], dtype, lens)
        out = dk.decode_attention_cuda(q, k, v, ln)
        err = float((out.float() - decode_attention_ref(q, k, v, ln)
                     .float()).abs().max())
        b_ms, b_by = cs.bound(*cs.decode_work(q, k, ln), dt)
        row = {"tree": str(root), "shape": name, **sh, "kv_len": lens[:3],
               "dtype": dt, "max_abs_err": err, "bound_ms": b_ms,
               "bound_by": b_by,
               **cs.times(timer, lambda: dk.decode_attention_cuda(q, k, v,
                                                                  ln),
                          cs.sdpa_slots(torch, q, k, v, ln))}
        # the same device time after a 64 MiB read in place of the Timer's
        # write: the L2 holds no dirty lines for the call to write back
        row["device_clean_ms"] = clean.device(
            lambda: dk.decode_attention_cuda(q, k, v, ln))
        print(json.dumps(row), flush=True)
    # what a plain streaming op reaches under the same Timer: K + V of the
    # full ring into a third tensor of their size (3 x 62.9 MB)
    k, v = (torch.randn(8, 4096, 8, 120, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    o = torch.empty_like(k)
    ms = timer.device(lambda: torch.add(k, v, out=o))
    nbytes = 3 * k.numel() * k.element_size()
    print(json.dumps({"tree": str(root), "shape": "stream_add",
                      "device_ms": ms, "bytes": nbytes,
                      "tb_per_s": nbytes / ms / 1e9}), flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(Path(sys.argv[2]).resolve())
        return
    roots = sys.argv[1:] or [str(Path(__file__).resolve().parents[1])]
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)


if __name__ == "__main__":
    main()
