"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries land in
``build/repro_torch/`` at the repository root (git-ignored), named by a
hash of the source, so an edited kernel rebuilds and an unchanged one is
reused.  Nothing here runs at import: the first kernel launch builds its
library, or ``build_all`` builds every one, all ``nvcc`` processes started
together.

A build that cannot run (no ``nvcc``) or fails raises; there is no
fallback to a plain version.

``LAUNCHES`` counts, per kernel, the launches the wrappers made: a
wrapper adds one right where it launches its kernel and nowhere else, so
a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches made by its wrapper
LAUNCHES: Dict[str, int] = {
    "similarity_topk_batched": 0,
    "similarity_lookup": 0,
    "similarity_topk_touch": 0,
    "similarity_topk": 0,
    "paged_attention": 0,
    "ivf_pq_probe": 0,
    "decode_attention": 0,
    "decode_attention_lse": 0,
    "flash_attention": 0,
}

# source stem -> loaded library
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are compiled at first use and need the CUDA "
                           "toolkit")
    return path


def _lib_path(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:16]}.so"


def _start_build(stem: str):
    """Start one ``nvcc`` for ``stem``; returns (process, tmp, out) or None
    when the library is already built."""
    out = _lib_path(stem)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(stem: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{stem}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)            # atomic: a reader never sees half a .so


def build_all(stems: Iterable[str] = ("similarity", "paged_attention",
                                     "ivf_pq", "decode_attention",
                                     "flash_attention")) -> None:
    """Compile every kernel source at once (one ``nvcc`` per source, all
    started together) and load the libraries."""
    jobs = {s: _start_build(s) for s in stems}
    for stem, job in jobs.items():
        if job is not None:
            _finish_build(stem, job)
    for stem in jobs:
        load(stem)


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, building it first if
    needed.  Every exported function returns ``cudaGetLastError()`` as an
    int; argtypes are declared by the kernel module that calls it."""
    lib = _LIBS.get(stem)
    if lib is None:
        job = _start_build(stem)
        if job is not None:
            _finish_build(stem, job)
        lib = ctypes.CDLL(str(_lib_path(stem)))
        _LIBS[stem] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """Streaming multiprocessors of CUDA device ``device`` (the kernels'
    split plans aim at about a wave of blocks)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# (device index, stream) -> the fp32 workspace of the kernels' split passes
_WORKSPACE: Dict[tuple, torch.Tensor] = {}


def workspace(t: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` fp32 entries of scratch on ``t``'s device for a
    launch on ``stream``: one buffer per device and stream, grown on
    demand and reused (launches on one stream run in order, so a launch
    finds the previous one done with it)."""
    key = (t.get_device(), stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < n:
        ws = _WORKSPACE[key] = torch.empty(n, dtype=torch.float32,
                                           device=t.device)
    return ws


def check(stem: str, err: int, what: str) -> None:
    """Raise if a kernel's C entry point (in ``csrc/<stem>.cu``) reported
    a CUDA error; each library exports ``<stem>_error_string``."""
    if err != 0:
        fn = getattr(load(stem), f"{stem}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} at launch: "
                           f"{fn(err).decode()}")
