"""Checkpoint / restore in the reference's on-disk format — the port of
``repro/checkpoint/checkpointer.py``.

* one directory per step, ``<root>/step_<N:08d>/``: one ``.npy`` per leaf,
  named by its flattened path (dict keys as they are, a named tuple's
  fields by name, a sequence index as a number; "/" written
  ``__SLASH__``, a space ``_``), and ``manifest.json`` with each leaf's
  shape and dtype;
* atomic: a save writes ``step_<N>.tmp`` and renames it only after the
  manifest is fsynced;
* asynchronous: ``save`` copies the tensors to the host (it blocks for
  that copy only) and a background thread writes them;
* ``keep`` newest steps retained, older ones pruned.

A checkpoint written by either package restores in the other: a
``TrainState`` of the port keeps the reference's flat weight layout, so
its leaves are named and shaped alike (``params__SLASH__blocks__SLASH__0
__SLASH__attn__SLASH__wq``, ``opt__SLASH__count``, ``step``).  Leaves go
through numpy, so a bfloat16 tensor is refused (numpy has no such type).

Elastic restore: ``restore(step, like, shardings)`` loads each leaf from
the same files and places it on the *current* mesh by the given
``parallel/sharding.py::Sharding`` (this rank's slice), so a checkpoint
saved on one mesh reshards onto another.  A sharded state is saved whole:
the caller gathers it (``Sharding.unshard``) first.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.utils.tree import leaves_with_paths, map_with_paths


def leaf_name(path: tuple) -> str:
    """A leaf's file name (without ``.npy``), as the reference names it."""
    return "/".join(path).replace("/", "__SLASH__").replace(" ", "_")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy type; save the "
                            "fp32 master weights")
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Checkpointer:
    def __init__(self, root: str, keep: int = 3, async_save: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.save_seconds: List[float] = []

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def steps(self) -> List[int]:
        out = []
        for d in self.root.glob("step_*"):
            if d.is_dir() and not d.name.endswith(".tmp"):
                try:
                    out.append(int(d.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, block: bool = False) -> None:
        """Copy to the host, then write (in a thread unless ``block``)."""
        host = [(leaf_name(p), _host(x)) for p, x in leaves_with_paths(tree)]

        def write():
            t0 = time.perf_counter()
            tmp = self.root / f"step_{step:08d}.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {}
            for name, arr in host:
                np.save(tmp / f"{name}.npy", arr)
                manifest[name] = {"shape": list(arr.shape),
                                  "dtype": str(arr.dtype)}
            mpath = tmp / "manifest.json"
            mpath.write_text(json.dumps({"step": step, "leaves": manifest}))
            with open(mpath) as f:
                os.fsync(f.fileno())
            final = self._step_dir(step)
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._prune()
            self.save_seconds.append(time.perf_counter() - t0)

        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int, like: Any, shardings: Optional[Any] = None,
                device="cuda") -> Any:
        """The tree saved at ``step``, in ``like``'s structure (its leaf
        values are ignored), every leaf a tensor on ``device`` with its
        saved dtype.  ``shardings`` (``like``'s structure, a ``Sharding``
        per leaf, or one for every leaf) places each leaf on the current
        mesh: this rank's slice of it.  A leaf of ``like`` missing from
        the checkpoint raises ``KeyError``."""
        dev = resolve_device(device)
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        place = {}
        if shardings is not None:
            if hasattr(shardings, "place"):
                place = {leaf_name(p): shardings
                         for p, _ in leaves_with_paths(like)}
            else:
                place = {leaf_name(p): s
                         for p, s in leaves_with_paths(shardings)}

        def load(path, _):
            name = leaf_name(path)
            if name not in manifest["leaves"]:
                raise KeyError(f"checkpoint {step} missing leaf {name}")
            t = torch.from_numpy(np.load(d / f"{name}.npy")).to(dev)
            return place[name].place(t) if name in place else t

        return map_with_paths(load, like)
