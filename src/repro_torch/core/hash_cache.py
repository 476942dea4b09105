"""Exact-match content-hash cache — the CoIC "3D model / panorama" path.

The paper: "For 3D object rendering and VR video streaming tasks, CoIC uses
the hash value of the required 3D model or panoramic frames as the feature
descriptor."  The ML-serving analogue is loadable-state reuse: KV caches,
prefix blocks, compiled artifacts — anything expensive to (re)load keyed by
exact content.

Host-side (scheduling tier) with byte-size-bounded LRU; values are arbitrary
trees of device tensors, so a hit hands back device-resident state with zero
reload cost — exactly the paper's Fig-2b "load latency" saving.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np
import torch


def content_hash(obj: Any) -> str:
    """Stable hash of token arrays / tensors / bytes / str / tuples
    thereof: the reference's digest for the same values."""
    h = hashlib.sha256()

    def feed(o):
        if isinstance(o, (bytes, bytearray)):
            h.update(b"b"); h.update(o)
        elif isinstance(o, str):
            h.update(b"s"); h.update(o.encode())
        elif isinstance(o, (int, float)):
            h.update(b"n"); h.update(repr(o).encode())
        elif isinstance(o, (list, tuple)):
            h.update(b"l")
            for e in o:
                feed(e)
        else:
            dtype, shape, raw = _array_parts(o)
            h.update(b"a"); h.update(dtype.encode())
            h.update(shape.encode()); h.update(raw)

    feed(obj)
    return h.hexdigest()


# float types numpy has; torch's others (bfloat16, the float8 types) keep
# their torch name, which is also ml_dtypes' (the reference's numpy name)
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _array_parts(o: Any) -> Tuple[str, str, bytes]:
    """(dtype name, shape as a tuple's text, raw bytes) of an array or a
    tensor, as numpy names them.  A tensor of any dtype, device or grad
    state is copied to the host, detached; a dtype numpy lacks gives its
    bytes under torch's name."""
    if isinstance(o, torch.Tensor):
        t = o.detach().cpu().contiguous()
        if t.is_floating_point() and t.dtype not in _NUMPY_FLOATS:
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
            return str(t.dtype).split(".")[-1], str(tuple(t.shape)), raw
        o = t.numpy()
    arr = np.asarray(o)
    return str(arr.dtype), str(arr.shape), arr.tobytes()


def _nbytes(tree: Any) -> int:
    """Bytes of every tensor / array leaf of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)


class HashCache:
    """Byte-bounded LRU of pytrees keyed by content hash."""

    def __init__(self, capacity_bytes: int = 1 << 30):
        self.capacity_bytes = capacity_bytes
        self._store: "OrderedDict[str, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Any]:
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return entry[0]

    def put(self, key: str, value: Any) -> None:
        size = _nbytes(value)
        if key in self._store:
            old = self._store.pop(key)
            self._bytes -= old[1]
        while self._store and self._bytes + size > self.capacity_bytes:
            _, (_, sz) = self._store.popitem(last=False)
            self._bytes -= sz
        if size <= self.capacity_bytes:
            self._store[key] = (value, size)
            self._bytes += size

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def __len__(self) -> int:
        return len(self._store)

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"entries": len(self._store), "bytes": self._bytes,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}
