"""Small tree utilities — the port's copy of ``repro/utils/tree.py``.

A tree is nested dicts, named tuples, lists and tuples whose leaves are
tensors, numpy arrays or anything with ``shape`` and ``dtype``; ``None``
is an empty subtree.  Leaves come in JAX's order (a dict's keys sorted),
and a leaf's path names each step as JAX's key paths do: a dict key, a
named tuple's field name, a sequence index, each as a string.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree: Any, path: tuple = ()
                      ) -> Iterator[Tuple[tuple, Any]]:
    """(path, leaf) for every leaf, in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from leaves_with_paths(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from leaves_with_paths(x, path + (str(i),))
    else:
        yield path, tree


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_param_count(tree: Any) -> int:
    """Total number of scalar parameters in a tree of arrays."""
    return int(sum(int(np.prod(tuple(l.shape)))
                   for _, l in leaves_with_paths(tree)))


def tree_size_bytes(tree: Any) -> int:
    """Total byte size of a tree of arrays."""
    return int(sum(int(np.prod(tuple(l.shape))) * _itemsize(l.dtype)
                   for _, l in leaves_with_paths(tree)))


def map_with_paths(fn: Callable[[tuple, Any], Any], tree: Any,
                   path: tuple = ()) -> Any:
    """The tree with each leaf replaced by ``fn(path, leaf)``; path
    elements are strings."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, x, path + (str(i),))
                          for i, x in enumerate(tree))
    return fn(path, tree)
