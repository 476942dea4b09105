"""PyTorch/CUDA port of the CoIC reproduction (``src/repro``), slice by slice.

The package mirrors ``repro/`` module for module and imports nothing of it
(nor JAX).  Entry points take a ``device`` that defaults to ``"cuda"``; the
tests pass ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version.  See ROADMAP.md for what is ported and what waits.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
