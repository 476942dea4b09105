"""What the readers of the engine's launch phases and pad fill share
(``metrics/decode_issue_ms.py`` and the five beside it).

Under a tracer the program's engine splits each model launch's span into
``pack`` (inputs built and uploaded), ``forward`` (the model call, which
returns once its kernels are issued) and ``sample`` (the argmax copied to
the host: the wait for the device), and observes, per launch, the real
tokens and the padded slots it ran in ``engine/fill/<kind>/tokens`` and
``engine/fill/<kind>/slots``.  A program without them reads None.
"""
from __future__ import annotations

from typing import Callable, Optional


def span_mean_ms(w, keep: Callable[[str], bool]) -> Optional[float]:
    """Mean length, in ms, of the engine spans closed inside [T0, T1]
    whose path (``step/decode/forward``) ``keep`` accepts."""
    if w.spans is None:
        return None
    d = [b - a for path, a, b in w.spans.closed
         if keep(path) and w.T0 <= a and b <= w.T1]
    return sum(d) / len(d) * 1e3 if d else None


def fill_share(w, kind: str) -> Optional[float]:
    """The window's real tokens over the slots its ``kind`` launches ran
    (``descriptor``, ``prefill``, ``decode``), in percent."""
    _, tokens = w.hist(f"engine/fill/{kind}/tokens")
    n, slots = w.hist(f"engine/fill/{kind}/slots")
    return 100.0 * tokens / slots if n > 0 and slots > 0 else None
