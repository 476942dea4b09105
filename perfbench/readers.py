"""What the metric readers (``metrics/<name>.py``) share: the window's
work from the benchmark's own records, kernel time by name."""
from __future__ import annotations

from typing import Optional

from perfbench import devtrace as DT
from perfbench.work import PEAK_FLOPS, Work


def window_work(w) -> Work:
    """The work of steps s0 + 1 .. s1: each request's descriptor at the
    step after it was sent; a model-served request's prefill at its first
    step and one decoded token a step from there to its last."""
    wk = Work(w.spec, w.k_layers)
    lo, hi = w.s0, w.s1
    for r in w.reqs:
        if lo < r.submit_step + 1 <= hi:
            wk.descriptor(r.prompt_len)
        if r.tokens is None or r.source != "cloud":
            continue
        p, S = r.first_step, r.prompt_len
        if lo < p <= hi:
            wk.prefill(S)
        for j in range(max(0, lo + 1 - p), min(len(r.tokens) - 1,
                                                hi - p + 1)):
            wk.decode(S + j)
    return wk


def step_ms(w) -> Optional[float]:
    """Mean wall time of the window's engine steps: from the return of
    step s0 to that of step s1, over s1 - s0 steps."""
    n = w.s1 - w.s0
    if n <= 0:
        return None
    return (w.step_end[w.s1 - 1] - w.step_end[w.s0 - 1]) / n * 1e3


def mfu(w) -> Optional[float]:
    return window_work(w).model_flops / (w.seconds * PEAK_FLOPS) * 100.0


def kernel_seconds(w, names, in_spans=None, names_in_spans=()) -> float:
    """Device time of kernels named ``names`` anywhere, and of those named
    ``names_in_spans`` when they began while an engine span named in
    ``in_spans`` was open on the host."""
    total = 0.0
    for n, a, b in w.device_events:
        k = DT.base_name(n)
        if k in names:
            total += b - a
        elif k in names_in_spans:
            label = w.spans.at(a) or ""
            if any(s in label.split("/") for s in in_spans):
                total += b - a
    return total


def idle_share(w) -> Optional[float]:
    if w.device_events is None:
        return None
    busy = sum(b - a for a, b in DT.union(w.device_events))
    return (1.0 - busy / w.seconds) * 100.0
