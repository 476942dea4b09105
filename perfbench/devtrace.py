"""The device trace of a traced run, on the host's clock.

``DeviceTrace`` runs ``torch.profiler`` with CUDA activity alone (no CPU
op events, to keep its cost down), and after the window reads every
device activity (kernels, copies, fills) as (name, start, end) in
``time.perf_counter`` seconds.  The profiler stamps activities on the
wall clock (``time.time_ns``'s base); a spin kernel launched right after
a synchronise, whose host launch time is known, fixes the offset between
the two clocks, so a kernel can be matched to the host span that was open
when it began.

``host_spans`` turns the engine's ``Tracer`` events into (path, start,
end) intervals; ``span_at`` finds the innermost one open at a time.
"""
from __future__ import annotations

import bisect
import time
from typing import List, Optional, Tuple

def base_name(name: str) -> str:
    """A demangled kernel name's function name: ``void ns::f<T>(P)`` ->
    ``f``."""
    s = name.replace("(anonymous namespace)", "")
    cuts = [i for i in (s.find("<"), s.find("(")) if i >= 0]
    head = s[:min(cuts)] if cuts else s
    words = head.split()
    return (words[-1] if words else s).split("::")[-1]


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.events: List[Tuple[str, float, float]] = []
        self._marks: List[Tuple[float, str]] = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.mark("perfbench_mark_start")

    def mark(self, label: str) -> None:
        """Synchronise, note the host clock, launch a spin kernel."""
        self.torch.cuda.synchronize()
        self._marks.append((time.perf_counter(), label))
        self.torch.cuda._sleep(1000)
        self.torch.cuda.synchronize()

    def stop(self) -> None:
        self.mark("perfbench_mark_stop")
        self.prof.stop()

    def read(self) -> None:
        """The stopped profile's device activities, on the host clock."""
        wall_minus_perf = time.time_ns() * 1e-9 - time.perf_counter()
        raw = []
        from torch.autograd import DeviceType

        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            t0 = e.start_ns() * 1e-9
            raw.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
        raw.sort(key=lambda r: r[1])
        spins = [r for r in raw if "spin_kernel" in r[0]]
        if len(spins) == len(self._marks):
            # the offset of the first mark: device start - host launch
            offset = spins[0][1] - self._marks[0][0]
            raw = [r for r in raw if "spin_kernel" not in r[0]]
        else:                          # no marker kernels: the wall clock
            offset = wall_minus_perf
        self.events = [(n, a - offset, b - offset) for n, a, b in raw]
        self.prof = None


def clip(events, t0: float, t1: float):
    """The events' parts inside [t0, t1]."""
    out = []
    for n, a, b in events:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out.append((n, a, b))
    return out


def union(intervals) -> List[Tuple[float, float]]:
    """Merged (start, end) intervals of (name, start, end) events."""
    out: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda r: r[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class SpanIndex:
    """The innermost engine span open at each host time, from a
    ``Tracer``'s B/E events on the engine track (``t_epoch``: the
    perf_counter value of the tracer's zero).  Spans nest, so time splits
    into segments, each labelled by the path of the spans open in it
    (``step/admit/prefill_chunk``), or None outside any."""

    def __init__(self, events, t_epoch: float):
        stack: List[Tuple[str, float]] = []
        self.starts: List[float] = []
        self.labels: List[Optional[str]] = []
        self.closed: List[Tuple[str, float, float]] = []   # (path, t0, t1)
        for ev in events:
            if ev.get("pid") != 1 or ev.get("ph") not in ("B", "E"):
                continue
            t = t_epoch + ev["ts"] * 1e-6
            if ev["ph"] == "B":
                stack.append((ev["name"], t))
            elif stack:
                path = "/".join(s[0] for s in stack)
                self.closed.append((path, stack.pop()[1], t))
            self.starts.append(t)
            self.labels.append("/".join(s[0] for s in stack) if stack
                               else None)

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.labels[i] if i >= 0 else None


def breakdown(events, spans: "SpanIndex", t0: float, t1: float,
              top: int = 10) -> dict:
    """The device operations that took the most time (by function name),
    and the device's idle time in [t0, t1] by the engine span open on the
    host at each gap's middle ("harness" outside every span)."""
    ops = {}
    for n, a, b in events:
        k = base_name(n)
        ops[k] = ops.get(k, 0.0) + (b - a)
    idle, at = {}, t0
    for a, b in union(events) + [(t1, t1)]:
        if a > at:
            k = spans.at((at + a) / 2) or "harness"
            idle[k] = idle.get(k, 0.0) + (a - at)
        at = max(at, b)
    return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda r: -r[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda r: -r[1])[:top]}
