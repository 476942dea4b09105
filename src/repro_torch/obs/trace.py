"""Zero-dep span tracer — Chrome trace-event JSON, loadable in Perfetto.

Two tracks, one timeline (microseconds since the tracer's epoch):

* **engine track** (``pid=PID_ENGINE``): wall-clock spans of the serving
  pipeline, emitted as matched ``B``/``E`` duration events that nest on
  the engine tid — ``step`` > { ``schedule`` > [``descriptor``,
  ``lookup`` > per-rung ``probe:local|peer|remote|cloud``],
  ``admit`` > [``prefill``, ``prefill_chunk``], ``decode``, ``retire`` } —
  plus a ``request:<rid>`` span (category ``request``) inside the step
  that served/retired the request, carrying tier + completion args.

* **request track** (``pid=PID_REQUESTS``, one tid per request id):
  MODELED-latency spans on the paced clock, emitted as ``X`` complete
  events — an outer ``request`` span whose duration is exactly
  ``ServedResult.completion_ms`` and child spans for each accounting term
  (``queue_wait``/``engine_steps``, ``uplink``, ``lookup``, ``peer_net``,
  ``remote_net``, ``cloud_net``, ``cloud_compute``, ``downlink``) laid
  end-to-end, so the sum of child durations reconstructs the completion
  time per tier (the acceptance invariant ``scripts/check_trace.py`` and
  ``tests/test_obs.py`` verify).

``NullTracer`` is the default everywhere: every method is a no-op and
``enabled`` is False, so a disabled hot path pays exactly one attribute
check (``if self.trace.enabled:``) before skipping span bookkeeping.

Export: ``Tracer.export(path)`` writes ``{"traceEvents": [...]}`` —
open in https://ui.perfetto.dev (or chrome://tracing).  Validation lives
in ``scripts/check_trace.py``.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

PID_ENGINE = 1
PID_REQUESTS = 2

# thread/process names shown by Perfetto (M metadata events)
_TRACK_NAMES = {PID_ENGINE: "engine", PID_REQUESTS: "requests (modeled)"}


class _NullSpan:
    """Reusable no-op context manager (one instance, zero allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: no events, no state, every call a no-op."""

    enabled = False

    def now_us(self) -> float:
        return 0.0

    def begin(self, name: str, *, cat: str = "engine", pid: int = PID_ENGINE,
              tid: int = 0, ts: Optional[float] = None, args: dict = None
              ) -> None:
        pass

    def end(self, *, pid: int = PID_ENGINE, tid: int = 0,
            ts: Optional[float] = None) -> None:
        pass

    def span(self, name: str, *, cat: str = "engine",
             pid: int = PID_ENGINE, tid: int = 0, args: dict = None):
        return _NULL_SPAN

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "engine", pid: int = PID_ENGINE, tid: int = 0,
                 args: dict = None) -> None:
        pass

    def instant(self, name: str, *, cat: str = "engine",
                pid: int = PID_ENGINE, tid: int = 0,
                ts: Optional[float] = None, args: dict = None) -> None:
        pass

    def export(self, path: str) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("tracer", "name", "cat", "pid", "tid", "args")

    def __init__(self, tracer, name, cat, pid, tid, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.pid = pid
        self.tid = tid
        self.args = args

    def __enter__(self):
        self.tracer.begin(self.name, cat=self.cat, pid=self.pid,
                          tid=self.tid, args=self.args)
        return self

    def __exit__(self, *exc):
        self.tracer.end(pid=self.pid, tid=self.tid)
        return False


class Tracer(NullTracer):
    """The recording tracer.  Events accumulate host-side in a list of
    dicts (the Chrome trace-event wire shape, ready to dump); the only
    per-span cost is two appends and a ``perf_counter`` read.

    ``max_steps=N`` bounds host memory on long runs by keeping a RING of
    the last N engine-step segments: a segment opens at each top-level
    ``step`` begin on the engine track and carries EVERYTHING emitted
    until the next one (nested engine spans, request markers, and the
    modeled request timelines retired during that step), so evicting the
    oldest segment drops whole steps — matched B/E pairs and complete
    request/term groups together — and a ring-truncated export still
    passes every ``scripts/check_trace.py`` structural invariant.  Track
    metadata (``M`` events) is kept outside the ring.  The default
    ``max_steps=None`` keeps every event (the original behavior)."""

    enabled = True

    def __init__(self, max_steps: Optional[int] = None):
        assert max_steps is None or max_steps >= 1, max_steps
        self._epoch = time.perf_counter()
        self._meta: List[dict] = []
        # ring of per-step event segments; segment [-1] is always current.
        # max_steps=None -> one unbounded segment, never rotated.
        self._segments: deque = deque([[]], maxlen=max_steps)
        self._max_steps = max_steps
        # open-span name stacks per (pid, tid) — lets export() close any
        # spans left open (a crash mid-step must still produce a valid
        # trace) and check_trace verify matched begin/end
        self._open: Dict[Tuple[int, int], List[str]] = {}
        for pid, name in _TRACK_NAMES.items():
            self._meta.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": name}})

    @property
    def events(self) -> List[dict]:
        out = list(self._meta)
        for seg in self._segments:
            out.extend(seg)
        return out

    def _emit(self, ev: dict) -> None:
        self._segments[-1].append(ev)

    # ------------------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def begin(self, name, *, cat="engine", pid=PID_ENGINE, tid=0, ts=None,
              args=None):
        if (self._max_steps is not None and name == "step"
                and pid == PID_ENGINE
                and not self._open.get((pid, tid))):
            # new top-level engine step: rotate the ring (deque eviction
            # drops the oldest whole segment when full)
            self._segments.append([])
        ev = {"ph": "B", "name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": self.now_us() if ts is None else ts}
        if args:
            ev["args"] = args
        self._emit(ev)
        self._open.setdefault((pid, tid), []).append(name)

    def end(self, *, pid=PID_ENGINE, tid=0, ts=None):
        stack = self._open.get((pid, tid))
        if not stack:
            raise RuntimeError(f"Tracer.end with no open span on "
                               f"(pid={pid}, tid={tid})")
        stack.pop()
        self._emit({"ph": "E", "pid": pid, "tid": tid,
                    "ts": self.now_us() if ts is None else ts})

    def span(self, name, *, cat="engine", pid=PID_ENGINE, tid=0, args=None):
        return _Span(self, name, cat, pid, tid, args)

    def complete(self, name, ts_us, dur_us, *, cat="engine", pid=PID_ENGINE,
                 tid=0, args=None):
        ev = {"ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": float(ts_us), "dur": float(dur_us)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name, *, cat="engine", pid=PID_ENGINE, tid=0,
                ts=None, args=None):
        ev = {"ph": "i", "name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": self.now_us() if ts is None else ts, "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)

    # ------------------------------------------------------------------
    def request_timeline(self, rid: int, ts_ms: float, tier: str,
                         terms: List[Tuple[str, float]],
                         completion_ms: float, args: dict = None) -> None:
        """Emit the modeled per-request reconstruction on the request
        track: an outer ``request`` span of exactly ``completion_ms`` and
        one child span per accounting term, laid end-to-end from
        ``ts_ms``.  ``terms`` must sum to ``completion_ms`` (within float
        rounding) — the caller passes the same terms its completion
        accounting added up."""
        base = float(ts_ms) * 1e3                       # ms -> us
        a = {"tier": tier, "completion_ms": completion_ms}
        if args:
            a.update(args)
        self.complete("request", base, completion_ms * 1e3,
                      cat="request_model", pid=PID_REQUESTS, tid=rid,
                      args=a)
        t = base
        for name, ms in terms:
            if ms <= 0.0:
                continue
            self.complete(name, t, ms * 1e3, cat="request_term",
                          pid=PID_REQUESTS, tid=rid)
            t += ms * 1e3

    # ------------------------------------------------------------------
    def export(self, path: str) -> None:
        """Write Chrome trace-event JSON.  Any still-open B spans are
        closed at the current timestamp first (a valid trace beats a
        precise one when exporting mid-run)."""
        now = self.now_us()
        tail = []
        for (pid, tid), stack in self._open.items():
            tail.extend({"ph": "E", "pid": pid, "tid": tid, "ts": now}
                        for _ in stack)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events + tail,
                       "displayTimeUnit": "ms"}, f)
