"""Unified telemetry registry — counters, gauges, and HDR-bucket histograms.

Every host-side counter the serving stack used to scatter across ad-hoc
dicts and dataclass fields (``ServingEngine.dispatches``, ``TierLadder``
tier/rung counts, ``DeadlineStats``, ``digest_bytes_shipped``,
``PagedStats``, ``prefill_tokens_*``) now lives in ONE
``MetricsRegistry``.  The legacy ``stats()`` dicts are thin views over the
same metric objects — incrementing a counter updates both the view and the
snapshot by construction, which is what makes "registry snapshot equals
legacy stats bit-for-bit" a trivial invariant instead of a
synchronization problem (tests/test_obs.py pins it on a seeded
federated + paged run).

Metric names are ``/``-separated paths (``ladder/tier_counts/local``,
``engine/dispatches/decode``, ``digest/bytes_shipped``); a component gets
its namespace from a ``prefix`` argument so two ladders (an org ladder and
an engine's serve ladder) coexist in one registry.

Design constraints, in order:

* **hot-path cost** — ``Counter.inc`` is one attribute add; nothing in
  this module allocates per-observation except ``Histogram.observe``'s
  bucket index math.  There is no lock (the serving stack is
  single-threaded host code, like the schedulers it models).
* **deterministic snapshots** — counters/gauges are exact.  Histograms
  use fixed log-spaced buckets (HDR-style, ~4% relative error) rather
  than sampling reservoirs, so two runs observing the same values
  snapshot the same percentiles.
* **zero deps** — stdlib + numpy only.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterator, Mapping, Optional, Sequence


class Counter:
    """Monotonic (by convention) integer counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v: int) -> None:
        self.value = v


class Gauge:
    """Last-write-wins scalar (floats allowed)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def max(self, v) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Fixed-bucket log-spaced (HDR-style) histogram with exact
    count/sum/min/max and ~``growth``-relative-error percentiles.

    Buckets: value ``v`` > 0 lands in bucket ``floor(log(v) / log(growth))``
    (clamped to ``[lo_bucket, hi_bucket]``); zeros and negatives land in a
    dedicated underflow bucket.  Percentile reconstruction returns the
    upper edge of the bucket holding the requested rank — deterministic
    for a given observation multiset, no reservoir sampling.
    """

    __slots__ = ("count", "sum", "min", "max", "_buckets", "_under",
                 "_growth", "_lo", "_hi", "_log_g")

    def __init__(self, growth: float = 1.04, lo: float = 1e-6,
                 hi: float = 1e9):
        assert growth > 1.0, growth
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._growth = growth
        self._log_g = math.log(growth)
        self._lo = int(math.floor(math.log(lo) / self._log_g))
        self._hi = int(math.ceil(math.log(hi) / self._log_g))
        self._buckets: Dict[int, int] = {}
        self._under = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self._under += 1
            return
        b = int(math.floor(math.log(v) / self._log_g))
        b = min(max(b, self._lo), self._hi)
        self._buckets[b] = self._buckets.get(b, 0) + 1

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding rank ``ceil(q/100 * count)``
        (0.0 for an empty histogram)."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = self._under
        if rank <= seen:
            return min(self.min, 0.0)
        for b in sorted(self._buckets):
            seen += self._buckets[b]
            if rank <= seen:
                # clamp the bucket edge to the observed extrema so p100
                # never exceeds max and p0 never undercuts min
                edge = self._growth ** (b + 1)
                return float(min(max(edge, self.min), self.max))
        return float(self.max)

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": (self.min if self.count else 0.0),
            "max": (self.max if self.count else 0.0),
            "mean": (self.sum / self.count if self.count else 0.0),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """The one store.  ``counter``/``gauge``/``histogram`` are idempotent
    get-or-create (same name twice returns the same object; a name can
    never change kind).  ``snapshot()`` flattens everything into one
    JSON-ready dict keyed by metric name."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    # ------------------------------------------------------------------
    def _get_or_create(self, name: str, kind, factory):
        m = self._metrics.get(name)
        if m is None:
            m = factory()
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, Gauge)

    def histogram(self, name: str, growth: float = 1.04) -> Histogram:
        return self._get_or_create(name, Histogram,
                                   lambda: Histogram(growth=growth))

    # ------------------------------------------------------------------
    def names(self) -> Sequence[str]:
        return list(self._metrics)

    def get(self, name: str):
        return self._metrics.get(name)

    def value(self, name: str, default=None):
        m = self._metrics.get(name)
        if m is None:
            return default
        return m.snapshot() if isinstance(m, Histogram) else m.value

    def find(self, prefix: str) -> Dict[str, object]:
        """All metrics whose name starts with ``prefix + '/'`` (or equals
        ``prefix``), keyed by the remainder of the name."""
        pre = prefix + "/"
        out = {}
        for name, m in self._metrics.items():
            if name == prefix:
                out[""] = m
            elif name.startswith(pre):
                out[name[len(pre):]] = m
        return out

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat ``{name: value}`` dict (histograms expand to their
        count/sum/percentile sub-dict).  JSON-serializable."""
        out = {}
        for name, m in self._metrics.items():
            out[name] = (m.snapshot() if isinstance(m, Histogram)
                         else m.value)
        return out

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)


# ---------------------------------------------------------------------------
# Prometheus text exposition (zero-dep, deterministic)
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    """Sanitize a ``/``-path metric name into the Prometheus grammar
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (every illegal byte becomes ``_``)."""
    out = []
    for i, ch in enumerate(name):
        ok = (ch.isascii()
              and (ch.isalpha() or ch in "_:" or (ch.isdigit() and i > 0)))
        out.append(ch if ok else "_")
    return "".join(out)


def _prom_num(v) -> str:
    """Deterministic number rendering: ints verbatim, floats via repr
    (shortest round-trip — two registries holding the same values always
    render the same text)."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def export_prometheus(metrics: MetricsRegistry,
                      path: Optional[str] = None) -> str:
    """Render the registry in the Prometheus text exposition format.

    Counters/gauges map 1:1.  Histograms render as native Prometheus
    histograms with CUMULATIVE ``le`` buckets reconstructed from the
    log-spaced store: each occupied bucket ``b`` contributes its upper
    edge ``growth**(b+1)``, the underflow bucket (zeros/negatives) lands
    under ``le="0"``, and ``+Inf`` carries the total count — plus the
    standard ``_sum``/``_count`` series.  Output is sorted by metric name
    and numerically deterministic, which is what makes a golden-file test
    possible (tests/test_obs.py).  ``path`` additionally writes the text.
    """
    lines: list = []
    for name in sorted(metrics.names()):
        m = metrics.get(name)
        pname = _prom_name(name)
        if isinstance(m, Histogram):
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            if m._under:
                cum += m._under
                lines.append(f'{pname}_bucket{{le="0"}} {cum}')
            for b in sorted(m._buckets):
                cum += m._buckets[b]
                edge = m._growth ** (b + 1)
                lines.append(f'{pname}_bucket{{le="{_prom_num(edge)}"}} '
                             f'{cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{pname}_sum {_prom_num(m.sum)}")
            lines.append(f"{pname}_count {m.count}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_prom_num(m.value)}")
        else:
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_prom_num(m.value)}")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def snapshot_to_prometheus(snapshot: Mapping,
                           path: Optional[str] = None) -> str:
    """Render a ``MetricsRegistry.snapshot()`` dict (e.g. a benchmark
    run's ``--metrics-out`` JSON, loaded back) as Prometheus text.

    A snapshot has already collapsed histogram buckets into percentiles,
    so histogram entries render as Prometheus SUMMARIES (``quantile``
    labels + ``_sum``/``_count``) rather than ``le`` buckets; scalars
    render as gauges (a snapshot does not record counter-vs-gauge kind).
    ``scripts/export_metrics.py`` is the CLI over this.
    """
    lines: list = []
    for name in sorted(snapshot):
        v = snapshot[name]
        pname = _prom_name(name)
        if isinstance(v, Mapping):                 # histogram snapshot
            lines.append(f"# TYPE {pname} summary")
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                lines.append(f'{pname}{{quantile="{q}"}} '
                             f'{_prom_num(v[key])}')
            lines.append(f"{pname}_sum {_prom_num(v['sum'])}")
            lines.append(f"{pname}_count {_prom_num(v['count'])}")
        else:
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_prom_num(v)}")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


class CounterDict(Mapping):
    """A dict-shaped view over registry counters, so call sites written as
    ``self.dispatches["decode"] += 1`` keep working verbatim while the
    store moves into the registry (``__setitem__`` routes the read-modify-
    write back into the underlying ``Counter``)."""

    __slots__ = ("_counters",)

    def __init__(self, metrics: MetricsRegistry, prefix: str,
                 keys: Sequence[str]):
        self._counters = {k: metrics.counter(f"{prefix}/{k}") for k in keys}

    def __getitem__(self, key: str) -> int:
        return self._counters[key].value

    def __setitem__(self, key: str, value: int) -> None:
        self._counters[key].set(value)

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def __repr__(self) -> str:
        return repr(dict(self))


class LazyCounterGroup:
    """Registry counters created on first touch under one prefix, exposed
    as a plain dict of observed keys — the shape ``DeadlineStats.met`` /
    ``.missed`` always had (absent tier == zero, not a 0 entry)."""

    __slots__ = ("_metrics", "_prefix", "_counters")

    def __init__(self, metrics: MetricsRegistry, prefix: str):
        self._metrics = metrics
        self._prefix = prefix
        self._counters: Dict[str, Counter] = {}

    def inc(self, key: str, n: int = 1) -> None:
        c = self._counters.get(key)
        if c is None:
            c = self._metrics.counter(f"{self._prefix}/{key}")
            self._counters[key] = c
        c.inc(n)

    def get(self, key: str, default: int = 0) -> int:
        c = self._counters.get(key)
        return c.value if c is not None else default

    def total(self) -> int:
        return sum(c.value for c in self._counters.values())

    def as_dict(self) -> Dict[str, int]:
        return {k: c.value for k, c in self._counters.items()}
