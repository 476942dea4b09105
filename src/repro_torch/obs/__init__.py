"""Observability: tracing (Perfetto export), the unified metrics registry,
and kernel profiling hooks — the port's copy of ``repro/obs``."""
from repro_torch.obs.metrics import (Counter, CounterDict, Gauge, Histogram,
                                     LazyCounterGroup, MetricsRegistry)
from repro_torch.obs.profile import (KernelProfiler, active,
                                     disable_profiling, enable_profiling)
from repro_torch.obs.trace import (NULL_TRACER, PID_ENGINE, PID_REQUESTS,
                                   NullTracer, Tracer)
from repro_torch.obs.views import (EMPTY_DIGEST_STATS, digest_block,
                                   ladder_block, org_stats)

__all__ = [
    "Counter", "CounterDict", "Gauge", "Histogram", "LazyCounterGroup",
    "MetricsRegistry",
    "KernelProfiler", "active", "disable_profiling", "enable_profiling",
    "NULL_TRACER", "PID_ENGINE", "PID_REQUESTS", "NullTracer", "Tracer",
    "EMPTY_DIGEST_STATS", "digest_block", "ladder_block", "org_stats",
]
