"""repro_torch.obs — metrics registry and per-query explain traces.

Copies of the reference's pure-Python ``repro.obs.metrics`` and
``repro.obs.trace``.  The rolling serving window and the profiler hooks
come with the serving frontend (ROADMAP queue 1, items 6-7).
"""
from repro_torch.obs.metrics import (DEFAULT_MS_EDGES, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     NULL_INSTRUMENT)
from repro_torch.obs.trace import (STAGES, SearchTrace, Span, TraceRecorder,
                                   build_search_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_INSTRUMENT",
    "DEFAULT_MS_EDGES", "STAGES", "SearchTrace", "Span", "TraceRecorder",
    "build_search_trace",
]
