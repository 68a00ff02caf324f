"""repro_torch.obs — metrics, traces, the serving window, profiling.

Copies of the reference's pure-Python ``repro.obs.metrics``,
``repro.obs.trace`` and ``repro.obs.window``; ``profiler`` is the
counterpart of ``repro.obs.profiler`` over ``torch.profiler``.
"""
from repro_torch.obs.metrics import (DEFAULT_MS_EDGES, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     NULL_INSTRUMENT)
from repro_torch.obs.profiler import (annotate, enable_profiling,
                                      profile_trace, profiling_enabled)
from repro_torch.obs.trace import (STAGES, SearchTrace, Span, TraceRecorder,
                                   build_search_trace)
from repro_torch.obs.window import RollingWindow

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_INSTRUMENT",
    "DEFAULT_MS_EDGES", "RollingWindow", "STAGES", "SearchTrace", "Span",
    "TraceRecorder", "build_search_trace", "annotate", "enable_profiling",
    "profile_trace", "profiling_enabled",
]
