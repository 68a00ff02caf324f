"""Lightweight metrics registry — counters, gauges, latency histograms.

A copy of ``repro/obs/metrics.py`` (pure Python; the port imports
nothing of the reference package).

The serving path's claims (2.51x throughput at equal recall, fewer I/O
hops, graceful drift recovery) are runtime properties; this registry is
where the runtime publishes the numbers that back them.  Design
constraints, in order:

1. **Near-zero overhead when disabled.**  A registry constructed with
   ``enabled=False`` hands every caller the same shared no-op
   instrument (``NULL_INSTRUMENT``) and allocates nothing — no dict
   entries, no per-call branches beyond one attribute check the caller
   already does.
2. **Hot-path instruments are pre-resolved.**  ``counter()`` /
   ``gauge()`` / ``histogram()`` are called once at wiring time and the
   returned instrument is cached by the caller (see
   ``Database.__init__``); the per-event cost is one float add or one
   ``bisect`` into a fixed edge tuple.
3. **Pull for component state, push for events.**  Components that
   already keep counters (the CLOCK ``NodeCache``, the
   ``CatapultMaintainer``, the frontend's rolling window) register a
   *collector* — a zero-arg callable returning ``{name: float}`` —
   that the registry polls at snapshot time, so their hot paths stay
   untouched.

Exporters: ``snapshot()`` (plain dict — ``db.metrics()``'s shape),
``to_json()``, and ``to_prometheus()`` (text exposition format, one
``# TYPE`` line per metric, histogram ``_bucket``/``_sum``/``_count``
series with cumulative ``le`` labels).

Metric naming convention (see docs/OBSERVABILITY.md for the full
catalogue): ``catapultdb_<component>_<what>[_<unit>]``, snake_case,
Prometheus-legal as written — no sanitization pass at export time.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_left
from typing import Callable, Optional

# Fixed default edges for latency histograms, in milliseconds.  Spanning
# sub-ms jit dispatch up to multi-second cold compiles; the overflow
# bucket (+Inf) is implicit.
DEFAULT_MS_EDGES = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)


class Counter:
    """Monotonic float counter."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins float value."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with percentile readout.

    ``edges`` are the bucket *upper* bounds; an implicit overflow bucket
    catches everything above ``edges[-1]``.  ``percentile(q)`` linearly
    interpolates within the bucket where the cumulative count crosses
    ``q`` (the standard fixed-bucket estimate: exact at bucket
    boundaries, never off by more than one bucket width inside) and
    returns ``edges[-1]`` for observations that landed in the overflow.
    """
    __slots__ = ("name", "edges", "counts", "count", "sum")

    def __init__(self, name: str, edges=DEFAULT_MS_EDGES):
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"histogram edges must be sorted, non-empty: "
                             f"{edges!r}")
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        # bisect_left: an observation equal to an edge counts INSIDE
        # that bucket (Prometheus's inclusive ``le`` convention)
        self.counts[bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v

    def percentile(self, q: float) -> float:
        """Estimated value at quantile ``q`` in [0, 1] (0.0 if empty)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo_cum = cum
            cum += c
            if cum >= target:
                if i >= len(self.edges):        # overflow bucket
                    return self.edges[-1]
                lo = 0.0 if i == 0 else self.edges[i - 1]
                hi = self.edges[i]
                frac = (target - lo_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.edges[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class _NullInstrument:
    """The disabled registry's universal instrument: every mutator is a
    no-op, every readout is zero.  One shared instance, zero allocation
    per call site."""
    __slots__ = ()
    name = "<disabled>"
    value = 0.0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0


NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Named instruments + pull collectors, with snapshot/export."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._collectors: list[Callable[[], dict]] = []

    # ------------------------------------------------------------ instruments
    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_INSTRUMENT
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_INSTRUMENT
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str, edges=DEFAULT_MS_EDGES) -> Histogram:
        if not self.enabled:
            return NULL_INSTRUMENT
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, edges)
            return self._histograms[name]

    def register_collector(self, fn: Callable[[], dict]) -> None:
        """``fn() -> {name: float}``, polled at snapshot time — the
        pull path for components that keep their own counters (node
        cache, maintainer, rolling window).  No-op when disabled."""
        if not self.enabled:
            return
        with self._lock:
            self._collectors.append(fn)

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        """One plain dict: counters/gauges/collector values map to
        floats; histograms map to ``{count, sum, mean, p50, p95, p99}``.
        Disabled registries return ``{}``."""
        if not self.enabled:
            return {}
        out: dict = {}
        with self._lock:
            for name, c in self._counters.items():
                out[name] = c.value
            for name, g in self._gauges.items():
                out[name] = g.value
            for name, h in self._histograms.items():
                out[name] = {"count": h.count, "sum": h.sum, "mean": h.mean,
                             "p50": h.percentile(0.50),
                             "p95": h.percentile(0.95),
                             "p99": h.percentile(0.99)}
            collectors = list(self._collectors)
        for fn in collectors:
            for name, v in fn().items():
                out[name] = float(v)
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (scrapeable as-is)."""
        lines: list[str] = []
        if not self.enabled:
            return ""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
            collectors = list(self._collectors)
        for c in counters:
            lines.append(f"# TYPE {c.name} counter")
            lines.append(f"{c.name} {c.value:g}")
        for g in gauges:
            lines.append(f"# TYPE {g.name} gauge")
            lines.append(f"{g.name} {g.value:g}")
        for fn in collectors:
            for name, v in fn().items():
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {float(v):g}")
        for h in hists:
            lines.append(f"# TYPE {h.name} histogram")
            cum = 0
            for edge, c in zip(h.edges, h.counts):
                cum += c
                lines.append(f'{h.name}_bucket{{le="{edge:g}"}} {cum}')
            lines.append(f'{h.name}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{h.name}_sum {h.sum:g}")
            lines.append(f"{h.name}_count {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")
