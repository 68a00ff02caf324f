"""Serve-level rolling window: QPS, batch occupancy, flush latency.

A copy of ``repro/obs/window.py`` (pure Python; the port imports
nothing of the reference package).

The ``VectorSearchFrontend`` records one entry per ``flush()`` (or bulk
``search()``) into a bounded deque; ``snapshot()`` reads out the
serving-health numbers the ROADMAP's perf work gates on — rolling QPS,
mean batch occupancy (how full the fixed-shape dispatches run), and
flush latency percentiles.  Recording is one deque append per flush —
cheap enough to stay always-on; the registry-facing export goes through
``as_collector`` so ``db.metrics()`` picks the window up without the
frontend pushing anything per-flush.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np


class RollingWindow:
    """Bounded per-flush serving telemetry."""

    def __init__(self, limit: int = 256):
        if limit < 1:
            raise ValueError(f"window limit must be >= 1, got {limit}")
        self.limit = limit
        # entries: (t_end, n_queries, occupancy, flush_ms)
        self._entries: deque = deque(maxlen=limit)
        self.total_flushes = 0
        self.total_queries = 0

    def record_flush(self, *, queries: int, occupancy: float,
                     ms: float, t_end: float | None = None) -> None:
        """One serviced flush: ``queries`` real lanes dispatched,
        ``occupancy`` = mean(real lanes / max_batch) over its chunks,
        ``ms`` wall time of the whole flush."""
        self._entries.append((t_end if t_end is not None
                              else time.perf_counter(),
                              int(queries), float(occupancy), float(ms)))
        self.total_flushes += 1
        self.total_queries += int(queries)

    def snapshot(self) -> dict:
        """Rolling readout over the retained window (all-zero if empty)."""
        if not self._entries:
            return {"flushes": 0, "queries": 0, "qps": 0.0,
                    "batch_occupancy": 0.0, "flush_p50_ms": 0.0,
                    "flush_p95_ms": 0.0, "flush_p99_ms": 0.0,
                    "flush_mean_ms": 0.0}
        entries = list(self._entries)
        times = np.array([e[0] for e in entries])
        queries = np.array([e[1] for e in entries])
        occ = np.array([e[2] for e in entries])
        ms = np.array([e[3] for e in entries])
        # window span: first flush's own duration anchors the single-
        # flush case (QPS = queries / that flush's wall time)
        span_s = float(times[-1] - times[0]) + float(ms[0]) / 1e3
        return {
            "flushes": len(entries),
            "queries": int(queries.sum()),
            "qps": float(queries.sum() / span_s) if span_s > 0 else 0.0,
            "batch_occupancy": float(occ.mean()),
            "flush_p50_ms": float(np.percentile(ms, 50)),
            "flush_p95_ms": float(np.percentile(ms, 95)),
            "flush_p99_ms": float(np.percentile(ms, 99)),
            "flush_mean_ms": float(ms.mean()),
        }

    def as_collector(self, prefix: str = "catapultdb_serve_"):
        """A ``MetricsRegistry.register_collector`` adapter."""
        def collect() -> dict:
            return {prefix + k: float(v) for k, v in
                    self.snapshot().items()}
        return collect
