"""Straggler detection + mitigation hooks.

A copy of ``repro/ft/straggler.py`` (the port imports nothing of the
reference).

In a synchronous SPMD step the slowest participant sets the step time, so
mitigation is (a) *detect* persistently slow hosts, (b) *act*: exclude
the host at the next elastic re-mesh (ft/elastic.py) or promote a hot
spare.  On real clusters detection uses per-host step heartbeats; here
the monitor tracks wall-time per step with an EMA + MAD outlier rule —
the same statistics a multi-host deployment feeds from per-host timers.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional


@dataclasses.dataclass
class StragglerPolicy:
    window: int = 32          # steps kept for the baseline statistics
    warmup: int = 5           # ignore compile/first steps
    threshold: float = 3.0    # MAD multiples flagged as straggling
    patience: int = 3         # consecutive flags before action


class StepMonitor:
    def __init__(self, policy: StragglerPolicy | None = None,
                 host_id: int = 0):
        self.policy = policy or StragglerPolicy()
        self.host_id = host_id
        self.times: deque[float] = deque(maxlen=self.policy.window)
        self._t0: Optional[float] = None
        self._seen = 0
        self._flags = 0
        self.actions: list[str] = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.record(time.perf_counter() - self._t0)

    def record(self, dt: float) -> bool:
        """Returns True when this step is flagged as a straggler step."""
        self._seen += 1
        if self._seen <= self.policy.warmup:
            return False
        flagged = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            mad = sorted(abs(t - med) for t in self.times)[len(self.times) // 2]
            if dt > med + self.policy.threshold * max(mad, 1e-6):
                flagged = True
        self.times.append(dt)
        self._flags = self._flags + 1 if flagged else 0
        if self._flags >= self.policy.patience:
            self.actions.append(
                f"host {self.host_id}: {self._flags} consecutive slow steps "
                f"(last {dt:.3f}s) — exclude at next re-mesh / promote spare")
            self._flags = 0
        return flagged

    @property
    def median(self) -> float:
        return sorted(self.times)[len(self.times) // 2] if self.times else 0.0
