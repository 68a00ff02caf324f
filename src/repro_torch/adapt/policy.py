"""Maintenance policy — what to do about what the telemetry says.

Port of ``repro/adapt/policy.py``: three decision/action primitives
over ``BucketState`` + ``TelemetryState``, composed by the maintainer.

* **TTL eviction** (:func:`ttl_evict`) — entries older than
  ``ttl_steps`` publish events are cleared (the LRU only recycles an
  entry when its bucket receives new traffic; an abandoned bucket keeps
  its shortcuts forever otherwise).
* **Drift flush** (:func:`drift_flush`) — when the drift score crosses
  its threshold, bucket rows whose traffic share moved materially
  (either direction) are flushed wholesale.
* **Utility gate** (:func:`gate_decision`) — hysteresis on the
  *measured hop saving*: below ``gate_low`` catapult lookup is gated
  off (the engine dispatches the plain diskann path), above
  ``gate_high`` a probe re-admits it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.adapt import stats as ts
from repro_torch.core import buckets as bk


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Knobs of the adapt layer; the reference's fields and defaults
    (sized for batch≈128-256 serving)."""
    # telemetry decay rates (forwarded to stats.update_telemetry)
    win_alpha: float = ts.WIN_ALPHA
    fast_decay: float = ts.FAST_DECAY
    slow_decay: float = ts.SLOW_DECAY
    # TTL eviction: max entry age in publish events; <= 0 disables.
    # 4096 ≈ the volume that fully re-publishes a b=40, L=8 table twice.
    ttl_steps: int = 4096
    # drift flush: trigger above this TV distance; flush buckets whose
    # share of total traffic moved by more than region_threshold
    # (absolute probability mass, either direction)
    drift_threshold: float = 0.35
    region_threshold: float = 0.005
    # telemetry sampling: fold every Nth enabled batch (probe/shadow
    # batches always fold)
    observe_every: int = 2
    # utility gate: hysteresis on measured hop saving, with the shadow
    # cadence that keeps the diskann baseline EWMA honest while enabled
    # and the probe cadence that re-tests catapults while disabled
    gate_low: float = 0.04
    gate_high: float = 0.08
    baseline_every: int = 48
    probe_every: int = 16
    min_batches: int = 8          # catapult-side evidence floor
    min_base: int = 2             # shadow-side evidence floor
    # cache re-pinning: destinations of the top-N hot buckets
    repin_buckets: int = 8


def ttl_evict(buckets: bk.BucketState, ttl_steps: int
              ) -> tuple[bk.BucketState, int]:
    """Clear entries older than ``ttl_steps`` on the publish clock;
    returns (new state, number of entries cleared).  One eviction step
    and one host sync (the count) — this runs on every tick."""
    if ttl_steps <= 0:
        return buckets, 0
    out = bk.evict_stale(buckets, ttl_steps)
    n = (buckets.ids >= 0).sum() - (out.ids >= 0).sum()
    return out, int(n)


def drift_regions(tel: ts.TelemetryState, region_threshold: float
                  ) -> np.ndarray:
    """(n_buckets,) bool — buckets whose probability mass moved by more
    than ``region_threshold`` between the long-run and recent-window
    distributions."""
    recent = tel.recent.cpu().numpy().astype(np.float64)
    longrun = tel.longrun.cpu().numpy().astype(np.float64)
    rm, lm = recent.sum(), longrun.sum()
    if rm <= 0 or lm <= 0:
        return np.zeros(recent.size, bool)
    return np.abs(recent / rm - longrun / lm) > region_threshold


def drift_flush(buckets: bk.BucketState, tel: ts.TelemetryState,
                cfg: PolicyConfig) -> tuple[bk.BucketState, int, bool]:
    """Flush shifted-region bucket rows when drift crosses the
    threshold; returns (new state, entries flushed, triggered)."""
    score = float(ts.drift_score(tel))
    if score <= cfg.drift_threshold:
        return buckets, 0, False
    mask = drift_regions(tel, cfg.region_threshold)
    if not mask.any():
        return buckets, 0, False
    before = int((buckets.ids >= 0).sum())
    out = bk.evict_buckets(buckets, mask)
    return out, before - int((out.ids >= 0).sum()), True


def gate_decision(saving: float | None, enabled: bool, cfg: PolicyConfig,
                  n_batches: int, n_base: int) -> bool:
    """Hysteresis gate on measured hop saving.  Returns the new enabled
    flag; never moves without evidence on both sides of the ratio."""
    if saving is None:
        return enabled
    if enabled:
        if (n_batches >= cfg.min_batches and n_base >= cfg.min_base
                and saving < cfg.gate_low):
            return False
        return True
    return saving > cfg.gate_high


def hot_destinations(buckets: bk.BucketState, tel: ts.TelemetryState,
                     top: int) -> np.ndarray:
    """Live destination ids published in the ``top`` hottest buckets —
    the blocks a disk tier should keep warm after maintenance reshapes
    the table."""
    rows = ts.hot_buckets(tel, top)
    if rows.size == 0:
        return np.empty(0, np.int64)
    ids = buckets.ids.cpu().numpy()[rows].ravel()
    return np.unique(ids[ids >= 0]).astype(np.int64)
