"""Workload adaptation — drift-aware catapult maintenance.

Port of ``repro/adapt/``: the bucket layer's LRU publishes give passive
adaptation; this package adds the active maintenance loop.

* :mod:`repro_torch.adapt.stats` — streaming per-bucket telemetry as a
  frozen dataclass of tensors (EWMA win-rate, exponential-decay bucket
  histograms, drift score),
* :mod:`repro_torch.adapt.policy` — TTL eviction, drift-triggered region
  flush, and the utility gate that disables catapult lookup when it
  stops paying off,
* :mod:`repro_torch.adapt.maintainer` — the host-side maintenance tick,
  per frontend flush or on a background thread.
"""
from repro_torch.adapt.maintainer import CatapultMaintainer
from repro_torch.adapt.policy import PolicyConfig
from repro_torch.adapt.stats import (TelemetryState, drift_score, hop_saving,
                                     init_telemetry, observe_update,
                                     telemetry_from_arrays,
                                     telemetry_to_arrays, update_telemetry)

__all__ = [
    "CatapultMaintainer", "PolicyConfig", "TelemetryState", "drift_score",
    "hop_saving", "init_telemetry", "observe_update",
    "telemetry_from_arrays", "telemetry_to_arrays", "update_telemetry",
]
