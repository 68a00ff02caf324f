"""Streaming catapult telemetry — the adapt layer's measurement substrate.

Port of ``repro/adapt/stats.py``.  One ``TelemetryState`` per catapult
engine: a frozen dataclass of tensors on the engine's device, scalars
as 0-d tensors and the two histograms as ``(n_buckets,)`` float32.
Folding in a batch (:func:`observe_update`) is one ``lsh_hash`` launch
(the CUDA kernel on the card) plus a handful of elementwise ops on
``(B,)`` and ``(n_buckets,)`` tensors, with no host sync.

Signals (see the reference for the full story):

* **EWMA win/use-rate** — per-batch fraction of real lanes whose bucket
  supplied a destination (``used``) / whose best start was a shortcut
  (``won``).
* **EWMA hops, two-sided** — ``hops_ewma`` over catapult batches and
  ``base_hops_ewma`` over the maintainer's shadow (diskann) batches;
  their ratio is the measured hop saving the utility gate thresholds.
* **Decay histograms** — ``recent`` (fast decay) and ``longrun`` (slow
  decay) over bucket hash ids.
* **Drift score** — total-variation distance between the two
  histograms normalized to distributions.

The arithmetic is the reference's float32 arithmetic: every constant
enters as a float32 tensor before it meets a state tensor
(``1 - float32(alpha)``, not ``float32(1 - alpha)``), and XLA contracts
each update, ``(1 - a) * old + a * new`` and ``(1 - d) * hist +
counts``, into one fused multiply-add that rounds once.  :func:`_fma`
computes that in float64, where the product of two float32 is exact,
and rounds once to float32, so each EWMA and histogram update equals
the reference's (the double rounding differs only when a float64 sum
lands exactly on a float32 midpoint).  Only :func:`drift_score` sums in
another order than XLA (256 terms).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import lsh as lsh_mod
from repro_torch.device import resolve_device

# default EWMA / decay constants; PolicyConfig carries the tunables
WIN_ALPHA = 0.1      # win/use/hops EWMA step
FAST_DECAY = 0.25    # per-batch decay of the recent-window histogram
SLOW_DECAY = 0.02    # per-batch decay of the long-run histogram


@dataclasses.dataclass(frozen=True)
class TelemetryState:
    win_ewma: torch.Tensor       # () f32 EWMA of per-batch catapult win-rate
    use_ewma: torch.Tensor       # () f32 EWMA of per-batch catapult use-rate
    hops_ewma: torch.Tensor      # () f32 EWMA of mean hops, catapult batches
    base_hops_ewma: torch.Tensor  # () f32 EWMA of mean hops, shadow batches
    recent: torch.Tensor         # (n_buckets,) f32 fast-decay histogram
    longrun: torch.Tensor        # (n_buckets,) f32 slow-decay histogram
    n_batches: torch.Tensor      # () i32 catapult batches folded in
    n_base: torch.Tensor         # () i32 shadow (diskann) batches folded in
    n_queries: torch.Tensor      # () i32 real query lanes folded in

    @property
    def n_buckets(self) -> int:
        return self.recent.shape[0]

    @property
    def device(self) -> torch.device:
        return self.recent.device


def init_telemetry(n_buckets: int, device="cuda") -> TelemetryState:
    device = resolve_device(device)

    def scalar(dtype):
        return torch.zeros((), dtype=dtype, device=device)
    return TelemetryState(
        win_ewma=scalar(torch.float32), use_ewma=scalar(torch.float32),
        hops_ewma=scalar(torch.float32), base_hops_ewma=scalar(torch.float32),
        recent=torch.zeros(n_buckets, dtype=torch.float32, device=device),
        longrun=torch.zeros(n_buckets, dtype=torch.float32, device=device),
        n_batches=scalar(torch.int32), n_base=scalar(torch.int32),
        n_queries=scalar(torch.int32))


def _f32(x: float, device: torch.device) -> torch.Tensor:
    """float32(x) on ``device``, filled there: no host-to-card copy (a
    blocking copy would sync the stream)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once, as a fused multiply-add."""
    return (x.double() * y.double() + z.double()).float()


def _ewma(old, new, alpha, first, active):
    stepped = torch.where(first, new, _fma(1 - alpha, old, alpha * new))
    return torch.where(active, stepped, old)


def _update(state: TelemetryState, hashes, used, won, hops, real,
            baseline, win_alpha, fast_decay, slow_decay) -> TelemetryState:
    dev = state.device
    hashes, used, won, hops, real = (
        torch.as_tensor(x, device=dev) for x in (hashes, used, won, hops,
                                                 real))
    real = real.to(torch.bool)
    used, won = used.to(torch.bool), won.to(torch.bool)
    n_real = real.sum(dtype=torch.int32)
    active = n_real > 0
    denom = n_real.clamp(min=1).to(torch.float32)
    win_rate = (won & real).sum().to(torch.float32) / denom
    use_rate = (used & real).sum().to(torch.float32) / denom
    mean_hops = torch.where(real, hops, 0).sum().to(torch.float32) / denom
    a = _f32(win_alpha, dev)

    # traffic histograms update on every observed batch — shadow batches
    # are real traffic too, and drift detection must not pause for them.
    # The counts are small integers, so index_add_ is exact in any order.
    counts = torch.zeros_like(state.recent).index_add_(
        0, hashes.long(), real.to(torch.float32))
    recent = _fma(1 - _f32(fast_decay, dev), state.recent, counts)
    longrun = _fma(1 - _f32(slow_decay, dev), state.longrun, counts)
    n_queries = state.n_queries + n_real

    if baseline:
        base = _ewma(state.base_hops_ewma, mean_hops, a, state.n_base == 0,
                     active)
        return dataclasses.replace(
            state, base_hops_ewma=base, recent=recent, longrun=longrun,
            n_base=state.n_base + active.to(torch.int32),
            n_queries=n_queries)

    first = state.n_batches == 0
    return dataclasses.replace(
        state,
        win_ewma=_ewma(state.win_ewma, win_rate, a, first, active),
        use_ewma=_ewma(state.use_ewma, use_rate, a, first, active),
        hops_ewma=_ewma(state.hops_ewma, mean_hops, a, first, active),
        recent=recent, longrun=longrun,
        n_batches=state.n_batches + active.to(torch.int32),
        n_queries=n_queries)


def update_telemetry(state: TelemetryState, hashes, used, won, hops, real,
                     *, baseline: bool = False,
                     win_alpha: float = WIN_ALPHA,
                     fast_decay: float = FAST_DECAY,
                     slow_decay: float = SLOW_DECAY) -> TelemetryState:
    """Fold one observed batch into the telemetry (pre-hashed variant).

    ``hashes`` (B,) int bucket ids, ``used``/``won``/``real`` (B,) bool,
    ``hops`` (B,) node expansions; tensors on the state's device (arrays
    are copied there, which syncs the card).  Only ``real`` lanes count (the frontend's padded
    lanes repeat a real query).  ``baseline=True`` marks a shadow batch:
    it feeds ``base_hops_ewma`` and the histograms, never the win/use
    signals.  The first batch on each side seeds its EWMAs directly.
    """
    return _update(state, hashes, used, won, hops, real, baseline,
                   win_alpha, fast_decay, slow_decay)


def observe_update(state: TelemetryState, lsh: lsh_mod.LSHParams,
                   queries: torch.Tensor, used, won, hops, real, *,
                   baseline: bool = False,
                   win_alpha: float = WIN_ALPHA,
                   fast_decay: float = FAST_DECAY,
                   slow_decay: float = SLOW_DECAY) -> TelemetryState:
    """The serving path's step: hash the (B, d) float32 ``queries`` (one
    ``lsh_hash`` launch on the card) and fold the batch in."""
    hashes = lsh_mod.hash_codes(lsh, queries)
    return _update(state, hashes, used, won, hops, real, baseline,
                   win_alpha, fast_decay, slow_decay)


def drift_score(state: TelemetryState) -> torch.Tensor:
    """Total-variation distance between the recent-window and long-run
    bucket distributions, a 0-d float32 tensor in [0, 1]; 0 while either
    histogram is still empty (no evidence is not drift)."""
    rm, lm = state.recent.sum(), state.longrun.sum()
    p = state.recent / rm.clamp(min=1e-9)
    q = state.longrun / lm.clamp(min=1e-9)
    tv = 0.5 * (p - q).abs().sum()
    return torch.where((rm > 0) & (lm > 0), tv, torch.zeros_like(tv))


def hop_saving(state: TelemetryState) -> float | None:
    """Measured fractional hop saving of catapult dispatch over the
    shadow diskann baseline — the utility gate's signal.  None until
    both sides have evidence.  Reads device scalars (host syncs): call
    it on ticks and probe verdicts, not per batch."""
    if int(state.n_batches) == 0 or int(state.n_base) == 0:
        return None
    base = float(state.base_hops_ewma)
    if base <= 0:
        return None
    return 1.0 - float(state.hops_ewma) / base


def hot_buckets(state: TelemetryState, top: int) -> np.ndarray:
    """Indices of the ``top`` buckets by recent traffic mass (host-side
    helper for the maintainer's cache re-pinning)."""
    recent = state.recent.cpu().numpy()
    top = min(int(top), recent.size)
    idx = np.argpartition(recent, -top)[-top:]
    return idx[recent[idx] > 0]


# ------------------------------------------------------------------ persist
# field-name -> ndarray, the reference's npz schema: float32 and int32
# arrays in, the same bytes out, across packages.

def telemetry_to_arrays(state: TelemetryState,
                        prefix: str = "adapt_") -> dict[str, np.ndarray]:
    return {prefix + f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(TelemetryState)}


def telemetry_from_arrays(arrays, prefix: str = "adapt_", device="cuda"
                          ) -> TelemetryState | None:
    """Rebuild a state on ``device`` from ``telemetry_to_arrays`` output
    (either package's); None when the snapshot lacks adapt keys."""
    names = [f.name for f in dataclasses.fields(TelemetryState)]
    if not all(prefix + n in arrays for n in names):
        return None
    device = resolve_device(device)
    return TelemetryState(**{n: torch.tensor(np.asarray(arrays[prefix + n]),
                                             device=device)
                             for n in names})
