"""CatapultMaintainer — the host-side maintenance loop.

Port of ``repro/adapt/maintainer.py``, line for line in behaviour, over
the port's RAM-tier engine (the disk and sharded tiers slot in through
the same ``shards``/``_cache`` hooks when they are ported).  The
serving loop calls :meth:`observe` after every dispatched batch; every
``tick_every`` observed batches (or on a background thread,
:meth:`start`) the maintainer runs one maintenance tick:

1. TTL-evict entries older than the policy's publish-clock budget,
2. drift-flush shifted bucket regions when the drift score trips, then
   fold the recent window into the long-run histogram so one shift
   triggers one flush,
3. apply the utility gate on *measured hop saving*: while catapults are
   enabled, every ``baseline_every`` batches runs through the plain
   diskann dispatch as a shadow baseline; saving below ``gate_low``
   gates catapult lookup off engine-side.  While gated off, every
   ``probe_every`` batches runs WITH catapults as a probe; ``gate_high``
   re-admits.  A gated-off batch costs one counter increment,
4. re-pin a disk tier's cache around the surviving hot destinations (a
   no-op on the RAM tier, which has no cache),
5. snapshot telemetry into a bounded history.

Host syncs: a batch's fold syncs nothing (the telemetry stays on the
engine's device); the device scalars are read on ticks, probe verdicts
and snapshots only.

Threading: a tick swaps each unit's bucket state by attribute
assignment (atomic under the GIL).  A background tick issues its torch
ops from a second thread on the same device; with no stream set, both
threads enqueue onto the device's default stream, so the card runs the
tick's ops and a search's ops in enqueue order, never at once, and the
caching allocator is thread-safe.  What can race is the table itself: a
search reads the pre-tick table and assigns its published copy back, so
either the tick's evictions or that batch's publishes are lost.  The
reference accepts the same race: maintenance is advisory, never
load-bearing for correctness (a lost TTL eviction is redone by the next
tick).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.adapt import policy as pol
from repro_torch.adapt import stats as ts

HISTORY_LIMIT = 1024


class CatapultMaintainer:
    """Drift-aware maintenance over one catapult engine."""

    def __init__(self, engine, policy: pol.PolicyConfig | None = None,
                 tick_every: int = 32,
                 consolidate_threshold: float = 0.0,
                 mutate_lock=None):
        if getattr(engine, "mode", None) != "catapult":
            raise ValueError(
                f"maintainer needs a catapult-mode engine, got "
                f"{getattr(engine, 'mode', None)!r}")
        self.engine = engine
        self.policy = policy or pol.PolicyConfig()
        self.tick_every = tick_every
        # > 0: each tick checks the tombstone fraction and runs a
        # background consolidate() when it crosses the threshold
        # (serialized against the facade's mutations via mutate_lock)
        self.consolidate_threshold = float(consolidate_threshold)
        self.mutate_lock = mutate_lock
        self.consolidations = 0
        # a sharded engine's shards are its units; single engines are
        # their own
        self._units = list(getattr(engine, "shards", None) or [engine])
        for unit in self._units:
            if unit.adapt_state is None:
                n_buckets = unit._cat.buckets.ids.shape[0]
                unit.adapt_state = ts.init_telemetry(n_buckets, unit.device)
        # resume the gate where the engine left it
        self._gate_on = all(u.catapult_enabled for u in self._units)
        self._probing = False     # gated-off probe batch in flight
        self._shadow = False      # enabled-state baseline batch in flight
        self._off_batches = 0
        self._since_shadow = 0
        self._since_tick = 0
        self._obs_count = 0
        self._lock = threading.RLock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # counters for benches / snapshots
        self.ttl_evicted = 0
        self.flushed_entries = 0
        self.drift_flushes = 0
        self.gate_transitions = 0
        self.probes = 0
        self.shadows = 0
        self.ticks = 0
        self.history: list[dict] = []

    # ---------------------------------------------------------------- signals
    @property
    def win_rate(self) -> float:
        return float(np.mean([float(u.adapt_state.win_ewma)
                              for u in self._units]))

    @property
    def drift(self) -> float:
        return float(max(float(ts.drift_score(u.adapt_state))
                         for u in self._units))

    @property
    def hop_saving(self) -> float | None:
        """Measured fractional hop saving vs the shadow diskann
        baseline; None until both EWMAs have evidence."""
        vals = [ts.hop_saving(u.adapt_state) for u in self._units]
        vals = [v for v in vals if v is not None]
        return float(np.mean(vals)) if vals else None

    @property
    def catapult_enabled(self) -> bool:
        return self._gate_on

    def _set_engines(self, flag: bool) -> None:
        """Persist a GATE verdict on every unit."""
        for unit in self._units:
            unit.catapult_enabled = flag

    def _set_override(self, flag: bool | None) -> None:
        """Arm/clear the one-batch shadow/probe dispatch override —
        transient by design, so a persisted engine never records a
        spuriously gated-off state."""
        for unit in self._units:
            unit.catapult_override = flag

    # ---------------------------------------------------------------- observe
    def observe(self, queries: np.ndarray, stats,
                real_mask: np.ndarray | None = None) -> None:
        """Fold one dispatched batch into the telemetry.

        ``queries``: the (B, d) batch as dispatched; ``stats``: the
        ``SearchStats`` the search returned; ``real_mask``: (B,) bool,
        False on padded lanes (None = all real).
        """
        with self._lock:
            if not self._gate_on and not self._probing and not self._shadow:
                # gated off: one counter, occasionally arm a probe
                self._off_batches += 1
                if (self.policy.probe_every > 0
                        and self._off_batches >= self.policy.probe_every):
                    self._off_batches = 0
                    self._probing = True
                    self.probes += 1
                    self._set_override(True)
                return
            cfg = self.policy
            if self._shadow or self._probing:
                sample = True          # the scarce side always folds
            else:
                self._obs_count += 1
                sample = (cfg.observe_every <= 1
                          or self._obs_count % cfg.observe_every == 0)
            if sample:
                self._fold(queries, stats, real_mask,
                           baseline=self._shadow)
            if self._shadow:
                # shadow verdict is the tick's job; just restore dispatch
                self._shadow = False
                self._set_override(None)
                return
            if self._probing:
                # verdict on the probe batch: readmit or stay dark
                self._probing = False
                self._set_override(None)
                if pol.gate_decision(self.hop_saving, False, cfg,
                                     *self._evidence()):
                    self._gate_on = True
                    self.gate_transitions += 1
                    self._set_engines(True)
                return
            if (cfg.baseline_every > 0 and self._gate_on):
                self._since_shadow += 1
                if self._since_shadow >= cfg.baseline_every:
                    # arm a shadow: the NEXT batch dispatches diskann
                    self._since_shadow = 0
                    self._shadow = True
                    self.shadows += 1
                    self._set_override(False)
            self._since_tick += 1
            if self.tick_every and self._since_tick >= self.tick_every:
                self._since_tick = 0
                self._tick_locked()

    def _fold(self, queries, stats, real_mask, baseline: bool) -> None:
        b = int(np.shape(queries)[0])
        real = (np.ones(b, bool) if real_mask is None
                else np.asarray(real_mask, bool))
        cfg = self.policy
        for unit in self._units:
            dev = unit.device

            def up(a, dtype):
                # from pageable host memory the CUDA runtime stages the bytes
                # before returning, so non_blocking skips only the
                # stream sync a blocking copy would add to every fold
                return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                    dev, non_blocking=True)
            unit.adapt_state = ts.observe_update(
                unit.adapt_state, unit._cat.lsh, up(queries, np.float32),
                up(stats.used, bool), up(stats.won, bool),
                up(stats.hops, np.float32), up(real, bool),
                baseline=baseline, win_alpha=cfg.win_alpha,
                fast_decay=cfg.fast_decay, slow_decay=cfg.slow_decay)

    def _evidence(self) -> tuple[int, int]:
        return (min(int(u.adapt_state.n_batches) for u in self._units),
                min(int(u.adapt_state.n_base) for u in self._units))

    # ---------------------------------------------------------------- tick
    def tick(self) -> None:
        """Run one maintenance pass now (the background thread's body;
        also callable directly, e.g. after a bulk load)."""
        with self._lock:
            self._tick_locked()

    def _tick_locked(self) -> None:
        cfg = self.policy
        self.ticks += 1
        for unit in self._units:
            tel = unit.adapt_state
            buckets = unit._cat.buckets
            buckets, n_ttl = pol.ttl_evict(buckets, cfg.ttl_steps)
            buckets, n_flush, triggered = pol.drift_flush(buckets, tel, cfg)
            self.ttl_evicted += n_ttl
            self.flushed_entries += n_flush
            if triggered:
                self.drift_flushes += 1
                # accept the new regime: realign the long-run histogram
                # with the recent window (mass preserved) so the same
                # shift doesn't re-trigger on every subsequent tick
                recent = tel.recent.cpu().numpy().astype(np.float64)
                rm = recent.sum()
                lm = float(tel.longrun.cpu().numpy().sum())
                if rm > 0:
                    unit.adapt_state = dataclasses.replace(
                        tel, longrun=torch.as_tensor(
                            (recent * (lm / rm)).astype(np.float32),
                            device=tel.device))
            if n_ttl or n_flush:
                unit._cat = dataclasses.replace(unit._cat, buckets=buckets)
            # keep a disk tier warm around the surviving hot set (the
            # RAM tier has no cache)
            cache = getattr(unit, "_cache", None)
            if cache is not None and cfg.repin_buckets > 0:
                dests = pol.hot_destinations(buckets, unit.adapt_state,
                                             cfg.repin_buckets)
                if dests.size:
                    cache.pin_rotating(dests)
        if self._gate_on and not self._probing and not self._shadow:
            if not pol.gate_decision(self.hop_saving, True, cfg,
                                     *self._evidence()):
                self._gate_on = False
                self._off_batches = 0
                self.gate_transitions += 1
                self._set_engines(False)
        self._maybe_consolidate()
        self.history.append(self.snapshot())
        if len(self.history) > HISTORY_LIMIT:
            del self.history[: len(self.history) - HISTORY_LIMIT]

    def _maybe_consolidate(self) -> None:
        if self.consolidate_threshold <= 0.0:
            return
        frac = self._tombstone_fraction()
        if frac < self.consolidate_threshold:
            self._consolidated_at = -1.0
            return
        # an in-place graph splice repairs edges without lowering the
        # fraction; don't re-splice every tick at an unchanged fraction
        # — wait for new deletes to accumulate
        if frac <= getattr(self, "_consolidated_at", -1.0):
            return
        lock = self.mutate_lock
        if lock is not None:
            with lock:
                self.engine.consolidate()
        else:
            self.engine.consolidate()
        self.consolidations += 1
        self._consolidated_at = self._tombstone_fraction()

    def _tombstone_fraction(self) -> float:
        own = getattr(self.engine, "tombstone_fraction", None)
        if own is not None:
            return float(own())
        dead = n = 0
        for unit in self._units:
            na = int(unit.n_active)
            dead += int(unit._tomb_np[:na].sum())
            n += na
        return dead / n if n else 0.0

    # ---------------------------------------------------------------- thread
    def start(self, interval: float = 0.5) -> None:
        """Run ticks on a daemon thread every ``interval`` seconds, so
        maintenance overlaps serving instead of riding the flush
        cadence."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                self.tick()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="catapult-maintainer")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    # ---------------------------------------------------------------- report
    def snapshot(self) -> dict:
        """Point-in-time telemetry for benches and the examples (reads
        device scalars: one host sync each)."""
        saving = self.hop_saving
        return {
            "win_ewma": self.win_rate,
            "use_ewma": float(np.mean([float(u.adapt_state.use_ewma)
                                       for u in self._units])),
            "hops_ewma": float(np.mean([float(u.adapt_state.hops_ewma)
                                        for u in self._units])),
            "base_hops_ewma": float(np.mean(
                [float(u.adapt_state.base_hops_ewma)
                 for u in self._units])),
            "hop_saving": -1.0 if saving is None else saving,
            "drift": self.drift,
            "enabled": bool(self._gate_on),
            "n_queries": int(max(int(u.adapt_state.n_queries)
                                 for u in self._units)),
            "ttl_evicted": self.ttl_evicted,
            "flushed_entries": self.flushed_entries,
            "drift_flushes": self.drift_flushes,
            "gate_transitions": self.gate_transitions,
            "probes": self.probes,
            "shadows": self.shadows,
            "ticks": self.ticks,
            "consolidations": self.consolidations,
        }
