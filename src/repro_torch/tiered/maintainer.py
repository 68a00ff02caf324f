"""TieredMaintainer — one tick for catapults AND memory residence.

Port of ``repro/tiered/maintainer.py``.  The decayed bucket histograms
that aim catapults also decide which rows deserve RAM, so
``TieredMaintainer`` is a ``CatapultMaintainer``: the tiered engine's
``shards`` property hands the base class the cold units (every shard of
a sharded cold tier), so observe/fold, TTL eviction, drift flushes and
the utility gate run unchanged over the cold tier.  The subclass adds
one step to the tick, ``TieredVectorSearchEngine.rebalance()``, after
the base maintenance, so a drift flush that just evicted a shifted
region's stale shortcuts also keeps their destinations out of the
promotion candidates.
"""
from __future__ import annotations

from repro_torch.adapt import policy as pol
from repro_torch.adapt.maintainer import CatapultMaintainer


class TieredMaintainer(CatapultMaintainer):
    """Catapult maintenance + hot/cold rebalancing in one tick."""

    def __init__(self, engine, policy: pol.PolicyConfig | None = None,
                 tick_every: int = 32, **kwargs):
        if not hasattr(engine, "rebalance"):
            raise ValueError("TieredMaintainer wraps a tiered engine "
                             "(needs .rebalance()); got "
                             f"{type(engine).__name__}")
        super().__init__(engine, policy=policy, tick_every=tick_every,
                         **kwargs)
        self.tiered = engine

    def _tick_locked(self) -> None:
        super()._tick_locked()
        self.tiered.rebalance()
        # the base tick already appended its snapshot; refresh it so the
        # history row carries this tick's residency
        if self.history:
            self.history[-1] = self.snapshot()

    def snapshot(self) -> dict:
        """Base telemetry + tier residency, one flat dict."""
        snap = super().snapshot()
        snap.update(self.tiered.tier_stats())
        return snap
