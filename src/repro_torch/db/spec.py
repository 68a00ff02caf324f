"""Declarative index specification + request/response types.

Port of ``repro/db/spec.py``.  ``IndexSpec`` keeps the reference's
fields and validation, so one spec reads the same in both packages.
The port serves the RAM tier in every mode (``catapult``, ``diskann``,
``lsh_apg``), at full precision or with PQ traversal (``pq=M``),
filtered (``filters=True``) or not, with the adapt layer
(``adapt=PolicyConfig(...)``, catapult mode) or without; a spec asking
for anything else raises ``CapabilityError`` naming, by title, the
ROADMAP item that will bring it.  ``io``/``ingest``/``tiered`` keep
their places but only take ``None`` for now (their spec types come
with their tiers).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.adapt.policy import PolicyConfig
from repro_torch.core.engine import SearchStats
from repro_torch.core.vamana import VamanaParams

TIERS = ("ram", "disk", "sharded", "tiered")
MODES = ("catapult", "diskann", "lsh_apg")
HOP_BACKENDS = ("unfused", "fused")


class CapabilityError(RuntimeError):
    """Operation not supported by this tier (see ``Database.caps``)."""


class Caps(NamedTuple):
    """What this database can do — probe instead of type-sniffing."""
    tier: str            # 'ram' | 'disk' | 'sharded' | 'tiered'
    mutable: bool        # upsert / delete / consolidate
    filtered: bool       # built with labels: filtered search available
    persistent: bool     # save() / reopen via open()
    sharded: bool        # scatter-gather over >1 shard
    host_views: bool = True  # db.vectors / db.tombstones available


# what the port lacks -> the ROADMAP queue 1 item (by title) that brings it
_NOT_PORTED = {
    "tier": "ROADMAP queue 1, items 'Disk tier', 'Sharded tier' and "
            "'tiered/ and ingest/'",
    "io": "ROADMAP queue 1, item 'Disk tier'",
    "ingest": "ROADMAP queue 1, item 'tiered/ and ingest/'",
    "tiered": "ROADMAP queue 1, item 'tiered/ and ingest/'",
}


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Everything needed to construct an index, tier included.

    Graph/build geometry: ``degree``/``build_beam``/``build_batch``/
    ``alpha`` map onto ``VamanaParams``; ``dim`` is validated against the
    corpus at ``create()`` (None = infer).  ``mode`` picks the
    acceleration layer; ``hop_backend`` the traversal hop ('unfused':
    gather-distance kernel + torch merge; 'fused': one fused-hop kernel
    per hop — bit-identical results).  ``k``/``beam_width`` are the
    defaults a request can override per call.
    """
    tier: str = "ram"
    mode: str = "catapult"
    path: Optional[str] = None
    # graph/build geometry
    dim: Optional[int] = None
    degree: int = 32
    build_beam: int = 64
    build_batch: int = 512
    alpha: float = 1.2
    # features
    pq: Optional[int] = None
    filters: bool = False
    spare_capacity: int = 0
    # catapult layer
    n_bits: int = 8
    bucket_capacity: int = 40
    seed: int = 0
    # disk tiers
    cache_frames: int = 2048
    n_shards: int = 2
    tiered: Optional[object] = None
    io: Optional[object] = None
    ingest: Optional[object] = None
    hop_backend: str = "unfused"
    # serving defaults (overridable per SearchRequest)
    k: int = 10
    beam_width: Optional[int] = None
    # workload adaptation (catapult mode only)
    adapt: Optional[PolicyConfig] = None
    adapt_tick_every: int = 32
    # warm-up searches at create(); () disables
    warm_batch_shapes: tuple = ()
    # observability: False swaps the registry for a no-op one
    metrics: bool = True

    def __post_init__(self) -> None:
        if self.tier not in TIERS:
            raise ValueError(f"tier must be one of {TIERS}, "
                             f"got {self.tier!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if self.tier != "ram" and self.mode == "lsh_apg":
            raise ValueError("lsh_apg traverses at full precision — "
                             "RAM tier only")
        if self.tier != "ram" and self.path is None:
            raise ValueError(f"tier={self.tier!r} needs a path")
        if self.n_shards < 1:
            raise ValueError(f"need >= 1 shard, got {self.n_shards}")
        if self.adapt is not None and self.mode != "catapult":
            raise ValueError("adapt policy needs mode='catapult'")
        if self.hop_backend not in HOP_BACKENDS:
            raise ValueError(f"hop_backend must be one of {HOP_BACKENDS}, "
                             f"got {self.hop_backend!r}")
        asked = {"tier": self.tier != "ram", "io": self.io is not None,
                 "ingest": self.ingest is not None,
                 "tiered": self.tiered is not None}
        for name, on in asked.items():
            if on:
                raise CapabilityError(
                    f"IndexSpec.{name}={getattr(self, name)!r} is not ported "
                    f"to repro_torch yet: {_NOT_PORTED[name]}")

    def vamana(self) -> VamanaParams:
        return VamanaParams(max_degree=self.degree,
                            build_beam=self.build_beam,
                            batch=self.build_batch, alpha=self.alpha,
                            seed=self.seed)


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """One batched k-NN request; every field is per-request.

    ``publish=False`` opts the whole batch out of the catapult bucket
    publish (warmup traffic, replayed audits, shadow reads).
    """
    queries: np.ndarray
    k: Optional[int] = None              # None = the spec default
    beam_width: Optional[int] = None     # None = the spec/tier default
    filter_labels: Optional[np.ndarray] = None
    publish: bool = True
    max_iters: Optional[int] = None


class SearchResult(NamedTuple):
    """(ids, dists, stats) — unpacks like the internal engines' return."""
    ids: np.ndarray              # (B, k) int32, -1 padded
    dists: np.ndarray            # (B, k) float32
    stats: SearchStats
