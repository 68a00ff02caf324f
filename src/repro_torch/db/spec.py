"""Declarative index specification + request/response types.

Port of ``repro/db/spec.py``.  ``IndexSpec`` keeps the reference's
fields and validation, so one spec reads the same in both packages.
The port serves every tier: RAM in every mode (``catapult``,
``diskann``, ``lsh_apg``); the single-store disk tier (``tier="disk"``,
a CTPL block file at ``path``, its I/O engine configured by
``io=IoSpec()``), the sharded tier (``tier="sharded"``, ``n_shards``
CTPL shards under a manifest directory) and the hot/cold tiered tier
(``tier="tiered"``, configured by ``tiered=TieredSpec()``) in
``catapult`` and ``diskann`` modes; at full precision or with PQ
traversal (``pq=M``; the disk tiers always traverse PQ), filtered
(``filters=True``) or not, with the adapt layer
(``adapt=PolicyConfig(...)``, catapult mode) or without, and born
empty for streaming ingest (``ingest=IngestSpec(...)``, defaulted when
``create`` gets no vectors).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.adapt.policy import PolicyConfig
from repro_torch.core.engine import SearchStats
from repro_torch.core.vamana import VamanaParams

TIERS = ("ram", "disk", "sharded", "tiered")
COLD_TIERS = ("disk", "sharded")
MODES = ("catapult", "diskann", "lsh_apg")
HOP_BACKENDS = ("unfused", "fused")
ADMISSION_POLICIES = ("clock", "locality")


class CapabilityError(RuntimeError):
    """Operation not supported by this tier (see ``Database.caps``)."""


@dataclasses.dataclass(frozen=True)
class IoSpec:
    """Disk-tier I/O engine configuration (``IndexSpec.io``).

    ``pipeline=False`` (the default) is the synchronous engine: demand
    fetches on the search path, nothing speculative.  ``pipeline=True``
    turns on the async submission/completion engine
    (``repro_torch.store.pipeline``): ``workers`` reader threads overlap
    speculative block reads with rerank/route compute, prefetching the
    beam frontier's neighborhoods (the adjacency of each lane's top
    ``prefetch_depth`` beam nodes) under a bounded ``queue_depth`` of
    outstanding reads, with in-flight dedup and cancellation of
    mispredicted prefetches.

    ``admission`` picks the cache-admission policy: ``'clock'`` is pure
    recency; ``'locality'`` grants frequently re-demanded nodes extra
    CLOCK lives and admits speculative blocks unreferenced.  Both
    compose with catapult-destination pinning.

    The spec persists next to the index (``<store>.io.json``), so a
    plain ``open(path)`` resumes the engine the index was tuned with; an
    explicit ``spec.io`` at ``open()`` overrides the persisted one.

    Search results are unaffected either way: ids/dists are bit-identical
    with the pipeline on or off — only wall-clock and I/O accounting move.
    """
    pipeline: bool = False
    workers: int = 2
    prefetch_depth: int = 4      # beam-frontier nodes speculated per lane
    queue_depth: int = 256       # max outstanding speculative reads
    admission: str = "clock"

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError(f"io.workers must be >= 1, got {self.workers}")
        if self.prefetch_depth < 1:
            raise ValueError(f"io.prefetch_depth must be >= 1, "
                             f"got {self.prefetch_depth}")
        if self.queue_depth < 1:
            raise ValueError(f"io.queue_depth must be >= 1, "
                             f"got {self.queue_depth}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"io.admission must be one of "
                             f"{ADMISSION_POLICIES}, "
                             f"got {self.admission!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IoSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


BOOTSTRAP_MODES = ("seed", "direct")


@dataclasses.dataclass(frozen=True)
class IngestSpec:
    """Streaming-ingest configuration (``IndexSpec.ingest``).

    Set (or defaulted) whenever a database is born empty —
    ``create(spec)`` with no vectors — and available on any mutable
    database for the batching/locality knobs.

    * ``batch_size`` — ``IngestQueue`` flush granularity: concurrent
      ``put()`` rows coalesce into one graph insertion of (at most)
      this many rows.
    * ``bootstrap`` — ``'seed'`` serves the first rows from an exact
      brute-force buffer and cuts over to the graph at
      ``bootstrap_cutover`` rows (the deterministic build over the
      buffered rows in arrival order — identical to a batch build of
      the same prefix); ``'direct'`` builds the graph from the very
      first insert batch.
    * ``initial_capacity`` — row preallocation of the first graph
      build; growth past it re-creates the backend at
      ``grow_factor`` times the previous capacity (a FreshDiskANN-style
      generation rebuild that also compacts tombstones away).
    * ``consolidate_threshold`` — tombstone fraction at which an
      attached maintainer runs ``consolidate()`` in the background
      (0 disables).
    * ``locality_group`` — Slipstream-style batch reordering: each
      insert batch is sorted by an LSH code before graph insertion so
      nearby rows link sequentially; assigned ids still come back in
      caller order.

    Persists next to the index (single store: ``<store>.ingest.json``
    sidecar; sharded: the manifest's ``ingest`` entry) and is resumed
    by ``open()``; an explicit ``spec.ingest`` overrides the persisted
    one.
    """
    batch_size: int = 256
    bootstrap: str = "seed"
    bootstrap_cutover: int = 256
    initial_capacity: int = 1024
    grow_factor: float = 2.0
    consolidate_threshold: float = 0.25
    locality_group: bool = True

    def __post_init__(self) -> None:
        if self.batch_size < 1:
            raise ValueError(f"ingest.batch_size must be >= 1, "
                             f"got {self.batch_size}")
        if self.bootstrap not in BOOTSTRAP_MODES:
            raise ValueError(f"ingest.bootstrap must be one of "
                             f"{BOOTSTRAP_MODES}, got {self.bootstrap!r}")
        if self.bootstrap_cutover < 2:
            raise ValueError(f"ingest.bootstrap_cutover must be >= 2 (a "
                             f"graph needs two rows), "
                             f"got {self.bootstrap_cutover}")
        if self.initial_capacity < 1:
            raise ValueError(f"ingest.initial_capacity must be >= 1, "
                             f"got {self.initial_capacity}")
        if self.grow_factor <= 1.0:
            raise ValueError(f"ingest.grow_factor must be > 1.0, "
                             f"got {self.grow_factor}")
        if not (0.0 <= self.consolidate_threshold < 1.0):
            raise ValueError(f"ingest.consolidate_threshold must be in "
                             f"[0, 1), got {self.consolidate_threshold}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IngestSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class Caps(NamedTuple):
    """What this database can do — probe instead of type-sniffing."""
    tier: str            # 'ram' | 'disk' | 'sharded' | 'tiered'
    mutable: bool        # upsert / delete / consolidate
    filtered: bool       # built with labels: filtered search available
    persistent: bool     # save() / reopen via open()
    sharded: bool        # scatter-gather over >1 shard
    host_views: bool = True  # db.vectors / db.tombstones available


@dataclasses.dataclass(frozen=True)
class TieredSpec:
    """Hot/cold tiered-database configuration (``IndexSpec.tiered``).

    The tiered tier serves a RAM ``VectorSearchEngine`` over the HOT
    rows in front of a cold disk index holding the whole corpus (the
    cold store is the canonical home of every row — global ids are cold
    ids, so promotion/demotion never renumbers anything).

    * ``hot_fraction``/``hot_capacity`` size the hot set: ``hot_capacity``
      (rows) wins when set, else ``ceil(hot_fraction * n)`` at
      ``create()``.
    * ``cold_tier`` picks the cold backend: ``'disk'`` (one CTPL file)
      or ``'sharded'`` (a manifest directory, ``IndexSpec.n_shards``).
    * ``promote_top`` — hot buckets consulted per maintainer rebalance;
      their live catapult destinations are the promotion candidates.
    * ``demote_after`` — rebalances a hot row survives without
      re-appearing in the candidate set before it is demotable.
    * ``pin_cold`` — keep the hot rows tier-pinned in the cold cache so
      the cold tier's block fetch path never pays disk reads for rows
      the RAM tier already serves.

    Persisted in the ``tiered.json`` manifest, so a plain ``open()``
    resumes the layout the index was created with.
    """
    hot_fraction: float = 0.1
    hot_capacity: Optional[int] = None
    cold_tier: str = "disk"
    promote_top: int = 16
    demote_after: int = 2
    pin_cold: bool = True

    def __post_init__(self) -> None:
        if not (0.0 < self.hot_fraction <= 1.0):
            raise ValueError(f"tiered.hot_fraction must be in (0, 1], "
                             f"got {self.hot_fraction}")
        if self.hot_capacity is not None and self.hot_capacity < 1:
            raise ValueError(f"tiered.hot_capacity must be >= 1, "
                             f"got {self.hot_capacity}")
        if self.cold_tier not in COLD_TIERS:
            raise ValueError(f"tiered.cold_tier must be one of "
                             f"{COLD_TIERS}, got {self.cold_tier!r}")
        if self.promote_top < 1:
            raise ValueError(f"tiered.promote_top must be >= 1, "
                             f"got {self.promote_top}")
        if self.demote_after < 1:
            raise ValueError(f"tiered.demote_after must be >= 1, "
                             f"got {self.demote_after}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TieredSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


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
    tiered: Optional[TieredSpec] = None
    io: Optional[IoSpec] = None
    # streaming ingest (None = IngestSpec() defaults, materialized when
    # a database is created empty); persisted with the index and
    # resumed by open()
    ingest: Optional[IngestSpec] = None
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
        if self.io is not None and not isinstance(self.io, IoSpec):
            raise ValueError(f"io must be an IoSpec (or None for the "
                             f"synchronous default), got {type(self.io)}")
        if self.ingest is not None and not isinstance(self.ingest,
                                                      IngestSpec):
            raise ValueError(f"ingest must be an IngestSpec (or None for "
                             f"the defaults), got {type(self.ingest)}")
        if self.tiered is not None and not isinstance(self.tiered,
                                                      TieredSpec):
            raise ValueError(f"tiered must be a TieredSpec (or None for "
                             f"the defaults), got {type(self.tiered)}")
        if self.hop_backend not in HOP_BACKENDS:
            raise ValueError(f"hop_backend must be one of {HOP_BACKENDS}, "
                             f"got {self.hop_backend!r}")

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
