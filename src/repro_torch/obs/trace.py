"""Per-query trace spans + the ``explain`` search mode's return type.

A copy of ``repro/obs/trace.py`` (pure Python; the port imports nothing
of the reference package).  The RAM tier records ``route`` and, with
PQ, ``rerank``; the disk tier ``route``, ``fetch``, ``speculate`` (with
the I/O pipeline on) and ``rerank``, and fills ``blocks_read`` /
``cache_hits`` from its ``SearchStats``.

A ``TraceRecorder`` is a host-side collector threaded through one
search call (``engine.search(..., trace=rec)``): each engine tier times
its lifecycle stages into it —

* ``route``   — entry-point selection (catapult bucket lookup vs medoid
                / per-label entry) + the device-side beam traversal,
                synced so the wall time is honest,
* ``fetch``   — the disk tiers' batched deduplicated block fetch
                through the CLOCK cache,
* ``speculate`` — the disk tier's queueing of next round's likely
                blocks on the I/O pipeline,
* ``rerank``  — full-precision rerank (host-side from fetched blocks on
                disk, device PQ rerank on RAM),
* ``merge``   — the sharded tier's rebase + global top-k merge,
* ``scatter`` — the sharded tier's whole fan-out wall time (shards
                overlap on the thread pool, so per-stage times inside
                it are critical-path maxima, not sums).

``Database.search(..., explain=True)`` wraps the recorder into a
``SearchTrace`` — ids/dists identical to the non-explain call, plus the
entry point chosen per lane, catapult hit/win counts, hops, blocks
read, and the per-stage wall times.  Tracing costs one device sync per
stage; it is for debugging and attribution, not the steady-state hot
path (which reports through ``repro_torch.obs.metrics`` instead).
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np

# stable stage vocabulary — benches and make_report key on these
STAGES = ("route", "fetch", "rerank", "merge", "scatter")


@dataclasses.dataclass
class Span:
    """One timed stage of a search lifecycle."""
    name: str
    ms: float


class TraceRecorder:
    """Collects stage spans + notes for ONE search call.

    Thread-discipline: one recorder per engine search; the sharded tier
    gives each shard its own ``child`` recorder (shards run on a thread
    pool) and aggregates on the calling thread afterwards.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self.spans: list[Span] = []
        self.meta: dict = {}
        self.children: list["TraceRecorder"] = []

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append(Span(name, (time.perf_counter() - t0) * 1e3))

    def add_stage(self, name: str, ms: float) -> None:
        self.spans.append(Span(name, float(ms)))

    def note(self, **kv) -> None:
        self.meta.update(kv)

    def child(self, name: str) -> "TraceRecorder":
        rec = TraceRecorder(name)
        self.children.append(rec)
        return rec

    def stage_ms(self, name: str) -> float:
        """Total ms recorded under ``name`` (0.0 if never entered)."""
        return sum(s.ms for s in self.spans if s.name == name)


@dataclasses.dataclass
class SearchTrace:
    """The ``explain=True`` return: the answer plus how it was found.

    ``ids``/``dists``/``stats`` are exactly what the non-explain call
    returns.  ``entry`` is the per-lane entry point actually taken:
    ``'catapult'`` (the bucket supplied a valid destination),
    ``'label_entry'`` (filtered lane falling back to its per-label
    entry point), or ``'medoid'``.  ``catapult_won`` counts lanes whose
    best start beat the fallback.  ``stages`` are wall-time spans (see
    module docstring for the vocabulary); on the sharded tier
    ``route``/``fetch``/``rerank`` are critical-path maxima over the
    overlapped shards and ``shards`` holds each shard's own spans.
    """
    ids: np.ndarray               # (B, k) — identical to non-explain
    dists: np.ndarray             # (B, k)
    stats: object                 # the engine's SearchStats
    tier: str
    mode: str
    batch: int
    k: int
    beam_width: Optional[int]
    entry: np.ndarray             # (B,) unicode: catapult|label_entry|medoid
    catapult_used: int            # lanes whose bucket supplied a start
    catapult_won: int             # lanes whose catapult start beat fallback
    hops: np.ndarray              # (B,)
    blocks_read: Optional[np.ndarray]    # (B,) — disk tiers only
    cache_hits: Optional[np.ndarray]     # (B,)
    stages: list[Span]
    shards: list[dict]            # per-shard {"name", "stages": [Span...]}
    total_ms: float

    def stage_ms(self, name: str) -> float:
        return sum(s.ms for s in self.stages if s.name == name)

    def to_dict(self) -> dict:
        """JSON-ready summary (benches, structured logs)."""
        return {
            "tier": self.tier, "mode": self.mode, "batch": self.batch,
            "k": self.k, "beam_width": self.beam_width,
            "entry_counts": {kind: int((self.entry == kind).sum())
                             for kind in np.unique(self.entry)},
            "catapult_used": self.catapult_used,
            "catapult_won": self.catapult_won,
            "hops_mean": float(np.mean(self.hops)),
            "blocks_read_mean": (None if self.blocks_read is None
                                 else float(np.mean(self.blocks_read))),
            "stages_ms": {s.name: round(self.stage_ms(s.name), 4)
                          for s in self.stages},
            "shards": [{"name": sh["name"],
                        "stages_ms": {s.name: round(s.ms, 4)
                                      for s in sh["stages"]}}
                       for sh in self.shards],
            "total_ms": round(self.total_ms, 4),
        }


def build_search_trace(*, ids, dists, stats, tier: str, mode: str, k: int,
                       beam_width: Optional[int],
                       filter_labels: Optional[np.ndarray],
                       recorder: TraceRecorder,
                       total_ms: float) -> SearchTrace:
    """Assemble the facade-level ``SearchTrace`` from an engine search's
    outputs + the recorder it filled."""
    b = int(np.shape(ids)[0])
    used = np.asarray(stats.used, bool)
    won = np.asarray(stats.won, bool)
    entry = np.full(b, "medoid", dtype="<U11")
    if filter_labels is not None:
        entry[np.asarray(filter_labels) >= 0] = "label_entry"
    entry[used] = "catapult"
    return SearchTrace(
        ids=np.asarray(ids), dists=np.asarray(dists), stats=stats,
        tier=tier, mode=mode, batch=b, k=k, beam_width=beam_width,
        entry=entry, catapult_used=int(used.sum()),
        catapult_won=int(won.sum()),
        hops=np.asarray(stats.hops),
        blocks_read=(None if stats.block_reads is None
                     else np.asarray(stats.block_reads)),
        cache_hits=(None if stats.cache_hits is None
                    else np.asarray(stats.cache_hits)),
        stages=list(recorder.spans),
        shards=[{"name": c.name, "stages": list(c.spans)}
                for c in recorder.children],
        total_ms=total_ms)
