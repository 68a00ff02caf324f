"""Empty-bootstrap engine: a database born with zero rows.

Port of ``repro/ingest/bootstrap.py``, the same state machine over the
port's tier engines, on the ``device`` that ``create`` resolved: every
cutover and generation rebuild builds its backend there, so from the
cutover on every search and insert runs on the inner engine's device
(the card by default).

``create(spec)`` with no vectors returns a serving-ready ``Database``
over a ``BootstrapEngine`` — an engine-protocol wrapper that runs the
streaming state machine

    empty ──first rows──▶ seed ──cutover──▶ graph

* **empty** — searches answer immediately (all ``-1`` ids, zero stats).
* **seed** — the first rows live in a host buffer and searches are
  exact brute force over the live buffered rows (filters + tombstones
  honored), so recall is perfect while the corpus is tiny.
* **graph** — at ``ingest.bootstrap_cutover`` live rows (or on the very
  first batch with ``ingest.bootstrap='direct'``) the real tier backend
  is built over the buffered rows IN ARRIVAL ORDER through the same
  construction path as ``create(spec, vectors)`` — deterministic in
  ``(spec.seed, rows)``, so the cutover index is identical to a
  batch-built twin of the same prefix.  The medoid is elected by that
  build; subsequent batches stream through ``insert_batch``.

The wrapper owns a stable EXTERNAL id space: callers see sequential
arrival-order gids on every tier, while the backend's internal gids
(capacity-ranged on the sharded tier, regenerated on growth) stay
hidden behind an ``ext2int``/``int2ext`` indirection.  When the backend
runs out of spare capacity the engine performs a FreshDiskANN-style
generation rebuild — gather the live rows, rebuild at ``grow_factor``
times the capacity, remap — which also compacts tombstones away;
external ids never change.

Concurrency: searches run lock-free against a snapshot of the current
``(inner, int2ext)`` generation; cutover/growth take a write gate that
drains in-flight searches before replacing the backing store (the disk
tiers rebuild in place, so a reader of the old generation must not
cross the rebuild).  Every inner engine's ``search`` returns host numpy,
so a search's device work has finished (its ids were copied back)
before it leaves the gate; a rebuild never frees tensors a queued
kernel still reads.  ``_close`` closes the old disk engine, which drains
its I/O pipeline, before the new one is built over the same path.  All
mutations are serialized by the owning ``Database``'s mutate lock.

The seed phase's brute force stays host numpy, as in the reference: it
is exact over a buffer of at most ``bootstrap_cutover`` rows, and numpy
keeps it bit-equal to the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core.engine import SearchStats
from repro_torch.db.spec import IndexSpec, IngestSpec
from repro_torch.device import resolve_device


class _SearchGate:
    """Tiny readers/writer gate: searches are readers, generation swaps
    (cutover, growth rebuild) are writers.  Writers drain readers and
    block new ones; readers never block each other."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._readers = 0
        self._writing = False

    @contextlib.contextmanager
    def read(self):
        with self._cv:
            while self._writing:
                self._cv.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cv:
                self._readers -= 1
                if not self._readers:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cv:
            while self._writing:
                self._cv.wait()
            self._writing = True
            while self._readers:
                self._cv.wait()
        try:
            yield
        finally:
            with self._cv:
                self._writing = False
                self._cv.notify_all()


def _base(inner):
    """The engine that owns row storage (the cold tier of a tiered
    engine; the engine itself elsewhere)."""
    return getattr(inner, "cold", inner)


def _total_capacity(inner) -> int:
    base = _base(inner)
    shards = getattr(base, "shards", None)
    if shards is not None and getattr(base, "offsets", None) is not None:
        return int(base.offsets[-1])
    return int(base.capacity)


def _free_capacity(inner) -> int:
    base = _base(inner)
    shards = getattr(base, "shards", None)
    if shards is not None:
        return int(sum(int(sh.capacity) - int(sh.n_active)
                       for sh in shards))
    return int(base.capacity) - int(base.n_active)


def _build_row_gids(inner, n: int) -> np.ndarray:
    """Backend gid of each of the ``n`` rows a fresh build consumed, in
    input order.  Derived from the built engine itself (shard ``s`` got
    the ``s``-th contiguous input slice), never re-derived from the
    splitting arithmetic."""
    base = _base(inner)
    shards = getattr(base, "shards", None)
    if shards is None:
        return np.arange(n, dtype=np.int64)
    out = np.empty(n, np.int64)
    pos = 0
    for s, sh in enumerate(shards):
        c = int(sh.n_active)
        out[pos: pos + c] = int(base.offsets[s]) + np.arange(c, dtype=np.int64)
        pos += c
    if pos != n:
        raise AssertionError(f"build consumed {pos} rows, expected {n}")
    return out


def _gather_rows(inner, int_ids: np.ndarray) -> np.ndarray:
    """Host gather of backend rows by internal gid (shard-aware)."""
    base = _base(inner)
    shards = getattr(base, "shards", None)
    if shards is None:
        return np.ascontiguousarray(base._vec_np[int_ids], np.float32)
    off = np.asarray(base.offsets, np.int64)
    which = np.searchsorted(off, int_ids, side="right") - 1
    out = np.empty((int_ids.shape[0], int(base.dim)), np.float32)
    for s, sh in enumerate(shards):
        m = which == s
        if m.any():
            out[m] = sh._vec_np[int_ids[m] - int(off[s])]
    return out


def _close(engine) -> None:
    """Release an engine's resources; the RAM tier has no handles and
    therefore no close()."""
    fn = getattr(engine, "close", None)
    if fn is not None:
        fn()


class BootstrapEngine:
    """Engine-protocol wrapper behind every database born empty."""

    def __init__(self, spec: IndexSpec, device="cuda"):
        # resolved before the first row arrives: an empty database on a
        # machine without a card raises at create()
        self._device = resolve_device(device)
        if spec.dim is None:
            raise ValueError("create(spec) with no vectors needs spec.dim "
                             "(nothing to infer the dimension from)")
        self.spec = dataclasses.replace(
            spec, ingest=spec.ingest or IngestSpec())
        self._ing = self.spec.ingest
        self._dim = int(spec.dim)
        self.phase = "empty"                    # 'empty' | 'seed' | 'graph'
        cap0 = max(self._ing.bootstrap_cutover, self._ing.batch_size, 64)
        self._buf: Optional[np.ndarray] = np.zeros((cap0, self._dim),
                                                   np.float32)
        self._n_buf = 0
        self._ext_tomb = np.zeros(0, bool)      # per EXTERNAL gid, forever
        self._ext2int: Optional[np.ndarray] = None     # graph phase only
        self._ext_labels = (np.zeros(0, np.int32) if spec.filters else None)
        self._n_labels = 0
        self._gen: tuple = (None, None)         # (inner, int2ext) snapshot
        self._gate = _SearchGate()
        self._cutover_cbs: list = []
        # observability (surfaced as catapultdb_ingest_* via Database)
        self.cutovers = 0
        self.growths = 0
        self.cutover_ms = 0.0
        self.grow_ms = 0.0

    # ------------------------------------------------------------- protocol
    @property
    def mode(self) -> str:
        return self.spec.mode

    @property
    def device(self):
        """The device every build of this engine runs on (a property, so
        a probe before the cutover never falls into ``__getattr__``)."""
        return self._device

    @property
    def filtered(self) -> bool:
        return bool(self.spec.filters)

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def n_labels(self) -> int:
        inner = self._gen[0]
        if inner is not None:
            return int(getattr(inner, "n_labels", 0) or self._n_labels)
        return self._n_labels

    @property
    def n_active(self) -> int:
        # external rows still occupying backend slots (tombstoned-but-
        # uncompacted included) — the same "allocated rows" semantics
        # every internal engine reports; rows a generation rebuild
        # dropped no longer count
        if self.phase == "graph":
            return int((self._ext2int >= 0).sum())
        return int(self._ext_tomb.shape[0])

    @property
    def ext_rows(self) -> int:
        """External ids ever assigned — the length of the ext-indexed
        host views (``db.vectors`` / ``db.tombstones``)."""
        return int(self._ext_tomb.shape[0])

    @property
    def capacity(self) -> int:
        inner = self._gen[0]
        if inner is None:
            return int(self._buf.shape[0]) if self._buf is not None else 0
        return _total_capacity(inner)

    @property
    def bootstrap_phase(self) -> str:
        return self.phase

    @property
    def inner(self):
        """The real tier backend (None before cutover)."""
        return self._gen[0]

    @property
    def shards(self):
        inner = self._gen[0]
        if inner is None:
            return None
        return getattr(inner, "shards", None) or [inner]

    def __getattr__(self, name):
        # anything not phase-dependent delegates to the real backend
        # once it exists (pq_subspaces, n_bits, io, tiered, hot, ...)
        if name.startswith("__"):
            raise AttributeError(name)
        inner = self.__dict__.get("_gen", (None,))[0]
        if inner is not None:
            return getattr(inner, name)
        raise AttributeError(f"{type(self).__name__} has no attribute "
                             f"{name!r} before cutover")

    def on_cutover(self, cb) -> None:
        """Run ``cb(self)`` once the graph backend exists (immediately
        when it already does) — deferred maintainer attach etc."""
        if self.phase == "graph":
            cb(self)
        else:
            self._cutover_cbs.append(cb)

    # --------------------------------------------------------------- search
    def search(self, queries: np.ndarray, k: int,
               beam_width: Optional[int] = None,
               filter_labels: Optional[np.ndarray] = None,
               max_iters: Optional[int] = None,
               publish_mask: Optional[np.ndarray] = None,
               trace=None):
        with self._gate.read():
            inner, int2ext = self._gen
            if inner is None:
                return self._seed_search(queries, k, filter_labels, trace)
            # host numpy back: the device work is done inside the gate
            ids, dists, stats = inner.search(
                queries, k=k, beam_width=beam_width,
                filter_labels=filter_labels, max_iters=max_iters,
                publish_mask=publish_mask, trace=trace)
            ids = np.asarray(ids)
            if trace is not None:
                with trace.stage("ingest_map"):
                    ids = self._map_ext(ids, int2ext)
                trace.note(ingest_phase="graph")
            else:
                ids = self._map_ext(ids, int2ext)
            return ids, np.asarray(dists), stats

    @staticmethod
    def _map_ext(ids: np.ndarray, int2ext: np.ndarray) -> np.ndarray:
        safe = np.clip(ids, 0, int2ext.shape[0] - 1)
        return np.where(ids >= 0, int2ext[safe], -1)

    def _seed_search(self, queries, k, filter_labels, trace):
        q = np.ascontiguousarray(queries, np.float32)
        B = q.shape[0]
        ids = np.full((B, k), -1, np.int64)
        dists = np.full((B, k), np.inf, np.float32)
        stats = SearchStats(hops=np.zeros(B, np.int64),
                            ndists=np.zeros(B, np.int64),
                            used=np.zeros(B, bool),
                            won=np.zeros(B, bool))
        n = self._n_buf
        span = (trace.stage("bootstrap") if trace is not None
                else contextlib.nullcontext())
        with span:
            if n:
                v = self._buf[:n]
                mask = np.broadcast_to(~self._ext_tomb[:n], (B, n)).copy()
                if filter_labels is not None:
                    want = np.asarray(filter_labels).reshape(B, 1)
                    mask &= self._ext_labels[:n][None, :] == want
                d2 = ((q[:, None, :] - v[None, :, :]) ** 2).sum(-1)
                d2 = np.where(mask, d2, np.inf).astype(np.float32)
                kk = min(k, n)
                top = np.argsort(d2, axis=1, kind="stable")[:, :kk]
                td = np.take_along_axis(d2, top, axis=1)
                hit = np.isfinite(td)
                ids[:, :kk] = np.where(hit, top, -1)
                dists[:, :kk] = np.where(hit, td, np.inf)
                stats = stats._replace(
                    ndists=mask.sum(axis=1).astype(np.int64))
        if trace is not None:
            trace.note(ingest_phase=self.phase, buffered=int(n))
        return ids, dists, stats

    # --------------------------------------------------------------- mutate
    def insert_batch(self, new_vectors: np.ndarray,
                     labels: Optional[np.ndarray] = None) -> np.ndarray:
        v = np.ascontiguousarray(new_vectors, np.float32)
        if v.ndim == 1:
            v = v[None, :]
        if v.shape[1] != self._dim:
            raise ValueError(f"rows have dim {v.shape[1]}, "
                             f"index has dim {self._dim}")
        if labels is not None:
            labels = np.asarray(labels, np.int32).reshape(-1)
            self._n_labels = max(self._n_labels, int(labels.max()) + 1)
        if self._ext_labels is not None:
            lab = (labels if labels is not None
                   else np.zeros(v.shape[0], np.int32))
            self._ext_labels = np.concatenate([self._ext_labels, lab])
        if self.phase == "graph":
            return self._graph_insert(v, labels)
        return self._seed_insert(v, labels)

    insert = insert_batch

    def _seed_insert(self, v, labels) -> np.ndarray:
        b = v.shape[0]
        n = self._n_buf
        if n + b > self._buf.shape[0]:
            grown = np.zeros((max(2 * self._buf.shape[0], n + b),
                              self._dim), np.float32)
            grown[:n] = self._buf[:n]
            self._buf = grown
        self._buf[n: n + b] = v
        self._n_buf = n + b
        self._ext_tomb = np.concatenate([self._ext_tomb,
                                         np.zeros(b, bool)])
        self.phase = "seed"
        live = int(self._n_buf - self._ext_tomb.sum())
        if live >= 2 and (self._ing.bootstrap == "direct"
                          or live >= self._ing.bootstrap_cutover):
            self._cutover()
        return np.arange(n, n + b, dtype=np.int64)

    def _graph_insert(self, v, labels) -> np.ndarray:
        b = v.shape[0]
        inner = self._gen[0]
        if _free_capacity(inner) < b:
            self._grow(b)
        inner, int2ext = self._gen
        int_ids = np.asarray(inner.insert_batch(v, labels), np.int64)
        n = self._ext_tomb.shape[0]
        ext_ids = np.arange(n, n + b, dtype=np.int64)
        self._ext2int = np.concatenate([self._ext2int, int_ids])
        self._ext_tomb = np.concatenate([self._ext_tomb,
                                         np.zeros(b, bool)])
        int2ext[int_ids] = ext_ids      # in place: searches see it live
        return ext_ids

    def delete(self, ids: np.ndarray) -> None:
        ext = np.asarray(ids, np.int64).ravel()
        ext = ext[ext >= 0]
        if ext.size == 0:
            return
        if int(ext.max()) >= self._ext_tomb.shape[0]:
            raise IndexError(f"id {int(ext.max())} out of range "
                             f"({self._ext_tomb.shape[0]} rows)")
        self._ext_tomb[ext] = True
        inner = self._gen[0]
        if inner is not None:
            int_ids = self._ext2int[ext]
            int_ids = int_ids[int_ids >= 0]
            if int_ids.size:
                inner.delete(int_ids)

    def consolidate(self) -> int:
        """Reclaim tombstoned rows: a same-capacity generation rebuild
        over the live rows (FreshDiskANN's StreamingMerge analog) when
        any backend slots are wasted, else the inner engine's in-place
        graph splice.  Returns the number of rows reclaimed/repaired."""
        inner = self._gen[0]
        if inner is None or self.phase != "graph":
            return 0
        if ((self._ext2int >= 0) & self._ext_tomb).any():
            return self._rebuild_generation(_total_capacity(inner))
        return int(inner.consolidate())

    # ------------------------------------------------------ cutover / growth
    def _replaced_spec(self, n_rows: int, capacity: int) -> IndexSpec:
        return dataclasses.replace(
            self.spec, dim=self._dim,
            spare_capacity=max(int(capacity) - int(n_rows), 0))

    def _cutover(self) -> None:
        """Deterministic seed→graph transition: build the real backend
        over the buffered rows in arrival order (the exact build a
        batch ``create()`` of the same prefix runs), then apply any
        seed-phase tombstones."""
        from repro_torch.db import factory
        t0 = time.perf_counter()
        n = self._n_buf
        vectors = np.ascontiguousarray(self._buf[:n])
        labels = self._ext_labels[:n] if self.filtered else None
        cap = max(self._ing.initial_capacity, n)
        if cap <= n:
            cap = int(np.ceil(n * self._ing.grow_factor))
        spec = self._replaced_spec(n, cap)
        inner = factory._build_engine(spec, vectors, labels,
                                      self._n_labels or None,
                                      device=self._device)
        int_ids = _build_row_gids(inner, n)
        int2ext = np.full(_total_capacity(inner), -1, np.int64)
        int2ext[int_ids] = np.arange(n, dtype=np.int64)
        dead = np.nonzero(self._ext_tomb[:n])[0]
        if dead.size:
            inner.delete(int_ids[dead])
        with self._gate.write():
            self._ext2int = int_ids
            self._gen = (inner, int2ext)
            self._buf = None
            self.phase = "graph"
        self.cutovers += 1
        self.cutover_ms += (time.perf_counter() - t0) * 1e3
        cbs, self._cutover_cbs = self._cutover_cbs, []
        for cb in cbs:
            cb(self)

    def _grow(self, min_extra: int) -> None:
        """Generation rebuild at ``grow_factor``× capacity."""
        t0 = time.perf_counter()
        old_cap = _total_capacity(self._gen[0])
        n_live = int((~self._ext_tomb).sum())
        self._rebuild_generation(
            max(int(np.ceil(old_cap * self._ing.grow_factor)),
                n_live + int(min_extra)))
        self.growths += 1
        self.grow_ms += (time.perf_counter() - t0) * 1e3

    def _rebuild_generation(self, new_cap: int) -> int:
        """Gather the live rows, rebuild the backend deterministically
        (compacting tombstones away), remap the external ids.  The
        write gate drains in-flight searches first — the disk tiers
        rebuild over the same path.  Returns the number of tombstoned
        rows reclaimed."""
        from repro_torch.db import factory
        old, _ = self._gen
        live_ext = np.nonzero(~self._ext_tomb)[0]
        n_live = int(live_ext.size)
        if n_live < 2:
            raise RuntimeError(
                "a generation rebuild needs >= 2 live rows; this index "
                "is effectively empty — recreate it instead")
        reclaimed = int(((self._ext2int >= 0) & self._ext_tomb).sum())
        new_cap = max(int(new_cap), n_live)
        with self._gate.write():
            vectors = _gather_rows(old, self._ext2int[live_ext])
            labels = (self._ext_labels[live_ext] if self.filtered else None)
            _close(old)
            spec = self._replaced_spec(n_live, new_cap)
            inner = factory._build_engine(spec, vectors, labels,
                                          self._n_labels or None,
                                          device=self._device)
            int_ids = _build_row_gids(inner, n_live)
            ext2int = np.full(self._ext_tomb.shape[0], -1, np.int64)
            ext2int[live_ext] = int_ids
            int2ext = np.full(_total_capacity(inner), -1, np.int64)
            int2ext[int_ids] = live_ext
            self._ext2int = ext2int
            self._gen = (inner, int2ext)
        return reclaimed

    # -------------------------------------------------------------- persist
    def save(self) -> None:
        if self.phase == "empty":
            raise RuntimeError("nothing to save: this database has never "
                               "received a row")
        if self.phase == "seed":
            # a save point is a deterministic cutover point: the
            # persisted artifact is always a real graph index
            self._cutover()
        self._gen[0].save()

    def persist_arrays(self) -> dict:
        """The indirection state ``Database.save`` writes beside the
        keymap (consumed by ``resume``)."""
        out = {"ext2int": np.asarray(self._ext2int, np.int64),
               "ext_tomb": np.asarray(self._ext_tomb, bool)}
        if self._ext_labels is not None:
            out["ext_labels"] = np.asarray(self._ext_labels, np.int32)
        return out

    @classmethod
    def resume(cls, spec: IndexSpec, inner, state: dict) -> "BootstrapEngine":
        """Rewrap a reopened backend with its persisted external-id
        indirection (graph phase; the seed buffer never persists —
        ``save`` cuts over first)."""
        dim = int(getattr(inner, "dim", 0)
                  or inner._vec_np.shape[1])
        self = cls(dataclasses.replace(spec, dim=dim), device=inner.device)
        self.phase = "graph"
        self._buf = None
        self._ext2int = np.asarray(state["ext2int"], np.int64)
        self._ext_tomb = np.asarray(state["ext_tomb"], bool)
        if "ext_labels" in state:
            self._ext_labels = np.asarray(state["ext_labels"], np.int32)
            self._n_labels = (int(self._ext_labels.max()) + 1
                              if self._ext_labels.size else 0)
        int2ext = np.full(_total_capacity(inner), -1, np.int64)
        live = self._ext2int >= 0
        int2ext[self._ext2int[live]] = np.nonzero(live)[0]
        self._gen = (inner, int2ext)
        return self

    def close(self) -> None:
        inner = self._gen[0]
        if inner is not None:
            _close(inner)

    # ---------------------------------------------------------------- stats
    def io_stats(self, reset: bool = False):
        inner = self._gen[0]
        if inner is None:
            from repro_torch.store.cache import ZERO_IO_STATS
            return ZERO_IO_STATS
        return inner.io_stats(reset=reset)

    def tombstone_fraction(self) -> float:
        """Fraction of OCCUPIED backend slots that are tombstoned — the
        waste ``consolidate()`` can reclaim.  (External death marks are
        permanent and excluded: a rebuilt generation has dropped those
        rows already.)"""
        if self.phase != "graph":
            n = self._ext_tomb.shape[0]
            return float(self._ext_tomb.sum()) / n if n else 0.0
        occupied = self._ext2int >= 0
        n = int(occupied.sum())
        return (float((occupied & self._ext_tomb).sum()) / n) if n else 0.0

    def ingest_stats(self) -> dict:
        """Pull-collector payload for the catapultdb_ingest_* gauges."""
        phase_code = {"empty": 0, "seed": 1, "graph": 2}[self.phase]
        return {"phase": phase_code,
                "rows": int(self._ext_tomb.shape[0]),
                "buffered": int(self._n_buf if self._buf is not None else 0),
                "capacity": int(self.capacity),
                "cutovers": int(self.cutovers),
                "growths": int(self.growths),
                "cutover_ms": float(self.cutover_ms),
                "grow_ms": float(self.grow_ms),
                "tombstone_fraction": self.tombstone_fraction()}

    # ------------------------------------------------------------ host views
    @property
    def _vec_np(self) -> np.ndarray:
        """Host view in EXTERNAL row order (tombstoned rows zeroed after
        a growth rebuild dropped them) — ``db.vectors`` material."""
        if self._gen[0] is None:
            n = self._n_buf if self._buf is not None else 0
            return (self._buf[:n] if self._buf is not None
                    else np.zeros((0, self._dim), np.float32))
        inner = self._gen[0]
        ids = self._ext2int
        out = np.zeros((ids.shape[0], self._dim), np.float32)
        live = ids >= 0
        if live.any():
            out[live] = _gather_rows(inner, ids[live])
        return out

    @property
    def _tomb_np(self) -> np.ndarray:
        return self._ext_tomb
