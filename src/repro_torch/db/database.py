"""The ``Database`` facade — every tier.

Port of ``repro/db/database.py`` for the RAM, single-store disk,
sharded and tiered tiers: ``search`` (a ``SearchRequest`` or a raw
query array with keywords, per-request ``publish`` and
``filter_labels``, ``explain=True`` traces), ``upsert`` (with ``keys=``
for a true upsert, locality grouped when the spec carries an
``IngestSpec``, gids in caller order), ``delete`` (by id or by key),
``consolidate``, ``save`` (the engine's files, the key map, the
bootstrap indirection of a database born empty and the ``IngestSpec``),
``io_stats`` (all-zero on the RAM tier), ``ingest_queue``, ``serve``
(the micro-batching frontend, with the drift-aware maintainer attached
when the spec carries an adapt policy — at the cutover on a database
still empty or seeding — and an ingest queue pumped once a flush),
``attach_maintainer`` (a ``TieredMaintainer`` on the tiered tier;
background consolidate at ``IngestSpec.consolidate_threshold``),
``metrics`` (with the tiered tier's ``tier_stats()`` as
``catapultdb_tier_*`` and a bootstrap engine's ``ingest_stats()`` as
``catapultdb_ingest_*``), ``warm``, ``close`` and the host views (where
one engine owns the whole row range, ``caps.host_views``; in external
id order on a database born empty).  Every search passes an explicit
all-True or all-False ``publish_mask``, as the reference's does.
Mutations and maintainer ticks serialize on one lock; searches take
none.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
import weakref
from functools import partial
from typing import Optional

import numpy as np

from repro_torch.adapt import CatapultMaintainer
from repro_torch.db.spec import (CapabilityError, Caps, IndexSpec,
                                 SearchRequest, SearchResult)
from repro_torch.ingest.keys import (KeyMap, ingest_spec_path,
                                     ingest_state_path, write_ingest_state)
from repro_torch.ingest.queue import IngestQueue, locality_order
from repro_torch.obs import MetricsRegistry, TraceRecorder, build_search_trace
from repro_torch.serving import VectorSearchFrontend

# batch-mean hop counts per search — graph-walk lengths, not latencies
_HOP_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0)


def _adapt_metrics(db_ref) -> dict:
    """The maintainer's snapshot as ``catapultdb_adapt_*`` metrics.  The
    maintainer is read at scrape time (``attach_maintainer`` may run
    after the collector registers), through a weak reference, so the
    registry keeps no database alive."""
    db = db_ref()
    m = None if db is None else db.maintainer
    if m is None:
        return {}
    return {f"catapultdb_adapt_{key}": float(v)
            for key, v in m.snapshot().items()
            if isinstance(v, (bool, int, float, np.bool_, np.integer,
                              np.floating))}


def _io_metrics(db_ref) -> dict:
    """The engine's ``IoStats`` as ``catapultdb_cache_*`` /
    ``catapultdb_io_prefetch_*`` metrics (all-zero on the RAM tier)."""
    db = db_ref()
    if db is None:
        return {}
    st = db.backend.io_stats()
    return {"catapultdb_cache_hits": float(st.hits),
            "catapultdb_cache_misses": float(st.misses),
            "catapultdb_cache_block_reads": float(st.block_reads),
            "catapultdb_cache_prefetch_batches": float(st.prefetch_batches),
            "catapultdb_cache_batched_reads": float(st.batched_reads),
            "catapultdb_io_prefetch_issued": float(st.prefetch_issued),
            "catapultdb_io_prefetch_completed":
                float(st.prefetch_completed),
            "catapultdb_io_prefetch_hits": float(st.prefetch_hits),
            "catapultdb_io_prefetch_wasted": float(st.prefetch_wasted),
            "catapultdb_io_prefetch_cancelled":
                float(st.prefetch_cancelled)}


def _tier_metrics(db_ref) -> dict:
    """The tiered engine's ``tier_stats()`` as ``catapultdb_tier_*``."""
    db = db_ref()
    if db is None:
        return {}
    return {f"catapultdb_tier_{key}": float(v)
            for key, v in db.backend.tier_stats().items()}


def _ingest_metrics(db_ref) -> dict:
    """The key count, and a bootstrap engine's ``ingest_stats()``, as
    ``catapultdb_ingest_*``."""
    db = db_ref()
    if db is None:
        return {}
    out = {"catapultdb_ingest_keys":
           float(len(db._keymap) if db._keymap else 0)}
    stats = getattr(db.backend, "ingest_stats", None)
    if stats is not None:
        out.update({f"catapultdb_ingest_{key}": float(v)
                    for key, v in stats().items()})
    return out


class Database:
    """CatapultDB handle over a RAM or disk engine; construct via
    ``repro_torch.db.create`` or ``repro_torch.db.open``, never
    directly."""

    def __init__(self, backend, spec: IndexSpec, caps: Caps, keymap=None):
        self.backend = backend       # the internal engine
        self.spec = spec
        self.caps = caps
        self.maintainer = None       # set by serve()/attach_maintainer()
        self.last_warm_ms: Optional[float] = None
        self.last_warm_breakdown: dict = {}   # {batch_shape: ms}
        # upsert/delete/consolidate serialize here, and the maintainer
        # shares the lock for its background consolidate; searches stay
        # lock-free
        self._mutate_lock = threading.RLock()
        self._keymap = keymap        # caller keys <-> gids (lazy)
        self.registry = MetricsRegistry(enabled=spec.metrics)
        reg = self.registry
        self._m_requests = reg.counter("catapultdb_search_requests_total")
        self._m_queries = reg.counter("catapultdb_search_queries_total")
        self._m_explains = reg.counter("catapultdb_search_explain_total")
        self._m_latency = reg.histogram("catapultdb_search_latency_ms")
        self._m_hops = reg.histogram("catapultdb_search_hops",
                                     edges=_HOP_EDGES)
        self._m_used = reg.counter("catapultdb_catapult_used_total")
        self._m_won = reg.counter("catapultdb_catapult_won_total")
        self._m_block_reads = reg.counter("catapultdb_io_block_reads_total")
        self._m_cache_hits = reg.counter("catapultdb_io_cache_hits_total")
        self._m_ing_rows = reg.counter("catapultdb_ingest_rows_total")
        self._m_ing_batches = reg.counter("catapultdb_ingest_batches_total")
        self._m_ing_reupserts = reg.counter(
            "catapultdb_ingest_reupserts_total")
        self._m_ing_deletes = reg.counter("catapultdb_ingest_deletes_total")
        if reg.enabled:
            # weak references: the registry keeps no database alive, so
            # dropping the last reference frees its tables at once
            me = weakref.ref(self)
            reg.register_collector(partial(_io_metrics, me))
            reg.register_collector(partial(_adapt_metrics, me))
            reg.register_collector(partial(_ingest_metrics, me))
            if hasattr(backend, "tier_stats"):
                reg.register_collector(partial(_tier_metrics, me))

    def _record_search(self, batch: int, ms: float, stats,
                       explained: bool) -> None:
        self._m_requests.inc()
        self._m_queries.inc(batch)
        self._m_latency.observe(ms)
        self._m_hops.observe(float(np.mean(stats.hops)))
        used = int(np.asarray(stats.used).sum())
        if used:
            self._m_used.inc(used)
        won = int(np.asarray(stats.won).sum())
        if won:
            self._m_won.inc(won)
        if stats.block_reads is not None:
            self._m_block_reads.inc(int(np.asarray(stats.block_reads).sum()))
            self._m_cache_hits.inc(int(np.asarray(stats.cache_hits).sum()))
        if explained:
            self._m_explains.inc()

    def metrics(self, fmt: str = "dict"):
        """One snapshot of every published metric: ``'dict'`` (default),
        ``'json'`` or ``'prometheus'`` text."""
        if fmt == "dict":
            return self.registry.snapshot()
        if fmt == "json":
            return self.registry.to_json()
        if fmt == "prometheus":
            return self.registry.to_prometheus()
        raise ValueError(f"fmt must be 'dict', 'json' or 'prometheus', "
                         f"got {fmt!r}")

    # ---------------------------------------------------------------- search
    def search(self, request, *, k: Optional[int] = None,
               beam_width: Optional[int] = None,
               filter_labels: Optional[np.ndarray] = None,
               publish: Optional[bool] = None,
               max_iters: Optional[int] = None,
               explain: bool = False):
        """Serve one batched request.

        ``request`` is a ``SearchRequest`` — or a raw (B, d) query array
        with the request fields as keyword arguments; keywords alongside
        a ``SearchRequest`` raise.  ``explain=True`` returns a
        ``repro_torch.obs.SearchTrace`` (same ids/dists, plus entry
        points, catapult counts, hops and stage times).
        """
        if isinstance(request, SearchRequest):
            extras = dict(k=k, beam_width=beam_width,
                          filter_labels=filter_labels, publish=publish,
                          max_iters=max_iters)
            passed = [name for name, v in extras.items() if v is not None]
            if passed:
                raise TypeError(
                    f"got a SearchRequest AND keyword(s) {passed}; set "
                    f"the fields on the request (dataclasses.replace) "
                    f"instead")
        else:
            request = SearchRequest(queries=request, k=k,
                                    beam_width=beam_width,
                                    filter_labels=filter_labels,
                                    publish=publish is not False,
                                    max_iters=max_iters)
        if request.filter_labels is not None and not self.caps.filtered:
            raise CapabilityError(
                f"filter_labels on an unfiltered index (tier="
                f"{self.caps.tier}); build with IndexSpec(filters=True) "
                f"and labels")
        q = np.ascontiguousarray(request.queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        mask = np.full(q.shape[0], bool(request.publish), bool)
        kk = request.k or self.spec.k
        bw = request.beam_width or self.spec.beam_width
        recorder = TraceRecorder() if explain else None
        timed = explain or self.registry.enabled
        t0 = time.perf_counter() if timed else 0.0
        ids, dists, stats = self.backend.search(
            q, k=kk, beam_width=bw, filter_labels=request.filter_labels,
            max_iters=request.max_iters, publish_mask=mask, trace=recorder)
        total_ms = (time.perf_counter() - t0) * 1e3 if timed else 0.0
        if self.registry.enabled:
            self._record_search(q.shape[0], total_ms, stats, explain)
        if explain:
            return build_search_trace(
                ids=ids, dists=dists, stats=stats, tier=self.caps.tier,
                mode=self.backend.mode, k=kk, beam_width=bw,
                filter_labels=request.filter_labels, recorder=recorder,
                total_ms=total_ms)
        return SearchResult(ids=ids, dists=dists, stats=stats)

    # ---------------------------------------------------------------- mutate
    def upsert(self, vectors: np.ndarray,
               labels: Optional[np.ndarray] = None, *,
               keys=None) -> np.ndarray:
        """Insert a batch; returns the assigned ids in caller order
        (stable forever), on every tier.

        ``keys``: caller-chosen row identities (all-int or all-str per
        database, one per row).  A key already present performs a true
        upsert: the new row is inserted, then the old row tombstoned, so
        ``search`` never returns both versions and the key is never
        absent mid-upsert.  A filtered database needs ``labels``.

        When the spec carries ``ingest.locality_group`` (every database
        born empty does), the batch is locality grouped before graph
        insertion — sorted by an LSH code so near rows link in turn —
        and the returned gids are un-permuted back to caller order."""
        self._need("mutable", "upsert()")
        if labels is not None and not self.caps.filtered:
            raise CapabilityError("labels on an unfiltered index")
        if labels is None and self.caps.filtered:
            # the engine would tag the rows label 0 and pollute that
            # label's filtered results
            raise ValueError("a filtered index needs labels on upsert()")
        vectors = np.ascontiguousarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        b = vectors.shape[0]
        if keys is not None and len(keys) != b:
            raise ValueError(f"{len(keys)} keys for {b} rows")
        ing = self.spec.ingest
        with self._mutate_lock:
            order = None
            if ing is not None and ing.locality_group and b > 2:
                order = locality_order(vectors, seed=self.spec.seed)
                vectors = vectors[order]
                if labels is not None:
                    labels = np.asarray(labels)[order]
            gids = np.asarray(self.backend.insert_batch(vectors, labels),
                              np.int64)
            if order is not None:
                unperm = np.empty(b, np.int64)
                unperm[order] = gids     # gid of caller row order[i]
                gids = unperm
            replaced = 0
            if keys is not None:
                old = self._ensure_keymap().assign(keys, gids)
                stale = old[old >= 0]
                if stale.size:
                    # true upsert: the replaced rows die after the new
                    # ones landed
                    self.backend.delete(stale)
                    replaced = int(stale.size)
        if self.registry.enabled:
            self._m_ing_rows.inc(b)
            self._m_ing_batches.inc()
            if replaced:
                self._m_ing_reupserts.inc(replaced)
        return gids

    def delete(self, ids: Optional[np.ndarray] = None, *,
               keys=None) -> None:
        """Tombstone rows by gid, or by caller key (exactly one of
        ``ids``/``keys``; unknown keys raise ``KeyError``).  Catapult
        buckets drop the dead destinations; the medoid and label
        entries are re-elected as needed."""
        self._need("mutable", "delete()")
        if (ids is None) == (keys is None):
            raise TypeError("delete() takes exactly one of ids= or keys=")
        with self._mutate_lock:
            if keys is not None:
                ids = self._ensure_keymap().drop(keys)
            self.backend.delete(ids)
        if self.registry.enabled:
            self._m_ing_deletes.inc(int(np.asarray(ids).size))

    def consolidate(self) -> int:
        """FreshVamana compaction pass; returns the repaired row count."""
        self._need("mutable", "consolidate()")
        with self._mutate_lock:
            return self.backend.consolidate()

    def _ensure_keymap(self) -> KeyMap:
        if self._keymap is None:
            self._keymap = KeyMap()
        return self._keymap

    @property
    def keys(self) -> KeyMap:
        """The caller-key <-> gid map; empty until the first keyed
        upsert."""
        return self._ensure_keymap()

    def ingest_queue(self, batch_size: Optional[int] = None):
        """An ``IngestQueue`` over this database: thread-safe ``put()``
        of rows (+ keys/labels), coalesced into locality-grouped graph
        insertions of ``spec.ingest.batch_size`` rows, pumped by the
        serving frontend (``serve(ingest=...)``) or explicitly."""
        self._need("mutable", "ingest_queue()")
        return IngestQueue(self, batch_size=batch_size)

    # ---------------------------------------------------------------- persist
    def save(self) -> None:
        """Flush every persisted structure (blocks, tombstones, label
        entries, catapult buckets + adapt telemetry where live, the
        ingest spec, the key map and the bootstrap indirection) so that
        ``repro_torch.db.open(spec.path)`` resumes this exact state."""
        self._need("persistent", "save()")
        with self._mutate_lock:
            self._stage_ingest_manifest()
            self.backend.save()
            self._persist_ingest_state()

    def _stage_ingest_manifest(self) -> None:
        """Hand the sharded manifest its durable ingest entries before the
        engine rewrites it (``save`` and every ``insert_batch`` rewrite
        the manifest from scratch, merging ``manifest_extra`` in each
        time, so the entries survive)."""
        if self.spec.ingest is None and self._keymap is None:
            return
        base = getattr(self.backend, "inner", self.backend)
        extra = getattr(base, "manifest_extra", None)
        if extra is None:
            return
        if self.spec.ingest is not None:
            extra["ingest"] = self.spec.ingest.to_dict()
        extra["keys"] = "keys.npz"

    def _persist_ingest_state(self) -> None:
        """Sidecars beside the saved index: the IngestSpec json (single
        stores and tiered directories; the sharded tier carries it in
        its manifest) and the keys npz (key map + bootstrap external-id
        indirection), in the reference's schema."""
        path = self.spec.path
        bootstrap = getattr(self.backend, "persist_arrays", None)
        if self._keymap is None and bootstrap is None:
            return
        state = bootstrap() if bootstrap is not None else {}
        write_ingest_state(ingest_state_path(self.caps.tier, path),
                           self._keymap, state.get("ext2int"),
                           state.get("ext_tomb"),
                           ext_labels=state.get("ext_labels"))
        if self.spec.ingest is not None and self.caps.tier != "sharded":
            sp = ingest_spec_path(self.caps.tier, path)
            tmp = sp + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.spec.ingest.to_dict(), f, indent=1)
            os.replace(tmp, sp)

    # ---------------------------------------------------------------- serve
    def serve(self, *, max_batch: int = 64, k: Optional[int] = None,
              beam_width: Optional[int] = None, maintain=None,
              ingest=None):
        """One-line serving: a micro-batching ``VectorSearchFrontend``
        over this database, with the drift-aware ``CatapultMaintainer``
        attached when the spec carries an adapt policy.

        ``maintain``: None = follow ``spec.adapt``; False = never
        attach; a ``PolicyConfig`` = attach with that policy.  On a
        database born empty that has not cut over yet, the maintainer
        attaches at the cutover (``fe.maintainer`` is None until then).

        ``ingest``: an ``IngestQueue`` (or True for a fresh one via
        ``ingest_queue()``) the frontend pumps once per flush — the
        ingest-while-serving interleave.  The queue rides on the
        returned frontend as ``fe.ingest``.
        """
        maintainer = None
        deferred_policy = None
        policy = self.spec.adapt if maintain is None else maintain
        if policy:
            if self.backend.mode != "catapult":
                # fail at serve() time, not inside the upsert that
                # happens to trigger the deferred cutover attach
                raise CapabilityError(
                    f"maintainer needs mode='catapult', this database "
                    f"is {self.backend.mode!r}")
            if getattr(self.backend, "bootstrap_phase", "graph") != "graph":
                # no catapult buckets exist before the seed->graph
                # cutover; attach the moment they do
                deferred_policy = policy
            else:
                maintainer = self.attach_maintainer(
                    policy if policy is not True else None)
        if ingest is True:
            ingest = self.ingest_queue()
        fe = VectorSearchFrontend(
            self.backend, k=k or self.spec.k, max_batch=max_batch,
            beam_width=beam_width or self.spec.beam_width,
            maintainer=maintainer, metrics=self.registry, ingest=ingest)
        if deferred_policy is not None:
            # runs inside the upsert that crosses the cutover, under the
            # mutate lock the maintainer shares (an RLock)
            def _attach(_eng, _policy=deferred_policy, _fe=fe):
                _fe.maintainer = self.attach_maintainer(
                    _policy if _policy is not True else None)
            self.backend.on_cutover(_attach)
        # the frontend's rolling window (QPS, occupancy, flush p99)
        # rides into db.metrics() as a pull collector
        self.registry.register_collector(fe.window.as_collector())
        return fe

    def attach_maintainer(self, policy=None, tick_every: Optional[int] = None):
        """Create (and remember) the right maintainer over the backend —
        ``TieredMaintainer`` on the tiered tier (catapult maintenance and
        hot/cold rebalancing in one tick), ``CatapultMaintainer``
        elsewhere — sharing this database's mutate lock; ``policy`` and
        ``tick_every`` default to the spec's ``adapt`` and
        ``adapt_tick_every``.  When the spec carries an ``IngestSpec``,
        the maintainer runs a background ``consolidate()`` whenever the
        tombstone fraction crosses its ``consolidate_threshold``."""
        if self.backend.mode != "catapult":
            raise CapabilityError(
                f"maintainer needs mode='catapult', this database is "
                f"{self.backend.mode!r}")
        cls = CatapultMaintainer
        if self.caps.tier == "tiered":
            from repro_torch.tiered import TieredMaintainer
            cls = TieredMaintainer
        ing = self.spec.ingest
        self.maintainer = cls(
            self.backend, policy or self.spec.adapt,
            tick_every=tick_every or self.spec.adapt_tick_every,
            consolidate_threshold=(ing.consolidate_threshold
                                   if ing is not None else 0.0),
            mutate_lock=self._mutate_lock)
        return self.maintainer

    def warm(self, batch_shapes=None, *, k: Optional[int] = None,
             beam_width: Optional[int] = None) -> float:
        """One throwaway ``publish=False`` search per declared batch size
        (bucket state untouched), then a cold start of the disk tier's
        I/O counters; on the card this builds and loads the kernels and
        settles the allocator.  Returns elapsed ms."""
        shapes = tuple(batch_shapes if batch_shapes is not None
                       else self.spec.warm_batch_shapes)
        breakdown: dict = {}
        t0 = time.perf_counter()
        for b in shapes:
            tb = time.perf_counter()
            q = np.zeros((int(b), self.dim), np.float32)
            self.search(q, k=k, beam_width=beam_width, publish=False)
            breakdown[int(b)] = (time.perf_counter() - tb) * 1e3
        ms = (time.perf_counter() - t0) * 1e3
        if shapes:
            # the warm-up's block reads are not the workload's
            self.io_stats(reset=True)
        self.last_warm_ms = ms
        # per-shape cost, so a first-query regression names its shape
        self.last_warm_breakdown = breakdown
        if self.registry.enabled:
            self.registry.gauge("catapultdb_warm_total_ms").set(ms)
            for b, bms in breakdown.items():
                self.registry.gauge(f"catapultdb_warm_ms_shape_{b}").set(bms)
        return ms

    def close(self) -> None:
        """Release the engine's file and reader threads (the RAM tier
        holds none)."""
        close = getattr(self.backend, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "Database":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def n_active(self) -> int:
        return self.backend.n_active

    @property
    def dim(self) -> int:
        if getattr(self.backend, "dim", 0):
            return int(self.backend.dim)          # sharded/tiered facade
        return int(self.backend._vec_np.shape[1])

    @property
    def n_labels(self) -> int:
        return int(getattr(self.backend, "n_labels", 0))

    @property
    def vectors(self) -> np.ndarray:
        """Host view of the active rows (``caps.host_views``).  Indexed
        by external id on a database born empty (compacted rows
        zeroed)."""
        self._need("host_views", "db.vectors")
        n = getattr(self.backend, "ext_rows", self.backend.n_active)
        return self.backend._vec_np[:n]

    @property
    def tombstones(self) -> np.ndarray:
        """Tombstone flags of the active rows (``caps.host_views``).  On
        a database born empty the index is the external id space: ids
        outlive compaction, so a dropped row still reads True."""
        self._need("host_views", "db.tombstones")
        n = getattr(self.backend, "ext_rows", self.backend.n_active)
        return self.backend._tomb_np[:n]

    def _need(self, cap: str, op: str) -> None:
        """Raise ``CapabilityError`` naming the tier when ``caps`` lacks
        ``cap``."""
        if not getattr(self.caps, cap):
            raise CapabilityError(
                f"{op} needs the {cap!r} capability, which the "
                f"{self.caps.tier!r} tier of this database lacks")

    # ---------------------------------------------------------------- I/O
    def io_stats(self, reset: bool = False):
        """The typed I/O record (``repro_torch.store.cache.IoStats``), one
        shape on every tier: cache counters plus the async pipeline's
        speculation counters; all-zero on the RAM tier.  ``reset=True``
        returns the snapshot and then cold-starts the I/O path (counters
        and cache dropped, structural pins re-established)."""
        return self.backend.io_stats(reset=reset)

    def reset_io(self) -> None:
        """Deprecated: use ``io_stats(reset=True)``."""
        warnings.warn("Database.reset_io() is deprecated; use "
                      "db.io_stats(reset=True)", DeprecationWarning,
                      stacklevel=2)
        self.backend.io_stats(reset=True)

    @property
    def cache_stats(self):
        """Deprecated: use ``io_stats()`` (same leading five fields)."""
        warnings.warn("Database.cache_stats is deprecated; use "
                      "db.io_stats()", DeprecationWarning, stacklevel=2)
        return self.backend.cache_stats

