"""Micro-batching front door for vector search.

Port of ``repro/serving/engine.py``'s ``VectorSearchFrontend``: single
queries coalesce into fixed-shape batches and dispatch to any of the
port's search backends (every tier, and a database born empty), with the
adapt layer's maintainer observing every dispatched chunk and an
attached ingest queue pumped once a flush.  The reference's
``ServingEngine`` (LM decode) comes with ROADMAP queue 1, item 'LLM/RAG
stack last'.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.engine import SearchStats
from repro_torch.obs import NULL_INSTRUMENT, RollingWindow


class VectorSearchFrontend:
    """Coalesce single search requests into fixed-shape backend batches.

    The frontend always dispatches full ``max_batch``-row batches,
    padding by repeating the last real query, so a backend sees one
    batch shape.  Padded lanes are masked out of the catapult bucket
    publish and out of the returned stats
    (``publish_mask``): an unmasked pad would double-publish the last
    real query's destination — skewing the bucket LRU toward
    batch-boundary traffic — and double-count it in the adapt layer's
    win-rate/drift telemetry.  ``submit`` returns a ticket; ``flush``
    services every pending ticket in ONE backend search per chunk and
    returns ``{ticket: (ids, dists)}``.  ``search`` is the
    batch-in/batch-out convenience used by bulk callers (it also
    returns the per-chunk SearchStats for I/O attribution, real lanes
    only).

    ``k``/``beam_width`` are per-request: ``submit(q, k=...,
    beam_width=...)`` overrides the construction-time defaults for that
    ticket only.  ``flush`` groups pending tickets by their effective
    (k, beam) pair — requests sharing a pair batch together, so the
    batch shapes a backend sees stay bounded by the number of distinct
    pairs in flight, never by request interleaving order — and each
    ticket gets back ids/dists shaped by ITS k.

    ``maintainer`` (a ``repro_torch.adapt.CatapultMaintainer``) hooks the
    workload-adaptation loop into the serving path: every dispatched
    chunk is observed (real lanes only), and maintenance ticks ride
    the flush cadence.

    Serving telemetry: ``window`` (a ``repro_torch.obs.RollingWindow``)
    keeps a bounded rolling readout — QPS, mean batch occupancy, flush
    latency percentiles — recorded once per ``flush()``/bulk
    ``search()`` call (one deque append; always on).  ``metrics`` (an
    optional ``repro_torch.obs.MetricsRegistry``) additionally
    publishes flush counts and a full-history flush-latency histogram;
    ``Database.serve()`` passes its own registry here.
    """

    def __init__(self, backend, *, k: int = 10, max_batch: int = 64,
                 beam_width: Optional[int] = None, maintainer=None,
                 metrics=None, ingest=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.backend = backend
        self.k, self.max_batch, self.beam_width = k, max_batch, beam_width
        self.maintainer = maintainer
        # an attached ingest queue (anything with ``pump()``) is pumped
        # once per flush()/bulk search() — writes interleave with serving
        # at flush granularity instead of competing for the backend
        self.ingest = ingest
        # ticket queue entries: (ticket, query, k, beam_width) with the
        # per-request overrides already resolved against the defaults
        self._queue: list[tuple[int, np.ndarray, int, Optional[int]]] = []
        self._next_ticket = 0
        self.batches_dispatched = 0
        self.window = RollingWindow()
        self._m_flushes = (metrics.counter("catapultdb_serve_flushes_total")
                           if metrics is not None else NULL_INSTRUMENT)
        self._m_flush_ms = (metrics.histogram("catapultdb_serve_flush_ms")
                            if metrics is not None else NULL_INSTRUMENT)

    def submit(self, query: np.ndarray, k: Optional[int] = None,
               beam_width: Optional[int] = None) -> int:
        """Queue one query; ``k``/``beam_width`` override the frontend
        defaults for this ticket only."""
        q = np.ascontiguousarray(query, np.float32).ravel()
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queue.append((ticket, q, k or self.k,
                            beam_width or self.beam_width))
        return ticket

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _dispatch_chunk(self, qs: np.ndarray, k: int,
                        beam_width: Optional[int] = None):
        """Pad to the fixed batch shape, search with padded lanes masked
        out of publishes, and return (ids, dists, stats) trimmed to the
        real lanes; feeds the maintainer when one is attached."""
        real = qs.shape[0]
        pad = self.max_batch - real
        if pad:
            qs = np.concatenate([qs, np.repeat(qs[-1:], pad, axis=0)])
        mask = np.zeros(self.max_batch, bool)
        mask[:real] = True
        ids, dists, stats = self.backend.search(
            qs, k=k, beam_width=beam_width, publish_mask=mask)
        self.batches_dispatched += 1
        if self.maintainer is not None:
            # full padded shape + real_mask, NOT the trimmed views, as
            # the reference does: the pad lanes fold in masked out
            self.maintainer.observe(qs, stats, real_mask=mask)
        stats = SearchStats(hops=np.asarray(stats.hops)[:real],
                            ndists=np.asarray(stats.ndists)[:real],
                            used=np.asarray(stats.used)[:real],
                            won=np.asarray(stats.won)[:real],
                            block_reads=(None if stats.block_reads is None
                                         else np.asarray(
                                             stats.block_reads)[:real]),
                            cache_hits=(None if stats.cache_hits is None
                                        else np.asarray(
                                            stats.cache_hits)[:real]))
        return np.asarray(ids[:real]), np.asarray(dists[:real]), stats

    def flush(self) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """Serve every queued request; returns {ticket: (ids, dists)}.

        Tickets group by their effective (k, beam) pair — submission
        order is preserved within a pair, and each pair dispatches its
        own fixed-shape chunks, so mixed-k traffic costs one batch shape
        per distinct pair, not one per flush pattern."""
        out: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        groups: dict[tuple, list] = {}
        for entry in self._queue:
            groups.setdefault((entry[2], entry[3]), []).append(entry)
        self._queue = []
        t0 = time.perf_counter()
        served = 0
        occupancy: list[float] = []
        for (k, beam), entries in groups.items():
            for lo in range(0, len(entries), self.max_batch):
                chunk = entries[lo: lo + self.max_batch]
                qs = np.stack([q for _, q, _, _ in chunk])
                ids, dists, _ = self._dispatch_chunk(qs, k, beam)
                served += len(chunk)
                occupancy.append(len(chunk) / self.max_batch)
                for row, (ticket, _, _, _) in enumerate(chunk):
                    out[ticket] = (ids[row], dists[row])
        if served:
            ms = (time.perf_counter() - t0) * 1e3
            self.window.record_flush(
                queries=served, occupancy=float(np.mean(occupancy)), ms=ms)
            self._m_flushes.inc()
            self._m_flush_ms.observe(ms)
        if self.ingest is not None:
            self.ingest.pump()
        return out

    def search(self, queries: np.ndarray, k: Optional[int] = None,
               beam_width: Optional[int] = None):
        """Bulk path: chunk a (Q, d) batch through the backend and
        reassemble — same route the ticketed path takes, minus the queue."""
        k = k or self.k
        beam_width = beam_width or self.beam_width
        queries = np.ascontiguousarray(queries, np.float32)
        if queries.shape[0] == 0:
            return (np.empty((0, k), np.int32),
                    np.empty((0, k), np.float32), [])
        all_ids, all_d, all_stats = [], [], []
        t0 = time.perf_counter()
        occupancy: list[float] = []
        for lo in range(0, queries.shape[0], self.max_batch):
            ids, dists, stats = self._dispatch_chunk(
                queries[lo: lo + self.max_batch], k, beam_width)
            occupancy.append(ids.shape[0] / self.max_batch)
            all_ids.append(ids)
            all_d.append(dists)
            all_stats.append(stats)
        ms = (time.perf_counter() - t0) * 1e3
        self.window.record_flush(queries=int(queries.shape[0]),
                                 occupancy=float(np.mean(occupancy)), ms=ms)
        self._m_flushes.inc()
        self._m_flush_ms.observe(ms)
        if self.ingest is not None:
            self.ingest.pump()
        return (np.concatenate(all_ids), np.concatenate(all_d), all_stats)
