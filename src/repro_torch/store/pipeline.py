"""Async submission/completion I/O pipeline over the node cache.

A copy of ``repro/store/pipeline.py`` (numpy and the standard
library; the port imports nothing of the reference package).

The disk search loop used to be strictly synchronous: the device idles
while the host fetches blocks, the host idles while the device routes
the next batch.  This module is the io_uring-shaped fix (ROADMAP "Async
pipelined I/O engine"): a small thread pool *submits* speculative block
reads and *completes* them into the thread-safe ``NodeCache`` in the
background, so the reads overlap the two compute phases that used to
mask them —

* round N's full-precision rerank (host numpy, releases the GIL), and
* round N+1's device traversal (the ``route`` stage).

What gets speculated is the paper's own locality argument turned into
I/O: under a workload with query locality, round N+1's queries land in
the neighborhoods round N's winners live in, so the engine hands the
pipeline the *adjacency of the current beam frontier* (the top beam
nodes' neighbor lists, already in hand from the demand fetch).  By the
time the next batch's rerank demands those blocks they are resident —
a miss converted off the critical path (``prefetch_hits``).

Discipline the engine relies on:

* **batched submission** — reads are submitted in chunks of ``_CHUNK``
  nodes per pool task (io_uring's many-SQEs-one-syscall shape), so the
  submission cost on the search path amortizes instead of paying one
  executor round-trip per block,
* **in-flight dedup** — a node queued here, being read by a worker, or
  demanded by the search path is read exactly once (the cache's
  condition-variable protocol; the pipeline additionally refuses to
  queue a node it already has queued),
* **bounded queue depth** — at most ``queue_depth`` speculative reads
  outstanding; submissions beyond the budget are dropped and counted
  (``prefetch_cancelled``), never queued unboundedly,
* **cancellation of mispredictions** — each ``advance()`` opens a new
  round; queued reads from two or more rounds ago are stale frontier
  predictions and are cancelled before they touch the store (whole
  chunks via ``Future.cancel``, started chunks node-by-node),
* **quiescence** — ``drain()`` blocks until every outstanding read has
  completed or been cancelled; the engine calls it before graph surgery
  invalidates the cache (and ``close()`` on shutdown).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait

import numpy as np

# speculation submitted at round R serves round R+1's demand; anything
# still queued when round R+2 opens predicted a frontier two batches
# stale — cancel it
_KEEP_ROUNDS = 1
# nodes per submitted pool task: the executor round-trip (~10us) is paid
# once per chunk, not once per block — batched SQEs, in io_uring terms
_CHUNK = 32


class IoPipeline:
    """Speculative prefetch engine: submit now, complete in background."""

    def __init__(self, cache, workers: int = 2, queue_depth: int = 256):
        if workers < 1:
            raise ValueError(f"need >= 1 worker, got {workers}")
        if queue_depth < 1:
            raise ValueError(f"need queue_depth >= 1, got {queue_depth}")
        self.cache = cache
        self.queue_depth = queue_depth
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="ctpl-io")
        self._lock = threading.Lock()
        self._round = 0
        self._queued: dict[int, int] = {}     # node -> round queued
        self._chunks: list[tuple[int, Future, list[int]]] = []
        self._closed = False

    # ------------------------------------------------------------ submission
    def speculate(self, node_ids) -> int:
        """Queue speculative reads for ``node_ids``; returns the number
        actually submitted.  Already-resident, already-queued and
        over-budget nodes are skipped (the latter counted cancelled)."""
        ids = np.atleast_1d(np.asarray(node_ids)).ravel()
        ids = ids[ids >= 0]
        # one cache-lock residency sweep for the whole candidate set —
        # never a lock acquisition per node on the search path
        fresh = self.cache.missing(ids)
        submitted = dropped = 0
        with self._lock:
            if self._closed:
                return 0
            self._chunks = [(r, f, c) for r, f, c in self._chunks
                            if not f.done()]
            budget = self.queue_depth - len(self._queued)
            rnd = self._round
            take: list[int] = []
            for i, node in enumerate(fresh):
                if node in self._queued:
                    continue
                if budget <= 0:
                    # bounded queue: everything beyond the budget is a
                    # counted drop, never an unbounded backlog
                    dropped += len(fresh) - i
                    break
                take.append(node)
                self._queued[node] = rnd
                budget -= 1
            for i in range(0, len(take), _CHUNK):
                chunk = take[i: i + _CHUNK]
                fut = self._pool.submit(self._read_chunk, chunk, rnd)
                self._chunks.append((rnd, fut, chunk))
            submitted = len(take)
        if submitted:
            self.cache.note_prefetch_issued(submitted)
        if dropped:
            self.cache.note_prefetch_cancelled(dropped)
        return submitted

    def submit(self, node_ids) -> int:
        """Queue this round's DEMAND reads (the deduplicated fetch set).

        Unlike ``speculate`` these reads are certain — the engine calls
        this right before ``fetch_batch``, which then *completes*
        against in-flight reads instead of paying each miss serially
        (submit-then-complete, the io_uring shape).  Demand submission
        bypasses the speculative queue budget (the set is bounded by
        the beam geometry and drained immediately) and skips the
        ``prefetch_*`` accounting; its I/O lands in ``block_reads``
        like any other demand read."""
        ids = np.atleast_1d(np.asarray(node_ids)).ravel()
        ids = ids[ids >= 0]
        fresh = self.cache.missing(ids)
        with self._lock:
            if self._closed:
                return 0
            rnd = self._round
            take = [n for n in fresh if n not in self._queued]
            for node in take:
                self._queued[node] = rnd
            for i in range(0, len(take), _CHUNK):
                chunk = take[i: i + _CHUNK]
                fut = self._pool.submit(self._read_chunk, chunk, rnd,
                                        True)
                self._chunks.append((rnd, fut, chunk))
        return len(take)

    def _read_chunk(self, nodes: list[int], rnd: int,
                    demand: bool = False) -> None:
        stale = 0
        try:
            for node in nodes:
                with self._lock:
                    self._queued.pop(node, None)
                    if not demand and self._round - rnd > _KEEP_ROUNDS:
                        # a misprediction by the time a worker got here
                        stale += 1
                        continue
                if demand:
                    self.cache.load(node)
                else:
                    self.cache.prefetch(node)
        finally:
            with self._lock:
                for node in nodes:
                    self._queued.pop(node, None)
            if stale:
                self.cache.note_prefetch_cancelled(stale)

    # ------------------------------------------------------------ completion
    def advance(self) -> None:
        """Open a new beam round: speculation two or more rounds old is a
        misprediction — cancel whatever of it has not started."""
        dropped = 0
        with self._lock:
            self._round += 1
            keep = []
            for rnd, fut, chunk in self._chunks:
                if self._round - rnd > _KEEP_ROUNDS and fut.cancel():
                    for node in chunk:
                        if self._queued.pop(node, None) is not None:
                            dropped += 1
                elif not fut.done():
                    keep.append((rnd, fut, chunk))
                # running stale chunks cancel themselves, node by node,
                # via the round check in _read_chunk
            self._chunks = keep
        if dropped:
            self.cache.note_prefetch_cancelled(dropped)

    def drain(self) -> None:
        """Block until no speculative read is outstanding (graph surgery
        and benchmarks call this before touching the store/cache)."""
        while True:
            with self._lock:
                self._chunks = [(r, f, c) for r, f, c in self._chunks
                                if not f.done()]
                futs = [f for _r, f, _c in self._chunks]
            if not futs:
                return
            wait(futs)

    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self._queued)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for _r, fut, _c in self._chunks:
                fut.cancel()
        self._pool.shutdown(wait=True)
        with self._lock:
            self._chunks.clear()
            self._queued.clear()
