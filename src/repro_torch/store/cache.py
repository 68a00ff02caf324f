"""I/O-counting node cache over block frames (CLOCK replacement).

A copy of ``repro/store/cache.py`` (numpy and the standard library;
the port imports nothing of the reference package).

A disk-resident graph index is dominated by block reads, and which
blocks are read is governed by the caching strategy (GoVector's core
observation).  This cache holds decoded node blocks in fixed frames and
services the engine's batched "fetch these nodes" requests:

* CLOCK replacement — one reference bit per frame, a sweeping hand;
  approximates LRU at O(1) per eviction with no ordered structure,
* hit/miss/block-read counters — global and returned per ``fetch`` call
  so the engine can attribute I/O to individual queries,
* pinning — frames holding structurally hot nodes (the medoid, per-label
  entry points) are never evicted; *catapult destinations* rotate
  through a bounded pin budget (``pin_rotating``) since the hot set
  drifts with the workload.

Since the async I/O pipeline (``repro_torch.store.pipeline``) the cache is
**thread-safe**: demand fetches on the search path and speculative
prefetch workers resolve nodes concurrently under one condition
variable, with in-flight dedup — a node being read by any thread is
read exactly once; everyone else waits on the condition and then hits
the freshly installed frame.  All counters mutate under the lock, so
``CacheStats``/``IoStats`` snapshots are race-free however many readers
are live.

Two admission policies (``IoSpec.admission``):

* ``'clock'`` — every admitted block enters referenced, pure recency
  (the pre-pipeline behaviour, bit-for-bit),
* ``'locality'`` — GoVector-style: admission is access-locality-aware.
  Demand-accessed nodes keep a decaying access-frequency score; frames
  of frequently re-read nodes are granted extra CLOCK lives, while
  *speculatively* prefetched blocks enter unreferenced — a mispredicted
  prefetch is the next sweep's first victim instead of flushing the
  resident hot set.  This layers on (never replaces) the hard/rotating
  pins, so catapult destinations stay the top of the hierarchy.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import NamedTuple, Sequence

import numpy as np

ADMISSION_POLICIES = ("clock", "locality")

# locality admission: decayed access-score thresholds for extra CLOCK
# lives, and the per-round geometric decay of the score itself
_FREQ_DECAY = 0.8
_LIVES_THRESHOLDS = (3.0, 6.0)     # score >= t -> one more life, max 2


class CacheStats(NamedTuple):
    """Global I/O counters, snapshot via ``NodeCache.stats``.

    ``block_reads`` is every load from the store; ``batched_reads`` is
    the subset issued by deduplicated ``fetch_batch`` calls — comparing
    the two against a naive per-lane replay is how the prefetcher's I/O
    win is attributed in fig12.

    This is the legacy 5-field record kept for the ``cache_stats``
    deprecation shims; new code reads the superset ``IoStats`` via
    ``db.io_stats()``.
    """
    hits: int
    misses: int
    block_reads: int
    prefetch_batches: int    # fetch_batch calls (one per rerank round)
    batched_reads: int       # deduplicated loads issued by those calls


class IoStats(NamedTuple):
    """The one typed I/O record every tier reports (``db.io_stats()``).

    The first five fields are ``CacheStats``; the ``prefetch_*`` tail
    accounts the async pipeline's speculative reads:

    * ``prefetch_issued``     — speculative reads submitted,
    * ``prefetch_completed``  — speculative reads that actually hit the
      store (an issued read whose node turned out resident costs no I/O),
    * ``prefetch_hits``       — demand fetches served by a block a
      prefetch brought in (misses converted off the critical path),
    * ``prefetch_wasted``     — prefetched blocks evicted before any
      demand touched them (mispredictions that cost a read),
    * ``prefetch_cancelled``  — speculative reads cancelled before the
      store was touched (stale rounds + bounded-queue drops).
    """
    hits: int
    misses: int
    block_reads: int
    prefetch_batches: int
    batched_reads: int
    prefetch_issued: int
    prefetch_completed: int
    prefetch_hits: int
    prefetch_wasted: int
    prefetch_cancelled: int


ZERO_IO_STATS = IoStats(*([0] * len(IoStats._fields)))


class NodeCache:
    """Fixed-capacity, thread-safe frame cache over a ``layout.BlockStore``."""

    def __init__(self, store, capacity: int = 1024,
                 pin_budget: int | None = None, admission: str = "clock"):
        if capacity < 2:
            raise ValueError("cache needs at least 2 frames")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{ADMISSION_POLICIES}, got {admission!r}")
        self.store = store
        self.capacity = capacity
        self.admission = admission
        dim, degree = store.header.dim, store.header.degree
        self.frame_vec = np.zeros((capacity, dim), np.float32)
        self.frame_adj = np.full((capacity, degree), -1, np.int32)
        self.frame_node = np.full(capacity, -1, np.int64)
        self.ref = np.zeros(capacity, bool)
        self.lives = np.zeros(capacity, np.int8)    # locality extra passes
        self.pinned = np.zeros(capacity, bool)
        self.frame_of: dict[int, int] = {}
        self.hand = 0
        # hard ceiling so CLOCK always finds a victim frame
        self.max_pinned = max(1, capacity - max(1, capacity // 8))
        self.pin_budget = min(pin_budget or max(1, capacity // 4),
                              self.max_pinned)
        self._rotating: deque[int] = deque()     # FIFO of soft-pinned nodes
        self._rotating_set: set[int] = set()
        # tier pins: the tiered database's hot-row set, replaced
        # wholesale by set_tier_pins(); applied to resident frames
        # immediately and to future installs lazily (_install), so
        # pinning never costs a block read of its own
        self._hard_pins: set[int] = set()
        self._tier_pins: set[int] = set()
        self.tier_pin_budget = max(1, capacity // 2)
        # concurrency: ONE condition guards every frame-table and counter
        # mutation; actual store reads happen outside it (see _resolve)
        self._cond = threading.Condition(threading.RLock())
        self._inflight: set[int] = set()     # nodes some thread is reading
        self._epoch = 0                      # bumped by invalidate()
        # locality admission state: node -> (decayed score, last round)
        self._freq: dict[int, tuple[float, int]] = {}
        self._round = 0
        # prefetched-but-not-yet-demanded residents (hit/waste attribution)
        self._spec_resident: set[int] = set()
        self.hits = 0
        self.misses = 0
        self.block_reads = 0
        self.prefetch_batches = 0
        self.batched_reads = 0
        self.prefetch_issued = 0
        self.prefetch_completed = 0
        self.prefetch_hits = 0
        self.prefetch_wasted = 0
        self.prefetch_cancelled = 0

    # ------------------------------------------------------------ replacement
    def _victim(self) -> int:
        """CLOCK sweep (lock held): skip pinned frames, give referenced
        ones a pass, and burn locality lives before surrender."""
        while True:
            f = self.hand
            self.hand = (self.hand + 1) % self.capacity
            if self.pinned[f]:
                continue
            if self.ref[f]:
                self.ref[f] = False
                continue
            if self.lives[f] > 0:
                self.lives[f] -= 1
                continue
            return f

    def _touch_freq(self, node: int) -> float:
        """Decayed demand-access score bump (lock held, locality only)."""
        score, rnd = self._freq.get(node, (0.0, self._round))
        score = score * (_FREQ_DECAY ** (self._round - rnd)) + 1.0
        self._freq[node] = (score, self._round)
        if len(self._freq) > 8 * self.capacity:
            self._freq = {n: (s, r) for n, (s, r) in self._freq.items()
                          if s * (_FREQ_DECAY ** (self._round - r)) >= 0.5}
        return score

    def _lives_for(self, node: int) -> int:
        score, rnd = self._freq.get(node, (0.0, self._round))
        score *= _FREQ_DECAY ** (self._round - rnd)
        return sum(score >= t for t in _LIVES_THRESHOLDS)

    def _install(self, node: int, vec, adj, *, speculative: bool) -> int:
        """Put freshly read block bytes into a victim frame (lock held)."""
        f = self._victim()
        old = int(self.frame_node[f])
        if old >= 0:
            self.frame_of.pop(old, None)
            if old in self._spec_resident:
                self._spec_resident.discard(old)
                self.prefetch_wasted += 1
        self.frame_vec[f] = vec
        self.frame_adj[f] = adj
        self.frame_node[f] = node
        self.frame_of[node] = f
        # locality admission: speculative blocks enter unreferenced — a
        # misprediction is the next sweep's first victim, not a resident
        # eviction; demand blocks enter referenced as always
        self.ref[f] = not (speculative and self.admission == "locality")
        self.lives[f] = (self._lives_for(node)
                         if self.admission == "locality" else 0)
        if speculative:
            self._spec_resident.add(node)
        # a hot-tier resident landing in a frame stays pinned (lazy half
        # of set_tier_pins) — ceiling-guarded so CLOCK keeps victims
        if node in self._tier_pins \
                and int(self.pinned.sum()) < self.max_pinned:
            self.pinned[f] = True
        return f

    # ------------------------------------------------------------ resolution
    def _resolve(self, node: int, out_vec=None, out_adj=None,
                 *, speculative: bool = False,
                 nowait: bool = False) -> bool | None:
        """Resolve one node to block contents, thread-safe.

        Returns True when THIS call performed the store read (a miss).
        Concurrent requests for the same node dedup through
        ``_inflight``: one thread reads, the rest wait on the condition
        and hit the installed frame.  The store read itself runs outside
        the lock, so reads overlap with other threads' cache work (and
        with the host rerank compute the pipeline hides them behind).

        ``out_vec``/``out_adj`` are per-row output buffers filled under
        the lock (miss fills come from the local read, immune to a
        concurrent eviction of the new frame).  ``speculative=True`` is
        the prefetch path: no copy-out, speculative admission, and no
        hit/waste attribution flip.  ``nowait=True`` returns None
        instead of blocking on an in-flight node — ``fetch_batch`` uses
        it to keep doing its own reads and only wait at the end, when
        the contended nodes have mostly completed.
        """
        while True:
            with self._cond:
                f = self.frame_of.get(node)
                if f is not None:
                    self.ref[f] = True
                    if not speculative:
                        if self.admission == "locality":
                            self._touch_freq(node)
                        if node in self._spec_resident:
                            self._spec_resident.discard(node)
                            self.prefetch_hits += 1
                    if out_vec is not None:
                        out_vec[...] = self.frame_vec[f]
                        out_adj[...] = self.frame_adj[f]
                    return False
                if node in self._inflight:
                    if speculative:
                        return False    # someone else is already on it
                    if nowait:
                        return None     # caller will come back for it
                    self._cond.wait()
                    continue            # re-check residency on wake
                self._inflight.add(node)
                epoch = self._epoch
                if not speculative and self.admission == "locality":
                    self._touch_freq(node)
            # -- the actual disk I/O, outside the lock --
            try:
                blk = self.store.read_block(node)
                vec = np.asarray(blk["vec"], np.float32)
                adj = np.asarray(blk["adj"], np.int32)
            except BaseException:
                with self._cond:
                    self._inflight.discard(node)
                    self._cond.notify_all()
                raise
            with self._cond:
                self._inflight.discard(node)
                self._cond.notify_all()
                self.block_reads += 1
                if speculative:
                    self.prefetch_completed += 1
                if epoch == self._epoch:
                    # a stale-epoch read raced invalidate(): the bytes may
                    # predate graph surgery — count the I/O, install nothing
                    self._install(node, vec, adj, speculative=speculative)
                if out_vec is not None:
                    out_vec[...] = vec
                    out_adj[...] = adj
                return True

    def prefetch(self, node: int) -> bool:
        """Speculatively pull one block into the cache (pipeline workers).

        Returns True when a store read was performed.  Already-resident
        and already-in-flight nodes are no-ops — the in-flight dedup
        makes concurrent speculation against the demand path safe.
        """
        return self._resolve(int(node), speculative=True)

    def load(self, node: int) -> bool:
        """Pull one block in with DEMAND semantics — the pipeline's
        submit-then-complete fetch path (``IoPipeline.submit``): the
        block is certain to be used this round, so it admits referenced
        and skips the ``prefetch_*`` attribution entirely.  Returns True
        when this call performed the store read."""
        return self._resolve(int(node))

    def contains(self, node: int) -> bool:
        with self._cond:
            return int(node) in self.frame_of

    def missing(self, node_ids) -> list[int]:
        """The subset of ``node_ids`` not resident, ONE lock acquisition
        for the whole sweep — the pipeline's submission-path filter."""
        ids = np.atleast_1d(np.asarray(node_ids)).ravel()
        with self._cond:
            return [int(n) for n in ids if int(n) not in self.frame_of]

    # ------------------------------------------------------------ fetch
    def fetch(self, node_ids: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray, int, int]:
        """Service one batched node request.

        Returns ``(vectors (m, d), adjacency (m, R), hits, misses)``
        aligned with ``node_ids``.  Each miss is exactly one block read
        performed by this call; a node concurrently being read by
        another thread counts as a hit here (that read is charged where
        it was issued).  Duplicate ids within a call hit the frame
        loaded by the first occurrence.
        """
        ids = np.asarray(node_ids).ravel()
        out_vec = np.empty((ids.size, self.frame_vec.shape[1]), np.float32)
        out_adj = np.empty((ids.size, self.frame_adj.shape[1]), np.int32)
        hits = misses = 0
        for j, node in enumerate(ids):
            if self._resolve(int(node), out_vec[j], out_adj[j]):
                misses += 1
            else:
                hits += 1
        with self._cond:
            self.hits += hits
            self.misses += misses
        return out_vec, out_adj, hits, misses

    def fetch_batch(self, requests: Sequence[np.ndarray]
                    ) -> list[tuple[np.ndarray, np.ndarray, int, int]]:
        """One deduplicated multi-node fetch servicing many lanes at once
        — the rerank prefetcher's unit of work (one call per beam round).

        Returns one ``(vectors, adjacency, hits, misses)`` tuple per
        request, aligned like ``fetch``.  Each distinct node across the
        whole batch is resolved exactly ONCE: its miss (if any) is
        charged to the first lane that wants it and counted in
        ``batched_reads``; every other occurrence is a hit.  This holds
        under any frame-pool pressure because contents are copied out
        the moment the node resolves — so ``batched_reads`` ≤ the reads
        a naive per-lane ``fetch`` loop would issue (which re-reads
        nodes evicted between lanes).
        """
        with self._cond:
            self.prefetch_batches += 1
            self._round += 1              # locality decay clock
        ids = [np.asarray(r).ravel() for r in requests]
        out = [(np.empty((a.size, self.frame_vec.shape[1]), np.float32),
                np.empty((a.size, self.frame_adj.shape[1]), np.int32))
               for a in ids]
        # node -> every (lane, row) slot wanting it, in arrival order
        wanted: dict[int, list[tuple[int, int]]] = {}
        for lane, arr in enumerate(ids):
            for row, node in enumerate(arr):
                wanted.setdefault(int(node), []).append((lane, row))
        hits = np.zeros(len(ids), np.int64)
        misses = np.zeros(len(ids), np.int64)
        batched = 0
        # two passes: nodes another thread is already reading are
        # deferred (nowait), so this thread spends the first pass doing
        # its own store reads in parallel with the pipeline workers and
        # only waits at the end — by then the deferred nodes have mostly
        # completed, instead of blocking head-of-line on each one
        deferred: list[tuple[int, list[tuple[int, int]]]] = []
        for node, slots in wanted.items():
            lane0, row0 = slots[0]
            st = self._resolve(node, out[lane0][0][row0],
                               out[lane0][1][row0], nowait=True)
            if st is None:
                deferred.append((node, slots))
                continue
            if st:
                batched += 1
                misses[lane0] += 1
                hits[lane0] -= 1     # first slot below counts as hit
            for lane, row in slots[1:]:
                out[lane][0][row] = out[lane0][0][row0]
                out[lane][1][row] = out[lane0][1][row0]
            for lane, _row in slots:
                hits[lane] += 1
        for node, slots in deferred:
            lane0, row0 = slots[0]
            if self._resolve(node, out[lane0][0][row0], out[lane0][1][row0]):
                batched += 1
                misses[lane0] += 1
                hits[lane0] -= 1
            for lane, row in slots[1:]:
                out[lane][0][row] = out[lane0][0][row0]
                out[lane][1][row] = out[lane0][1][row0]
            for lane, _row in slots:
                hits[lane] += 1
        with self._cond:
            self.hits += int(hits.sum())
            self.misses += int(misses.sum())
            self.batched_reads += batched
        return [(v, a, int(h), int(m))
                for (v, a), h, m in zip(out, hits, misses)]

    # ------------------------------------------------------------ pinning
    def pin(self, node_ids) -> None:
        """Permanently pin nodes (medoid, label entry points).

        Loading a not-yet-cached pin costs one block read (a prefetch);
        pins beyond the safety ceiling are ignored rather than wedging
        the CLOCK sweep.
        """
        for node in np.atleast_1d(np.asarray(node_ids)).ravel():
            node = int(node)
            if node < 0:
                continue
            with self._cond:
                if int(self.pinned.sum()) >= self.max_pinned:
                    return
                self._hard_pins.add(node)
                f = self.frame_of.get(node)
            if f is None:
                self._resolve(node)
            with self._cond:
                f = self.frame_of.get(node)
                if f is not None:
                    self.pinned[f] = True

    def pin_rotating(self, node_ids) -> None:
        """Soft-pin a drifting hot set (catapult destinations).

        Keeps at most ``pin_budget`` rotating pins, unpinning the oldest
        first — the disk-tier analogue of the bucket layer's LRU.
        """
        for node in np.atleast_1d(np.asarray(node_ids)).ravel():
            node = int(node)
            with self._cond:
                if node < 0 or node in self._rotating_set:
                    continue
                while (len(self._rotating) >= self.pin_budget
                       or int(self.pinned.sum()) >= self.max_pinned):
                    if not self._rotating:
                        return  # ceiling is all hard pins; nothing to rotate
                    old = self._rotating.popleft()
                    self._rotating_set.discard(old)
                    fo = self.frame_of.get(old)
                    if fo is not None and old not in self._tier_pins \
                            and old not in self._hard_pins:
                        self.pinned[fo] = False
                f = self.frame_of.get(node)
            if f is None:
                self._resolve(node)
            with self._cond:
                f = self.frame_of.get(node)
                if f is None or self.pinned[f]:
                    continue
                self.pinned[f] = True
                self._rotating.append(node)
                self._rotating_set.add(node)

    def set_tier_pins(self, node_ids) -> None:
        """Replace the tier-pin set wholesale (the tiered database's hot
        rows, re-pinned after every rebalance).

        Unlike ``pin``/``pin_rotating`` this NEVER issues a block read:
        members already resident are pinned now; the rest pin lazily
        when a demand fetch or prefetch installs them (``_install``).
        Bounded by ``tier_pin_budget`` (half the frame pool) and the
        hard ``max_pinned`` ceiling, so CLOCK always finds a victim.
        Rows leaving the set unpin unless a hard or rotating pin also
        holds their frame.
        """
        ids = np.atleast_1d(np.asarray(node_ids, np.int64)).ravel()
        new = {int(n) for n in ids if n >= 0}
        if len(new) > self.tier_pin_budget:
            # deterministic truncation; callers wanting priority order
            # should pre-truncate before handing the set over
            new = set(sorted(new)[: self.tier_pin_budget])
        with self._cond:
            for node in self._tier_pins - new:
                f = self.frame_of.get(node)
                if f is not None and node not in self._hard_pins \
                        and node not in self._rotating_set:
                    self.pinned[f] = False
            self._tier_pins = new
            for node in new:
                f = self.frame_of.get(node)
                if f is not None \
                        and int(self.pinned.sum()) < self.max_pinned:
                    self.pinned[f] = True

    # ------------------------------------------------------------ maintenance
    def invalidate(self) -> None:
        """Drop every frame (after graph surgery rewrites adjacency rows).

        Counters survive; pins are re-established by the engine.  The
        epoch bump discards any in-flight read raced against the
        surgery — its (possibly stale) bytes never enter a frame.
        """
        with self._cond:
            self._epoch += 1
            self.frame_of.clear()
            self.frame_node[:] = -1
            self.ref[:] = False
            self.lives[:] = 0
            self.pinned[:] = False
            self._rotating.clear()
            self._rotating_set.clear()
            self._spec_resident.clear()
            self._freq.clear()

    def reset_counters(self) -> None:
        with self._cond:
            self.hits = self.misses = self.block_reads = 0
            self.prefetch_batches = self.batched_reads = 0
            self.prefetch_issued = self.prefetch_completed = 0
            self.prefetch_hits = self.prefetch_wasted = 0
            self.prefetch_cancelled = 0

    def note_prefetch_issued(self, n: int = 1) -> None:
        with self._cond:
            self.prefetch_issued += n

    def note_prefetch_cancelled(self, n: int = 1) -> None:
        with self._cond:
            self.prefetch_cancelled += n

    @property
    def stats(self) -> CacheStats:
        with self._cond:
            return CacheStats(hits=self.hits, misses=self.misses,
                              block_reads=self.block_reads,
                              prefetch_batches=self.prefetch_batches,
                              batched_reads=self.batched_reads)

    @property
    def io_stats(self) -> IoStats:
        with self._cond:
            return IoStats(hits=self.hits, misses=self.misses,
                           block_reads=self.block_reads,
                           prefetch_batches=self.prefetch_batches,
                           batched_reads=self.batched_reads,
                           prefetch_issued=self.prefetch_issued,
                           prefetch_completed=self.prefetch_completed,
                           prefetch_hits=self.prefetch_hits,
                           prefetch_wasted=self.prefetch_wasted,
                           prefetch_cancelled=self.prefetch_cancelled)

    @property
    def hit_rate(self) -> float:
        with self._cond:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    @property
    def resident(self) -> int:
        with self._cond:
            return len(self.frame_of)
