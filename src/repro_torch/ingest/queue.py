"""Ingest-while-serving: batched concurrent upserts with locality order.

A copy of ``repro/ingest/queue.py`` (numpy and threading only).

``IngestQueue`` is the write-side twin of the serving frontend's
micro-batcher: concurrent producers ``put()`` rows (with optional
caller keys/labels) and get a ``Ticket`` back immediately; the queue
coalesces everything pending into graph insertions of
``IngestSpec.batch_size`` rows.  ``pump()`` flushes one batch — the
serving frontend calls it after every search flush, so ingest
interleaves with serving instead of competing with it — and
``flush()`` drains the queue (e.g. at the end of a stream).

Each coalesced batch is Slipstream-style locality grouped before it
hits the graph (``locality_order``): rows are sorted by a random-
hyperplane LSH code, so near-identical rows insert adjacently and the
engine's sequential in-batch linking sees its neighbors immediately.
``Database.upsert`` undoes the permutation before returning, so every
ticket still resolves to gids in ITS caller's row order.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np


def locality_order(vectors: np.ndarray, n_bits: int = 16,
                   seed: int = 0) -> np.ndarray:
    """A permutation sorting rows by random-hyperplane LSH code —
    nearby rows end up adjacent.  Deterministic in ``(seed, vectors)``."""
    v = np.asarray(vectors, np.float32)
    b, d = v.shape
    if b <= 2:
        return np.arange(b)
    rng = np.random.default_rng(seed)
    n_bits = min(n_bits, 62)
    planes = rng.standard_normal((d, n_bits)).astype(np.float32)
    bits = (v @ planes) > 0.0
    code = bits @ (np.int64(1) << np.arange(n_bits, dtype=np.int64))
    return np.argsort(code, kind="stable")


class Ticket:
    """Resolves to the assigned gids (caller row order) once the batch
    holding these rows has been inserted."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._gids: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("ingest ticket not resolved in time")
        if self._error is not None:
            raise self._error
        return self._gids

    @property
    def gids(self) -> np.ndarray:
        return self.wait(0.0) if self.done() else self.wait()

    def _resolve(self, gids: np.ndarray) -> None:
        self._gids = gids
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()


class IngestQueue:
    """Batches concurrent ``upsert`` traffic into the database.

    Construct via ``db.ingest_queue()``.  Thread-safe producers; any
    thread may pump (the database's mutate lock serializes the actual
    insertions)."""

    def __init__(self, db, batch_size: Optional[int] = None):
        from repro_torch.db.spec import IngestSpec
        self.db = db
        ing = db.spec.ingest or IngestSpec()
        self.batch_size = int(batch_size or ing.batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, "
                             f"got {self.batch_size}")
        self._lock = threading.Lock()
        self._pending: list = []     # (ticket, vectors, keys, labels)
        self._depth_rows = 0
        self.rows_enqueued = 0
        self.batches_flushed = 0
        reg = getattr(db, "registry", None)
        if reg is not None and reg.enabled:
            reg.register_collector(lambda: {
                "catapultdb_ingest_queue_depth": float(self.depth),
                "catapultdb_ingest_queue_rows_enqueued":
                    float(self.rows_enqueued),
                "catapultdb_ingest_queue_batches_flushed":
                    float(self.batches_flushed)})

    @property
    def depth(self) -> int:
        return self._depth_rows

    def put(self, vectors: np.ndarray, keys=None, labels=None) -> Ticket:
        """Enqueue rows; returns a ``Ticket`` resolving to their gids."""
        v = np.ascontiguousarray(vectors, np.float32)
        if v.ndim == 1:
            v = v[None, :]
        if keys is not None and len(keys) != v.shape[0]:
            raise ValueError(f"{len(keys)} keys for {v.shape[0]} rows")
        t = Ticket()
        with self._lock:
            self._pending.append((t, v, keys, labels))
            self._depth_rows += v.shape[0]
            self.rows_enqueued += v.shape[0]
        return t

    def _take_batch(self) -> list:
        """Pop up to ``batch_size`` rows of pending entries, splitting
        an oversized entry so a giant put cannot stall the flush."""
        taken: list = []
        rows = 0
        with self._lock:
            while self._pending and rows < self.batch_size:
                t, v, keys, labels = self._pending[0]
                room = self.batch_size - rows
                if v.shape[0] <= room:
                    self._pending.pop(0)
                    taken.append((t, v, keys, labels, True))
                    rows += v.shape[0]
                else:
                    head_t = Ticket()   # partial slice gets its own leg
                    taken.append((head_t, v[:room],
                                  keys[:room] if keys is not None else None,
                                  labels[:room] if labels is not None
                                  else None, False))
                    self._pending[0] = (
                        t, v[room:],
                        keys[room:] if keys is not None else None,
                        labels[room:] if labels is not None else None)
                    # the original ticket resolves when its TAIL lands;
                    # chain the head's gids onto it
                    t._head_legs = getattr(t, "_head_legs", [])
                    t._head_legs.append(head_t)
                    rows += room
                self._depth_rows -= min(v.shape[0], room)
        return taken

    def _insert(self, taken: list) -> None:
        keyed = [e for e in taken if e[2] is not None]
        plain = [e for e in taken if e[2] is None]
        for group in (plain, keyed):
            if not group:
                continue
            vecs = np.concatenate([e[1] for e in group])
            keys = ([k for e in group for k in e[2]]
                    if group is keyed else None)
            labels = None
            if any(e[3] is not None for e in group):
                labels = np.concatenate([
                    np.asarray(e[3], np.int32) if e[3] is not None
                    else np.zeros(e[1].shape[0], np.int32)
                    for e in group])
            try:
                gids = self.db.upsert(vecs, labels, keys=keys)
            except BaseException as exc:
                for e in group:
                    e[0]._fail(exc)
                continue
            pos = 0
            for e in group:
                b = e[1].shape[0]
                out = gids[pos: pos + b]
                pos += b
                if e[4]:
                    legs = getattr(e[0], "_head_legs", None)
                    if legs:
                        out = np.concatenate(
                            [leg.wait(0.0) for leg in legs] + [out])
                    e[0]._resolve(out)
                else:
                    e[0]._resolve(out)

    def pump(self, max_batches: int = 1) -> int:
        """Flush up to ``max_batches`` coalesced batches; returns rows
        inserted.  The serving frontend calls this once per flush."""
        total = 0
        for _ in range(max_batches):
            taken = self._take_batch()
            if not taken:
                break
            self._insert(taken)
            self.batches_flushed += 1
            total += sum(e[1].shape[0] for e in taken)
        return total

    def flush(self) -> int:
        """Drain everything pending; returns rows inserted."""
        total = 0
        while True:
            n = self.pump()
            if not n:
                return total
            total += n
