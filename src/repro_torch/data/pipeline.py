"""Deterministic sharded data pipeline with async host prefetch.

A copy of ``repro/data/pipeline.py`` (numpy and threads; the port
imports nothing of the reference): the same batches for the same
``(seed, step, host_id)``.

Production posture: each host materializes only its shard of the global
batch, derived from (seed, step, host_id) — restart-safe (a resumed run
regenerates the identical stream from the checkpointed step) and
elastic-safe (re-slicing by the new host count keeps the *global* batch
sequence identical).  ``Prefetcher`` overlaps host batch synthesis with
device compute via a background thread and a bounded queue.

Synthetic corpora: token streams from a mixture of per-document Zipfian
unigram models — enough structure for loss to fall, zero external data.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, n_hosts: int = 1, host_id: int = 0,
                 extras: Optional[dict] = None):
        assert global_batch % n_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.extras = extras or {}

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for (step, host) — the restart contract."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        # mixture of "documents": each row repeats its document token with
        # 10% noise — a low-entropy, provably learnable stream (the model
        # learns the copy-previous bigram; CE floor ≈ 0.1·ln V + H(0.1)).
        doc = rng.integers(0, self.vocab, self.local_batch)
        toks = np.broadcast_to(doc[:, None],
                               (self.local_batch, self.seq)).copy()
        noise = rng.random((self.local_batch, self.seq)) < 0.1
        toks[noise] = rng.integers(0, self.vocab, int(noise.sum()))
        out = {"tokens": toks.astype(np.int32)}
        for name, shape_dtype in self.extras.items():
            shape, dtype = shape_dtype
            out[name] = rng.normal(size=(self.local_batch,) + shape
                                   ).astype(dtype)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Bounded background prefetch of host batches (overlap with compute)."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(make_batch(step), timeout=0.1)
                    step += 1
                except queue.Full:
                    continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self, timeout: float = 60.0) -> dict:
        return self._q.get(timeout=timeout)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2.0)
