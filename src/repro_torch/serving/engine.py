"""Batched serving engines: LM continuous batching + vector-search routing.

Port of ``repro/serving/engine.py``.  Two front doors live here:

* ``ServingEngine`` — slot-based continuous batching for LM decode: a
  fixed pool of B decode slots; finished sequences free their slot and
  the next queued request is prefilled into it.  The scheduler is
  host-side, with the reference's admission, offset grouping, EOS and
  ``max_len`` rules — and its slot clobbering (see the class).
* ``VectorSearchFrontend`` — micro-batching router for retrieval: single
  queries coalesce into fixed-shape batches and dispatch to any of the
  port's search backends (every tier, and a database born empty), with
  the adapt layer's maintainer observing every dispatched chunk and an
  attached ingest queue pumped once a flush.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import SearchStats
from repro_torch.models import model as M
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


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (S,) int
    max_new_tokens: int = 16
    out: Optional[np.ndarray] = None


class ServingEngine:
    """Continuous batching over ``slots`` decode slots of one cache.

    Prompts are fed token by token through ``decode_step`` into their
    slot, and each decode call serves every active slot at one write
    offset.  As in the reference, a call writes K/V (and advances SSM
    state) for ALL rows at that offset, so slots at other offsets have
    their caches overwritten: requests served together can decode other
    tokens than each served alone.  Kept for parity
    (``tests/test_torch_lm_serving.py`` shows both packages doing it).
    """

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_len: int = 128, eos_id: int = 1):
        self.cfg, self.params = cfg, params
        self.slots, self.max_len, self.eos = slots, max_len, eos_id
        self.device = params.device
        self.cache = M.init_cache(cfg, slots, max_len, self.device)
        self.pos = np.zeros(slots, np.int64)       # next write offset
        self.budget = np.zeros(slots, np.int64)    # remaining new tokens
        self.active: list[Optional[Request]] = [None] * slots
        self.last_tok = np.zeros(slots, np.int64)

    def _decode(self, tokens: np.ndarray, pos: int) -> np.ndarray:
        """One decode call for every slot; returns each row's argmax."""
        toks = torch.as_tensor(tokens, dtype=torch.int32).to(self.device)
        with torch.no_grad():
            logits, self.cache = M.decode_step(self.cfg, self.params, toks,
                                               self.cache, pos)
        return logits[:, -1].argmax(-1).cpu().numpy()

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Feed the prompt token by token through decode (slot-local
        prefill, as the reference does it)."""
        for t in req.prompt.astype(np.int64):
            tok = np.zeros((self.slots, 1), np.int32)
            tok[slot, 0] = int(t)
            nxt = self._decode(tok, int(self.pos[slot]))
            self.pos[slot] += 1
        self.last_tok[slot] = int(nxt[slot])
        self.budget[slot] = req.max_new_tokens
        req.out = np.asarray([int(nxt[slot])], np.int64)
        self.active[slot] = req

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve all requests to completion; returns them with .out filled,
        in order of completion."""
        pending = list(requests)
        done: list[Request] = []
        while pending or any(a is not None for a in self.active):
            for s in range(self.slots):              # admit
                if self.active[s] is None and pending:
                    self.pos[s] = 0
                    self._prefill_into_slot(s, pending.pop(0))
            toks = self.last_tok.astype(np.int32)[:, None]
            groups: dict[int, list[int]] = {}
            for s in range(self.slots):
                if self.active[s] is not None:
                    groups.setdefault(int(self.pos[s]), []).append(s)
            for off, ss in groups.items():           # one call per offset
                nxt_all = self._decode(toks, off)
                for s in ss:
                    nxt = int(nxt_all[s])
                    req = self.active[s]
                    req.out = np.append(req.out, nxt)
                    self.pos[s] += 1
                    self.budget[s] -= 1
                    self.last_tok[s] = nxt
                    if (nxt == self.eos or self.budget[s] <= 0
                            or self.pos[s] >= self.max_len - 1):
                        done.append(req)
                        self.active[s] = None
        return done
