"""VectorSearchEngine — the RAM-tier facade over the paper's machinery.

Port of ``repro/core/engine.py``.  One engine object = one index + one
acceleration mode:

* ``mode='diskann'``   — vanilla Vamana beam search from the medoid
                         (the paper's primary baseline),
* ``mode='catapult'``  — CatapultDB: LSH-bucketed shortcut layer
                         (the paper's contribution),
* ``mode='lsh_apg'``   — static data-side LSH entry points (baseline).

Orthogonal features, composable with every mode as in the reference:

* ``build(labels=, n_labels=)`` — FilteredVamana stitched graph,
  per-label entry points and predicate-constrained traversal,
* ``pq_subspaces=M`` — DiskANN's PQ traversal distances with a
  full-precision rerank of the final beam,
* ``insert``/``delete``/``consolidate`` — FreshVamana online updates
  (tombstones), and ``search_two_phase``.

The search path runs on the engine's ``device`` (the card by default);
the host keeps numpy mirrors for graph surgery (build, insert,
consolidate).  An insert writes only the rows it touched back to the
device; a consolidate uploads the adjacency whole.  The mirrors are
views supplied by a storage backend — ``RamStore`` arrays here, the
memmap'd block file of ``DiskStore`` for the disk tier
(``repro_torch.store.io_engine``), which swaps the backend in through
``_make_store``.
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import buckets as bk
from repro_torch.core import catapult as cat
from repro_torch.core import filters as flt
from repro_torch.core import insert as ins
from repro_torch.core import lsh_apg as apg
from repro_torch.core import pq as pq_mod
from repro_torch.core.beam_search import (SearchSpec, beam_search,
                                          beam_search_l2, l2_dist_fn)
from repro_torch.core.vamana import VamanaParams, build_vamana, medoid_index
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_hop import FusedL2Hop, FusedPQHop


class SearchStats(NamedTuple):
    hops: np.ndarray          # (B,) node expansions
    ndists: np.ndarray        # (B,) distance computations
    used: np.ndarray          # (B,) bool catapult used (catapult mode only)
    won: np.ndarray           # (B,) bool catapult beat fallback
    # disk-backed engines only (None on the RAM path):
    block_reads: Optional[np.ndarray] = None   # (B,) node blocks read
    cache_hits: Optional[np.ndarray] = None    # (B,) node cache hits


class RamStore:
    """Device-memory-scale backend: plain numpy arrays on the host."""

    def __init__(self, vectors: np.ndarray, adjacency: np.ndarray):
        self.vectors = vectors        # (capacity, d) float32
        self.adjacency = adjacency    # (capacity, R) int32, -1 padded

    @classmethod
    def allocate(cls, capacity: int, dim: int, degree: int) -> 'RamStore':
        return cls(np.zeros((capacity, dim), np.float32),
                   np.full((capacity, degree), -1, np.int32))

    def flush(self) -> None:          # RAM is always "durable enough"
        pass

    def close(self) -> None:
        pass


class DiskStore:
    """Disk-resident backend: views into a block-aligned store file.

    ``vectors``/``adjacency`` are strided memmap views into per-node
    blocks (``repro_torch.store.layout``), so insert-time graph surgery
    writes disk pages in place; ``flush`` persists them plus header
    metadata.
    """

    def __init__(self, block_store):
        self.block_store = block_store
        self.vectors = block_store.vectors
        self.adjacency = block_store.adjacency

    @classmethod
    def create(cls, path: str, capacity: int, dim: int, degree: int,
               has_labels: bool = False) -> 'DiskStore':
        from repro_torch.store import layout   # lazy: breaks an import cycle
        return cls(layout.create_store(path, capacity=capacity, dim=dim,
                                       degree=degree, has_labels=has_labels))

    @classmethod
    def open(cls, path: str, mode: str = 'r+') -> 'DiskStore':
        from repro_torch.store import layout
        return cls(layout.open_store(path, mode=mode))

    def flush(self, **header_updates) -> None:
        self.block_store.flush(**header_updates)

    def close(self) -> None:
        self.block_store.close()


def brute_force_knn(vectors: np.ndarray, queries: np.ndarray, k: int,
                    labels: np.ndarray | None = None,
                    filter_labels: np.ndarray | None = None,
                    exclude: np.ndarray | None = None) -> np.ndarray:
    """Exact ground truth (chunked to bound memory).  ``filter_labels``
    (with ``labels``) restricts each filtered lane (label >= 0) to its
    label; ``exclude`` hides rows (e.g. tombstoned ones)."""
    out = np.zeros((queries.shape[0], k), np.int32)
    for lo in range(0, queries.shape[0], 256):
        q = queries[lo: lo + 256]
        d = ((q[:, None, :] - vectors[None, :, :]) ** 2).sum(-1)
        if exclude is not None:
            d[:, exclude] = np.inf
        if filter_labels is not None and labels is not None:
            fl = filter_labels[lo: lo + 256]
            mism = (labels[None, :] != fl[:, None]) & (fl[:, None] >= 0)
            d[mism] = np.inf
        out[lo: lo + 256] = np.argsort(d, axis=1)[:, :k]
    return out


def recall_at_k(found: np.ndarray, truth: np.ndarray) -> float:
    """Fraction of true k-NN present in the returned k (paper's metric)."""
    k = truth.shape[1]
    hits = sum(len(set(f[:k].tolist()) & set(t.tolist())) for f, t in
               zip(found, truth))
    return hits / (truth.shape[0] * k)


@dataclasses.dataclass
class VectorSearchEngine:
    mode: str = 'catapult'
    vamana: VamanaParams = dataclasses.field(default_factory=VamanaParams)
    n_bits: int = 8                 # L (paper default)
    bucket_capacity: int = 40       # b (paper default)
    apg_entries: int = 8            # LSH-APG rows kept per bucket
    pq_subspaces: Optional[int] = None
    seed: int = 0
    capacity: Optional[int] = None  # adjacency row preallocation for inserts
    store: Optional[object] = None  # storage backend; default RamStore
    # traversal hop implementation: "unfused" (gather-distance kernel +
    # torch merge) or "fused" (one fused-hop kernel per hop).  Results
    # are bit-identical; filtered searches always take the composed hop.
    hop_backend: str = 'unfused'
    device: object = 'cuda'
    # workload-adaptation hooks (repro_torch.adapt): the utility gate
    # routes catapult-mode dispatch through the plain diskann path when
    # the maintainer decides shortcuts stopped paying off, so a gated-off
    # engine runs exactly what a diskann-mode engine runs.
    # ``catapult_enabled`` is the persistent gate verdict;
    # ``catapult_override`` the maintainer's transient one-batch override
    # for shadow-baseline/probe batches; ``adapt_state`` the maintainer's
    # telemetry of this engine.
    catapult_enabled: bool = True
    catapult_override: Optional[bool] = None
    adapt_state: Optional[object] = None

    # populated by build()
    n_active: int = 0
    medoid: int = 0
    n_labels: int = 0
    filtered: bool = False

    @property
    def catapult_active(self) -> bool:
        """Effective dispatch switch: the transient override when one is
        armed, else the persistent gate."""
        return (self.catapult_override if self.catapult_override is not None
                else self.catapult_enabled)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.mode not in ('catapult', 'diskann', 'lsh_apg'):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.hop_backend not in ('unfused', 'fused'):
            raise ValueError(f"unknown hop_backend {self.hop_backend!r}")

    def build(self, vectors: np.ndarray, labels: np.ndarray | None = None,
              n_labels: int | None = None,
              prebuilt=None) -> 'VectorSearchEngine':
        """prebuilt: optional (adjacency, medoid[, label_entries]) — share
        one Vamana build across engines (or carry the reference's graph
        across); a filtered engine takes all three."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        n, d = vectors.shape
        cap = self.capacity or n
        self.filtered = labels is not None
        if self.filtered:
            if n_labels is None:
                raise ValueError("labels need n_labels")
            if prebuilt is not None:
                adj, med, entries = prebuilt
            else:
                adj, med, entries = flt.build_stitched_graph(
                    vectors, labels, n_labels, self.vamana,
                    device=self.device)
            self.n_labels = n_labels
            self._label_entry_np = np.asarray(entries, np.int32).copy()
            self._labels_np = np.zeros(cap, np.int32)
            self._labels_np[:n] = labels.astype(np.int32)
        else:
            if prebuilt is not None:
                adj, med = prebuilt[0], prebuilt[1]
            else:
                adj, med = build_vamana(vectors, self.vamana, capacity=cap,
                                        device=self.device)
            self._label_entry_np = None
            self._labels_np = None
        # the host mirrors are views of the storage backend from here on
        # (a prebuilt graph is copied in, never shared by reference)
        if self.store is None:
            self.store = self._make_store(cap, d, adj.shape[1])
        sv, sa = self.store.vectors, self.store.adjacency
        if sv.shape != (cap, d) or sa.shape != (cap, adj.shape[1]):
            raise ValueError(f"store geometry {sv.shape}, {sa.shape} does "
                             f"not match ({cap}, {d}), degree {adj.shape[1]}")
        rows = min(adj.shape[0], cap)
        sa[:rows] = adj[:rows]
        sa[rows:] = -1
        sv[:n] = vectors
        sv[n:] = 0.0
        self._adj_np = sa
        self._vec_np = sv
        self._tomb_np = np.zeros(cap, bool)
        # rows >= n are tombstoned until inserted
        self._tomb_np[n:] = True
        self.n_active, self.medoid = n, int(med)
        self.capacity = cap
        self._init_aux(vectors)
        self._sync_device()
        return self

    def _make_store(self, capacity: int, dim: int, degree: int):
        """Backend factory — the disk engine swaps RAM for a block file."""
        return RamStore.allocate(capacity, dim, degree)

    def _init_aux(self, vectors: np.ndarray,
                  pq_codebook: pq_mod.PQCodebook | None = None) -> None:
        """The mode's auxiliary state: catapult LSH + buckets, the
        LSH-APG table, the PQ codebook + codes; deterministic in (seed,
        vectors).

        Each draw has a CPU ``torch.Generator`` of its own (the
        reference splits one ``jax.random`` key; torch cannot replay
        it): ``seed`` for the catapult hyperplanes, ``seed + 1`` for
        the codebook's initial rows and ``seed + 2`` for the LSH-APG
        hyperplanes, so one seed gives the same state on the CPU and on
        the card.  ``pq_codebook`` skips the training (a carried-over
        codebook, as the reference's disk reopen passes its persisted
        one); the codes are encoded from it either way."""
        x = None
        if self.mode == 'catapult':
            gen = torch.Generator().manual_seed(self.seed)
            self._cat = cat.make_catapult_state(
                gen, vectors.shape[1], self.n_bits, self.bucket_capacity,
                self.device)
        elif self.mode == 'lsh_apg':
            x = torch.as_tensor(vectors, device=self.device)
            gen = torch.Generator().manual_seed(self.seed + 2)
            self._apg = apg.build_lsh_apg(x, gen, self.n_bits,
                                          self.apg_entries, self.device)
        if self.pq_subspaces:
            if x is None:
                x = torch.as_tensor(vectors, device=self.device)
            if pq_codebook is not None:
                if pq_codebook.n_subspaces != self.pq_subspaces:
                    raise ValueError(
                        f"codebook has {pq_codebook.n_subspaces} subspaces, "
                        f"the engine {self.pq_subspaces}")
                self._pq = pq_mod.PQCodebook(
                    pq_codebook.centroids.to(self.device))
            else:
                gen = torch.Generator().manual_seed(self.seed + 1)
                self._pq = pq_mod.train_pq(gen, x, self.pq_subspaces,
                                           device=self.device)
            codes = np.zeros((self._vec_np.shape[0], self.pq_subspaces),
                             np.int32)
            codes[:x.shape[0]] = pq_mod.encode(self._pq, x).cpu().numpy()
            self._codes_np = codes

    # ---------------------------------------------------------------- device
    def _upload(self, a: np.ndarray | None) -> torch.Tensor | None:
        """A host mirror on the engine's device (shares memory with it on
        the CPU)."""
        return None if a is None else torch.as_tensor(a, device=self.device)

    def _sync_device(self) -> None:
        """Upload every host mirror whole (build, and after a codebook
        or graph is carried over)."""
        up = self._upload
        self._adj = up(self._adj_np)
        self._vec = up(self._vec_np)
        self._tomb = up(self._tomb_np)
        self._labels = up(self._labels_np)
        self._label_entry = up(self._label_entry_np)
        self._codes = up(self._codes_np) if self.pq_subspaces else None

    @property
    def cache_stats(self):
        """Uniform across tiers: the RAM engine has no block cache, so
        its record is all-zero rather than absent."""
        from repro_torch.store.cache import CacheStats
        return CacheStats(hits=0, misses=0, block_reads=0,
                          prefetch_batches=0, batched_reads=0)

    def io_stats(self, reset: bool = False):
        """Tier-uniform typed I/O record; the RAM engine does no block
        I/O, so the record is all-zero (and ``reset`` a no-op)."""
        from repro_torch.store.cache import ZERO_IO_STATS
        return ZERO_IO_STATS

    def tombstone_fraction(self) -> float:
        """Dead-row share of the active range — the maintainer's
        background-consolidate trigger signal."""
        n = int(self.n_active)
        return float(self._tomb_np[:n].sum()) / n if n else 0.0

    # ---------------------------------------------------------------- search
    def search(self, queries: np.ndarray, k: int,
               beam_width: int | None = None,
               filter_labels: np.ndarray | None = None,
               max_iters: int | None = None,
               publish_mask: np.ndarray | None = None,
               trace=None
               ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """Batched k-NN search.  Returns (ids (B,k), dists (B,k), stats).

        ``filter_labels`` ((B,) int, -1 = unfiltered lane) constrains
        each lane to its label on a filtered engine.
        ``publish_mask`` ((B,) bool) opts lanes out of the catapult
        bucket publish and usage stats.  ``trace`` is an optional
        ``repro_torch.obs.TraceRecorder``: the route and rerank stages
        are timed into it (each synced with the device).
        """
        q = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                            device=self.device)
        b = q.shape[0]
        l = beam_width or max(2 * k, 16)
        # PQ mode reranks the *entire* final beam at full precision
        # (DiskANN's fetch of the candidate list), so the search returns
        # the whole beam, not just k PQ-approximate winners.
        # max_iters is a SAFETY bound, not a budget: Algorithm 1 stops
        # when the beam converges.
        spec = SearchSpec(beam_width=l, k=(l if self.pq_subspaces else k),
                          max_iters=max_iters or (4 * l + 64),
                          hop_backend=self.hop_backend)
        flabels = (torch.as_tensor(np.asarray(filter_labels, np.int32),
                                   device=self.device)
                   if filter_labels is not None
                   else torch.full((b,), -1, dtype=torch.int32,
                                   device=self.device))
        stage = trace.stage if trace is not None else (lambda _: nullcontext())
        sync = trace is not None and self.device.type == "cuda"
        with stage("route"):
            res, used, won = self._dispatch(q, flabels, spec,
                                            publish_mask=publish_mask)
            if sync:
                torch.cuda.synchronize(self.device)
        ids, dists = res.ids, res.dists
        with stage("rerank"):
            if self.pq_subspaces:
                ids, dists = pq_mod.rerank(self._vec, q, ids, k)
                if sync:
                    torch.cuda.synchronize(self.device)
        stats = SearchStats(hops=res.hops.cpu().numpy(),
                            ndists=res.ndists.cpu().numpy(), used=used,
                            won=won)
        return ids.cpu().numpy(), dists.cpu().numpy(), stats

    def _dispatch(self, queries: torch.Tensor, flabels: torch.Tensor,
                  spec: SearchSpec, publish_mask=None):
        """Run the mode's traversal; returns (raw result, used, won).  A
        gated-off catapult engine (``catapult_active`` False) takes the
        diskann path."""
        b = queries.shape[0]
        pq = (self._pq, self._codes) if self.pq_subspaces else None
        if self.mode == 'catapult' and self.catapult_active:
            pm = (None if publish_mask is None
                  else torch.as_tensor(np.asarray(publish_mask, bool),
                                       device=self.device))
            new_cat, res, st = _search_catapult(
                self._cat, self._adj, self._vec, self._tomb, self._labels,
                self._label_entry, queries, flabels, self.medoid, spec, pq,
                pm)
            self._cat = new_cat
            return res, st.used.cpu().numpy(), st.won.cpu().numpy()
        if self.mode == 'lsh_apg':
            res = _search_apg(self._apg, self._adj, self._vec, self._tomb,
                              self._labels, queries, flabels, self.medoid,
                              spec)
        else:
            res = _search_diskann(self._adj, self._vec, self._tomb,
                                  self._labels, self._label_entry, queries,
                                  flabels, self.medoid, spec, pq)
        z = np.zeros(b, bool)
        return res, z, z

    def search_two_phase(self, queries: np.ndarray, k: int,
                         beam_width: int | None = None,
                         phase1_iters: int = 8
                         ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """Convergence-compacted search (beyond the paper).

        A lockstep batch pays max(hops) while catapults cut the *mean*.
        Phase 1 runs a short iteration budget for the whole batch, at
        full precision and unfiltered; phase 2 warm-restarts only the
        unconverged lanes from their phase-1 beams, without a result
        mask (as in the reference, so it can return tombstoned ids).
        The reference pads phase 2 to fixed chunks for its jit cache;
        lanes are independent, so here it is one call over the
        stragglers, with the same results.  ``used``/``won`` are the
        phase-1 catapult stats.
        """
        queries = np.ascontiguousarray(queries, np.float32)
        b = queries.shape[0]
        q = torch.as_tensor(queries, device=self.device)
        l = beam_width or max(2 * k, 16)
        spec1 = SearchSpec(beam_width=l, k=l, max_iters=phase1_iters,
                           hop_backend=self.hop_backend)
        unfiltered = torch.full((b,), -1, dtype=torch.int32,
                                device=self.device)
        if self.mode == 'catapult' and self.catapult_active:
            new_cat, res, st = _search_catapult(
                self._cat, self._adj, self._vec, self._tomb, None, None, q,
                unfiltered, self.medoid, spec1, None)
            self._cat = new_cat
            used, won = st.used.cpu().numpy(), st.won.cpu().numpy()
        else:
            res = _search_diskann(self._adj, self._vec, self._tomb, None,
                                  None, q, unfiltered, self.medoid, spec1,
                                  None)
            used = won = np.zeros(b, bool)
        ids = res.ids.cpu().numpy()
        dists = res.dists.cpu().numpy()
        hops = res.hops.cpu().numpy()
        ndists = res.ndists.cpu().numpy()
        conv = res.converged.cpu().numpy()

        if not conv.all():
            idx = np.nonzero(~conv)[0]
            spec2 = SearchSpec(beam_width=l, k=l, max_iters=4 * l + 64,
                               hop_backend=self.hop_backend)
            sel = torch.as_tensor(idx, device=self.device)
            res2 = beam_search_l2(self._adj, self._vec, q[sel],
                                  res.ids[sel].contiguous(), spec2)
            ids[idx] = res2.ids.cpu().numpy()
            dists[idx] = res2.dists.cpu().numpy()
            hops[idx] += res2.hops.cpu().numpy()
            ndists[idx] += res2.ndists.cpu().numpy()
        order = np.argsort(dists, axis=1)[:, :k]
        stats = SearchStats(hops=hops, ndists=ndists, used=used, won=won)
        return (np.take_along_axis(ids, order, 1),
                np.take_along_axis(dists, order, 1), stats)

    # ---------------------------------------------------------------- updates
    def insert(self, new_vectors: np.ndarray,
               labels: np.ndarray | None = None) -> np.ndarray:
        """FreshVamana batch insert; returns the assigned node ids.  Only
        the rows the batch touched are written to the device."""
        new_vectors = np.ascontiguousarray(new_vectors, np.float32)
        start = self.n_active
        vec = self._insert_table()
        self.n_active = ins.insert_batch(
            self._adj_np, self._vec_np, self.n_active, new_vectors,
            self.medoid, self.vamana, self._adj, vec)
        new = slice(start, self.n_active)
        self._tomb_np[new] = False
        self._tomb[new] = False
        if self._labels_np is not None:
            self._labels_np[new] = labels if labels is not None else 0
            self._labels[new] = torch.as_tensor(self._labels_np[new],
                                                device=self.device)
        if self.pq_subspaces:
            codes = pq_mod.encode(self._pq, vec[new])
            self._codes_np[new] = codes.cpu().numpy()
            self._codes[new] = codes
        return np.arange(start, self.n_active, dtype=np.int64)

    def _insert_table(self) -> torch.Tensor:
        """The device vector table an insert searches and writes its rows
        into: the engine's own mirror here."""
        return self._vec

    def insert_batch(self, new_vectors: np.ndarray,
                     labels: np.ndarray | None = None) -> np.ndarray:
        """Alias for :meth:`insert` — the mutable-tier spelling."""
        return self.insert(new_vectors, labels)

    def delete(self, ids: np.ndarray) -> None:
        """Tombstone ``ids`` and repair what could still steer a query
        onto them: catapult buckets drop the dead destinations, and a
        tombstoned medoid / label entry point is re-elected among the
        surviving nodes."""
        ids = np.atleast_1d(np.asarray(ids, np.int64)).ravel()
        ids = ids[ids >= 0]     # tolerate search()'s -1 padding lanes
        if ids.size == 0:
            return
        self._tomb_np = ins.delete(self._tomb_np, ids)
        self._tomb = self._upload(self._tomb_np)
        if self.mode == 'catapult':
            self._cat = dataclasses.replace(
                self._cat, buckets=bk.evict_ids(self._cat.buckets, ids))
        if self._tomb_np[self.medoid]:
            self.medoid = self._elect_medoid()
        if self.filtered:
            self._label_entry_np = flt.refresh_label_entries(
                self._label_entry_np, self._vec_np, self._labels_np,
                self._tomb_np, self.n_active)
            self._label_entry = self._upload(self._label_entry_np)

    def _elect_medoid(self) -> int:
        """Deterministic medoid re-election over the live rows."""
        live = (~self._tomb_np[: self.n_active]).nonzero()[0]
        if live.size == 0:
            return self.medoid
        return int(live[medoid_index(self._vec_np[live])])

    def consolidate(self) -> int:
        """Splice tombstoned nodes out of the graph (FreshVamana
        compaction); node ids stay stable.  Returns the number of
        repaired rows."""
        repaired = ins.consolidate(self._adj_np, self._vec_np,
                                   self._tomb_np, self.n_active, self.vamana)
        self._adj = self._upload(self._adj_np)
        return repaired


# ---------------------------------------------------------------------------
# search paths (functions of tensors only)
# ---------------------------------------------------------------------------

def _mk_dist(vec: torch.Tensor, hop_backend: str = 'unfused', pq=None):
    """The traversal's dist_fn: full-precision L2 over ``vec``, or with
    ``pq=(codebook, codes)`` PQ-ADC distances (built once per batch)."""
    if hop_backend == 'fused':
        # fused backends ARE dist_fns (the composed hop's kernel, so
        # catapult entry scoring is identical) that also let beam_search
        # run one fused-hop kernel per hop
        return FusedPQHop(*pq) if pq else FusedL2Hop(vec)
    return pq_mod.adc_dist_fn(*pq) if pq else l2_dist_fn(vec)


def _masks(tomb: torch.Tensor, labels, flabels):
    """Traversal constraints: the predicate mask of a filtered engine
    (``filters.make_filter_mask_fn``), and the result mask that hides
    tombstoned nodes."""
    def result_mask(ids):
        return ~tomb[ids.clamp(min=0).long()]

    neighbor_mask = (flt.make_filter_mask_fn(labels, flabels)
                     if labels is not None else None)
    return neighbor_mask, result_mask


def _search_diskann(adj, vec, tomb, labels, label_entry, queries, flabels,
                    medoid: int, spec: SearchSpec, pq=None):
    b = queries.shape[0]
    if label_entry is not None:
        starts = torch.where(flabels >= 0,
                             label_entry[flabels.clamp(min=0).long()], medoid)
    else:
        starts = torch.full((b,), medoid, dtype=torch.int32,
                            device=queries.device)
    nmask, rmask = _masks(tomb, labels, flabels)
    return beam_search(adj, queries, starts.to(torch.int32)[:, None], spec,
                       _mk_dist(vec, spec.hop_backend, pq),
                       neighbor_mask_fn=nmask, result_mask_fn=rmask)


def _search_apg(apg_index, adj, vec, tomb, labels, queries, flabels,
                medoid: int, spec: SearchSpec):
    # LSH-APG traverses at full precision, with or without PQ codes
    starts = apg.entry_points(apg_index, queries, medoid)
    nmask, rmask = _masks(tomb, labels, flabels)
    return beam_search(adj, queries, starts, spec,
                       _mk_dist(vec, spec.hop_backend),
                       neighbor_mask_fn=nmask, result_mask_fn=rmask)


def _search_catapult(cat_state, adj, vec, tomb, labels, label_entry, queries,
                     flabels, medoid: int, spec: SearchSpec, pq=None,
                     publish_mask=None):
    nmask, rmask = _masks(tomb, labels, flabels)
    return cat.catapulted_lookup(
        cat_state, adj, queries, spec, _mk_dist(vec, spec.hop_backend, pq),
        medoid, filter_labels=flabels, node_labels=labels,
        label_entry=label_entry, neighbor_mask_fn=nmask,
        result_mask_fn=rmask, publish_mask=publish_mask)
