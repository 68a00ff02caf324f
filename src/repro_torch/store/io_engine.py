"""DiskVectorSearchEngine — the paper's disk-resident deployment, measured.

Port of ``repro/store/io_engine.py``.  DiskANN's split: PQ-compressed
vectors and the traversal live in device memory; full-precision vectors
sit on disk in block-aligned node blocks and are fetched only to rerank.
Every node *expansion* also reads that node's block (the adjacency row
lives in it), so the traversal's hop count is the query's block-read
count, modulo caching.  Catapults cut hops, therefore catapults cut
block reads; this engine makes that measurable.

* on the device: adjacency (traversal gathers), PQ codes + codebook
  (traversal distances, through ``pq_adc`` / ``fused_hop_pq``),
  tombstones, labels, catapult buckets.  The full-precision vector
  table is never uploaded for a search — ``_sync_device`` installs a
  (1, d) dummy, so a full-precision path fails on shape instead of
  silently defeating the tiering.  An ``insert`` uploads the table for
  its own search and drops it before it returns.
* on disk: one block per node (vector + adjacency + label) in a
  ``layout.BlockStore``; the host mirrors are memmap views, so
  FreshVamana insert surgery mutates disk pages in place.  Device
  mirrors are always copies of them (``_upload``), never views.
* the I/O path: the beam search runs on the device and returns its
  expansion trace; each lane's trace ∪ final beam is fetched through the
  CLOCK ``NodeCache`` (misses are counted block reads) and the final
  rerank computes full-precision distances on the host from the bytes
  read off disk, in numpy float32 as the reference does.
* pinning: the medoid and per-label entry points are hard-pinned;
  catapult destinations rotate through the cache's soft-pin budget.

``mode='lsh_apg'`` and ``search_two_phase`` traverse at full precision
and raise here, as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.adapt import stats as adapt_stats
from repro_torch.core import buckets as bk
from repro_torch.core import catapult as cat
from repro_torch.core.beam_search import SearchSpec
from repro_torch.core.engine import DiskStore, SearchStats, VectorSearchEngine
from repro_torch.db.spec import IoSpec
from repro_torch.store.cache import IoStats, NodeCache
from repro_torch.store.layout import open_store
from repro_torch.store.pipeline import IoPipeline


def _adapt_sidecar(store_path: str) -> str:
    return store_path + ".adapt.npz"


def _io_sidecar(store_path: str) -> str:
    return store_path + ".io.json"


def read_io_sidecar(store_path: str) -> Optional[IoSpec]:
    """The persisted ``IoSpec`` next to a CTPL file, or None."""
    path = _io_sidecar(store_path)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return IoSpec.from_dict(json.load(f))


def default_pq_subspaces(dim: int) -> int:
    """Largest M in {8, 4, 2} dividing dim (PQ needs dim % M == 0)."""
    for m in (8, 4, 2):
        if dim % m == 0:
            return m
    return 1


@dataclasses.dataclass
class DiskVectorSearchEngine(VectorSearchEngine):
    """VectorSearchEngine over a block-aligned disk store + node cache."""

    store_path: str = 'index.ctpl'
    cache_frames: int = 2048
    # I/O engine config (None = the synchronous IoSpec() default; load()
    # resumes the persisted sidecar when the caller expressed no choice)
    io: Optional[IoSpec] = None

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.mode not in ('catapult', 'diskann'):
            # lsh_apg traverses at full precision — incompatible with the
            # PQ-on-device / vectors-on-disk split this engine models
            raise ValueError(f'disk engine supports catapult/diskann modes, '
                             f'got {self.mode!r}')

    # ------------------------------------------------------------- build/load
    def build(self, vectors: np.ndarray, labels: np.ndarray | None = None,
              n_labels: int | None = None,
              prebuilt=None) -> 'DiskVectorSearchEngine':
        if self.pq_subspaces is None:
            # the disk tier is only honest with compressed traversal
            # distances — full-precision ones would need the vectors on
            # the device
            self.pq_subspaces = default_pq_subspaces(vectors.shape[1])
        super().build(vectors, labels=labels, n_labels=n_labels,
                      prebuilt=prebuilt)
        bs = self.store.block_store
        if self.filtered:
            bs.labels[: self.n_active] = self._labels_np[: self.n_active]
        bs.flush(n_active=self.n_active, medoid=self.medoid,
                 has_labels=self.filtered)
        # the build-time codebook (CTPL v2 tail): a reopen traverses with
        # the very same ADC tables, even after post-build inserts
        bs.write_pq(self._pq.centroids.cpu().numpy())
        # CTPL v3 mutation state: tombstone bitmap + label entry table
        bs.write_tombstones(self._tomb_np)
        if self.filtered:
            bs.write_label_entries(self._label_entry_np)
        # a fresh build owns the path outright — drop any adapt sidecar
        # a previous index at this location left behind
        if os.path.exists(_adapt_sidecar(self.store_path)):
            os.remove(_adapt_sidecar(self.store_path))
        self._open_cache()
        self._write_io_sidecar()
        return self

    @classmethod
    def load(cls, store_path: str, mode: str = 'catapult',
             **engine_kwargs) -> 'DiskVectorSearchEngine':
        """Reopen a persisted index without rebuilding the graph.

        The PQ codebook comes from the CTPL v2 tail when present (ADC
        distances then equal the live engine's, post-build inserts
        included); a v1 file retrains it from (seed, stored vectors).
        The v3 tombstone bitmap and label entry table round-trip (older
        files derive "rows >= n_active are dead").  Catapult LSH planes
        are drawn from ``seed``; buckets start empty unless a
        ``<store>.adapt.npz`` sidecar exists, in which case the bucket
        table, adapt telemetry and utility-gate flag resume where the
        saving process left them.
        """
        bs = open_store(store_path)
        try:
            return cls._load_from(bs, store_path, mode, engine_kwargs)
        except BaseException:
            bs.close()     # don't leak the file handle + memmaps
            raise

    @classmethod
    def _load_from(cls, bs, store_path: str, mode: str,
                   engine_kwargs: dict) -> 'DiskVectorSearchEngine':
        entries = bs.read_label_entries()
        if bs.header.has_labels and entries is None:
            raise NotImplementedError(
                'labeled store without a label-entry table (pre-v3 file): '
                'rebuild, or re-save with a v3 writer')
        eng = cls(mode=mode, store_path=store_path, **engine_kwargs)
        if eng.io is None:
            # no caller preference: resume the I/O engine the index was
            # tuned with (the .io.json sidecar save()/build() wrote)
            eng.io = read_io_sidecar(store_path)
        codebook = bs.read_pq()
        if codebook is not None:
            eng.pq_subspaces = codebook.shape[0]
        elif eng.pq_subspaces is None:
            eng.pq_subspaces = default_pq_subspaces(bs.header.dim)
        eng.store = DiskStore(bs)
        eng._adj_np = bs.adjacency
        eng._vec_np = bs.vectors
        eng.filtered = bs.header.has_labels
        if eng.filtered:
            eng.n_labels = entries.size
            eng._label_entry_np = entries.copy()
            # host copy, not the memmap view: the mutation code owns this
            # array; insert() writes it through to the blocks
            eng._labels_np = np.array(bs.labels, np.int32)
        else:
            eng._labels_np = None
            eng._label_entry_np = None
        eng.n_active, eng.medoid = bs.n_active, bs.medoid
        eng.capacity = bs.capacity
        tomb = bs.read_tombstones()
        if tomb is None:            # pre-v3 file: only "not yet inserted"
            tomb = np.zeros(bs.capacity, bool)
            tomb[bs.n_active:] = True
        eng._tomb_np = tomb.copy()
        sidecar = _adapt_sidecar(store_path)
        adapt_z = None
        if mode == 'catapult' and os.path.exists(sidecar):
            with np.load(sidecar) as z:
                adapt_z = dict(z)
            if "cat_n_bits" in adapt_z:
                # the geometry the saved bucket table + telemetry were
                # built under outranks the caller's (likely default)
                # kwargs
                eng.n_bits = int(adapt_z["cat_n_bits"])
                eng.bucket_capacity = int(adapt_z["cat_bucket_capacity"])
                eng.seed = int(adapt_z["cat_seed"])
        # the active rows go up once to be encoded (and, without a
        # persisted codebook, to train one); _init_aux keeps no
        # reference to that upload
        eng._init_aux(
            np.ascontiguousarray(bs.vectors[: bs.n_active], np.float32),
            pq_codebook=(None if codebook is None else
                         convert.pq_codebook_from_numpy(codebook,
                                                        eng.device)))
        if adapt_z is not None:
            buckets = bk.from_arrays(adapt_z, eng.device)
            if buckets.ids.shape != eng._cat.buckets.ids.shape:
                # a pre-geometry sidecar saved under non-default knobs:
                # refuse rather than serve wrong catapult destinations
                raise ValueError(
                    f"adapt sidecar bucket table "
                    f"{tuple(buckets.ids.shape)} does not match this "
                    f"engine's catapult geometry "
                    f"{tuple(eng._cat.buckets.ids.shape)}; reopen with the "
                    f"n_bits/bucket_capacity the index was built with")
            eng._cat = cat.CatapultState(lsh=eng._cat.lsh, buckets=buckets)
            eng.adapt_state = adapt_stats.telemetry_from_arrays(
                adapt_z, device=eng.device)
            if "catapult_enabled" in adapt_z:
                eng.catapult_enabled = bool(adapt_z["catapult_enabled"])
        eng._sync_device()
        eng._open_cache()
        return eng

    def _make_store(self, capacity: int, dim: int, degree: int) -> DiskStore:
        return DiskStore.create(self.store_path, capacity=capacity, dim=dim,
                                degree=degree, has_labels=self.filtered)

    def _open_cache(self) -> None:
        self.io = self.io or IoSpec()
        self._cache = NodeCache(self.store.block_store,
                                capacity=self.cache_frames,
                                admission=self.io.admission)
        self._pipeline = (IoPipeline(self._cache, workers=self.io.workers,
                                     queue_depth=self.io.queue_depth)
                          if self.io.pipeline else None)
        self._repin()

    def _write_io_sidecar(self) -> None:
        tmp = _io_sidecar(self.store_path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.io.to_dict(), f, indent=1)
        os.replace(tmp, _io_sidecar(self.store_path))

    def _quiesce_io(self) -> None:
        """Wait out every speculative read in flight — graph surgery is
        about to rewrite the blocks those reads would install."""
        if self._pipeline is not None:
            self._pipeline.drain()

    def _repin(self) -> None:
        self._cache.pin(self.medoid)
        if self._label_entry_np is not None:
            self._cache.pin(self._label_entry_np)

    def reset_io(self) -> None:
        """Cold-start the I/O path: drop every cached frame and counter,
        then re-establish the structural pins."""
        self._quiesce_io()
        self._cache.invalidate()
        self._cache.reset_counters()
        self._repin()

    def io_stats(self, reset: bool = False) -> IoStats:
        """The tier-uniform typed I/O record (``db.io_stats()``);
        ``reset=True`` returns the snapshot, then cold-starts the I/O
        path (counters and cache, pins re-established)."""
        snap = self._cache.io_stats
        if reset:
            self.reset_io()
        return snap

    @property
    def cache(self) -> NodeCache:
        return self._cache

    @property
    def pipeline(self) -> Optional[IoPipeline]:
        return self._pipeline

    @property
    def cache_stats(self):
        """Uniform tier spelling of the node cache's counters."""
        return self._cache.stats

    # ------------------------------------------------------------- device
    def _upload(self, a: np.ndarray | None) -> torch.Tensor | None:
        """A contiguous copy on the device, on the CPU too: a memmap view
        must not become a tensor that aliases the block file."""
        if a is None:
            return None
        return torch.tensor(np.ascontiguousarray(a), device=self.device)

    def _sync_device(self) -> None:
        up = self._upload
        self._adj = up(self._adj_np)
        self._tomb = up(self._tomb_np)
        self._labels = up(self._labels_np)
        self._label_entry = up(self._label_entry_np)
        self._codes = up(self._codes_np)
        # full-precision vectors stay on disk — see module docstring
        self._vec = torch.zeros((1, self._vec_np.shape[1]),
                                device=self.device)

    def _insert_table(self) -> torch.Tensor:
        """A transient upload of the whole host vector table for the
        insert's search (the reference's insert uploads it too); dropped
        when the insert returns."""
        return torch.as_tensor(np.array(self._vec_np, np.float32),
                               device=self.device)

    # ------------------------------------------------------------- search
    def search(self, queries: np.ndarray, k: int,
               beam_width: int | None = None,
               filter_labels: np.ndarray | None = None,
               max_iters: int | None = None,
               publish_mask: np.ndarray | None = None,
               trace=None
               ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """Beam search on the device, block fetch + rerank through the
        cache on the host.  ``trace`` (optional
        ``repro_torch.obs.TraceRecorder``) times the route, fetch,
        speculate and rerank stages."""
        q_np = np.ascontiguousarray(queries, np.float32)
        q = torch.as_tensor(q_np, device=self.device)
        b = q_np.shape[0]
        stage = trace.stage if trace is not None else (lambda _: nullcontext())
        # Wider default beam than the RAM engine (L ≈ 3k, not 2k): the
        # traversal is steered by PQ-approximate distances, and the slack
        # keeps true neighbors in the frontier despite quantization noise.
        l = beam_width or max(3 * k, 24)
        spec = SearchSpec(beam_width=l, k=l,
                          max_iters=max_iters or (4 * l + 64),
                          hop_backend=self.hop_backend)
        flabels = (torch.as_tensor(np.asarray(filter_labels, np.int32),
                                   device=self.device)
                   if filter_labels is not None
                   else torch.full((b,), -1, dtype=torch.int32,
                                   device=self.device))

        with stage("route"):
            res, used, won = self._dispatch(q, flabels, spec,
                                            publish_mask=publish_mask)
            beam_ids = res.ids.cpu().numpy()      # (B, l), tombstones masked
            expansions = res.trace.cpu().numpy()  # (B, max_iters), -1 padded
        fl_np = (np.asarray(filter_labels, np.int32)
                 if filter_labels is not None else None)

        out_ids = np.full((b, k), -1, np.int32)
        out_d = np.full((b, k), np.inf, np.float32)
        block_reads = np.zeros(b, np.int32)
        cache_hits = np.zeros(b, np.int32)
        # DiskANN's per-query I/O: a block per expansion (the adjacency
        # row lives in it) plus the unexpanded beam tail for rerank.
        wants = []
        for lane in range(b):
            beam = beam_ids[lane]
            expanded = expansions[lane]
            want = np.concatenate([expanded[expanded >= 0],
                                   beam[beam >= 0]])
            wants.append(np.unique(want))
        # One deduplicated multi-node fetch for the whole beam round
        # (a node's miss is charged to the first lane that wanted it).
        if self._pipeline is not None:
            # new beam round: last round's still-queued speculation is a
            # misprediction now — cancel it before it costs a read
            self._pipeline.advance()
            # every block this round's rerank needs goes to the worker
            # pool now; fetch_batch then completes against in-flight reads
            self._pipeline.submit(np.unique(np.concatenate(wants)))
        with stage("fetch"):
            fetched = self._cache.fetch_batch(wants)
        if self._pipeline is not None:
            # queue the beam frontier's neighborhoods before reranking, so
            # the speculative reads complete while the host reranks
            with stage("speculate"):
                self._speculate(beam_ids, wants, fetched)
        with stage("rerank"):
            for lane, (want, (vecs, _, hits, misses)) in enumerate(
                    zip(wants, fetched)):
                cache_hits[lane], block_reads[lane] = hits, misses
                if want.size == 0:
                    continue
                # Rerank every fetched block, not just the beam: true
                # neighbors that PQ noise evicted from the beam were still
                # expanded, so their vectors are already in hand.  Trace
                # nodes bypassed the device-side result mask, so apply the
                # tombstone/filter constraints here.
                keep = ~self._tomb_np[want]
                if fl_np is not None and self._labels_np is not None \
                        and fl_np[lane] >= 0:
                    keep &= self._labels_np[want] == fl_np[lane]
                cand = want[keep]
                if cand.size == 0:
                    continue
                d = ((vecs[keep] - q_np[lane]) ** 2).sum(-1)
                order = np.argsort(d, kind='stable')[:k]
                out_ids[lane, : order.size] = cand[order]
                out_d[lane, : order.size] = d[order]

        if self.mode == 'catapult' and self.catapult_active:
            # the freshly published destinations (best neighbor per query)
            # are the likeliest next landing blocks — soft-pin them
            dests = out_ids[:, 0]
            self._cache.pin_rotating(np.unique(dests[dests >= 0]))

        stats = SearchStats(hops=res.hops.cpu().numpy(),
                            ndists=res.ndists.cpu().numpy(),
                            used=used, won=won,
                            block_reads=block_reads, cache_hits=cache_hits)
        return out_ids, out_d, stats

    def _speculate(self, beam_ids: np.ndarray, wants, fetched) -> None:
        """Queue next round's likely blocks: the neighborhoods of each
        lane's beam frontier, the ones most lanes share first."""
        depth = self.io.prefetch_depth
        neigh = []
        for lane, want in enumerate(wants):
            if want.size == 0:
                continue
            heads = beam_ids[lane][:depth]
            heads = heads[heads >= 0]
            if heads.size == 0:
                continue
            # want is sorted-unique and contains the beam, so the heads'
            # adjacency rows are in this lane's fetched block set
            pos = np.searchsorted(want, heads)
            ok = pos < want.size
            pos = pos[ok]
            pos = pos[want[pos] == heads[ok]]
            if pos.size:
                neigh.append(fetched[lane][1][pos].ravel())
        if not neigh:
            return
        cand, freq = np.unique(np.concatenate(neigh), return_counts=True)
        ok = (cand >= 0) & ~self._tomb_np[np.maximum(cand, 0)]
        cand, freq = cand[ok], freq[ok]      # dead block = wasted read
        budget = 2 * self.io.queue_depth
        if cand.size > budget:
            top = np.argpartition(freq, cand.size - budget)[-budget:]
            cand = cand[top]
        if cand.size:
            self._pipeline.speculate(cand)

    def search_two_phase(self, queries: np.ndarray, k: int,
                         beam_width: int | None = None,
                         phase1_iters: int = 8):
        raise NotImplementedError(
            'two-phase compaction restarts from raw beams at full precision '
            '— a RAM-engine optimization; the disk tier reranks via the '
            'block cache instead')

    # ------------------------------------------------------------- updates
    def insert(self, new_vectors: np.ndarray,
               labels: np.ndarray | None = None) -> np.ndarray:
        """Write-through FreshVamana insert into the preallocated block
        region; returns the assigned node ids."""
        start = self.n_active
        ids = super().insert(new_vectors, labels)  # memmap surgery in place
        bs = self.store.block_store
        if self.filtered:
            bs.labels[start: self.n_active] = \
                self._labels_np[start: self.n_active]
        bs.flush(n_active=self.n_active, medoid=self.medoid)
        if bs.header.has_tombs:
            # the persisted bitmap still marks the new rows dead
            bs.write_tombstones(self._tomb_np)
        # insert surgery rewrites back-edges of existing nodes — cached
        # frames may hold stale adjacency; drop them and re-pin
        self._quiesce_io()
        self._cache.invalidate()
        self._repin()
        return ids

    def delete(self, ids: np.ndarray) -> None:
        """Tombstone delete, persisted: the CTPL v3 bitmap is rewritten,
        the (possibly re-elected) medoid and label entry points hit the
        header/tail, and the base class's bucket flush keeps catapults
        off dead blocks."""
        super().delete(ids)
        bs = self.store.block_store
        bs.write_tombstones(self._tomb_np)
        bs.flush(medoid=self.medoid)
        if self.filtered:
            bs.write_label_entries(self._label_entry_np)
        self._repin()            # the re-elected medoid/entries stay hot

    def consolidate(self) -> int:
        """Compaction pass: graph repair in place through the memmap
        views, plus a scrub of the tombstoned blocks (vector zeroed,
        label cleared), all persisted.  Node ids stay stable and
        ``n_active`` never shrinks."""
        self._quiesce_io()
        repaired = super().consolidate()
        bs = self.store.block_store
        deleted = self._tomb_np[: self.n_active].nonzero()[0]
        if deleted.size:
            bs.vectors[deleted] = 0.0
            bs.labels[deleted] = -1
        bs.flush(n_active=self.n_active, medoid=self.medoid)
        bs.write_tombstones(self._tomb_np)
        # adjacency rows were rewritten wholesale — drop stale frames
        self._cache.invalidate()
        self._repin()
        return repaired

    def save(self, include_adapt: bool = True) -> None:
        """Flush every persisted structure: blocks, header, tombstone
        bitmap, the label entry table of a filtered store, and — when
        the adapt layer is live — the ``<store>.adapt.npz`` sidecar
        (catapult geometry, buckets, telemetry and the utility-gate
        flag).  The I/O engine config rides in ``<store>.io.json``."""
        self._write_io_sidecar()
        bs = self.store.block_store
        bs.flush(n_active=self.n_active, medoid=self.medoid,
                 has_labels=self.filtered)
        bs.write_tombstones(self._tomb_np)
        if self.filtered:
            bs.write_label_entries(self._label_entry_np)
        if self.mode == 'catapult' and self.adapt_state is not None \
                and include_adapt:
            np.savez(_adapt_sidecar(self.store_path),
                     catapult_enabled=np.bool_(self.catapult_enabled),
                     cat_n_bits=np.int64(self.n_bits),
                     cat_bucket_capacity=np.int64(self.bucket_capacity),
                     cat_seed=np.int64(self.seed),
                     **bk.to_arrays(self._cat.buckets),
                     **adapt_stats.telemetry_to_arrays(self.adapt_state))
        elif os.path.exists(_adapt_sidecar(self.store_path)):
            # no adapt layer on this engine: a leftover sidecar would
            # resurrect a bucket table pointing at since-deleted nodes
            os.remove(_adapt_sidecar(self.store_path))

    def close(self) -> None:
        if self._pipeline is not None:
            self._pipeline.close()
        self.store.close()
