"""ShardedDiskVectorSearchEngine — scatter-gather serving over CTPL shards.

Port of ``repro/store/sharded_store.py``.  The corpus is row-sharded
into S independent CTPL block files, each served by its own
``DiskVectorSearchEngine`` — one ``DiskStore``, one CLOCK ``NodeCache``
and, in catapult mode, one private bucket table per shard: the paper's
one-instance-per-replica deployment that ``core/sharded.py`` models as
a mesh.  Per-shard searches run concurrently on a thread pool
(overlapping their host block fetches; on the card every shard's
kernels enqueue onto the device's default stream from its own thread),
and local results rebase to global row ids and merge with the same
``rebase_ids``/``merge_topk`` the mesh search uses.

On-disk layout, the reference's byte for byte (a directory):

    <store_dir>/
        manifest.json           multi-shard manifest (ctpl-sharded, v1)
        shard_0000.ctpl         CTPL block file of shard 0 (+ .io.json)
        shard_0000.buckets.npz  catapult buckets + adapt telemetry (save())
        shard_0001.ctpl         ...

Global ids are contiguous per shard: shard s owns rows
``[offsets[s], offsets[s] + capacity_s)``; with no spare capacity they
are the corpus row order.  ``save()``/``load()`` round-trip each
shard's catapult buckets and telemetry, so the first batch after a
reopen catapults like the last batch before the save.

The tier is mutable: ``insert_batch`` routes rows to the least-loaded
shard, ``delete`` fans tombstones out to the owning shards,
``consolidate`` compacts every shard, and filtered searches fan out
against each shard's per-label entry points.  Every shard engine
soft-pins its published catapult destinations in its cache, as the
port's single-store engine does (it has no switch for it).
"""
from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from repro_torch.adapt import stats as adapt_stats
from repro_torch.core import buckets as bk
from repro_torch.core import catapult as cat
from repro_torch.core.engine import SearchStats
from repro_torch.core.sharded import merge_topk, rebase_ids
from repro_torch.core.vamana import VamanaParams
from repro_torch.db.spec import IoSpec
from repro_torch.device import resolve_device
from repro_torch.store.cache import CacheStats, IoStats
from repro_torch.store.io_engine import DiskVectorSearchEngine

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = "ctpl-sharded"
MANIFEST_VERSION = 1


def _shard_file(s: int) -> str:
    return f"shard_{s:04d}.ctpl"


def _bucket_file(s: int) -> str:
    return f"shard_{s:04d}.buckets.npz"


@dataclasses.dataclass
class ShardedDiskVectorSearchEngine:
    """Scatter-gather facade over S disk-resident shard engines."""

    store_dir: str = "index.ctpl.d"
    n_shards: int = 2
    mode: str = "catapult"
    vamana: VamanaParams = dataclasses.field(default_factory=VamanaParams)
    n_bits: int = 8
    bucket_capacity: int = 40
    pq_subspaces: Optional[int] = None
    seed: int = 0
    cache_frames: int = 2048          # frames PER SHARD
    max_workers: Optional[int] = None  # shard-search overlap; default = S
    # I/O engine config, applied PER SHARD; None = the manifest's value
    # on load, the synchronous default on build
    io: Optional[IoSpec] = None
    # traversal hop implementation, applied PER SHARD
    hop_backend: str = "unfused"
    device: object = "cuda"

    # populated by build()/load()
    shards: list = dataclasses.field(default_factory=list)
    offsets: Optional[np.ndarray] = None   # (S+1,) global row offsets
    n_active: int = 0
    dim: int = 0
    filtered: bool = False
    n_labels: int = 0
    # durable caller-owned manifest entries (the ingest subsystem's
    # "ingest" spec and "keys" sidecar pointer): the manifest is
    # rewritten from scratch on every insert and save, so these are
    # merged in each time
    manifest_extra: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.n_shards < 1:
            raise ValueError(f"need >= 1 shard, got {self.n_shards}")
        if self.mode not in ("catapult", "diskann"):
            raise ValueError(f"sharded disk engine supports catapult/diskann "
                             f"modes, got {self.mode!r}")
        self._pool = None

    def _shard_kwargs(self, s: int) -> dict:
        return dict(vamana=dataclasses.replace(self.vamana,
                                               seed=self.seed + s),
                    n_bits=self.n_bits, bucket_capacity=self.bucket_capacity,
                    seed=self.seed + s, cache_frames=self.cache_frames,
                    io=self.io, hop_backend=self.hop_backend,
                    device=self.device)

    # ---------------------------------------------------------------- build
    def build(self, vectors: np.ndarray, labels: np.ndarray | None = None,
              n_labels: int | None = None,
              spare_capacity: int = 0) -> "ShardedDiskVectorSearchEngine":
        """Row-shard ``vectors`` into S contiguous slices and build each
        shard's graph and store on its own (seed ``seed + s``, as
        ``core.sharded.build_sharded_state``).  ``labels``/``n_labels``
        build every shard filtered.  ``spare_capacity`` extra rows in
        total are split evenly over the shards (the first ``spare mod
        S`` take one more) so ``insert_batch`` has room."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        n, d = vectors.shape
        self.filtered = labels is not None
        if self.filtered:
            if n_labels is None:
                raise ValueError("labels need n_labels")
            self.n_labels = int(n_labels)
        # one IoSpec for the manifest and every shard
        self.io = self.io or IoSpec()
        os.makedirs(self.store_dir, exist_ok=True)
        bounds = np.linspace(0, n, self.n_shards + 1).astype(np.int64)
        spare = np.full(self.n_shards, spare_capacity // self.n_shards,
                        np.int64)
        spare[: spare_capacity % self.n_shards] += 1
        self.offsets = np.zeros(self.n_shards + 1, np.int64)
        self.shards = []
        for s in range(self.n_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            cap = hi - lo + int(spare[s])
            self.offsets[s + 1] = self.offsets[s] + cap
            eng = DiskVectorSearchEngine(
                mode=self.mode, pq_subspaces=self.pq_subspaces, capacity=cap,
                store_path=os.path.join(self.store_dir, _shard_file(s)),
                **self._shard_kwargs(s))
            if self.filtered:
                eng.build(vectors[lo:hi], labels=labels[lo:hi],
                          n_labels=self.n_labels)
            else:
                eng.build(vectors[lo:hi])
            self.shards.append(eng)
        self.n_active, self.dim = n, d
        self._write_manifest()
        return self

    def _write_manifest(self) -> None:
        manifest = {
            "format": MANIFEST_FORMAT,
            "version": MANIFEST_VERSION,
            "n_shards": self.n_shards,
            "dim": self.dim,
            "mode": self.mode,
            "seed": self.seed,
            "n_bits": self.n_bits,
            "bucket_capacity": self.bucket_capacity,
            "filtered": self.filtered,
            "n_labels": self.n_labels,
            # the manifest is the tier's IoSpec home (it outranks the
            # per-shard .io.json sidecars on load)
            "io": (self.io or IoSpec()).to_dict(),
            "offsets": [int(o) for o in self.offsets],
            "shards": [{
                "file": _shard_file(s),
                "n_active": int(eng.n_active),
                "capacity": int(eng.capacity or eng.n_active),
                # the adapt layer's utility gate survives a reopen
                "catapult_enabled": bool(eng.catapult_enabled),
            } for s, eng in enumerate(self.shards)],
        }
        manifest.update(self.manifest_extra)
        tmp = os.path.join(self.store_dir, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(self.store_dir, MANIFEST_NAME))

    # ------------------------------------------------------------ adaptation
    @property
    def catapult_enabled(self) -> bool:
        """The adapt layer's utility gate, fanned out over the shards."""
        return all(eng.catapult_enabled for eng in self.shards)

    @catapult_enabled.setter
    def catapult_enabled(self, flag: bool) -> None:
        for eng in self.shards:
            eng.catapult_enabled = bool(flag)

    @property
    def catapult_active(self) -> bool:
        """Effective dispatch switch, true only when every shard would
        catapult."""
        return all(eng.catapult_active for eng in self.shards)

    # ---------------------------------------------------------------- search
    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.max_workers or self.n_shards)
        return self._pool

    def search(self, queries: np.ndarray, k: int,
               beam_width: int | None = None,
               filter_labels: np.ndarray | None = None,
               max_iters: int | None = None,
               publish_mask: np.ndarray | None = None,
               trace=None
               ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """Scatter the batch to every shard, gather and merge the global
        top-k.

        The requested beam (default max(3k, 24), the single store's) is
        split across the shards, floored at k: every shard returns k
        candidates, the merged pool is S·k.  Per-lane stats: hops,
        ndists, block_reads and cache_hits sum over the shards, used and
        won OR.  ``trace`` gets one ``scatter`` span for the fan-out and
        one ``merge`` span; each shard fills a child recorder, and the
        top-level route/fetch/speculate/rerank spans are the maxima over
        the shards (the critical path through the overlapped pool).
        """
        if not self.shards:
            raise RuntimeError("build() or load() first")
        stage = trace.stage if trace is not None else (lambda _: nullcontext())
        beam = beam_width or max(3 * k, 24)
        per_shard_beam = max(k, -(-beam // self.n_shards))
        kids = ([trace.child(f"shard_{s}") for s in range(self.n_shards)]
                if trace is not None else [None] * self.n_shards)

        def one(arg):
            eng, kid = arg
            return eng.search(queries, k, beam_width=per_shard_beam,
                              filter_labels=filter_labels,
                              max_iters=max_iters,
                              publish_mask=publish_mask, trace=kid)

        with stage("scatter"):
            results = list(self._executor().map(one, zip(self.shards, kids)))
        with stage("merge"):
            all_ids = torch.stack([
                rebase_ids(torch.from_numpy(ids), int(self.offsets[s]))
                for s, (ids, _, _) in enumerate(results)])        # (S, B, k)
            all_d = torch.stack([torch.from_numpy(d)
                                 for _, d, _ in results])          # (S, B, k)
            merged_ids, merged_d = merge_topk(all_ids, all_d, k)
            merged_ids = merged_ids.numpy()
            merged_d = merged_d.numpy()
        if trace is not None:
            for name in ("route", "fetch", "speculate", "rerank"):
                trace.add_stage(name, max(kid.stage_ms(name)
                                          for kid in kids))
        stats = SearchStats(
            hops=np.sum([st.hops for _, _, st in results], axis=0),
            ndists=np.sum([st.ndists for _, _, st in results], axis=0),
            used=np.any([st.used for _, _, st in results], axis=0),
            won=np.any([st.won for _, _, st in results], axis=0),
            block_reads=np.sum([st.block_reads for _, _, st in results],
                               axis=0),
            cache_hits=np.sum([st.cache_hits for _, _, st in results],
                              axis=0))
        return merged_ids, merged_d, stats

    # ---------------------------------------------------------------- updates
    def _shard_of(self, global_ids: np.ndarray) -> np.ndarray:
        return (np.searchsorted(self.offsets, global_ids, side="right")
                - 1).astype(np.int64)

    def insert_batch(self, new_vectors: np.ndarray,
                     labels: np.ndarray | None = None) -> np.ndarray:
        """Route inserts to the least-loaded shard (most free capacity);
        a batch larger than one shard's headroom splits greedily across
        shards in input order.  Returns global ids."""
        vectors = np.ascontiguousarray(new_vectors, np.float32)
        b = vectors.shape[0]
        out = np.empty(b, np.int64)
        pos = 0
        while pos < b:
            free = np.array([(e.capacity or e.n_active) - e.n_active
                             for e in self.shards])
            s = int(np.argmax(free))
            if free[s] <= 0:
                raise RuntimeError(
                    "every shard is at capacity; rebuild with spare_capacity")
            take = min(int(free[s]), b - pos)
            chunk_labels = (labels[pos: pos + take]
                            if labels is not None else None)
            local = self.shards[s].insert_batch(vectors[pos: pos + take],
                                                chunk_labels)
            out[pos: pos + take] = local + int(self.offsets[s])
            pos += take
        self.n_active += b
        self._write_manifest()
        return out

    def delete(self, global_ids: np.ndarray) -> None:
        """Fan tombstone deletes out to the owning shards."""
        gids = np.atleast_1d(np.asarray(global_ids, np.int64)).ravel()
        gids = gids[gids >= 0]  # tolerate search()'s -1 padding lanes
        shard_of = self._shard_of(gids)
        for s in np.unique(shard_of):
            self.shards[int(s)].delete(gids[shard_of == s]
                                       - int(self.offsets[int(s)]))

    def consolidate(self) -> int:
        """Run every shard's compaction pass; returns total repaired rows."""
        return sum(eng.consolidate() for eng in self.shards)

    # ---------------------------------------------------------------- I/O
    @property
    def cache_stats(self) -> CacheStats:
        """Cache counters summed over every shard's node cache."""
        per = [eng.cache.stats for eng in self.shards]
        return CacheStats(*[sum(s[i] for s in per) for i in range(5)])

    def io_stats(self, reset: bool = False) -> IoStats:
        """Tier-wide I/O record: each shard's counters summed once (every
        block read, hit and prefetch belongs to one shard's cache)."""
        per = [eng.io_stats(reset=reset) for eng in self.shards]
        return IoStats(*[sum(s[i] for s in per)
                         for i in range(len(IoStats._fields))])

    def reset_io(self) -> None:
        for eng in self.shards:
            eng.reset_io()

    def tombstone_fraction(self) -> float:
        """Dead-row share across every shard."""
        dead = sum(int(eng._tomb_np[:eng.n_active].sum())
                   for eng in self.shards)
        n = sum(int(eng.n_active) for eng in self.shards)
        return dead / n if n else 0.0

    # ---------------------------------------------------------------- persist
    def save(self) -> None:
        """Flush every shard and the manifest, and snapshot each shard's
        catapult buckets and adapt telemetry into its ``.buckets.npz``
        (the sharded layer owns them, so no shard writes its own
        ``.adapt.npz``)."""
        for s, eng in enumerate(self.shards):
            eng.save(include_adapt=False)
            if self.mode == "catapult":
                extra = (adapt_stats.telemetry_to_arrays(eng.adapt_state)
                         if eng.adapt_state is not None else {})
                np.savez(os.path.join(self.store_dir, _bucket_file(s)),
                         **bk.to_arrays(eng._cat.buckets), **extra)
        self._write_manifest()

    @classmethod
    def load(cls, store_dir: str, mode: str | None = None,
             **engine_kwargs) -> "ShardedDiskVectorSearchEngine":
        """Reopen a sharded index from its manifest directory: each shard
        through ``DiskVectorSearchEngine.load``, its bucket table and
        telemetry from its ``.buckets.npz`` when one exists, its gate
        from the manifest."""
        with open(os.path.join(store_dir, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        if manifest.get("format") != MANIFEST_FORMAT:
            raise ValueError(f"not a sharded CTPL manifest: "
                             f"{manifest.get('format')!r}")
        if int(manifest.get("version", 0)) != MANIFEST_VERSION:
            raise ValueError(f"unsupported manifest version "
                             f"{manifest.get('version')}")
        mode = mode or manifest["mode"]
        self = cls(store_dir=store_dir, n_shards=int(manifest["n_shards"]),
                   mode=mode, seed=int(manifest["seed"]),
                   n_bits=int(manifest["n_bits"]),
                   bucket_capacity=int(manifest["bucket_capacity"]),
                   **engine_kwargs)
        self.offsets = np.asarray(manifest["offsets"], np.int64)
        self.dim = int(manifest["dim"])
        self.filtered = bool(manifest.get("filtered", False))
        self.n_labels = int(manifest.get("n_labels", 0))
        # keep caller-owned entries durable across future rewrites
        self.manifest_extra = {key: manifest[key]
                               for key in ("ingest", "keys")
                               if key in manifest}
        if self.io is None and "io" in manifest:
            self.io = IoSpec.from_dict(manifest["io"])
        self.io = self.io or IoSpec()
        self.shards = []
        try:
            for s, meta in enumerate(manifest["shards"]):
                eng = DiskVectorSearchEngine.load(
                    os.path.join(store_dir, meta["file"]), mode=mode,
                    **self._shard_kwargs(s))
                self.shards.append(eng)
                bpath = os.path.join(store_dir, _bucket_file(s))
                if mode == "catapult" and os.path.exists(bpath):
                    with np.load(bpath) as z:
                        arrays = dict(z)
                    eng._cat = cat.CatapultState(
                        lsh=eng._cat.lsh,
                        buckets=bk.from_arrays(arrays, eng.device))
                    eng.adapt_state = adapt_stats.telemetry_from_arrays(
                        arrays, device=eng.device)
                eng.catapult_enabled = bool(meta.get("catapult_enabled",
                                                     True))
        except BaseException:
            self.close()         # don't leak the opened shards' files
            raise
        self.n_active = sum(eng.n_active for eng in self.shards)
        return self

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        for eng in self.shards:
            eng.close()
