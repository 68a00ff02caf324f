"""TieredVectorSearchEngine — hot rows in RAM over a cold disk index.

Port of ``repro/tiered/engine.py``.  The paper's locality signal, spent
on memory residence instead of entry points: the adapt layer's decay
histograms say where the query stream lands, so the rows under the hot
buckets are lifted into a RAM ``VectorSearchEngine`` (the HOT tier, on
the engine's device) fronting a cold ``DiskVectorSearchEngine`` or
``ShardedDiskVectorSearchEngine`` that holds the whole corpus.

Design invariants, the reference's:

* **The cold store is the canonical home of every row.**  Global ids
  ARE cold ids; the hot tier holds copies addressed through the
  ``_hot_gid`` indirection (hot slot -> global id), so promotion and
  demotion never renumber anything.
* **Search fans out to both tiers and merges.**  Hot and cold run
  concurrently (the hot search on a pool thread: its device syncs
  release the interpreter lock, so they do not hold up the cold tier's
  host fetch); hot slots rebase to global ids through the indirection
  and the two candidate lists merge with ``core.sharded.merge_topk``
  plus a keep-first dedup (a row resident in both tiers appears once).
  The merged pool holds the cold tier's own candidates, so tiered
  recall >= cold recall.
* **Promotion/demotion is maintainer work.**  ``rebalance()`` (driven
  by ``TieredMaintainer.tick``) reads each cold unit's adapt telemetry:
  live destinations of the hottest buckets promote; hot rows absent
  from the candidate set for ``tiered.demote_after`` consecutive
  rebalances demote when capacity needs the room.  The hot engine
  absorbs promotions by FreshVamana insert into spare slots and
  rebuilds from the live set when the slack runs out.
* **Hot rows pin out of the cold fetch path** (``NodeCache.
  set_tier_pins`` after every rebalance).
* **Persistence reuses CTPL.**  The store path is a directory: the cold
  store (``cold.ctpl`` or a ``cold.d/`` sharded manifest), a
  ``tiered.json`` manifest and a ``hot.npz`` hot-set sidecar (gids,
  staleness, counters) — the reference's files.  ``save()``
  canonicalises the hot engine (a deterministic rebuild over the live
  hot set) before writing the sidecar, so ``open()`` resumes the same
  hot graph and post-reopen searches match post-save searches.

``io_stats``/``cache_stats`` are the cold tier's (the hot tier does no
block I/O); upserts land cold-only, deletes fan to both tiers,
consolidate compacts both; filtered searches traverse the cold tier's
per-label entries and post-filter the hot candidates by the mirrored
labels.
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

from repro_torch.adapt import policy as pol
from repro_torch.core.engine import SearchStats, VectorSearchEngine
from repro_torch.core.sharded import merge_topk
from repro_torch.core.vamana import VamanaParams
from repro_torch.db.spec import IoSpec, TieredSpec
from repro_torch.device import resolve_device
from repro_torch.store.cache import CacheStats, IoStats
from repro_torch.store.io_engine import DiskVectorSearchEngine
from repro_torch.store.sharded_store import ShardedDiskVectorSearchEngine

TIERED_MANIFEST_NAME = "tiered.json"
TIERED_FORMAT = "ctpl-tiered"
TIERED_VERSION = 1
COLD_FILE = "cold.ctpl"       # single-store cold backend
COLD_DIR = "cold.d"           # sharded cold backend
HOT_SIDECAR = "hot.npz"

# the hot engine's private seed offset: its Vamana build must not share
# its RNG stream with the cold build over the same spec seed
_HOT_SEED_OFFSET = 101


def _keep_first(ids: np.ndarray, dists: np.ndarray, k: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Per lane, the first ``k`` ids >= 0 of a merged list, each id
    once (its first, nearest occurrence), in list order; -1/+inf
    padded."""
    b, m = ids.shape
    order = np.argsort(ids, axis=1, kind="stable")
    srt = np.take_along_axis(ids, order, 1)
    dup_sorted = np.zeros((b, m), bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup = np.zeros((b, m), bool)
    np.put_along_axis(dup, order, dup_sorted, 1)
    keep = (ids >= 0) & ~dup
    rank = np.cumsum(keep, axis=1) - 1
    lane, col = np.nonzero(keep & (rank < k))
    out_ids = np.full((b, k), -1, np.int32)
    out_d = np.full((b, k), np.inf, np.float32)
    out_ids[lane, rank[lane, col]] = ids[lane, col]
    out_d[lane, rank[lane, col]] = dists[lane, col]
    return out_ids, out_d


@dataclasses.dataclass
class TieredVectorSearchEngine:
    """Hot-RAM / cold-disk facade speaking the uniform engine protocol."""

    store_dir: str = "index.tiered.d"
    mode: str = "catapult"
    vamana: VamanaParams = dataclasses.field(default_factory=VamanaParams)
    n_bits: int = 8
    bucket_capacity: int = 40
    pq_subspaces: Optional[int] = None
    seed: int = 0
    cache_frames: int = 2048
    n_shards: int = 2                 # cold_tier='sharded' only
    io: Optional[IoSpec] = None
    hop_backend: str = "unfused"
    tiered: TieredSpec = dataclasses.field(default_factory=TieredSpec)
    device: object = "cuda"

    # populated by build()/load()
    cold: object = None               # Disk / ShardedDisk engine
    hot: Optional[VectorSearchEngine] = None
    filtered: bool = False
    n_labels: int = 0

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.mode not in ("catapult", "diskann"):
            raise ValueError(f"tiered engine supports catapult/diskann "
                             f"modes, got {self.mode!r}")
        self._pool = None
        self._hot_gid = np.empty(0, np.int64)   # hot slot -> global id
        self._hot_slot: dict[int, int] = {}     # global id -> hot slot
        self._hot_stale: dict[int, int] = {}    # gid -> rebalances unseen
        self._hot_labels: Optional[np.ndarray] = None  # per-slot labels
        self._hot_cap = 0                       # target hot-set size
        # tier counters (tier_stats())
        self.promotions = 0
        self.demotions = 0
        self.hot_rebuilds = 0
        self.rebalances = 0
        self.searches = 0        # lanes served
        self.hot_hits = 0        # lanes whose nearest neighbor was hot

    # ------------------------------------------------------------- delegation
    @property
    def n_active(self) -> int:
        return self.cold.n_active

    @property
    def dim(self) -> int:
        d = getattr(self.cold, "dim", 0)
        return int(d) if d else int(self.cold._vec_np.shape[1])

    @property
    def capacity(self):
        return getattr(self.cold, "capacity", None)

    @property
    def shards(self) -> list:
        """The catapult units — the cold engines that own LSH planes,
        bucket tables and adapt telemetry.  ``CatapultMaintainer``
        unwraps this as it does the sharded facade's, so the adapt
        machinery (gate, drift flush, shadow baselines) rides the cold
        tier unchanged."""
        return list(getattr(self.cold, "shards", None) or [self.cold])

    @property
    def catapult_enabled(self) -> bool:
        return self.cold.catapult_enabled

    @catapult_enabled.setter
    def catapult_enabled(self, flag: bool) -> None:
        self.cold.catapult_enabled = bool(flag)

    @property
    def catapult_active(self) -> bool:
        return self.cold.catapult_active

    @property
    def adapt_state(self):
        return getattr(self.cold, "adapt_state", None)

    # host views (single-store cold only) — Database.vectors/tombstones
    @property
    def _vec_np(self):
        return self.cold._vec_np

    @property
    def _tomb_np(self):
        return self.cold._tomb_np

    # ---------------------------------------------------------------- build
    def _cold_kwargs(self) -> dict:
        return dict(mode=self.mode, vamana=self.vamana, n_bits=self.n_bits,
                    bucket_capacity=self.bucket_capacity,
                    pq_subspaces=self.pq_subspaces, seed=self.seed,
                    cache_frames=self.cache_frames, io=self.io,
                    hop_backend=self.hop_backend, device=self.device)

    def build(self, vectors: np.ndarray, labels: np.ndarray | None = None,
              n_labels: int | None = None,
              spare_capacity: int = 0) -> "TieredVectorSearchEngine":
        """Build the cold store over the whole corpus, then lift an
        initial hot set into RAM: with no traffic yet there is no
        locality signal, so it is an evenly spaced deterministic sample
        of the corpus that the first rebalances reshape."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        n, _ = vectors.shape
        self.filtered = labels is not None
        if self.filtered:
            if n_labels is None:
                raise ValueError("labels need n_labels")
            self.n_labels = int(n_labels)
        os.makedirs(self.store_dir, exist_ok=True)
        if self.tiered.cold_tier == "sharded":
            self.cold = ShardedDiskVectorSearchEngine(
                store_dir=os.path.join(self.store_dir, COLD_DIR),
                n_shards=self.n_shards, **self._cold_kwargs())
            self.cold.build(vectors, labels=labels, n_labels=n_labels,
                            spare_capacity=spare_capacity)
        else:
            self.cold = DiskVectorSearchEngine(
                capacity=n + spare_capacity,
                store_path=os.path.join(self.store_dir, COLD_FILE),
                **self._cold_kwargs())
            self.cold.build(vectors, labels=labels, n_labels=n_labels)
        self._hot_cap = self._resolve_hot_cap(n)
        gids = np.unique(np.linspace(0, max(n - 1, 0),
                                     num=min(self._hot_cap, n)
                                     ).round().astype(np.int64)) \
            if n else np.empty(0, np.int64)
        self._build_hot(gids)
        self._pin_hot()
        self._write_manifest()
        self._write_hot_sidecar()
        return self

    def _resolve_hot_cap(self, n: int) -> int:
        cfg = self.tiered
        if cfg.hot_capacity is not None:
            return int(cfg.hot_capacity)
        return max(1, int(np.ceil(cfg.hot_fraction * n)))

    # ------------------------------------------------------------- hot engine
    def _hot_engine_capacity(self) -> int:
        # slack absorbs incremental promotions between rebuilds
        return self._hot_cap + max(8, self._hot_cap // 2)

    def _cold_units_and_offsets(self):
        shards = getattr(self.cold, "shards", None)
        if shards:
            return list(shards), np.asarray(self.cold.offsets, np.int64)
        return [self.cold], np.zeros(2, np.int64)

    def _cold_rows(self, gids: np.ndarray, attr: str) -> np.ndarray:
        """Gather per-row host state (vectors/labels/tombstones) from the
        cold store for global ids, shard-aware."""
        units, offsets = self._cold_units_and_offsets()
        if len(units) == 1:
            return np.asarray(getattr(units[0], attr)[gids])
        shard_of = self.cold._shard_of(gids)
        first = np.asarray(getattr(units[0], attr)[:1])
        out = np.empty((gids.size,) + first.shape[1:], first.dtype)
        for s in np.unique(shard_of):
            sel = shard_of == s
            local = gids[sel] - int(offsets[int(s)])
            out[sel] = np.asarray(getattr(units[int(s)], attr)[local])
        return out

    def _build_hot(self, gids: np.ndarray) -> None:
        """(Re)build the hot RAM engine over ``gids`` — deterministic in
        (sorted gid set, seed), which is what makes save()/open() resume
        the same graph.  The hot engine runs plain diskann dispatch at
        full precision: it is small and rebuilt on churn, so a catapult
        layer of its own would add state without saving hops."""
        gids = np.sort(np.unique(np.asarray(gids, np.int64)))
        if gids.size:
            dead = self._cold_rows(gids, "_tomb_np")
            gids = gids[~dead]
        cap = self._hot_engine_capacity()
        self._hot_gid = np.full(cap, -1, np.int64)
        self._hot_slot = {}
        stale = self._hot_stale
        self._hot_stale = {int(g): int(stale.get(int(g), 0)) for g in gids}
        self._hot_labels = None
        if gids.size == 0:
            self.hot = None
            return
        self.hot = VectorSearchEngine(
            mode="diskann",
            vamana=dataclasses.replace(self.vamana,
                                       seed=self.seed + _HOT_SEED_OFFSET),
            pq_subspaces=None, seed=self.seed + _HOT_SEED_OFFSET,
            capacity=cap, hop_backend=self.hop_backend, device=self.device)
        self.hot.build(self._cold_rows(gids, "_vec_np"))
        self._hot_gid[: gids.size] = gids
        self._hot_slot = {int(g): i for i, g in enumerate(gids)}
        if self.filtered:
            self._hot_labels = np.full(cap, -1, np.int32)
            self._hot_labels[: gids.size] = self._cold_rows(gids,
                                                            "_labels_np")

    def _hot_live_gids(self) -> np.ndarray:
        return np.sort(np.fromiter(self._hot_slot.keys(), np.int64,
                                   len(self._hot_slot)))

    def _pin_hot(self) -> None:
        """Tier-pin the hot rows in the cold cache(s): the cold fetch
        path stops paying disk reads for rows RAM already serves."""
        if not self.tiered.pin_cold:
            return
        gids = self._hot_live_gids()
        units, offsets = self._cold_units_and_offsets()
        if len(units) == 1:
            units[0].cache.set_tier_pins(gids)
            return
        shard_of = self.cold._shard_of(gids) if gids.size else \
            np.empty(0, np.int64)
        for s, unit in enumerate(units):
            unit.cache.set_tier_pins(gids[shard_of == s] - int(offsets[s]))

    # ---------------------------------------------------------------- search
    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=2)
        return self._pool

    def _search_hot(self, q_np: np.ndarray, k: int, beam: int,
                    fl_np: Optional[np.ndarray], trace=None
                    ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """Hot half of the fan-out: full-precision RAM search over the
        resident copies, results rebased to GLOBAL ids through the
        ``_hot_gid`` indirection.  Filtered lanes post-filter by the
        mirrored labels (the hot subset has no stitched graph; the cold
        tier already guarantees predicate-correct candidates)."""
        b = q_np.shape[0]
        ids = np.full((b, k), -1, np.int64)
        dists = np.full((b, k), np.inf, np.float32)
        zeros = np.zeros(b, np.int32)
        zb = np.zeros(b, bool)
        stats = SearchStats(hops=zeros, ndists=zeros, used=zb, won=zb)
        if self.hot is None or not self._hot_slot:
            return ids, dists, stats
        local, d, st = self.hot.search(q_np, k, beam_width=max(k, beam),
                                       trace=trace)
        local = np.asarray(local)
        gid = np.where(local >= 0,
                       self._hot_gid[np.maximum(local, 0)], -1)
        d = np.asarray(d, np.float32)
        if fl_np is not None and self._hot_labels is not None:
            lane_lab = np.asarray(fl_np, np.int32)[:, None]
            slot_lab = np.where(local >= 0,
                                self._hot_labels[np.maximum(local, 0)], -1)
            drop = (lane_lab >= 0) & (slot_lab != lane_lab)
            gid = np.where(drop, -1, gid)
            d = np.where(drop, np.inf, d)
        # a slot emptied by demotion keeps serving until the engine's
        # tombstone mask hides it; the indirection maps it to -1
        d = np.where(gid < 0, np.inf, d)
        ids[:, : gid.shape[1]] = gid[:, :k]
        dists[:, : d.shape[1]] = d[:, :k]
        return ids, dists, SearchStats(hops=np.asarray(st.hops),
                                       ndists=np.asarray(st.ndists),
                                       used=zb, won=zb)

    def search(self, queries: np.ndarray, k: int,
               beam_width: int | None = None,
               filter_labels: np.ndarray | None = None,
               max_iters: int | None = None,
               publish_mask: np.ndarray | None = None,
               trace=None
               ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """Fan out to both tiers, merge, dedup, answer as ONE database.

        The cold tier searches the full corpus at the full requested
        beam; the hot tier adds its full-precision candidates.  Per-lane
        stats: hops and ndists sum over the tiers, used/won and
        block_reads/cache_hits are the cold tier's.  ``trace`` gets a
        ``scatter`` span for the fan-out, a ``merge`` span, child
        recorders ``hot``/``cold``, and top-level route/fetch/speculate/
        rerank spans as the maxima over the two tiers.
        """
        if self.cold is None:
            raise RuntimeError("build() or load() first")
        q_np = np.ascontiguousarray(queries, np.float32)
        b = q_np.shape[0]
        stage = trace.stage if trace is not None else (lambda _: nullcontext())
        beam = beam_width or max(3 * k, 24)
        fl_np = (np.asarray(filter_labels, np.int32)
                 if filter_labels is not None else None)
        hot_kid = trace.child("hot") if trace is not None else None
        cold_kid = trace.child("cold") if trace is not None else None

        with stage("scatter"):
            fut = self._executor().submit(
                self._search_hot, q_np, k, beam, fl_np, hot_kid)
            cold_ids, cold_d, cold_st = self.cold.search(
                q_np, k, beam_width=beam, filter_labels=filter_labels,
                max_iters=max_iters, publish_mask=publish_mask,
                trace=cold_kid)
            hot_ids, hot_d, hot_st = fut.result()
        with stage("merge"):
            all_ids = torch.from_numpy(np.stack(
                [hot_ids, np.asarray(cold_ids, np.int64)]))   # (2, B, k)
            all_d = torch.from_numpy(np.stack(
                [hot_d, np.asarray(cold_d, np.float32)]))
            m_ids, m_d = merge_topk(all_ids, all_d, 2 * k)
            out_ids, out_d = _keep_first(m_ids.numpy(), m_d.numpy(), k)
        if trace is not None:
            for name in ("route", "fetch", "speculate", "rerank"):
                trace.add_stage(name, max(hot_kid.stage_ms(name),
                                          cold_kid.stage_ms(name)))
        top1 = out_ids[:, 0]
        self.searches += b
        self.hot_hits += int(np.isin(top1[top1 >= 0],
                                     self._hot_live_gids()).sum())
        stats = SearchStats(
            hops=np.asarray(cold_st.hops) + np.asarray(hot_st.hops),
            ndists=np.asarray(cold_st.ndists) + np.asarray(hot_st.ndists),
            used=np.asarray(cold_st.used), won=np.asarray(cold_st.won),
            block_reads=cold_st.block_reads, cache_hits=cold_st.cache_hits)
        return out_ids, out_d, stats

    # ---------------------------------------------------------------- updates
    def insert_batch(self, new_vectors: np.ndarray,
                     labels: np.ndarray | None = None) -> np.ndarray:
        """Upserts land in the cold tier only (the canonical home), so
        the returned global ids are cold ids; a new row earns hot
        residence through traffic."""
        return self.cold.insert_batch(new_vectors, labels)

    def delete(self, global_ids: np.ndarray) -> None:
        """Fan the tombstones to BOTH tiers: the cold bitmap persists the
        delete; a resident hot copy tombstones at once and its slot
        drops from the indirection."""
        gids = np.atleast_1d(np.asarray(global_ids, np.int64)).ravel()
        gids = gids[gids >= 0]
        self.cold.delete(gids)
        hot_slots = [self._hot_slot[int(g)] for g in gids
                     if int(g) in self._hot_slot]
        if hot_slots and self.hot is not None:
            self.hot.delete(np.asarray(hot_slots, np.int64))
            for g in gids:
                g = int(g)
                slot = self._hot_slot.pop(g, None)
                if slot is not None:
                    self._hot_gid[slot] = -1
                    self._hot_stale.pop(g, None)
        self._pin_hot()

    def consolidate(self) -> int:
        """Compact the cold store; the hot engine rebuilds over the
        surviving hot set when deletions left tombstoned slots."""
        repaired = self.cold.consolidate()
        if self.hot is not None and \
                bool(self.hot._tomb_np[: self.hot.n_active].any()):
            self._build_hot(self._hot_live_gids())
            self.hot_rebuilds += 1
            self._pin_hot()
        return repaired

    # ------------------------------------------------------------- rebalance
    def _hot_candidates(self, top: int) -> np.ndarray:
        """Promotion candidates: live destinations published in the
        hottest buckets of every cold unit's telemetry, as global ids.
        Empty until traffic has built telemetry."""
        units, offsets = self._cold_units_and_offsets()
        cand = []
        for s, unit in enumerate(units):
            tel = getattr(unit, "adapt_state", None)
            if tel is None or getattr(unit, "_cat", None) is None:
                continue
            dests = pol.hot_destinations(unit._cat.buckets, tel, top)
            if dests.size:
                cand.append(dests + int(offsets[s] if len(units) > 1 else 0))
        if not cand:
            return np.empty(0, np.int64)
        gids = np.unique(np.concatenate(cand))
        dead = self._cold_rows(gids, "_tomb_np")
        return gids[~dead]

    def rebalance(self) -> tuple[int, int]:
        """One promotion/demotion pass off the cold adapt telemetry.
        Returns (promoted, demoted) row counts.

        Every live hot row ages one rebalance; re-appearing in the
        candidate set resets it.  Rows at or past ``demote_after`` are
        the demotion pool, and demote only under capacity pressure from
        fresh promotions (an idle hot set stays resident)."""
        cfg = self.tiered
        cand = self._hot_candidates(cfg.promote_top)
        self.rebalances += 1
        if cand.size == 0:
            return 0, 0
        cand_set = {int(g) for g in cand}
        for g in list(self._hot_stale):
            self._hot_stale[g] = 0 if g in cand_set \
                else self._hot_stale[g] + 1
        promote = np.asarray(sorted(cand_set - set(self._hot_slot)),
                             np.int64)
        if promote.size == 0:
            self._pin_hot()
            return 0, 0
        live = len(self._hot_slot)
        room = self._hot_cap - live
        demote: list[int] = []
        need = int(promote.size) - max(room, 0)
        if need > 0:
            stale_pool = sorted(
                (g for g, age in self._hot_stale.items()
                 if age >= cfg.demote_after and g in self._hot_slot),
                key=lambda g: (-self._hot_stale[g], g))
            demote = stale_pool[:need]
            if len(demote) < need:
                # not enough decayed rows: promotion waits its turn
                promote = promote[: max(room, 0) + len(demote)]
        if promote.size == 0:
            self._pin_hot()
            return 0, 0
        self._apply_rebalance(promote, np.asarray(demote, np.int64))
        self.promotions += int(promote.size)
        self.demotions += len(demote)
        self._pin_hot()
        return int(promote.size), len(demote)

    def _apply_rebalance(self, promote: np.ndarray,
                         demote: np.ndarray) -> None:
        """Execute a rebalance verdict: incremental insert/delete while
        the hot engine has slack, a full deterministic rebuild when
        not."""
        if self.hot is None:
            self._build_hot(promote)
            self.hot_rebuilds += 1
            return
        free = (self.hot.capacity or self.hot.n_active) - self.hot.n_active
        if int(promote.size) > free:
            final = (set(self._hot_slot) - {int(g) for g in demote}) \
                | {int(g) for g in promote}
            for g in demote:
                self._hot_stale.pop(int(g), None)
            self._build_hot(np.asarray(sorted(final), np.int64))
            self.hot_rebuilds += 1
            return
        if demote.size:
            slots = [self._hot_slot[int(g)] for g in demote]
            self.hot.delete(np.asarray(slots, np.int64))
            for g in demote:
                g = int(g)
                slot = self._hot_slot.pop(g)
                self._hot_gid[slot] = -1
                self._hot_stale.pop(g, None)
        start = self.hot.n_active
        self.hot.insert_batch(self._cold_rows(promote, "_vec_np"))
        self._hot_gid[start: start + promote.size] = promote
        for i, g in enumerate(promote):
            self._hot_slot[int(g)] = start + i
            self._hot_stale[int(g)] = 0
        if self.filtered and self._hot_labels is not None:
            self._hot_labels[start: start + promote.size] = \
                self._cold_rows(promote, "_labels_np")

    # ---------------------------------------------------------------- stats
    def tier_stats(self) -> dict:
        """Tier-residency counters for ``db.metrics()`` and the benches:
        hot-set occupancy, hot-hit fraction (lanes whose nearest
        neighbor was RAM-resident), promotion/demotion totals, and the
        cold tier's cumulative block reads."""
        return {
            "hot_rows": len(self._hot_slot),
            "hot_capacity": int(self._hot_cap),
            "hot_hit_fraction": (self.hot_hits / self.searches
                                 if self.searches else 0.0),
            "promotions": self.promotions,
            "demotions": self.demotions,
            "hot_rebuilds": self.hot_rebuilds,
            "rebalances": self.rebalances,
            "cold_block_reads": int(self.cold.io_stats().block_reads),
        }

    # ---------------------------------------------------------------- I/O
    def io_stats(self, reset: bool = False) -> IoStats:
        """The COLD tier's counters (the hot tier does no block I/O)."""
        return self.cold.io_stats(reset=reset)

    def reset_io(self) -> None:
        self.cold.reset_io()

    def tombstone_fraction(self) -> float:
        """Dead-row share of the canonical (cold) row range."""
        return self.cold.tombstone_fraction()

    @property
    def cache_stats(self) -> CacheStats:
        return self.cold.cache_stats

    # ---------------------------------------------------------------- persist
    def _write_manifest(self) -> None:
        manifest = {
            "format": TIERED_FORMAT,
            "version": TIERED_VERSION,
            "cold_tier": self.tiered.cold_tier,
            "cold": (COLD_DIR if self.tiered.cold_tier == "sharded"
                     else COLD_FILE),
            "mode": self.mode,
            "dim": self.dim,
            "seed": self.seed,
            "n_bits": self.n_bits,
            "bucket_capacity": self.bucket_capacity,
            "filtered": self.filtered,
            "n_labels": self.n_labels,
            "tiered": self.tiered.to_dict(),
            "hot_file": HOT_SIDECAR,
        }
        tmp = os.path.join(self.store_dir, TIERED_MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(self.store_dir, TIERED_MANIFEST_NAME))

    def _write_hot_sidecar(self) -> None:
        gids = self._hot_live_gids()
        np.savez(os.path.join(self.store_dir, HOT_SIDECAR),
                 gids=gids,
                 stale=np.asarray([self._hot_stale.get(int(g), 0)
                                   for g in gids], np.int64),
                 hot_cap=np.int64(self._hot_cap),
                 promotions=np.int64(self.promotions),
                 demotions=np.int64(self.demotions),
                 hot_rebuilds=np.int64(self.hot_rebuilds),
                 rebalances=np.int64(self.rebalances))

    def save(self) -> None:
        """Persist the whole tiered layout: the cold store through its
        own machinery, then the hot engine canonicalises (a
        deterministic rebuild over the live hot gid set) before the hot
        sidecar and the manifest are written."""
        self.cold.save()
        self._build_hot(self._hot_live_gids())
        self._pin_hot()
        self._write_manifest()
        self._write_hot_sidecar()

    @classmethod
    def load(cls, store_dir: str, mode: str | None = None,
             tiered: Optional[TieredSpec] = None,
             **engine_kwargs) -> "TieredVectorSearchEngine":
        """Reopen a tiered layout from its ``tiered.json`` manifest: the
        cold store through its own ``load`` (adapt sidecars, IoSpec and
        all), the hot tier rebuilt from the ``hot.npz`` gid set (dead
        rows filtered against the cold tombstones), counters resumed."""
        with open(os.path.join(store_dir, TIERED_MANIFEST_NAME)) as f:
            manifest = json.load(f)
        if manifest.get("format") != TIERED_FORMAT:
            raise ValueError(f"not a tiered CTPL manifest: "
                             f"{manifest.get('format')!r}")
        if int(manifest.get("version", 0)) != TIERED_VERSION:
            raise ValueError(f"unsupported tiered manifest version "
                             f"{manifest.get('version')}")
        cfg = tiered or TieredSpec.from_dict(manifest["tiered"])
        mode = mode or manifest["mode"]
        for key in ("n_bits", "bucket_capacity", "seed"):
            engine_kwargs.pop(key, None)
        self = cls(store_dir=store_dir, mode=mode,
                   seed=int(manifest["seed"]),
                   n_bits=int(manifest["n_bits"]),
                   bucket_capacity=int(manifest["bucket_capacity"]),
                   tiered=cfg, **engine_kwargs)
        cold_path = os.path.join(store_dir, manifest["cold"])
        kwargs = dict(vamana=self.vamana, cache_frames=self.cache_frames,
                      io=self.io, hop_backend=self.hop_backend,
                      device=self.device)
        if manifest["cold_tier"] == "sharded":
            self.cold = ShardedDiskVectorSearchEngine.load(
                cold_path, mode=mode, **kwargs)
            self.n_shards = self.cold.n_shards
        else:
            self.cold = DiskVectorSearchEngine.load(
                cold_path, mode=mode, n_bits=self.n_bits,
                bucket_capacity=self.bucket_capacity, seed=self.seed,
                **kwargs)
        try:
            self.io = self.cold.io
            self.filtered = bool(self.cold.filtered)
            self.n_labels = int(getattr(self.cold, "n_labels", 0))
            self.pq_subspaces = getattr(self.cold, "pq_subspaces",
                                        self.pq_subspaces)
            hpath = os.path.join(store_dir, manifest.get("hot_file",
                                                         HOT_SIDECAR))
            gids = np.empty(0, np.int64)
            if os.path.exists(hpath):
                with np.load(hpath) as z:
                    gids = np.asarray(z["gids"], np.int64)
                    self._hot_stale = {int(g): int(a) for g, a in
                                       zip(gids, np.asarray(z["stale"]))}
                    self._hot_cap = int(z["hot_cap"])
                    self.promotions = int(z["promotions"])
                    self.demotions = int(z["demotions"])
                    self.hot_rebuilds = int(z["hot_rebuilds"])
                    self.rebalances = int(z["rebalances"])
            if not self._hot_cap:
                self._hot_cap = self._resolve_hot_cap(self.cold.n_active)
            self._build_hot(gids)
            self._pin_hot()
        except BaseException:
            self.cold.close()
            raise
        return self

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self.cold.close()
