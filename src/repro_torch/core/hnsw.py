"""Hierarchical (HNSW-style) index — the paper's second named substrate.

Port of ``repro/core/hnsw.py``.  CatapultDB claims index-agnosticism
over "any index that accepts a hint for where to begin the search, such
as the entry node in DiskANN or HNSW" (paper §1/§3); this substrate
makes the claim executable: a level hierarchy whose upper levels are
Vamana graphs over nested random subsets (the reference's stacked-Vamana
formulation of HNSW).

Search descends greedily from the top-level entry to a level-1 landing
node, then runs the standard level-0 beam search.  Every level's search
is the port's ``beam_search_l2`` (the gather-distance kernel on the
card).  The catapult layer plugs in exactly as for DiskANN: its
destinations (``lsh_hash`` on the card, then ``core/buckets``) are extra
level-0 starting points, racing the hierarchy's landing node.

The upper levels' subsets come from ``np.random.default_rng(seed)``, as
in the reference, so both packages pick the same rows; each level's
graph is a Vamana build, which agrees across the packages on >= 99% of
rows, so parity tests carry the reference's hierarchy across with
``repro_torch.convert.hnsw_index_from_numpy``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import buckets as bk
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.beam_search import SearchSpec, beam_search_l2
from repro_torch.core.vamana import VamanaParams, build_vamana, medoid_index
from repro_torch.device import resolve_device


@dataclasses.dataclass
class HnswIndex:
    vectors: torch.Tensor           # (N, d)
    level_ids: list                 # per level >= 1: (n_l,) global ids (np)
    level_adj: list                 # per level >= 1: (n_l, R) local-id adjacency
    base_adj: torch.Tensor          # (N, R) level-0 graph
    entry: int                      # global id of the top-level entry


def build_hnsw(vectors: np.ndarray, params: VamanaParams | None = None,
               level_scale: int = 16, max_levels: int = 4,
               seed: int = 0, device="cuda") -> HnswIndex:
    """Nested-subset hierarchy: level l holds ~N/level_scale^l points;
    every level's Vamana build runs on ``device``."""
    device = resolve_device(device)
    params = params or VamanaParams()
    rng = np.random.default_rng(seed)
    n = vectors.shape[0]
    base_adj, med = build_vamana(vectors, params, device=device)

    level_ids, level_adj = [], []
    ids = np.arange(n)
    up = dataclasses.replace(params, max_degree=max(params.max_degree // 2, 8),
                             build_beam=max(params.build_beam // 2, 16))
    for _ in range(max_levels):
        keep = max(len(ids) // level_scale, 4)
        if keep < 4 or len(ids) <= 8:
            break
        ids = np.sort(rng.choice(ids, size=keep, replace=False))
        adj, _ = build_vamana(vectors[ids], up, device=device)
        level_ids.append(ids)
        level_adj.append(torch.as_tensor(adj, device=device))
    if level_ids:
        top = level_ids[-1]
        entry = int(top[medoid_index(vectors[top])])
    else:
        entry = med
    return HnswIndex(vectors=torch.as_tensor(vectors, device=device),
                     level_ids=level_ids, level_adj=level_adj,
                     base_adj=torch.as_tensor(base_adj, device=device),
                     entry=entry)


def descend(index: HnswIndex, queries: torch.Tensor) -> torch.Tensor:
    """Greedy top-down walk; returns (B,) level-0 entry candidates."""
    b = queries.shape[0]
    dev = queries.device
    cur = torch.full((b,), index.entry, dtype=torch.int32, device=dev)
    spec = SearchSpec(beam_width=2, k=1, max_iters=24)
    for ids_np, adj in zip(reversed(index.level_ids),
                           reversed(index.level_adj)):
        ids = torch.as_tensor(np.asarray(ids_np, np.int32), device=dev)
        # map current global entries into this level's local id space
        # (entries come from the level above, a subset of this level)
        local = torch.searchsorted(ids, cur).to(torch.int32)
        local = local.clamp(0, ids.shape[0] - 1)
        res = beam_search_l2(adj, index.vectors[ids.long()], queries,
                             local[:, None], spec)
        cur = ids[res.ids[:, 0].clamp(min=0).long()]
    return cur


def search(index: HnswIndex, queries: torch.Tensor, spec: SearchSpec,
           extra_starts: torch.Tensor | None = None):
    """Hierarchy descent + level-0 beam search.

    extra_starts: (B, S) additional level-0 starting points — the
    catapult hook (same contract as DiskANN's medoid slot).
    """
    entries = descend(index, queries)[:, None]
    starts = (entries if extra_starts is None
              else torch.cat([extra_starts, entries], 1))
    return beam_search_l2(index.base_adj, index.vectors, queries, starts,
                          spec)


@dataclasses.dataclass
class HnswEngine:
    """Thin engine facade: HNSW substrate x {plain, catapult} modes, on
    ``device`` (the card by default)."""
    mode: str = "catapult"
    n_bits: int = 8
    bucket_capacity: int = 40
    seed: int = 0
    device: object = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def build(self, vectors: np.ndarray,
              params: VamanaParams | None = None) -> "HnswEngine":
        """The hierarchy, then the catapult hyperplanes from a CPU
        ``torch.Generator(seed)`` (the reference draws them with
        ``jax.random``; parity tests transplant them) and empty
        buckets."""
        self.index = build_hnsw(vectors, params, seed=self.seed,
                                device=self.device)
        d = vectors.shape[1]
        self._lsh = lsh_mod.make_lsh(torch.Generator().manual_seed(self.seed),
                                     self.n_bits, d, self.device)
        self._buckets = bk.make_buckets(2 ** self.n_bits,
                                        self.bucket_capacity, self.device)
        return self

    def search(self, queries: np.ndarray, k: int, beam_width: int = 16):
        q = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                            device=self.device)
        b = q.shape[0]
        spec = SearchSpec(beam_width=max(beam_width, k), k=k,
                          max_iters=4 * beam_width + 64)
        if self.mode == "catapult":
            hashes = lsh_mod.hash_codes(self._lsh, q)
            cat_ids, _ = bk.lookup(self._buckets, hashes)
            res = search(self.index, q, spec, extra_starts=cat_ids)
            self._buckets = bk.publish(
                self._buckets, hashes, res.ids[:, 0],
                torch.full((b,), -1, dtype=torch.int32, device=self.device))
            used = (cat_ids >= 0).any(1).cpu().numpy()
        else:
            res = search(self.index, q, spec)
            used = np.zeros(b, bool)
        return (res.ids.cpu().numpy(), res.dists.cpu().numpy(),
                {"hops": res.hops.cpu().numpy(),
                 "ndists": res.ndists.cpu().numpy(), "used": used})
