"""VectorSearchEngine — the RAM-tier facade over the paper's machinery.

Port of ``repro/core/engine.py`` for the RAM tier.  One engine object =
one index + one acceleration mode:

* ``mode='diskann'``   — vanilla Vamana beam search from the medoid
                         (the paper's primary baseline),
* ``mode='catapult'``  — CatapultDB: LSH-bucketed shortcut layer
                         (the paper's contribution).

``pq_subspaces=M`` traverses with DiskANN's PQ-approximate distances and
reranks the whole final beam at full precision.

The search path runs on the engine's ``device`` (the card by default);
the host keeps numpy mirrors for graph surgery (build).  Not ported yet,
and raising ``NotImplementedError`` naming their ROADMAP item:
``mode='lsh_apg'``, filtered search (labels),
``insert``/``delete``/``consolidate`` and ``search_two_phase``.
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import catapult as cat
from repro_torch.core import pq as pq_mod
from repro_torch.core.beam_search import SearchSpec, beam_search, l2_dist_fn
from repro_torch.core.vamana import VamanaParams, build_vamana
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_hop import FusedL2Hop, FusedPQHop

_ITEM5 = "ROADMAP queue 1, item 5 (core/engine.py beyond the RAM-tier main path)"


class SearchStats(NamedTuple):
    hops: np.ndarray          # (B,) node expansions
    ndists: np.ndarray        # (B,) distance computations
    used: np.ndarray          # (B,) bool catapult used (catapult mode only)
    won: np.ndarray           # (B,) bool catapult beat fallback


class RamStore:
    """Device-memory-scale backend: plain numpy arrays on the host."""

    def __init__(self, vectors: np.ndarray, adjacency: np.ndarray):
        self.vectors = vectors        # (capacity, d) float32
        self.adjacency = adjacency    # (capacity, R) int32, -1 padded

    @classmethod
    def allocate(cls, capacity: int, dim: int, degree: int) -> 'RamStore':
        return cls(np.zeros((capacity, dim), np.float32),
                   np.full((capacity, degree), -1, np.int32))


def brute_force_knn(vectors: np.ndarray, queries: np.ndarray,
                    k: int) -> np.ndarray:
    """Exact ground truth (chunked to bound memory)."""
    out = np.zeros((queries.shape[0], k), np.int32)
    for lo in range(0, queries.shape[0], 256):
        q = queries[lo: lo + 256]
        d = ((q[:, None, :] - vectors[None, :, :]) ** 2).sum(-1)
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
    pq_subspaces: Optional[int] = None
    seed: int = 0
    capacity: Optional[int] = None  # adjacency row preallocation
    # traversal hop implementation: "unfused" (gather-distance kernel +
    # torch merge) or "fused" (one fused-hop kernel per hop).  Results
    # are bit-identical.
    hop_backend: str = 'unfused'
    device: object = 'cuda'

    # populated by build()
    n_active: int = 0
    medoid: int = 0

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.mode == 'lsh_apg':
            raise NotImplementedError(f"mode='lsh_apg' is not ported yet "
                                      f"({_ITEM5}: core/lsh_apg.py)")
        if self.mode not in ('catapult', 'diskann'):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.hop_backend not in ('unfused', 'fused'):
            raise ValueError(f"unknown hop_backend {self.hop_backend!r}")

    def build(self, vectors: np.ndarray, labels: np.ndarray | None = None,
              n_labels: int | None = None,
              prebuilt=None) -> 'VectorSearchEngine':
        """prebuilt: optional (adjacency, medoid) — share one Vamana build
        across engines (or carry the reference's graph across)."""
        if labels is not None:
            raise NotImplementedError(f"filtered search is not ported yet "
                                      f"({_ITEM5}: core/filters.py)")
        vectors = np.ascontiguousarray(vectors, np.float32)
        n, d = vectors.shape
        cap = self.capacity or n
        if prebuilt is not None:
            adj, med = prebuilt[0], prebuilt[1]
        else:
            adj, med = build_vamana(vectors, self.vamana, capacity=cap,
                                    device=self.device)
        store = RamStore.allocate(cap, d, adj.shape[1])
        sv, sa = store.vectors, store.adjacency
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

    def _init_aux(self, vectors: np.ndarray,
                  pq_codebook: pq_mod.PQCodebook | None = None) -> None:
        """Catapult LSH + buckets and the PQ codebook + codes,
        deterministic in (seed, vectors).

        The hyperplanes come from a CPU ``torch.Generator`` seeded with
        ``seed`` and the codebook's initial rows from a second one seeded
        with ``seed + 1`` (the reference splits one ``jax.random`` key;
        torch cannot replay it), so one seed gives the same state on the
        CPU and on the card.  ``pq_codebook`` skips the training (a
        carried-over codebook, as the reference's disk reopen passes its
        persisted one); the codes are encoded from it either way."""
        if self.mode == 'catapult':
            gen = torch.Generator().manual_seed(self.seed)
            self._cat = cat.make_catapult_state(
                gen, vectors.shape[1], self.n_bits, self.bucket_capacity,
                self.device)
        if self.pq_subspaces:
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
    def _sync_device(self) -> None:
        self._adj = torch.as_tensor(self._adj_np, device=self.device)
        self._vec = torch.as_tensor(self._vec_np, device=self.device)
        self._tomb = torch.as_tensor(self._tomb_np, device=self.device)
        self._codes = (torch.as_tensor(self._codes_np, device=self.device)
                       if self.pq_subspaces else None)

    # ---------------------------------------------------------------- search
    def search(self, queries: np.ndarray, k: int,
               beam_width: int | None = None,
               filter_labels: np.ndarray | None = None,
               max_iters: int | None = None,
               publish_mask: np.ndarray | None = None,
               trace=None
               ) -> tuple[np.ndarray, np.ndarray, SearchStats]:
        """Batched k-NN search.  Returns (ids (B,k), dists (B,k), stats).

        ``publish_mask`` ((B,) bool) opts lanes out of the catapult
        bucket publish and usage stats.  ``trace`` is an optional
        ``repro_torch.obs.TraceRecorder``: the route and rerank stages
        are timed into it (each synced with the device).
        """
        if filter_labels is not None:
            raise NotImplementedError(f"filtered search is not ported yet "
                                      f"({_ITEM5}: core/filters.py)")
        q = torch.as_tensor(np.ascontiguousarray(queries, np.float32),
                            device=self.device)
        l = beam_width or max(2 * k, 16)
        # PQ mode reranks the *entire* final beam at full precision
        # (DiskANN's fetch of the candidate list), so the search returns
        # the whole beam, not just k PQ-approximate winners.
        # max_iters is a SAFETY bound, not a budget: Algorithm 1 stops
        # when the beam converges.
        spec = SearchSpec(beam_width=l, k=(l if self.pq_subspaces else k),
                          max_iters=max_iters or (4 * l + 64),
                          hop_backend=self.hop_backend)
        stage = trace.stage if trace is not None else (lambda _: nullcontext())
        sync = trace is not None and self.device.type == "cuda"
        with stage("route"):
            res, used, won = self._dispatch(q, spec, publish_mask=publish_mask)
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

    def _dispatch(self, queries: torch.Tensor, spec: SearchSpec,
                  publish_mask=None):
        """Run the mode's traversal; returns (raw result, used, won)."""
        b = queries.shape[0]
        dist = _mk_dist(self._vec, spec.hop_backend,
                        (self._pq, self._codes) if self.pq_subspaces
                        else None)
        if self.mode == 'catapult':
            pm = (None if publish_mask is None
                  else torch.as_tensor(np.asarray(publish_mask, bool),
                                       device=self.device))
            new_cat, res, st = _search_catapult(
                self._cat, self._adj, dist, self._tomb, queries,
                self.medoid, spec, pm)
            self._cat = new_cat
            return res, st.used.cpu().numpy(), st.won.cpu().numpy()
        res = _search_diskann(self._adj, dist, self._tomb, queries,
                              self.medoid, spec)
        z = np.zeros(b, bool)
        return res, z, z

    def search_two_phase(self, queries, k, beam_width=None, phase1_iters=8):
        raise NotImplementedError(f"search_two_phase is not ported yet "
                                  f"({_ITEM5})")

    # ---------------------------------------------------------------- updates
    def insert(self, new_vectors, labels=None):
        raise NotImplementedError(f"insert is not ported yet ({_ITEM5}: "
                                  f"core/insert.py)")

    def delete(self, ids) -> None:
        raise NotImplementedError(f"delete is not ported yet ({_ITEM5}: "
                                  f"core/insert.py)")

    def consolidate(self) -> int:
        raise NotImplementedError(f"consolidate is not ported yet ({_ITEM5}: "
                                  f"core/insert.py)")


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


def _masks(tomb: torch.Tensor):
    """The result mask hides tombstoned nodes (filters not ported yet)."""
    def result_mask(ids):
        return ~tomb[ids.clamp(min=0).long()]
    return result_mask


def _search_diskann(adj, dist, tomb, queries, medoid: int, spec: SearchSpec):
    b = queries.shape[0]
    starts = torch.full((b, 1), medoid, dtype=torch.int32,
                        device=queries.device)
    return beam_search(adj, queries, starts, spec, dist,
                       result_mask_fn=_masks(tomb))


def _search_catapult(cat_state, adj, dist, tomb, queries, medoid: int,
                     spec: SearchSpec, publish_mask=None):
    return cat.catapulted_lookup(
        cat_state, adj, queries, spec, dist, medoid,
        result_mask_fn=_masks(tomb), publish_mask=publish_mask)
