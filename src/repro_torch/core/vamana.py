"""Vamana proximity-graph construction (DiskANN's build algorithm).

Port of ``repro/core/vamana.py``.  The split is the reference's:

* the *search* inner loop of the build (greedy traversal collecting the
  visited set for RobustPrune) is the batched torch ``beam_search`` on
  the engine's device — the gather-distance kernel on the card,
* the sequential graph surgery (RobustPrune + reverse-edge insertion)
  runs on the host in numpy, line for line the reference's.

Two passes (alpha=1.0 then alpha) follow the DiskANN reference build.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.beam_search import SearchSpec, beam_search_l2
from repro_torch.device import resolve_device


@dataclasses.dataclass
class VamanaParams:
    max_degree: int = 32        # R
    alpha: float = 1.2          # pruning parameter (paper §3.3)
    build_beam: int = 64        # L at build time
    batch: int = 512            # insertion batch per search call
    seed: int = 0


def medoid_index(vectors: np.ndarray) -> int:
    """Node closest to the centroid — DiskANN's medoid approximation."""
    centroid = vectors.mean(axis=0)
    return int(np.argmin(((vectors - centroid) ** 2).sum(axis=1)))


def robust_prune(p: int, cand_ids: np.ndarray, vectors: np.ndarray,
                 alpha: float, max_degree: int) -> np.ndarray:
    """DiskANN RobustPrune: keep diverse close neighbors of p.

    Iteratively takes the closest remaining candidate v, then discards any
    candidate w with alpha * d(v, w) <= d(p, w) (w is "covered" by v).
    """
    cand_ids = np.unique(cand_ids)
    cand_ids = cand_ids[(cand_ids >= 0) & (cand_ids != p)]
    if cand_ids.size == 0:
        return cand_ids
    dp = ((vectors[cand_ids] - vectors[p]) ** 2).sum(axis=1)
    order = np.argsort(dp)
    cand_ids, dp = cand_ids[order], dp[order]
    alive = np.ones(cand_ids.size, bool)
    out = []
    for i in range(cand_ids.size):
        if not alive[i]:
            continue
        v = cand_ids[i]
        out.append(v)
        if len(out) >= max_degree:
            break
        rest = alive.copy()
        rest[: i + 1] = False
        idx = np.nonzero(rest)[0]
        if idx.size:
            dvw = ((vectors[cand_ids[idx]] - vectors[v]) ** 2).sum(axis=1)
            # squared distances: the alpha test in DiskANN is on true
            # distances; alpha**2 preserves it under squaring.
            covered = (alpha ** 2) * dvw <= dp[idx]
            alive[idx[covered]] = False
    return np.asarray(out, dtype=np.int32)


def _random_regular_init(n: int, r: int, rng: np.random.Generator) -> np.ndarray:
    adj = rng.integers(0, n, size=(n, r), dtype=np.int64).astype(np.int32)
    # avoid trivial self loops (duplicates are fine for an init graph)
    self_loop = adj == np.arange(n, dtype=np.int32)[:, None]
    adj[self_loop] = (adj[self_loop] + 1) % n
    return adj


def build_vamana(vectors: np.ndarray, params: VamanaParams | None = None,
                 capacity: int | None = None,
                 device="cuda") -> tuple[np.ndarray, int]:
    """Build a Vamana graph.

    Args:
      vectors: (N, d) float32 host array.
      params: build parameters.
      capacity: preallocate adjacency rows for future insertions;
        defaults to N.
      device: where the batched searches run ("cpu" to ask for the
        plain PyTorch path; "cuda" raises where there is no card).

    Returns (adjacency (capacity, R) int32 with -1 padding, medoid id).
    """
    device = resolve_device(device)
    params = params or VamanaParams()
    n, _ = vectors.shape
    r = params.max_degree
    rng = np.random.default_rng(params.seed)
    adj = _random_regular_init(n, r, rng)
    med = medoid_index(vectors)
    dev_vectors = torch.as_tensor(vectors, device=device)
    # record_scored: RobustPrune's candidate set is the FULL visited set V
    # (every node whose distance was computed), not just the expansion path.
    spec = SearchSpec(beam_width=params.build_beam, k=1,
                      max_iters=params.build_beam * 2, record_scored=True)
    starts = torch.full((params.batch, 1), med, dtype=torch.int32,
                        device=device)

    for alpha in (1.0, params.alpha):
        order = rng.permutation(n)
        for lo in range(0, n, params.batch):
            pts = order[lo: lo + params.batch]
            pad = params.batch - pts.size
            q_ids = np.concatenate([pts, np.zeros(pad, np.int64)]) if pad else pts
            dev_adj = torch.as_tensor(adj, device=device)
            res = beam_search_l2(dev_adj, dev_vectors,
                                 dev_vectors[torch.as_tensor(q_ids,
                                                             device=device)],
                                 starts, spec)
            scored = res.scored.cpu().numpy()       # (batch, max_iters, R)
            beam_ids = res.ids.cpu().numpy()        # includes k best
            for row, p in enumerate(pts):
                cand = np.concatenate([scored[row].ravel(), beam_ids[row],
                                       adj[p]])
                pruned = robust_prune(p, cand, vectors, alpha, r)
                adj[p] = -1
                adj[p, : pruned.size] = pruned
                # reverse edges with overflow pruning
                for v in pruned:
                    row_v = adj[v]
                    if p in row_v:
                        continue
                    slot = np.nonzero(row_v == -1)[0]
                    if slot.size:
                        adj[v, slot[0]] = p
                    else:
                        re = robust_prune(v, np.concatenate([row_v, [p]]),
                                          vectors, alpha, r)
                        adj[v] = -1
                        adj[v, : re.size] = re
    if capacity and capacity > n:
        grown = np.full((capacity, r), -1, np.int32)
        grown[:n] = adj
        adj = grown
    return adj, med
