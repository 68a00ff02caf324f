"""FilteredVamana support (paper §2.1.4, §3.4).

Port of ``repro/core/filters.py``.  Filtered (c,k)-ANN constrains
results to nodes whose label satisfies the query predicate (single-label
equality, the Papers workload's arXiv category).  Two halves:

* host numpy, line for line the reference's: ``label_entry_points``
  (medoid of each label), ``build_stitched_graph`` (a global Vamana
  graph unioned with per-label Vamana subgraphs in its slack columns,
  so greedy traversal restricted to one label stays connected; the
  builds' searches run on ``device``) and ``refresh_label_entries``
  (re-elect entries that were tombstoned),
* the search-time constraint ``make_filter_mask_fn``, the batched
  ``neighbor_mask_fn`` that ``core.beam_search`` takes; catapult
  destinations are vetted the same way in ``core.catapult``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.vamana import VamanaParams, build_vamana, medoid_index


def label_entry_points(vectors: np.ndarray, labels: np.ndarray,
                       n_labels: int) -> np.ndarray:
    """Per-label entry point: the medoid of each label's subset (0 for a
    label with no rows)."""
    entries = np.zeros(n_labels, np.int32)
    for lbl in range(n_labels):
        idx = np.nonzero(labels == lbl)[0]
        if idx.size == 0:
            entries[lbl] = 0
            continue
        entries[lbl] = idx[medoid_index(vectors[idx])]
    return entries


def build_stitched_graph(vectors: np.ndarray, labels: np.ndarray,
                         n_labels: int, params: VamanaParams,
                         label_degree: int | None = None, device="cuda"
                         ) -> tuple[np.ndarray, int, np.ndarray]:
    """Global Vamana ∪ per-label Vamana (StitchedVamana).

    Returns (adjacency (N, R_global + R_label), global medoid, per-label
    entry points).  Rows are -1 padded; each row's label edges fill its
    free slots in subgraph order, skipping edges it already has.
    """
    label_degree = label_degree or max(params.max_degree // 2, 8)
    g_adj, med = build_vamana(vectors, params, device=device)
    n, rg = g_adj.shape
    out = np.full((n, rg + label_degree), -1, np.int32)
    out[:, :rg] = g_adj

    sub_params = VamanaParams(max_degree=label_degree, alpha=params.alpha,
                              build_beam=max(params.build_beam // 2, 16),
                              batch=params.batch, seed=params.seed + 1)
    for lbl in range(n_labels):
        idx = np.nonzero(labels == lbl)[0]
        if idx.size < 2:
            continue
        sub_adj, _ = build_vamana(vectors[idx], sub_params, device=device)
        # remap subgraph-local ids to global and append into the slack slots
        for local, gid in enumerate(idx):
            nbrs = sub_adj[local]
            nbrs = idx[nbrs[nbrs >= 0]]
            existing = set(out[gid][out[gid] >= 0].tolist())
            free = np.nonzero(out[gid] == -1)[0]
            j = 0
            for nb in nbrs:
                if nb in existing or j >= free.size:
                    continue
                out[gid, free[j]] = nb
                existing.add(int(nb))
                j += 1
    return out, med, label_entry_points(vectors, labels, n_labels)


def refresh_label_entries(entries: np.ndarray, vectors: np.ndarray,
                          labels: np.ndarray, tombstones: np.ndarray,
                          n_active: int) -> np.ndarray:
    """Re-elect per-label entry points whose node was tombstoned.

    Labels whose entry is still live keep it; labels with no live
    members get the degenerate entry 0 (their searches return nothing
    after masking anyway).
    """
    entries = np.asarray(entries, np.int32).copy()
    for lbl in range(entries.size):
        e = int(entries[lbl])
        if 0 <= e < n_active and not tombstones[e]:
            continue
        idx = np.nonzero((labels[:n_active] == lbl)
                         & ~tombstones[:n_active])[0]
        entries[lbl] = idx[medoid_index(vectors[idx])] if idx.size else 0
    return entries


def make_filter_mask_fn(node_labels: torch.Tensor,
                        filter_labels: torch.Tensor):
    """Batched ``neighbor_mask_fn`` for ``beam_search``: True keeps the
    node.  ``filter_labels``: (B,) per-lane label, -1 = unfiltered lane;
    ids < 0 are kept (the search gives them +inf itself)."""

    def mask(lanes: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        flt = filter_labels[lanes][:, None]
        lbl = node_labels[ids.clamp(min=0).long()]
        return (flt < 0) | (lbl == flt) | (ids < 0)

    return mask
