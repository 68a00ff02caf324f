"""FreshVamana-style dynamic insertion and tombstone deletion (paper §3.2).

Port of ``repro/core/insert.py``.  Insertion follows FreshDiskANN:
greedy-search the current graph for each new point (batched
``beam_search_l2`` on the device, the gather-distance kernel on the
card), RobustPrune its visited set into out-edges, then add reverse
edges with overflow pruning.  The graph surgery is host numpy, line for
line the reference's.

The reference copies the whole adjacency and vector table to the device
for every insert batch.  Here the caller hands in its device mirrors of
the two tables: the batch's vectors are written into them before the
search and the rows the surgery touched after it.  The search sees the
same pre-batch graph, because that graph has no edge into the new rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.beam_search import SearchSpec, beam_search_l2
from repro_torch.core.vamana import VamanaParams, robust_prune


def insert_batch(adjacency: np.ndarray, vectors: np.ndarray, n_active: int,
                 new_vectors: np.ndarray, medoid: int, params: VamanaParams,
                 dev_adj: torch.Tensor, dev_vec: torch.Tensor) -> int:
    """Insert ``new_vectors`` into rows [n_active, n_active+B) in place.

    ``adjacency``/``vectors`` are the host arrays, preallocated with
    capacity, and ``dev_adj``/``dev_vec`` their mirrors on the device the
    search runs on, kept current row by row.  Returns the new n_active.
    """
    b = new_vectors.shape[0]
    cap = adjacency.shape[0]
    if n_active + b > cap:
        raise ValueError(f"inserting {b} rows into {n_active} of {cap}: "
                         f"capacity exceeded; rebuild with larger capacity")
    device = dev_vec.device
    vectors[n_active: n_active + b] = new_vectors
    dev_vec[n_active: n_active + b] = torch.as_tensor(new_vectors,
                                                      device=device)

    spec = SearchSpec(beam_width=params.build_beam, k=1,
                      max_iters=params.build_beam * 2, record_scored=True)
    res = beam_search_l2(dev_adj, dev_vec, dev_vec[n_active: n_active + b],
                         torch.full((b, 1), medoid, dtype=torch.int32,
                                    device=device), spec)
    scored = res.scored.cpu().numpy()
    beam_ids = res.ids.cpu().numpy()
    r = adjacency.shape[1]
    touched = set(range(n_active, n_active + b))
    for row in range(b):
        p = n_active + row
        cand = np.concatenate([scored[row].ravel(), beam_ids[row]])
        # Sequential-insert semantics (FreshVamana): later points in a batch
        # must see earlier ones, but the device search ran against the
        # pre-batch graph, so the nearest earlier in-batch points join the
        # prune candidates here.
        if row > 0:
            earlier = np.arange(n_active, p, dtype=np.int32)
            d_e = ((vectors[earlier] - vectors[p]) ** 2).sum(axis=1)
            earlier = earlier[np.argsort(d_e)[:32]]
            cand = np.concatenate([cand, earlier])
        pruned = robust_prune(p, cand, vectors, params.alpha, r)
        adjacency[p] = -1
        adjacency[p, : pruned.size] = pruned
        got_in_edge = False
        for v in pruned:
            row_v = adjacency[v]
            if p in row_v:
                got_in_edge = True
                continue
            touched.add(int(v))
            slot = np.nonzero(row_v == -1)[0]
            if slot.size:
                adjacency[v, slot[0]] = p
                got_in_edge = True
            else:
                re = robust_prune(v, np.concatenate([row_v, [p]]), vectors,
                                  params.alpha, r)
                adjacency[v] = -1
                adjacency[v, : re.size] = re
                got_in_edge = got_in_edge or p in re
        # If alpha-pruning dropped p from every back-edge list (a far,
        # out-of-distribution insert), force one in-edge at p's nearest
        # neighbor by replacing that node's farthest out-edge.
        if not got_in_edge and pruned.size:
            v0 = pruned[0]          # robust_prune orders by distance
            row_v = adjacency[v0]
            d_nb = ((vectors[np.maximum(row_v, 0)] - vectors[v0]) ** 2).sum(1)
            d_nb[row_v < 0] = -np.inf
            adjacency[v0, int(np.argmax(d_nb))] = p
            touched.add(int(v0))
    rows = np.fromiter(sorted(touched), np.int64, len(touched))
    dev_adj[torch.as_tensor(rows, device=device)] = torch.as_tensor(
        adjacency[rows], device=device)
    return n_active + b


def delete(tombstones: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Tombstone deletion: nodes stay traversable and vanish from
    results (searches pass a ``result_mask_fn`` keyed on this array)."""
    tombstones = tombstones.copy()
    tombstones[ids] = True
    return tombstones


def consolidate(adjacency: np.ndarray, vectors: np.ndarray,
                tombstones: np.ndarray, n_active: int,
                params: VamanaParams) -> int:
    """FreshVamana's consolidation: splice tombstoned nodes out of the
    graph (FreshDiskANN Algorithm 4).

    Every live node with an out-edge to a deleted node replaces it with
    that node's live out-neighborhood, RobustPruned back to the degree
    budget; the deleted rows then lose their out-edges.  Ids stay
    stable and ``n_active`` never shrinks.  Mutates ``adjacency`` in
    place; returns the number of live rows repaired.
    """
    deleted = tombstones[:n_active].nonzero()[0]
    if deleted.size == 0:
        return 0
    dead = np.zeros(adjacency.shape[0], bool)
    dead[deleted] = True
    r = adjacency.shape[1]
    # live nodes pointing at any deleted node
    live_rows = (~tombstones[:n_active]).nonzero()[0]
    touches = dead[np.maximum(adjacency[live_rows], 0)] \
        & (adjacency[live_rows] >= 0)
    repaired = live_rows[touches.any(axis=1)]
    for v in repaired:
        row = adjacency[v]
        row = row[row >= 0]
        keep = row[~dead[row]]
        gone = row[dead[row]]
        # inherit each deleted neighbor's live out-neighborhood
        inherit = adjacency[gone].ravel()
        inherit = inherit[inherit >= 0]
        inherit = inherit[~dead[inherit] & (inherit != v)]
        cand = np.unique(np.concatenate([keep, inherit]))
        adjacency[v] = -1
        if cand.size:
            pruned = robust_prune(v, cand, vectors, params.alpha, r)
            adjacency[v, : pruned.size] = pruned
    # disconnect the deleted rows themselves
    adjacency[deleted] = -1
    return int(repaired.size)
