"""Graph-based beam search — Algorithm 1 of the paper, batched in torch.

Port of ``repro/core/beam_search.py``.  A batch of queries runs in
lockstep: each lane holds a fixed-size beam (ids / dists / expanded
flags) and expands its closest unexpanded entry per iteration; converged
lanes mask their updates to no-ops.  Starting points are an array
padded with -1 — the hook the catapult layer uses.

Differences from the reference, none of them observable in the results:

* ``dist_fn`` is batched: ``(queries (B, d), ids (B, M)) -> (B, M)``
  (the reference's is per lane and vmapped).  ``l2_dist_fn`` routes it
  through ``kernels.ops.gather_distance``, so on the card the composed
  hop's distances are the gather-distance kernel.
* ``lax.while_loop`` becomes a Python loop bounded by ``max_iters`` that
  leaves when no lane is active.  The check reads one bool from the
  device per hop (a device->host sync).  Once every lane has converged
  further iterations are no-ops, so checking less often would give the
  same results; the per-hop check is kept for now.
* Inactive lanes feed all -1 neighbor rows on both bodies (the reference
  does so on the fused body only); their outputs are discarded either
  way, and -1 rows cost no loads.
* ``neighbor_mask_fn`` is batched too: ``(lanes (B,), ids (B, M)) ->
  (B, M)`` bool.  The distance call gets the masked ids as -1, so a
  node that fails the predicate reads no row; its distance is +inf
  either way, and ``_merge`` still sees its id, so it counts in
  ``ndists`` exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fused_hop import FusedL2Hop

INVALID = -1


class SearchResult(NamedTuple):
    ids: torch.Tensor        # (B, k) int32
    dists: torch.Tensor      # (B, k) f32
    hops: torch.Tensor       # (B,) int32 — node expansions
    ndists: torch.Tensor     # (B,) int32 — distance computations
    trace: torch.Tensor      # (B, max_iters) expanded node ids, -1 padded
    scored: torch.Tensor     # (B, max_iters, R) scored-neighbor ids, or a
                             # (B, 1, 1) dummy when not requested
    converged: torch.Tensor  # (B,) bool — beam fully expanded (vs. iter cap)


class BeamState(NamedTuple):
    ids: torch.Tensor        # (B, L) int32, -1 = empty slot
    dists: torch.Tensor      # (B, L) f32, +inf for empty slots
    expanded: torch.Tensor   # (B, L) bool, True for empty slots
    hops: torch.Tensor       # (B,) int32
    ndists: torch.Tensor     # (B,) int32
    trace: torch.Tensor      # (B, max_iters) int32
    scored: torch.Tensor     # (B, max_iters, R) int32 or (B, 1, 1) dummy
    it: int                  # global iteration counter


def l2_dist_fn(vectors: torch.Tensor) -> Callable:
    """Default distance: full-precision squared L2 against a vector table,
    through the gather-distance kernel (its plain version on the CPU)."""

    def dist(queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return ops.gather_distance(vectors, ids, queries)

    return dist


def _dedup_candidates(cand_ids, cand_dists, beam_ids):
    """Mask candidates already in the beam or duplicated among themselves.
    (B, C) candidates, (B, L) beam -> (masked dists, fresh)."""
    in_beam = ((cand_ids[:, :, None] == beam_ids[:, None, :])
               & (beam_ids[:, None, :] >= 0)).any(2)
    c = cand_ids.shape[1]
    pos = torch.arange(c, device=cand_ids.device)
    earlier = ((cand_ids[:, :, None] == cand_ids[:, None, :])
               & (pos[None, :] < pos[:, None])[None])
    dup = in_beam | earlier.any(2)
    fresh = ~dup & (cand_ids >= 0)
    return torch.where(fresh, cand_dists, torch.inf), fresh


def _merge(beam_ids, beam_dists, beam_exp, cand_ids, cand_dists):
    """Merge candidates into the fixed-size beams, keeping the L closest
    (stable: the first of equal distances wins, as jnp.argsort)."""
    l = beam_ids.shape[1]
    cand_dists, fresh = _dedup_candidates(cand_ids, cand_dists, beam_ids)
    ids = torch.cat([beam_ids, cand_ids], 1)
    dists = torch.cat([beam_dists, cand_dists], 1)
    exp = torch.cat([beam_exp, torch.zeros_like(cand_ids, dtype=torch.bool)],
                    1)
    order = torch.argsort(dists, dim=1, stable=True)[:, :l]
    ids, dists, exp = (ids.gather(1, order), dists.gather(1, order),
                       exp.gather(1, order))
    invalid = ~torch.isfinite(dists)
    ids = torch.where(invalid, INVALID, ids)
    exp = exp | invalid
    return ids, dists, exp, fresh.sum(1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Static configuration of a beam search."""
    beam_width: int
    k: int
    max_iters: int
    # record every scored neighbor (Vamana build needs RobustPrune's full
    # visited set V)
    record_scored: bool = False
    # "unfused" = composed hop (gather-distance kernel + torch merge);
    # "fused" = one fused-hop kernel per hop when the dist_fn is a fused
    # hop backend.  Results are bit-identical either way.
    hop_backend: str = "unfused"


def beam_search(
    adjacency: torch.Tensor,        # (N, R) int32, -1 padded
    queries: torch.Tensor,          # (B, d) f32
    start_ids: torch.Tensor,        # (B, S) int32, -1 padded
    spec: SearchSpec,
    dist_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    neighbor_mask_fn: Optional[Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor]] = None,
    result_mask_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> SearchResult:
    """Batched Algorithm 1.

    ``neighbor_mask_fn``: (lanes (B,), ids (B, M)) -> bool, False
    excludes a node from the beam entirely (the filtered traversal
    constraint); a mask keeps the search on the composed hop, as the
    fused kernels model no predicate.
    ``result_mask_fn``: (B, L) ids -> bool, False excludes a node from
    *results* only (tombstoned nodes remain traversable).
    Returns a SearchResult; ``trace`` records expansion order.
    """
    b = queries.shape[0]
    l, max_iters = spec.beam_width, spec.max_iters
    dev = queries.device
    use_fused = (getattr(dist_fn, "is_fused_hop", False)
                 and neighbor_mask_fn is None)
    lane = torch.arange(b, device=dev)

    def masked_dists(ids):
        """Composed distances of (B, M) ids: +inf for -1 and for ids the
        mask rejects (those are passed on as -1, so no row is read)."""
        if neighbor_mask_fn is None:
            return torch.where(ids < 0, torch.inf, dist_fn(queries, ids))
        keep = neighbor_mask_fn(lane, ids)
        d = dist_fn(queries, torch.where(keep, ids, INVALID))
        return torch.where(keep & (ids >= 0), d, torch.inf)

    empty_ids = torch.full((b, l), INVALID, dtype=torch.int32, device=dev)
    empty_d = torch.full((b, l), torch.inf, device=dev)
    empty_exp = torch.ones((b, l), dtype=torch.bool, device=dev)
    if use_fused:
        # init is a fused hop into an empty beam: candidates = start ids
        ids, dists, exp, n0 = dist_fn.hop_batch(queries, start_ids, empty_ids,
                                                empty_d, empty_exp)
    else:
        ids, dists, exp, n0 = _merge(empty_ids, empty_d, empty_exp,
                                     start_ids, masked_dists(start_ids))
    r = adjacency.shape[1]
    scored_shape = (b, max_iters, r) if spec.record_scored else (b, 1, 1)
    s = BeamState(
        ids=ids, dists=dists, expanded=exp,
        hops=torch.zeros((b,), dtype=torch.int32, device=dev), ndists=n0,
        trace=torch.full((b, max_iters), INVALID, dtype=torch.int32,
                         device=dev),
        scored=torch.full(scored_shape, INVALID, dtype=torch.int32,
                          device=dev),
        it=0)

    while s.it < max_iters:
        active = ((s.ids >= 0) & ~s.expanded).any(1)                 # (B,)
        if not bool(active.any()):                 # one device->host sync
            break
        sel = torch.argmin(
            torch.where(s.expanded | (s.ids < 0), torch.inf, s.dists), dim=1)
        node = s.ids[lane, sel]                                      # (B,)
        exp2 = s.expanded.clone()
        exp2[lane, sel] = True
        nbrs = torch.where(((node < 0) | ~active)[:, None], INVALID,
                           adjacency[node.clamp(min=0).long()])      # (B, R)
        if use_fused:
            nids, ndsts, nexp, nfresh = dist_fn.hop_batch(
                queries, nbrs, s.ids, s.dists, exp2)
        else:
            nids, ndsts, nexp, nfresh = _merge(s.ids, s.dists, exp2, nbrs,
                                               masked_dists(nbrs))
        act = active[:, None]
        # trace/scored columns are written in place: only this loop holds them
        s.trace[:, s.it] = torch.where(active, node, INVALID)
        if spec.record_scored:
            s.scored[:, s.it] = torch.where(act, nbrs, INVALID)
        s = s._replace(
            ids=torch.where(act, nids, s.ids),
            dists=torch.where(act, ndsts, s.dists),
            expanded=torch.where(act, nexp, s.expanded),
            hops=s.hops + active.to(torch.int32),
            ndists=s.ndists + torch.where(active, nfresh, 0),
            it=s.it + 1)

    res_dists = s.dists
    if result_mask_fn is not None:
        keep = result_mask_fn(s.ids)
        res_dists = torch.where(keep & (s.ids >= 0), res_dists, torch.inf)
    # Beam is sorted ascending by construction; re-sort because result
    # masking may have disturbed the order.
    order = torch.argsort(res_dists, dim=1, stable=True)[:, : spec.k]
    top_ids = s.ids.gather(1, order)
    top_d = res_dists.gather(1, order)
    top_ids = torch.where(torch.isfinite(top_d), top_ids, INVALID)
    converged = (s.expanded | (s.ids < 0)).all(1)
    return SearchResult(ids=top_ids, dists=top_d, hops=s.hops,
                        ndists=s.ndists, trace=s.trace, scored=s.scored,
                        converged=converged)


def beam_search_l2(adjacency: torch.Tensor, vectors: torch.Tensor,
                   queries: torch.Tensor, start_ids: torch.Tensor,
                   spec: SearchSpec) -> SearchResult:
    """Full-precision L2 search, no filters, on either hop backend."""
    if spec.hop_backend == "fused":
        return beam_search(adjacency, queries, start_ids, spec,
                           FusedL2Hop(vectors))
    return beam_search(adjacency, queries, start_ids, spec,
                       l2_dist_fn(vectors))
