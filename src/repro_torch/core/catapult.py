"""CATAPULTED_LOOKUP — Algorithm 2 of the paper, batched.

Port of ``repro/core/catapult.py``.  Per query batch:

  1. hash queries with random-hyperplane LSH -> bucket indices
     (the LSH kernel on the card),
  2. gather each bucket's catapult destinations and append the graph
     medoid (the fallback that guarantees the unmodified-DiskANN
     baseline, §3.2 "Competitive recall"),
  3. filtered lanes drop destinations whose label fails the predicate
     (§3.4) and fall back to their label's entry point instead,
  4. run the unchanged beam search with that starting set,
  5. publish each query's best neighbor back to its bucket (LRU evict),
     tagged with the lane's filter.

"used" = the bucket supplied at least one valid destination; "won" = some
catapult start is strictly closer to the query than the fallback.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import buckets as bk
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.beam_search import SearchResult, SearchSpec, beam_search

INVALID = -1


@dataclasses.dataclass(frozen=True)
class CatapultState:
    lsh: lsh_mod.LSHParams
    buckets: bk.BucketState


def make_catapult_state(generator: torch.Generator, dim: int, n_bits: int = 8,
                        capacity: int = 40, device="cuda") -> CatapultState:
    """Defaults b=40, L=8 — the paper's tuned optimum (§4.5)."""
    return CatapultState(
        lsh=lsh_mod.make_lsh(generator, n_bits, dim, device),
        buckets=bk.make_buckets(2 ** n_bits, capacity, device))


class CatapultStats(NamedTuple):
    used: torch.Tensor    # (B,) bool — bucket supplied >=1 valid destination
    won: torch.Tensor     # (B,) bool — best start was a catapult, not the medoid
    hops: torch.Tensor
    ndists: torch.Tensor


def catapulted_lookup(
    state: CatapultState,
    adjacency: torch.Tensor,
    queries: torch.Tensor,                  # (B, d)
    spec: SearchSpec,
    dist_fn,
    medoid: int,
    *,
    filter_labels: Optional[torch.Tensor] = None,   # (B,) int32, -1 = unfiltered
    node_labels: Optional[torch.Tensor] = None,     # (N,) int32
    label_entry: Optional[torch.Tensor] = None,     # (n_labels,) entry points
    neighbor_mask_fn=None,
    result_mask_fn=None,
    publish_mask: Optional[torch.Tensor] = None,    # (B,) bool, False = don't publish
) -> tuple[CatapultState, SearchResult, CatapultStats]:
    """One batch of Algorithm 2.  Returns (new state, results, stats)."""
    b = queries.shape[0]
    dev = queries.device
    hashes = lsh_mod.hash_codes(state.lsh, queries)           # (B,)
    cat_ids, _ = bk.lookup(state.buckets, hashes)             # (B, cap)
    if filter_labels is None:
        filter_labels = torch.full((b,), INVALID, dtype=torch.int32,
                                   device=dev)
    flt = filter_labels[:, None]

    # a destination is valid only if it satisfies the lane's predicate
    # (§3.4); unfiltered lanes accept everything (empty slots are -1)
    cat_sp = cat_ids
    if node_labels is not None:
        dest = torch.where(cat_ids >= 0,
                           node_labels[cat_ids.clamp(min=0).long()], INVALID)
        valid = (cat_ids >= 0) & ((flt < 0) | (dest == flt))
        cat_sp = torch.where(valid, cat_ids, INVALID)

    # fallback: the global medoid, or the label's entry point for
    # filtered lanes (FilteredVamana)
    if label_entry is not None:
        fallback = torch.where(
            filter_labels >= 0,
            label_entry[filter_labels.clamp(min=0).long()], medoid)
    else:
        fallback = torch.full((b,), medoid, dtype=torch.int32, device=dev)
    fallback = fallback.to(torch.int32)[:, None]
    starts = torch.cat([cat_sp, fallback], 1)

    result = beam_search(adjacency, queries, starts, spec, dist_fn,
                         neighbor_mask_fn=neighbor_mask_fn,
                         result_mask_fn=result_mask_fn)

    used = (cat_sp >= 0).any(1)
    # "won": some catapult start is strictly closer to q than the fallback
    d_start = dist_fn(queries, cat_sp)
    d_fb = dist_fn(queries, fallback)[:, 0]
    won = used & (torch.where(cat_sp >= 0, d_start, torch.inf).min(1).values
                  < d_fb)

    # Masked lanes (batch padding, frozen replicas) neither publish nor
    # report usage.
    best = result.ids[:, 0]
    if publish_mask is not None:
        pm = publish_mask.to(device=dev, dtype=torch.bool)
        best = torch.where(pm, best, INVALID)
        used &= pm
        won &= pm
    new_buckets = bk.publish(state.buckets, hashes, best, filter_labels)
    new_state = CatapultState(lsh=state.lsh, buckets=new_buckets)
    stats = CatapultStats(used=used, won=won, hops=result.hops,
                          ndists=result.ndists)
    return new_state, result, stats
