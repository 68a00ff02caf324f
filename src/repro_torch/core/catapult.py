"""CATAPULTED_LOOKUP — Algorithm 2 of the paper, batched.

Port of ``repro/core/catapult.py``.  Per query batch:

  1. hash queries with random-hyperplane LSH -> bucket indices
     (the LSH kernel on the card),
  2. gather each bucket's catapult destinations and append the graph
     medoid (the fallback that guarantees the unmodified-DiskANN
     baseline, §3.2 "Competitive recall"),
  3. run the unchanged beam search with that starting set,
  4. publish each query's best neighbor back to its bucket (LRU evict).

"used" = the bucket supplied at least one valid destination; "won" = some
catapult start is strictly closer to the query than the fallback.
Filtered search (§3.4: label-checked destinations, per-label entry
points) is not ported yet.
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
    node_labels: Optional[torch.Tensor] = None,
    label_entry: Optional[torch.Tensor] = None,
    result_mask_fn=None,
    publish_mask: Optional[torch.Tensor] = None,    # (B,) bool, False = don't publish
) -> tuple[CatapultState, SearchResult, CatapultStats]:
    """One batch of Algorithm 2.  Returns (new state, results, stats)."""
    if node_labels is not None or label_entry is not None:
        raise NotImplementedError(
            "filtered catapult search is not ported yet (ROADMAP queue 1, "
            "item 5: core/filters.py)")
    b = queries.shape[0]
    dev = queries.device
    hashes = lsh_mod.hash_codes(state.lsh, queries)           # (B,)
    # unfiltered lanes accept every destination: empty slots are already -1
    cat_sp, _ = bk.lookup(state.buckets, hashes)              # (B, cap)
    if filter_labels is None:
        filter_labels = torch.full((b,), INVALID, dtype=torch.int32,
                                   device=dev)
    fallback = torch.full((b, 1), medoid, dtype=torch.int32, device=dev)
    starts = torch.cat([cat_sp, fallback], 1)

    result = beam_search(adjacency, queries, starts, spec, dist_fn,
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
