"""Proximity baseline (Bergman et al., Middleware'25) — approximate cache.

Port of ``repro/core/proximity_cache.py``.  Proximity intercepts queries
in front of the database: if an incoming query embedding lies within
distance tau of a previously cached query, the cached neighbor list is
returned verbatim and the index is never consulted.  The paper's Fig. 2
shows the failure mode this design buys: under dynamic insertion the
cached lists go stale and median recall halves.

A fixed-capacity LRU cache with within-batch sequential semantics (each
query sees earlier queries' insertions), on an explicit device:

* ``cache_probe`` computes the reference's direct form ``sum((q - key)^2)``
  in chunks of queries, so it never holds more than
  ``PROBE_ELEMENTS`` floats of (chunk, C, d) differences (a whole
  (B, C, d) tensor at B=4,096, C=1,024, d=768 would be 12.9 GB),
* ``cache_insert`` is the LRU fold, serial by nature: like
  ``core/buckets.publish`` it runs on the host over numpy copies of the
  stamps and writes the touched slots back, so its integers (slots,
  stamps, step) are bit-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

INVALID = -1
PROBE_ELEMENTS = 1 << 24      # 64 MiB of float32 differences at a time


@dataclasses.dataclass(frozen=True)
class CacheState:
    keys: torch.Tensor     # (C, d) cached query embeddings
    values: torch.Tensor   # (C, k) int32 cached result ids
    stamp: torch.Tensor    # (C,) int32 LRU stamps, -1 empty
    step: int              # insertion clock


def make_cache(capacity: int, dim: int, k: int, device="cuda") -> CacheState:
    device = resolve_device(device)
    return CacheState(
        keys=torch.zeros((capacity, dim), dtype=torch.float32, device=device),
        values=torch.full((capacity, k), INVALID, dtype=torch.int32,
                          device=device),
        stamp=torch.full((capacity,), INVALID, dtype=torch.int32,
                         device=device),
        step=0)


class CacheHit(NamedTuple):
    hit: torch.Tensor      # (B,) bool
    ids: torch.Tensor      # (B, k) cached results (garbage where hit=False)


def cache_probe(state: CacheState, queries: torch.Tensor,
                tau: float) -> CacheHit:
    """Serve from cache when the nearest cached query is within tau (L2^2)."""
    c, d = state.keys.shape
    rows = max(1, PROBE_ELEMENTS // max(c * d, 1))
    empty = state.stamp < 0
    nearest, best = [], []
    for lo in range(0, queries.shape[0], rows):
        q = queries[lo: lo + rows]
        dist = ((q[:, None, :] - state.keys[None, :, :]) ** 2).sum(-1)
        dist = torch.where(empty[None, :], torch.inf, dist)
        nn = torch.argmin(dist, dim=1)
        nearest.append(nn)
        best.append(dist.gather(1, nn[:, None])[:, 0])
    nearest = torch.cat(nearest)
    hit = torch.cat(best) <= tau
    return CacheHit(hit=hit, ids=state.values[nearest])


def cache_insert(state: CacheState, queries: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> CacheState:
    """Insert missed queries (mask=True) with LRU eviction: query i takes
    the slot of the least stamp (an empty -1 slot first, the first of
    equals), in batch order."""
    stamp = state.stamp.cpu().numpy().copy()
    do = mask.cpu().numpy()
    step = state.step
    src, dst = [], []
    for i in np.nonzero(do)[0]:
        slot = int(np.argmin(stamp))
        stamp[slot] = step
        step += 1
        src.append(i)
        dst.append(slot)
    keys, values = state.keys.clone(), state.values.clone()
    if src:
        # a slot taken twice in one batch keeps its last writer, as the
        # sequential fold does: write the pairs in batch order
        dev = keys.device
        s = torch.as_tensor(np.asarray(src, np.int64), device=dev)
        t = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
        last = {slot: j for j, slot in enumerate(dst)}
        keep = torch.as_tensor(np.asarray(sorted(last.values()), np.int64),
                               device=dev)
        s, t = s[keep], t[keep]
        keys[t] = queries[s].to(keys.dtype)
        values[t] = ids[s].to(torch.int32)
    return CacheState(keys=keys, values=values,
                      stamp=torch.as_tensor(stamp, device=state.stamp.device),
                      step=step)


def flush(state: CacheState) -> CacheState:
    """What Proximity must do on every database update to stay correct."""
    return make_cache(state.keys.shape[0], state.keys.shape[1],
                      state.values.shape[1], state.keys.device)
