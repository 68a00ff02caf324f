"""Catapult buckets — the paper's auxiliary shortcut-edge layer (§3.2).

Port of ``repro/core/buckets.py``.  State is a dense ``(2**L, b)`` table
of destination node ids plus LRU stamps and filter tags, on the engine's
device:

* ``lookup``: one gather — the whole query batch reads the pre-batch
  bucket state (the paper's read-locked section),
* ``publish``: completed queries append their best neighbor one at a
  time, in batch order — a deterministic serialization of the paper's
  write-locked appends, preserving LRU semantics exactly.

``publish`` is a serial fold, so it runs on the host: the batch's
``(hashes, dest, tags)`` and the three tables (40 KiB each at b=40,
L=8) are copied to numpy, folded, and copied back.  Lane i's stamp is
``step + exclusive_cumsum(dest >= 0)[i]`` and buckets are independent,
which is what a later on-device fold can build on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

INVALID = -1


@dataclasses.dataclass(frozen=True)
class BucketState:
    ids: torch.Tensor     # (n_buckets, b) int32 destination node ids, -1 empty
    stamp: torch.Tensor   # (n_buckets, b) int32 LRU stamps, -1 empty
    tag: torch.Tensor     # (n_buckets, b) int32 filter label of the query that
                          # published the entry, -1 = unfiltered
    step: int             # monotone insertion clock


def make_buckets(n_buckets: int, capacity: int,
                 device="cuda") -> BucketState:
    device = resolve_device(device)

    def empty():
        return torch.full((n_buckets, capacity), INVALID, dtype=torch.int32,
                          device=device)
    return BucketState(ids=empty(), stamp=empty(), tag=empty(), step=0)


def lookup(state: BucketState,
           bucket_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Catapult destinations for a batch of bucket indices:
    (ids (B, b), tags (B, b))."""
    idx = bucket_idx.long()
    return state.ids[idx], state.tag[idx]


def publish(state: BucketState, bucket_idx: torch.Tensor, dest: torch.Tensor,
            tags: torch.Tensor) -> BucketState:
    """Append each (bucket, destination) pair with LRU eviction.

    Args:
      bucket_idx: (B,) int32 bucket per completed query.
      dest: (B,) int32 best-neighbor node id per query (-1 skips the lane).
      tags: (B,) int32 filter label of each query (-1 unfiltered).
    """
    hs = bucket_idx.cpu().numpy()
    ds = dest.cpu().numpy()
    ts = tags.cpu().numpy()
    ids = state.ids.cpu().numpy().copy()
    stamp = state.stamp.cpu().numpy().copy()
    tag = state.tag.cpu().numpy().copy()
    step = state.step
    for h, d, t in zip(hs, ds, ts):
        if d < 0:
            continue
        present = (ids[h] == d) & (tag[h] == t)
        # refresh the stamp on a hit (first match), else evict the
        # min-stamp slot (first minimum: an empty -1 slot wins)
        slot = np.argmax(present) if present.any() else np.argmin(stamp[h])
        ids[h, slot] = d
        stamp[h, slot] = step
        tag[h, slot] = t
        step += 1
    dev = state.ids.device
    return BucketState(ids=torch.from_numpy(ids).to(dev),
                       stamp=torch.from_numpy(stamp).to(dev),
                       tag=torch.from_numpy(tag).to(dev), step=step)


def evict_where(state: BucketState, mask: torch.Tensor) -> BucketState:
    """Clear every occupied entry selected by ``mask`` ((n_buckets, b)
    bool): ids, stamps and tags reset to INVALID together."""
    bad = mask & (state.ids >= 0)
    return BucketState(ids=torch.where(bad, INVALID, state.ids),
                       stamp=torch.where(bad, INVALID, state.stamp),
                       tag=torch.where(bad, INVALID, state.tag),
                       step=state.step)


def evict_ids(state: BucketState, dead) -> BucketState:
    """Clear every bucket entry whose destination is in ``dead``."""
    dead = torch.as_tensor(np.asarray(dead, np.int32).ravel(),
                           device=state.ids.device)
    return evict_where(state, torch.isin(state.ids, dead))


def evict_buckets(state: BucketState, bucket_mask) -> BucketState:
    """Flush whole bucket rows (``bucket_mask``: (n_buckets,) bool)."""
    mask = torch.as_tensor(np.asarray(bucket_mask, bool),
                           device=state.ids.device)
    return evict_where(state, mask[:, None])


def evict_stale(state: BucketState, max_age: int) -> BucketState:
    """TTL eviction: clear entries whose stamp is older than
    ``step - max_age`` on the publish clock."""
    cutoff = state.step - int(max_age)
    return evict_where(state, (state.stamp >= 0) & (state.stamp < cutoff))


def to_arrays(state: BucketState) -> dict[str, np.ndarray]:
    """Field-name -> ndarray snapshot, the reference's sidecar schema."""
    return {"ids": state.ids.cpu().numpy(),
            "stamp": state.stamp.cpu().numpy(),
            "tag": state.tag.cpu().numpy(),
            "step": np.asarray(state.step, np.int32)}


def from_arrays(arrays, device="cuda") -> BucketState:
    """Rebuild a state from ``to_arrays`` output (or the reference's)."""
    device = resolve_device(device)

    def table(name):
        return torch.tensor(np.asarray(arrays[name], np.int32),
                            device=device)
    return BucketState(ids=table("ids"), stamp=table("stamp"),
                       tag=table("tag"), step=int(arrays["step"]))
