"""Scatter-gather shard search: the mesh engine on one card.

Port of ``repro/core/sharded.py``.  How sharded vector databases scale
(Milvus/Weaviate segments, DiskANN replica groups):

  * the corpus is row-sharded over the ``model`` axis — each shard holds
    an independent Vamana subgraph over its rows (block-diagonal
    adjacency, local ids) with its own medoid,
  * the query stream is sharded over the leading (``data``) axes,
  * every device runs the unchanged batched Algorithm 2 on (its query
    block × its corpus shard), with a catapult bucket table of its own
    (the paper's one-instance-per-replica deployment),
  * results merge over the corpus shards and a local top-k: the
    scatter-gather pattern.  Local ids are rebased to global with the
    shard offset.

The reference runs one ``shard_map`` program per device of a JAX mesh
and gathers over ``model`` with ``all_gather``.  This port is one
process on one card: ``make_sharded_search`` takes the mesh as its
shape, ``(n_data, n_shards)``, and runs each virtual device's step in
turn over that device's slices of the state — corpus shard ``j`` (rows
``j·N … (j+1)·N``, medoid ``j``), bucket block ``i·S + j`` and query
block ``i`` — then rebases and merges exactly as the gather over
``model`` does.  ``rebase_ids``/``merge_topk`` are shared with the
disk-backed scatter-gather engine (``repro_torch.store.sharded_store``),
so both tiers merge with the same semantics.
"""
from __future__ import annotations

from math import prod
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import buckets as bk
from repro_torch.core import catapult as cat
from repro_torch.core import lsh as lsh_mod
from repro_torch.core.beam_search import SearchSpec, l2_dist_fn
from repro_torch.core.vamana import VamanaParams, build_vamana
from repro_torch.device import resolve_device


def rebase_ids(local_ids: torch.Tensor, offset: int) -> torch.Tensor:
    """Shard-local row ids -> global row ids; invalid lanes stay -1."""
    return torch.where(local_ids >= 0, local_ids + offset, -1)


def merge_topk(all_ids: torch.Tensor, all_dists: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard candidate lists: (S, Q, k') -> global top-k (Q, k).

    Stable in distance order (``jnp.argsort``'s tie order: the earlier
    shard, then the earlier slot, wins); -1 ids carry +inf distances by
    convention, so they sink.
    """
    s, q, kk = all_ids.shape
    flat_ids = all_ids.permute(1, 0, 2).reshape(q, s * kk)
    flat_d = all_dists.permute(1, 0, 2).reshape(q, s * kk)
    top = torch.argsort(flat_d, dim=1, stable=True)[:, :k]
    return flat_ids.gather(1, top), flat_d.gather(1, top)


class ShardedEngineState(NamedTuple):
    """Corpus arrays shard over ``model``; catapult buckets are per
    virtual DEVICE (each data-parallel replica keeps its own), laid out
    in device order ``i·S + j``."""
    vectors: torch.Tensor       # (S*N, d) f32
    adjacency: torch.Tensor     # (S*N, R) int32, local ids
    medoids: torch.Tensor       # (S,) int32, local ids
    hyperplanes: torch.Tensor   # (L, d) f32, shared by every device
    bucket_ids: torch.Tensor    # (DEV*2^L, b) int32
    bucket_stamp: torch.Tensor  # (DEV*2^L, b) int32
    bucket_step: torch.Tensor   # (DEV,) int32


def make_sharded_search(mesh: tuple, spec: SearchSpec, n_per_shard: int,
                        lsh_bits: int):
    """The scatter-gather search step over a virtual mesh.

    ``mesh``: its shape, the ``model`` (shard) axis last — ``(n_data,
    n_shards)``, or ``(n_pod, n_data, n_shards)``; the leading axes
    split the queries.

    step(state, queries (Q, d)) -> (new_state, ids (Q, k) global,
    dists (Q, k)).  Q must divide evenly over the query blocks.
    """
    n_shards = int(mesh[-1])
    n_blocks = int(prod(mesh[:-1]))
    n_buckets = 2 ** lsh_bits

    def step(state: ShardedEngineState, queries: torch.Tensor):
        q_total = queries.shape[0]
        if q_total % n_blocks:
            raise ValueError(f"{q_total} queries do not split over "
                             f"{n_blocks} query blocks")
        ql = q_total // n_blocks
        lsh = lsh_mod.LSHParams(hyperplanes=state.hyperplanes)
        medoids = state.medoids.tolist()
        steps = state.bucket_step.tolist()
        new_ids, new_stamp, new_step, out_ids, out_d = [], [], [], [], []
        for i in range(n_blocks):
            q = queries[i * ql: (i + 1) * ql]
            gids, dists = [], []
            for j in range(n_shards):
                dev = i * n_shards + j
                rows = slice(j * n_per_shard, (j + 1) * n_per_shard)
                blk = slice(dev * n_buckets, (dev + 1) * n_buckets)
                b_ids = state.bucket_ids[blk]
                buckets = bk.BucketState(ids=b_ids,
                                         stamp=state.bucket_stamp[blk],
                                         tag=torch.full_like(b_ids, -1),
                                         step=int(steps[dev]))
                new_state, result, _ = cat.catapulted_lookup(
                    cat.CatapultState(lsh=lsh, buckets=buckets),
                    state.adjacency[rows], q, spec,
                    l2_dist_fn(state.vectors[rows]), int(medoids[j]))
                nb = new_state.buckets
                new_ids.append(nb.ids)
                new_stamp.append(nb.stamp)
                new_step.append(nb.step)
                gids.append(rebase_ids(result.ids, j * n_per_shard))
                dists.append(result.dists)
            # the gather over the corpus shards, then the local top-k
            ids, d = merge_topk(torch.stack(gids), torch.stack(dists),
                                k=gids[0].shape[-1])
            out_ids.append(ids)
            out_d.append(d)
        new = state._replace(
            bucket_ids=torch.cat(new_ids), bucket_stamp=torch.cat(new_stamp),
            bucket_step=torch.tensor(new_step, dtype=torch.int32,
                                     device=state.bucket_step.device))
        return new, torch.cat(out_ids), torch.cat(out_d)

    return step


def build_sharded_state(workload_vectors: np.ndarray, n_shards: int, *,
                        n_devices: int | None = None, max_degree: int = 16,
                        lsh_bits: int = 8, bucket_cap: int = 40,
                        build_beam: int = 32, seed: int = 0,
                        device="cuda") -> ShardedEngineState:
    """Build a sharded engine's state: one Vamana graph per shard (seed
    ``seed + s``, local ids), the hyperplanes from ``seed`` and an empty
    bucket table per device, everything on ``device``.  The hyperplanes
    come from a ``torch.Generator`` (the reference draws them with
    ``jax.random``; parity transplants them)."""
    device = resolve_device(device)
    n_devices = n_devices or n_shards
    n_total, dim = workload_vectors.shape
    if n_total % n_shards:
        raise ValueError(f"{n_total} rows do not split over {n_shards} "
                         f"shards")
    n = n_total // n_shards
    adj = np.zeros((n_total, max_degree), np.int32)
    medoids = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        block = np.ascontiguousarray(workload_vectors[s * n: (s + 1) * n],
                                     np.float32)
        a, m = build_vamana(block, VamanaParams(max_degree=max_degree,
                                                build_beam=build_beam,
                                                seed=seed + s),
                            device=device)
        adj[s * n: (s + 1) * n] = a
        medoids[s] = m
    lsh = lsh_mod.make_lsh(torch.Generator().manual_seed(seed), lsh_bits,
                           dim, device)
    rows = n_devices * 2 ** lsh_bits

    def empty():
        return torch.full((rows, bucket_cap), -1, dtype=torch.int32,
                          device=device)

    return ShardedEngineState(
        vectors=torch.tensor(np.asarray(workload_vectors, np.float32),
                             device=device),
        adjacency=torch.tensor(adj, device=device),
        medoids=torch.tensor(medoids, device=device),
        hyperplanes=lsh.hyperplanes,
        bucket_ids=empty(), bucket_stamp=empty(),
        bucket_step=torch.zeros(n_devices, dtype=torch.int32, device=device))
