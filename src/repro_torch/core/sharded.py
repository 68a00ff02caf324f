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
and gathers over ``model`` with ``all_gather``.  ``make_sharded_search``
does the same over a ``torch.distributed`` ``DeviceMesh``, one process
(rank) per device: rank (i, j) holds its slice of the state
(``shard_state``: corpus shard ``j`` — rows ``j·N … (j+1)·N``, medoid
``j`` — and bucket block ``i·S + j``), runs Algorithm 2 on query block
``i``, rebases, gathers the shards' results over the ``model`` group
and merges them in shard order.  Given the mesh's shape instead,
``(n_data, n_shards)``, it is one process on one card and runs each
virtual device's step in turn over the full state, then rebases and
merges exactly as the gather does.  ``engine_state_specs`` gives the
state's shapes (meta tensors) and partition specs without allocating.
``rebase_ids``/``merge_topk`` are shared with the disk-backed
scatter-gather engine (``repro_torch.store.sharded_store``), so both
tiers merge with the same semantics.
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
from repro_torch.launch.mesh import (P, axis_sizes, batch_axes, group_index,
                                     local_slice)
from repro_torch.models import parallel as par


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
    in device order ``i·S + j``.  A rank of a ``DeviceMesh`` holds its
    slice of each (``shard_state``: N rows, one medoid, one table)."""
    vectors: torch.Tensor       # (S*N, d) f32
    adjacency: torch.Tensor     # (S*N, R) int32, local ids
    medoids: torch.Tensor       # (S,) int32, local ids
    hyperplanes: torch.Tensor   # (L, d) f32, shared by every device
    bucket_ids: torch.Tensor    # (DEV*2^L, b) int32
    bucket_stamp: torch.Tensor  # (DEV*2^L, b) int32
    bucket_step: torch.Tensor   # (DEV,) int32


def engine_state_specs(mesh, n_per_shard: int, dim: int, max_degree: int,
                       lsh_bits: int, bucket_cap: int):
    """The state's shapes as meta tensors (nothing allocated) and its
    partition specs, as a pair of ``ShardedEngineState``s: the corpus
    over ``model``, the per-device bucket tables over every axis.
    ``mesh``: a ``DeviceMesh`` or its axis sizes (``{"data": 2, "model":
    4}``)."""
    sizes = axis_sizes(mesh)
    n_shards, n_dev = sizes["model"], prod(sizes.values())
    all_axes = tuple(sizes)
    f32, i32 = torch.float32, torch.int32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    rows = n_dev * 2 ** lsh_bits
    shapes = ShardedEngineState(
        vectors=meta((n_shards * n_per_shard, dim), f32),
        adjacency=meta((n_shards * n_per_shard, max_degree), i32),
        medoids=meta((n_shards,), i32),
        hyperplanes=meta((lsh_bits, dim), f32),
        bucket_ids=meta((rows, bucket_cap), i32),
        bucket_stamp=meta((rows, bucket_cap), i32),
        bucket_step=meta((n_dev,), i32))
    specs = ShardedEngineState(
        vectors=P("model", None), adjacency=P("model", None),
        medoids=P("model"), hyperplanes=P(),
        bucket_ids=P(all_axes, None), bucket_stamp=P(all_axes, None),
        bucket_step=P(all_axes))
    return shapes, specs


def shard_state(state: ShardedEngineState, mesh) -> ShardedEngineState:
    """This rank's slice of a full state (views): its corpus shard, medoid,
    bucket block and step, and the shared hyperplanes — what the
    reference's ``device_put`` with ``engine_state_specs``' shardings
    leaves on a device."""
    n_rows, dim = state.vectors.shape
    n_shards = axis_sizes(mesh)["model"]
    _, specs = engine_state_specs(
        mesh, n_rows // n_shards, dim, state.adjacency.shape[1],
        state.hyperplanes.shape[0], state.bucket_ids.shape[1])
    return ShardedEngineState(*[local_slice(t, spec, mesh)
                                for t, spec in zip(state, specs)])


def _device_step(spec, lsh, vectors, adjacency, medoid: int, b_ids,
                 b_stamp, b_step: int, queries, offset: int):
    """One device's step: Algorithm 2 of its query block over its corpus
    shard with its bucket table; returns (new buckets, global ids,
    distances)."""
    buckets = bk.BucketState(ids=b_ids, stamp=b_stamp,
                             tag=torch.full_like(b_ids, -1), step=b_step)
    new_state, result, _ = cat.catapulted_lookup(
        cat.CatapultState(lsh=lsh, buckets=buckets), adjacency, queries,
        spec, l2_dist_fn(vectors), medoid)
    return new_state.buckets, rebase_ids(result.ids, offset), result.dists


def _split(queries, n_blocks: int) -> int:
    if queries.shape[0] % n_blocks:
        raise ValueError(f"{queries.shape[0]} queries do not split over "
                         f"{n_blocks} query blocks")
    return queries.shape[0] // n_blocks


def make_sharded_search(mesh, spec: SearchSpec, n_per_shard: int,
                        lsh_bits: int):
    """The scatter-gather search step.

    ``mesh``: a ``DeviceMesh`` with a ``model`` (shard) axis — one rank
    per device; the step takes this rank's ``shard_state`` and the whole
    batch of queries, and returns (its new state, the ids (Ql, k) and
    distances of its own query block), the reference's ``out_specs``
    layout — or the mesh's shape, ``(n_data, n_shards)`` or ``(n_pod,
    n_data, n_shards)``, the ``model`` axis last: the step then takes the
    full state and runs every virtual device in turn on this process's
    device, returning (new state, ids (Q, k) global, dists (Q, k)).
    The leading axes split the queries; Q must divide evenly over them.
    """
    if hasattr(mesh, "mesh_dim_names"):
        return _rank_search(mesh, spec, n_per_shard)
    n_shards = int(mesh[-1])
    n_blocks = int(prod(mesh[:-1]))
    n_buckets = 2 ** lsh_bits

    def step(state: ShardedEngineState, queries: torch.Tensor):
        ql = _split(queries, n_blocks)
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
                nb, g, d = _device_step(
                    spec, lsh, state.vectors[rows], state.adjacency[rows],
                    int(medoids[j]), state.bucket_ids[blk],
                    state.bucket_stamp[blk], int(steps[dev]), q,
                    j * n_per_shard)
                new_ids.append(nb.ids)
                new_stamp.append(nb.stamp)
                new_step.append(nb.step)
                gids.append(g)
                dists.append(d)
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


def _rank_search(mesh, spec: SearchSpec, n_per_shard: int):
    """The step of one rank of a ``DeviceMesh`` (``make_sharded_search``)."""
    import torch.distributed as dist
    qaxes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    n_blocks = prod(sizes[a] for a in qaxes)
    block = group_index(mesh, qaxes)
    shard = group_index(mesh, ("model",))
    group = mesh.get_group("model")

    def step(state: ShardedEngineState, queries: torch.Tensor):
        ql = _split(queries, n_blocks)
        nb, gids, dists = _device_step(
            spec, lsh_mod.LSHParams(hyperplanes=state.hyperplanes),
            state.vectors, state.adjacency, int(state.medoids[0]),
            state.bucket_ids, state.bucket_stamp, int(state.bucket_step[0]),
            queries[block * ql: (block + 1) * ql], shard * n_per_shard)
        # the scatter-gather merge over the corpus shards, in shard order
        all_ids = [torch.empty_like(gids) for _ in range(sizes["model"])]
        all_d = [torch.empty_like(dists) for _ in range(sizes["model"])]
        par.tally("all_gather", gids, len(all_ids))
        dist.all_gather(all_ids, gids.contiguous(), group=group)
        par.tally("all_gather", dists, len(all_d))
        dist.all_gather(all_d, dists.contiguous(), group=group)
        ids, d = merge_topk(torch.stack(all_ids), torch.stack(all_d),
                            k=gids.shape[-1])
        new = state._replace(
            bucket_ids=nb.ids, bucket_stamp=nb.stamp,
            bucket_step=torch.tensor([nb.step], dtype=torch.int32,
                                     device=state.bucket_step.device))
        return new, ids, d

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
