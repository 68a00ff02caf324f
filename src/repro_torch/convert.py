"""Carry the reference package's state across to the port.

The port cannot replay ``jax.random``, so state that the reference drew
from it is transplanted instead of reseeded.  Everything here takes
plain numpy (the caller extracts it from the reference) and returns the
port's state on a given device:

* the catapult layer: LSH hyperplanes + bucket tables in the reference's
  ``buckets.to_arrays`` schema (``ids``/``stamp``/``tag``/``step``),
* the PQ codebook: (M, K, ds) centroids, installed with
  ``VectorSearchEngine._init_aux(vectors, pq_codebook=)`` as the
  reference's disk reopen installs its persisted one,
* the LSH-APG index: hyperplanes + the (2**L, m) bucket table, set as
  the engine's ``_apg``,
* the adapt layer: a telemetry snapshot in the reference's
  ``telemetry_to_arrays`` schema, and a maintainer's counters and gate
  state (``maintainer_counters`` reads them off either package's
  ``CatapultMaintainer``; ``set_maintainer_counters`` installs them),
  so a parity test can hand a reference maintainer's state to the port
  mid-stream,
* an HNSW hierarchy (``core/hnsw.py``): the level-0 graph, each upper
  level's ids and graph, and the entry, as ``HnswIndex`` on a device
  (each level is a Vamana build, which agrees across the packages on
  >= 99% of rows only),
* a language model's parameters (``model_params_from_numpy``): the
  reference's ``M.init`` tree as numpy arrays, its stacked leaves split
  into the port's per-layer blocks, and its decode cache
  (``model_cache_from_numpy``), so decode parity can start from one
  cache,
* the graph needs no helper: pass ``prebuilt=(adjacency, medoid)`` to
  ``repro_torch.db.create``; a filtered graph crosses as
  ``prebuilt=(adjacency, medoid, label_entries)``, with the per-row
  labels as a numpy array (``create(spec, vectors, labels, ...)``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.adapt import stats as ts
from repro_torch.core import buckets as bk
from repro_torch.core.catapult import CatapultState
from repro_torch.core.hnsw import HnswIndex
from repro_torch.core.lsh import LSHParams
from repro_torch.core.lsh_apg import LshApgIndex
from repro_torch.core.pq import PQCodebook
from repro_torch.device import resolve_device
from repro_torch.models import model as lm


def catapult_state_from_numpy(hyperplanes: np.ndarray, bucket_arrays,
                              device="cuda") -> CatapultState:
    """(n_bits, d) hyperplanes + a ``to_arrays`` dict -> CatapultState."""
    device = resolve_device(device)
    h = torch.tensor(np.asarray(hyperplanes, np.float32), device=device)
    return CatapultState(lsh=LSHParams(hyperplanes=h),
                         buckets=bk.from_arrays(bucket_arrays, device))


def pq_codebook_from_numpy(centroids: np.ndarray, device="cuda") -> PQCodebook:
    """(M, K, ds) centroids -> PQCodebook on ``device``."""
    device = resolve_device(device)
    return PQCodebook(centroids=torch.tensor(
        np.asarray(centroids, np.float32), device=device))


def lsh_apg_index_from_numpy(hyperplanes: np.ndarray, table: np.ndarray,
                             device="cuda") -> LshApgIndex:
    """(n_bits, d) hyperplanes + (2**n_bits, m) int32 table -> LshApgIndex."""
    device = resolve_device(device)
    return LshApgIndex(
        lsh=LSHParams(hyperplanes=torch.tensor(
            np.asarray(hyperplanes, np.float32), device=device)),
        table=torch.tensor(np.asarray(table, np.int32), device=device))


def hnsw_index_from_numpy(vectors: np.ndarray, level_ids, level_adj,
                          base_adj: np.ndarray, entry: int,
                          device="cuda") -> HnswIndex:
    """(N, d) vectors, per-level (n_l,) ids and (n_l, R) adjacency, the
    (N, R) level-0 graph and the entry id -> ``HnswIndex`` on ``device``."""
    device = resolve_device(device)

    def up(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)
    return HnswIndex(vectors=up(vectors, np.float32),
                     level_ids=[np.asarray(i, np.int64) for i in level_ids],
                     level_adj=[up(a, np.int32) for a in level_adj],
                     base_adj=up(base_adj, np.int32), entry=int(entry))


def telemetry_from_numpy(arrays, device="cuda",
                         prefix: str = "adapt_") -> ts.TelemetryState:
    """A ``telemetry_to_arrays`` dict (either package's) -> the port's
    ``TelemetryState`` on ``device``, the same bytes."""
    state = ts.telemetry_from_arrays(arrays, prefix, device)
    if state is None:
        raise KeyError(f"no {prefix}* telemetry fields in {sorted(arrays)}")
    return state


# the maintainer's event counters, then its gate machine's state
MAINTAINER_COUNTERS = ("ttl_evicted", "flushed_entries", "drift_flushes",
                       "gate_transitions", "probes", "shadows", "ticks",
                       "consolidations")
_MAINTAINER_STATE = ("_gate_on", "_probing", "_shadow", "_off_batches",
                     "_since_shadow", "_since_tick", "_obs_count")


def maintainer_counters(maintainer) -> dict:
    """Plain ints and bools: a maintainer's counters and gate state."""
    return {name: getattr(maintainer, name)
            for name in MAINTAINER_COUNTERS + _MAINTAINER_STATE}


def set_maintainer_counters(maintainer, counters: dict) -> None:
    """Install ``maintainer_counters`` output on a port maintainer, and
    the engine flags they imply: the persistent gate verdict, and the
    one-batch override a pending shadow (False) or probe (True) arms."""
    for name, value in counters.items():
        setattr(maintainer, name, value)
    maintainer._set_engines(bool(maintainer._gate_on))
    maintainer._set_override(False if maintainer._shadow else
                             True if maintainer._probing else None)


def _tensor(a, device) -> torch.Tensor:
    """A copy of a numpy array (bfloat16 included, as ``ml_dtypes``
    holds it) on ``device``, bit for bit.  Always a copy: the caller's
    buffer (possibly one the reference's runtime owns) is never written
    by the port's in-place cache updates."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.tensor(a).to(device)


def model_params_from_numpy(cfg, tree, device="cuda") -> "lm.Model":
    """The reference's ``M.init(cfg, key)`` tree (numpy leaves) -> the
    port's ``Model`` on ``device``: every stacked leaf's row i goes to
    layer i of the matching ``ModuleList``; every parameter must be
    filled exactly once."""
    model = lm.Model(cfg, device)
    filled = []

    def load(module, sub, take):
        for name, value in sub.items():
            child = getattr(module, name)
            if isinstance(child, nn.ModuleList):
                for i, blk in enumerate(child):
                    load(blk, value, lambda a, i=i, t=take: t(a)[i])
            elif isinstance(value, dict):
                load(child, value, take)
            else:
                src = _tensor(take(value), child.device)
                if src.shape != child.shape or src.dtype != child.dtype:
                    raise ValueError(f"{name}: {tuple(src.shape)} "
                                     f"{src.dtype} against "
                                     f"{tuple(child.shape)} {child.dtype}")
                with torch.no_grad():
                    child.copy_(src)
                filled.append(child)

    load(model, tree, lambda a: a)
    if len({id(p) for p in filled}) != len(filled) or \
            len(filled) != len(list(model.parameters())):
        raise ValueError(f"the tree filled {len(filled)} of "
                         f"{len(list(model.parameters()))} parameters")
    return model


def model_cache_from_numpy(cfg, tree, device="cuda") -> dict:
    """A reference decode cache (``M.init_cache`` layout, numpy leaves)
    -> the port's cache dict on ``device``, the same names and bytes."""
    device = resolve_device(device)
    return {k: (model_cache_from_numpy(cfg, v, device)
                if isinstance(v, dict) else _tensor(v, device))
            for k, v in tree.items()}
