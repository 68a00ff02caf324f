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
* the graph needs no helper: pass ``prebuilt=(adjacency, medoid)`` to
  ``repro_torch.db.create``; a filtered graph crosses as
  ``prebuilt=(adjacency, medoid, label_entries)``, with the per-row
  labels as a numpy array (``create(spec, vectors, labels, ...)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.adapt import stats as ts
from repro_torch.core import buckets as bk
from repro_torch.core.catapult import CatapultState
from repro_torch.core.hnsw import HnswIndex
from repro_torch.core.lsh import LSHParams
from repro_torch.core.lsh_apg import LshApgIndex
from repro_torch.core.pq import PQCodebook
from repro_torch.device import resolve_device


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
