"""``create`` — how a CatapultDB database comes to be on the port.

Port of ``repro/db/factory.py`` for the RAM tier, filtered or not.
``open`` (persisted tiers) and empty-bootstrap creation (streaming
ingest) come with their tiers (ROADMAP queue 1, items 'Disk tier' and
'tiered/ and ingest/').
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.engine import VectorSearchEngine
from repro_torch.db.database import Database
from repro_torch.db.spec import Caps, IndexSpec
from repro_torch.device import resolve_device


def _caps(tier: str, filtered: bool) -> Caps:
    return Caps(tier=tier, mutable=True, filtered=bool(filtered),
                persistent=tier != "ram", sharded=tier == "sharded")


def create(spec: IndexSpec, vectors: Optional[np.ndarray] = None,
           labels: Optional[np.ndarray] = None, prebuilt=None, *,
           device="cuda") -> Database:
    """Build a fresh RAM-tier database per ``spec`` from ``vectors`` (+
    per-row ``labels`` when ``spec.filters``) on ``device`` (the card by
    default; raises if there is none) and run the spec's warm-up
    searches.

    ``prebuilt``: optional (adjacency, medoid[, label_entries]) from a
    previous build over the SAME vectors — shares one graph across
    engines, or carries the reference package's graph across.
    """
    dev = resolve_device(device)
    if vectors is None:
        raise NotImplementedError(
            "create(spec) with no vectors bootstraps a streaming-ingest "
            "database, which is not ported to repro_torch yet (ROADMAP "
            "queue 1, item 'tiered/ and ingest/')")
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape
    if spec.dim is not None and spec.dim != d:
        raise ValueError(f"spec.dim={spec.dim} but vectors have dim {d}")
    if spec.filters != (labels is not None):
        raise ValueError(
            "IndexSpec(filters=True) needs per-row labels at create() "
            "(and labels need filters=True)")
    n_labels = int(labels.max()) + 1 if labels is not None else None
    eng = VectorSearchEngine(
        mode=spec.mode, vamana=spec.vamana(), n_bits=spec.n_bits,
        bucket_capacity=spec.bucket_capacity, pq_subspaces=spec.pq,
        seed=spec.seed,
        capacity=n + spec.spare_capacity, hop_backend=spec.hop_backend,
        device=dev)
    eng.build(vectors, labels=labels, n_labels=n_labels, prebuilt=prebuilt)
    db = Database(eng, spec, _caps(spec.tier, labels is not None))
    db.warm()
    return db
