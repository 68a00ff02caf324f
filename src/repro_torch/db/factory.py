"""``create`` — how a CatapultDB database comes to be on the port.

Port of ``repro/db/factory.py`` for the RAM tier.  ``open`` (persisted
tiers) and empty-bootstrap creation (streaming ingest) come with their
tiers (ROADMAP queue 1, items 8-10).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.engine import VectorSearchEngine
from repro_torch.db.database import Database
from repro_torch.db.spec import Caps, IndexSpec
from repro_torch.device import resolve_device


def create(spec: IndexSpec, vectors: Optional[np.ndarray] = None,
           labels: Optional[np.ndarray] = None, prebuilt=None, *,
           device="cuda") -> Database:
    """Build a fresh RAM-tier database per ``spec`` from ``vectors`` on
    ``device`` (the card by default; raises if there is none) and run
    the spec's warm-up searches.

    ``prebuilt``: optional (adjacency, medoid) from a previous build over
    the SAME vectors — shares one graph across engines, or carries the
    reference package's graph across.
    """
    dev = resolve_device(device)
    if vectors is None:
        raise NotImplementedError(
            "create(spec) with no vectors bootstraps a streaming-ingest "
            "database, which is not ported to repro_torch yet (ROADMAP "
            "queue 1, item 10)")
    if labels is not None:
        raise ValueError("labels need IndexSpec(filters=True), which is "
                         "not ported to repro_torch yet")
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape
    if spec.dim is not None and spec.dim != d:
        raise ValueError(f"spec.dim={spec.dim} but vectors have dim {d}")
    eng = VectorSearchEngine(
        mode=spec.mode, vamana=spec.vamana(), n_bits=spec.n_bits,
        bucket_capacity=spec.bucket_capacity, pq_subspaces=spec.pq,
        seed=spec.seed,
        capacity=n + spec.spare_capacity, hop_backend=spec.hop_backend,
        device=dev)
    eng.build(vectors, prebuilt=prebuilt)
    db = Database(eng, spec, Caps(tier="ram", mutable=False, filtered=False,
                                  persistent=False, sharded=False))
    db.warm()
    return db
