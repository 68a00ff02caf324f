"""``create``/``open`` — the two ways a CatapultDB database comes to be.

Port of ``repro/db/factory.py`` for the RAM tier and the single-store
disk tier.  ``create(spec, vectors[, labels])`` builds a fresh index on
the tier the spec names; ``open(path)`` reopens a persisted CTPL block
file (any version, v1–v3), its sidecars included.  ``sniff`` tells what
a path holds, sharded and tiered manifest directories too, but those
tiers and empty-bootstrap creation (streaming ingest) come later
(ROADMAP queue 1, items 'Sharded tier' and 'tiered/ and ingest/'):
asking for them raises before any state is opened.
"""
from __future__ import annotations

import builtins
import dataclasses
import json
import os
import struct
from typing import Optional

import numpy as np

from repro_torch.core.engine import VectorSearchEngine
from repro_torch.db.database import Database
from repro_torch.db.spec import Caps, IndexSpec
from repro_torch.device import resolve_device
from repro_torch.ingest.keys import (KeyMap, ingest_spec_path,
                                     ingest_state_path, read_ingest_state)
from repro_torch.store.layout import MAGIC

# the reference's manifest names (repro/store/sharded_store.py,
# repro/tiered/engine.py), so that sniff() names what it finds
MANIFEST_NAME, MANIFEST_FORMAT = "manifest.json", "ctpl-sharded"
TIERED_MANIFEST_NAME, TIERED_FORMAT = "tiered.json", "ctpl-tiered"
_SHARDED_ITEM = "ROADMAP queue 1, item 'Sharded tier'"
_INGEST_ITEM = "ROADMAP queue 1, item 'tiered/ and ingest/'"


def sniff(path: str) -> tuple[str, int]:
    """Identify what a path holds: ``('tiered', manifest_version)`` for
    a hot/cold tiered layout, ``('sharded', manifest_version)`` for a
    shard manifest directory, ``('disk', ctpl_version)`` for a CTPL
    block file.  Raises ``FileNotFoundError``/``ValueError`` otherwise.
    """
    if os.path.isdir(path):
        # tiered outranks sharded: a tiered layout contains a sharded
        # manifest when its cold tier is sharded, never the reverse
        tpath = os.path.join(path, TIERED_MANIFEST_NAME)
        if os.path.exists(tpath):
            with builtins.open(tpath) as f:
                manifest = json.load(f)
            if manifest.get("format") != TIERED_FORMAT:
                raise ValueError(f"unrecognized tiered manifest format "
                                 f"{manifest.get('format')!r} in {path!r}")
            return "tiered", int(manifest.get("version", 0))
        mpath = os.path.join(path, MANIFEST_NAME)
        if not os.path.exists(mpath):
            raise ValueError(f"directory without a {TIERED_MANIFEST_NAME} "
                             f"or {MANIFEST_NAME}: {path!r}")
        with builtins.open(mpath) as f:     # this module defines open()
            manifest = json.load(f)
        if manifest.get("format") != MANIFEST_FORMAT:
            raise ValueError(f"unrecognized manifest format "
                             f"{manifest.get('format')!r} in {path!r}")
        return "sharded", int(manifest.get("version", 0))
    with builtins.open(path, "rb") as f:
        raw = f.read(8)
    if len(raw) < 8:
        raise ValueError(f"not a CTPL store (too short): {path!r}")
    magic, version = struct.unpack("<II", raw)
    if magic != MAGIC:
        raise ValueError(f"not a CTPL store (bad magic {magic:#x}): "
                         f"{path!r}")
    return "disk", version


def _caps(tier: str, filtered: bool) -> Caps:
    return Caps(tier=tier, mutable=True, filtered=bool(filtered),
                persistent=tier != "ram", sharded=tier == "sharded")


def create(spec: IndexSpec, vectors: Optional[np.ndarray] = None,
           labels: Optional[np.ndarray] = None, prebuilt=None, *,
           device="cuda") -> Database:
    """Build a fresh database per ``spec`` from ``vectors`` (+ per-row
    ``labels`` when ``spec.filters``) on ``device`` (the card by
    default; raises if there is none) and run the spec's warm-up
    searches.  ``tier="disk"`` writes the CTPL block file at
    ``spec.path`` (and its sidecars).

    ``prebuilt``: optional (adjacency, medoid[, label_entries]) from a
    previous build over the SAME vectors — shares one graph across
    engines, or carries the reference package's graph across.
    """
    dev = resolve_device(device)
    if vectors is None:
        raise NotImplementedError(
            f"create(spec) with no vectors bootstraps a streaming-ingest "
            f"database, which is not ported to repro_torch yet "
            f"({_INGEST_ITEM})")
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape
    if spec.dim is not None and spec.dim != d:
        raise ValueError(f"spec.dim={spec.dim} but vectors have dim {d}")
    if spec.filters != (labels is not None):
        raise ValueError(
            "IndexSpec(filters=True) needs per-row labels at create() "
            "(and labels need filters=True)")
    n_labels = int(labels.max()) + 1 if labels is not None else None
    kw = dict(mode=spec.mode, vamana=spec.vamana(), n_bits=spec.n_bits,
              bucket_capacity=spec.bucket_capacity, pq_subspaces=spec.pq,
              seed=spec.seed, capacity=n + spec.spare_capacity,
              hop_backend=spec.hop_backend, device=dev)
    if spec.tier == "disk":
        from repro_torch.store.io_engine import DiskVectorSearchEngine
        eng = DiskVectorSearchEngine(cache_frames=spec.cache_frames,
                                     io=spec.io, store_path=spec.path, **kw)
    else:
        eng = VectorSearchEngine(**kw)
    eng.build(vectors, labels=labels, n_labels=n_labels, prebuilt=prebuilt)
    db = Database(eng, spec, _caps(spec.tier, labels is not None))
    db.warm()
    return db


def open(path: str, *, mode: Optional[str] = None,
         spec: Optional[IndexSpec] = None, device="cuda") -> Database:
    """Reopen the CTPL block file at ``path`` (see ``sniff``) on
    ``device`` (the card by default; raises if there is none).

    ``mode`` overrides the acceleration mode (default 'catapult').
    ``spec`` supplies the runtime-only knobs a reopen cares about —
    graph params for future upserts, cache size, I/O engine (None
    resumes the persisted ``.io.json``), hop backend, serving defaults,
    adapt policy, warm shapes; its tier/path fields are ignored in
    favour of what is on disk.  An adapt sidecar resumes buckets,
    telemetry and the utility-gate verdict; a keys sidecar restores the
    caller-key map.  Sharded and tiered directories, and the streaming
    ingest state of a database born empty, raise ``NotImplementedError``
    before anything is opened.
    """
    dev = resolve_device(device)
    tier, _version = sniff(path)
    if tier != "disk":
        item = _SHARDED_ITEM if tier == "sharded" else _INGEST_ITEM
        raise NotImplementedError(f"open() of a {tier} layout is not ported "
                                  f"to repro_torch yet ({item})")
    if os.path.exists(ingest_spec_path(tier, path)):
        raise NotImplementedError(
            f"{ingest_spec_path(tier, path)!r} carries a streaming-ingest "
            f"spec, which is not ported to repro_torch yet ({_INGEST_ITEM})")
    state = read_ingest_state(ingest_state_path(tier, path))
    if state is not None and "ext2int" in state:
        raise NotImplementedError(
            f"{ingest_state_path(tier, path)!r} carries the bootstrap "
            f"external-id indirection of a database born empty, which is "
            f"not ported to repro_torch yet ({_INGEST_ITEM})")
    runtime = spec or IndexSpec()
    from repro_torch.store.io_engine import DiskVectorSearchEngine
    eng = DiskVectorSearchEngine.load(
        path, mode=mode or "catapult", n_bits=runtime.n_bits,
        bucket_capacity=runtime.bucket_capacity, seed=runtime.seed,
        vamana=runtime.vamana(), cache_frames=runtime.cache_frames,
        io=runtime.io, hop_backend=runtime.hop_backend, device=dev)
    # reflect what the engine restored (an adapt sidecar may have
    # overridden the runtime knobs): db.spec describes this index
    opened = dataclasses.replace(
        runtime, tier=tier, mode=eng.mode, path=path, pq=eng.pq_subspaces,
        filters=bool(eng.filtered), n_bits=eng.n_bits,
        bucket_capacity=eng.bucket_capacity, seed=eng.seed, io=eng.io,
        hop_backend=eng.hop_backend)
    keymap = KeyMap.from_arrays(state) if state is not None else None
    db = Database(eng, opened, _caps(tier, eng.filtered), keymap=keymap)
    db.warm()
    return db
