"""``create``/``open`` — the two ways a CatapultDB database comes to be.

Port of ``repro/db/factory.py``.  ``create(spec, vectors[, labels])``
builds a fresh index on the tier the spec names; ``open(path)`` reopens
what is persisted there, sniffing it: a CTPL block file (any version,
v1–v3) opens as the single-store disk tier, a sharded manifest
directory as the scatter-gather tier, a tiered manifest directory as
the hot/cold tiered database (a tiered layout wins over the sharded
manifest nested in its cold tier), sidecars included.  ``create(spec)``
with no vectors returns a database born empty (``repro_torch.ingest``'s
bootstrap engine); ``open`` resumes it from its keys sidecar's
external-id indirection and its persisted ``IngestSpec``.
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
from repro_torch.db.spec import Caps, IndexSpec, IngestSpec, TieredSpec
from repro_torch.device import resolve_device
from repro_torch.ingest.bootstrap import BootstrapEngine
from repro_torch.ingest.keys import (KeyMap, ingest_spec_path,
                                     ingest_state_path, read_ingest_state)
from repro_torch.store.layout import MAGIC

# the engine modules import repro_torch.db.spec, so this module (which
# the package's __init__ imports) pulls them in where they are used


def sniff(path: str) -> tuple[str, int]:
    """Identify what a path holds: ``('tiered', manifest_version)`` for
    a hot/cold tiered layout, ``('sharded', manifest_version)`` for a
    shard manifest directory, ``('disk', ctpl_version)`` for a CTPL
    block file.  Raises ``FileNotFoundError``/``ValueError`` otherwise.
    """
    if os.path.isdir(path):
        from repro_torch.store.sharded_store import (MANIFEST_FORMAT,
                                                     MANIFEST_NAME)
        from repro_torch.tiered import TIERED_FORMAT, TIERED_MANIFEST_NAME
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


def _caps(tier: str, filtered: bool, host_views: bool = True) -> Caps:
    return Caps(tier=tier, mutable=True, filtered=bool(filtered),
                persistent=tier != "ram", sharded=tier == "sharded",
                host_views=bool(host_views))


def _host_views(tier: str, tiered: Optional[TieredSpec]) -> bool:
    """Per-row host views (``db.vectors``/``db.tombstones``) exist when
    ONE engine owns the whole row range: any single store, or a tiered
    database over a single-store cold tier (``tiered``: its spec, None
    for the defaults).  Shard facades keep their rows per shard."""
    if tier == "sharded":
        return False
    if tier == "tiered":
        return (tiered or TieredSpec()).cold_tier != "sharded"
    return True


def create(spec: IndexSpec, vectors: Optional[np.ndarray] = None,
           labels: Optional[np.ndarray] = None, prebuilt=None, *,
           device="cuda") -> Database:
    """Build a fresh database per ``spec`` from ``vectors`` (+ per-row
    ``labels`` when ``spec.filters``) on ``device`` (the card by
    default; raises if there is none) and run the spec's warm-up
    searches.  ``tier="disk"`` writes the CTPL block file at
    ``spec.path`` (and its sidecars); ``tier="sharded"`` and
    ``tier="tiered"`` write their manifest directories there.

    ``vectors=None`` bootstraps EMPTY: the returned database serves at
    once (``spec.dim`` required — there is nothing to infer it from)
    and builds its medoid and graph as the first rows ``upsert`` in,
    every build on ``device``.

    ``prebuilt``: optional (adjacency, medoid[, label_entries]) from a
    previous build over the SAME vectors — shares one graph across
    engines, or carries the reference package's graph across.
    Single-store tiers only.
    """
    dev = resolve_device(device)
    if vectors is None:
        if labels is not None or prebuilt is not None:
            raise ValueError("create(spec) with no vectors takes neither "
                             "labels nor a prebuilt graph — stream rows "
                             "in through upsert()")
        eng = BootstrapEngine(spec, device=dev)
        spec = eng.spec          # ingest defaults materialized
        db = Database(eng, spec, _caps(spec.tier, spec.filters,
                                       _host_views(spec.tier, spec.tiered)))
        db.warm()
        return db
    vectors = np.ascontiguousarray(vectors, np.float32)
    n, d = vectors.shape
    if spec.dim is not None and spec.dim != d:
        raise ValueError(f"spec.dim={spec.dim} but vectors have dim {d}")
    if spec.filters != (labels is not None):
        raise ValueError(
            "IndexSpec(filters=True) needs per-row labels at create() "
            "(and labels need filters=True)")
    n_labels = int(labels.max()) + 1 if labels is not None else None
    if prebuilt is not None and spec.tier in ("sharded", "tiered"):
        raise ValueError("prebuilt graphs are single-store only — each "
                         "shard/tier builds over its own row set")
    eng = _build_engine(spec, vectors, labels, n_labels, prebuilt,
                        device=dev)
    if spec.tier == "tiered":
        spec = dataclasses.replace(spec, tiered=eng.tiered)
    db = Database(eng, spec, _caps(spec.tier, labels is not None,
                                   _host_views(spec.tier, spec.tiered)))
    db.warm()
    return db


def _build_engine(spec: IndexSpec, vectors: np.ndarray,
                  labels: Optional[np.ndarray], n_labels: Optional[int],
                  prebuilt=None, *, device="cuda"):
    """Construct and build the tier backend on ``device`` — the ONE
    construction path, shared by ``create()`` and the bootstrap engine's
    cutover and generation rebuilds (which is what makes a streamed-in
    index identical to a batch-built twin of the same rows)."""
    kw = dict(mode=spec.mode, vamana=spec.vamana(), n_bits=spec.n_bits,
              bucket_capacity=spec.bucket_capacity, pq_subspaces=spec.pq,
              seed=spec.seed, hop_backend=spec.hop_backend,
              device=resolve_device(device))
    if spec.tier in ("sharded", "tiered"):
        from repro_torch.store.sharded_store import \
            ShardedDiskVectorSearchEngine
        from repro_torch.tiered import TieredVectorSearchEngine
        if spec.tier == "tiered":
            eng = TieredVectorSearchEngine(
                store_dir=spec.path, cache_frames=spec.cache_frames,
                n_shards=spec.n_shards, io=spec.io,
                tiered=spec.tiered or TieredSpec(), **kw)
        else:
            eng = ShardedDiskVectorSearchEngine(
                store_dir=spec.path, n_shards=spec.n_shards,
                cache_frames=spec.cache_frames, io=spec.io, **kw)
        eng.build(vectors, labels=labels, n_labels=n_labels,
                  spare_capacity=spec.spare_capacity)
        return eng
    from repro_torch.store.io_engine import DiskVectorSearchEngine
    kw["capacity"] = vectors.shape[0] + spec.spare_capacity
    if spec.tier == "disk":
        eng = DiskVectorSearchEngine(cache_frames=spec.cache_frames,
                                     io=spec.io, store_path=spec.path, **kw)
    else:
        eng = VectorSearchEngine(**kw)
    eng.build(vectors, labels=labels, n_labels=n_labels, prebuilt=prebuilt)
    return eng


def open(path: str, *, mode: Optional[str] = None,
         spec: Optional[IndexSpec] = None, device="cuda") -> Database:
    """Reopen whatever is persisted at ``path`` (see ``sniff``) on
    ``device`` (the card by default; raises if there is none).

    ``mode`` overrides the acceleration mode (sharded and tiered
    manifests record their own; a single file defaults to 'catapult').
    ``spec`` supplies the runtime-only knobs a reopen cares about —
    graph params for future upserts, cache size, I/O engine (None
    resumes the persisted ``.io.json`` / manifest ``io``), hop backend,
    serving defaults, adapt policy, warm shapes, a tiered layout's
    ``TieredSpec`` (None resumes the persisted one); its tier/path
    fields are ignored in favour of what is on disk.  Adapt sidecars
    (``<store>.adapt.npz``, per-shard ``.buckets.npz`` and the
    manifest's gate) resume buckets, telemetry and the utility-gate
    verdict; a keys sidecar restores the caller-key map.  The persisted
    ``IngestSpec`` (an ``ingest.json`` sidecar, a sharded manifest's
    ``ingest`` entry) resumes unless ``spec.ingest`` overrides it; when
    the keys sidecar also carries the bootstrap external-id indirection
    (the database was born empty), the engine is rewrapped in a
    ``BootstrapEngine`` so external ids resolve exactly as before.
    """
    dev = resolve_device(device)
    tier, _version = sniff(path)
    runtime = spec or IndexSpec()
    # io=None means "no preference": the engine resumes the persisted
    # IoSpec; an explicit runtime.io overrides it
    kwargs = dict(vamana=runtime.vamana(), cache_frames=runtime.cache_frames,
                  io=runtime.io, hop_backend=runtime.hop_backend, device=dev)
    from repro_torch.store.io_engine import DiskVectorSearchEngine
    from repro_torch.store.sharded_store import ShardedDiskVectorSearchEngine
    from repro_torch.tiered import TieredVectorSearchEngine
    if tier == "tiered":
        eng = TieredVectorSearchEngine.load(path, mode=mode,
                                            tiered=runtime.tiered, **kwargs)
    elif tier == "sharded":
        eng = ShardedDiskVectorSearchEngine.load(path, mode=mode, **kwargs)
    else:
        eng = DiskVectorSearchEngine.load(
            path, mode=mode or "catapult", n_bits=runtime.n_bits,
            bucket_capacity=runtime.bucket_capacity, seed=runtime.seed,
            **kwargs)
    # reflect what the engine restored (a manifest or an adapt sidecar
    # may have overridden the runtime knobs): db.spec describes this
    # index
    opened = dataclasses.replace(
        runtime, tier=tier, mode=eng.mode, path=path,
        pq=getattr(eng, "pq_subspaces", runtime.pq),
        filters=bool(eng.filtered), n_bits=eng.n_bits,
        bucket_capacity=eng.bucket_capacity, seed=eng.seed,
        n_shards=getattr(eng, "n_shards", runtime.n_shards), io=eng.io,
        hop_backend=eng.hop_backend,
        tiered=eng.tiered if tier == "tiered" else runtime.tiered,
        ingest=runtime.ingest or _read_persisted_ingest(tier, path))
    state = read_ingest_state(ingest_state_path(tier, path))
    keymap = None
    if state is not None:
        keymap = KeyMap.from_arrays(state)
        if "ext2int" in state:
            eng = BootstrapEngine.resume(opened, eng, state)
            opened = eng.spec
    db = Database(eng, opened, _caps(tier, eng.filtered,
                                     _host_views(tier, opened.tiered)),
                  keymap=keymap)
    db.warm()
    return db


def _read_persisted_ingest(tier: str, path: str) -> Optional[IngestSpec]:
    """The IngestSpec a persisted index carries: the manifest ``ingest``
    entry on the sharded tier, an ``ingest.json`` sidecar elsewhere.
    None when the index has none."""
    if tier == "sharded":
        from repro_torch.store.sharded_store import MANIFEST_NAME
        with builtins.open(os.path.join(path, MANIFEST_NAME)) as f:
            d = json.load(f).get("ingest")
        return IngestSpec.from_dict(d) if d else None
    p = ingest_spec_path(tier, path)
    if not os.path.exists(p):
        return None
    with builtins.open(p) as f:
        return IngestSpec.from_dict(json.load(f))
