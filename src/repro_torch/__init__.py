"""repro_torch — the PyTorch/CUDA port of the CatapultDB reproduction.

A second package beside ``repro`` (the JAX/Pallas reference), with the
same layout so each module's counterpart is easy to find:

* ``core/``    — beam search (Algorithm 1), LSH, catapult buckets,
                 Algorithm 2, the Vamana build, filters, FreshVamana
                 updates, LSH-APG, the RAM-tier engine and the HNSW and
                 Proximity-cache baselines,
* ``kernels/`` — hand-written Hopper kernels (``csrc/*.cu``), their
                 plain PyTorch versions (``ref.py``) and the wrappers
                 (``ops.py``) that pick one by the device of the tensors,
* ``db/``      — the ``create``/``open``/``Database`` facade (every
                 tier),
* ``store/``   — the single-store disk tier (CTPL block files, the node
                 cache, the I/O pipeline) and the sharded tier,
* ``tiered/``  — the hot/cold tiered tier and its maintainer,
* ``serving/`` — the micro-batching ``VectorSearchFrontend``,
* ``adapt/``   — drift-aware catapult maintenance (telemetry, policy,
                 ``CatapultMaintainer``),
* ``obs/``     — metrics registry, explain traces, the serving window
                 and profiler hooks,
* ``ingest/``  — streaming ingest: databases born empty
                 (``BootstrapEngine``), the caller-key map and the
                 ``IngestQueue`` that interleaves upserts with serving,
* ``data/``    — synthetic workloads.

The language-model serving path sits beside them: ``configs/`` (the ten
assigned architectures), ``models/`` (their inference in plain PyTorch),
``serving/``'s ``ServingEngine`` and ``RagPipeline``, and
``launch/serve.py``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for the card where there is none raises.  The
package imports ``torch`` and numpy, never ``jax`` or ``repro``.

Public API, as the reference's: the ``repro_torch.db`` facade, its types
re-exported here, and the internal tier constructors and serving /
adaptation classes as deprecation shims.  Everything resolves lazily
(PEP 562), so ``import repro_torch`` stays free of the engine stack.
"""
from repro_torch.device import resolve_device

__version__ = "1.0.0"

# name -> defining module: the reference's documented symbol set
# (tests/test_torch_api_surface.py pins it)
_EXPORTS = {
    # the facade (preferred)
    "db": "repro_torch.db",
    "Database": "repro_torch.db",
    "IndexSpec": "repro_torch.db",
    "SearchRequest": "repro_torch.db",
    "SearchResult": "repro_torch.db",
    "Caps": "repro_torch.db",
    "CapabilityError": "repro_torch.db",
    "create": "repro_torch.db",
    "open": "repro_torch.db",
    "sniff": "repro_torch.db",
    # deprecation shims: the internal layer behind the facade
    "VectorSearchEngine": "repro_torch.core.engine",
    "DiskVectorSearchEngine": "repro_torch.store.io_engine",
    "ShardedDiskVectorSearchEngine": "repro_torch.store.sharded_store",
    "VectorSearchFrontend": "repro_torch.serving.engine",
    "CatapultMaintainer": "repro_torch.adapt.maintainer",
    "PolicyConfig": "repro_torch.adapt.policy",
}

__all__ = sorted(_EXPORTS) + ["resolve_device"]


def __getattr__(name):
    import importlib
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}")
    module = importlib.import_module(target)
    value = module if name == "db" else getattr(module, name)
    globals()[name] = value          # cache: resolve once per process
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
