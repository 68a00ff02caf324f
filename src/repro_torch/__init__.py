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

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for the card where there is none raises.  The
package imports ``torch`` and numpy, never ``jax`` or ``repro``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
