"""repro_torch — the PyTorch/CUDA port of the CatapultDB reproduction.

A second package beside ``repro`` (the JAX/Pallas reference), with the
same layout so each module's counterpart is easy to find:

* ``core/``    — beam search (Algorithm 1), LSH, catapult buckets,
                 Algorithm 2, the Vamana build, filters, FreshVamana
                 updates, LSH-APG and the RAM-tier engine,
* ``kernels/`` — hand-written Hopper kernels (``csrc/*.cu``), their
                 plain PyTorch versions (``ref.py``) and the wrappers
                 (``ops.py``) that pick one by the device of the tensors,
* ``db/``      — the ``create``/``Database`` facade (RAM tier),
* ``serving/`` — the micro-batching ``VectorSearchFrontend``,
* ``adapt/``   — drift-aware catapult maintenance (telemetry, policy,
                 ``CatapultMaintainer``),
* ``obs/``     — metrics registry, explain traces, the serving window
                 and profiler hooks,
* ``ingest/``  — the caller-key map behind keyed upserts,
* ``data/``    — synthetic workloads.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for the card where there is none raises.  The
package imports ``torch`` and numpy, never ``jax`` or ``repro``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
