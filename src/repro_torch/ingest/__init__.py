"""Streaming ingest: empty bootstrap, caller keys, ingest-while-serving.

Port of ``repro/ingest``.  The subsystem behind ``create(spec)`` with no
vectors and ``db.upsert(vectors, keys=...)``:

* ``BootstrapEngine`` — the empty → seed-brute-force → graph state
  machine with a stable external-id space over any tier backend, every
  build on the database's device;
* ``KeyMap`` — the persisted caller-key ↔ gid indirection;
* ``IngestQueue`` — batched concurrent upserts, locality grouped,
  interleaved with serving flushes;
* ``IngestSpec`` — the validated sub-config (re-exported from
  ``repro_torch.db.spec``, where it lives beside ``IoSpec``/
  ``TieredSpec``).
"""
from repro_torch.db.spec import IngestSpec
from repro_torch.ingest.bootstrap import BootstrapEngine
from repro_torch.ingest.keys import KeyMap
from repro_torch.ingest.queue import IngestQueue, Ticket, locality_order

__all__ = ["BootstrapEngine", "IngestQueue", "IngestSpec", "KeyMap",
           "Ticket", "locality_order"]
