"""repro_torch.store — disk-resident index storage (DiskANN's SSD tier).

Port of ``repro/store``:

* ``layout``    — the block-aligned CTPL file format (vector + adjacency
                  co-located per node, memmap-backed), byte for byte the
                  reference's (``src/repro/store/FORMAT.md``),
* ``cache``     — CLOCK node cache over block frames with hit/miss/read
                  accounting and pinning for hot nodes,
* ``pipeline``  — the async speculative-read pipeline over the cache,
* ``io_engine`` — ``DiskVectorSearchEngine``: PQ codes + adjacency on
                  the device for traversal; full-precision vectors read
                  from node blocks through the cache to rerank on the
                  host,
* ``sharded_store`` — ``ShardedDiskVectorSearchEngine``: scatter-gather
                  over S independent CTPL shards (one store, cache and
                  catapult table each) on a thread pool, with
                  manifest-directory persistence, least-loaded insert
                  routing and fanned-out deletes and filtered search.

The tier is mutable (CTPL v3): tombstone bitmaps and per-label entry
points persist in the block file; insert/delete/consolidate write
through and survive reopen.
"""
from repro_torch.store.cache import CacheStats, IoStats, NodeCache
from repro_torch.store.layout import (BlockStore, StoreHeader, block_size_for,
                                      create_store, open_store, write_store)

__all__ = [
    "BlockStore", "StoreHeader", "NodeCache", "CacheStats", "IoStats",
    "block_size_for", "create_store", "open_store", "write_store",
    "DiskVectorSearchEngine", "ShardedDiskVectorSearchEngine",
]


def __getattr__(name):
    # io_engine/sharded_store import repro_torch.core (which may itself
    # be mid-import when it lazily pulls in repro_torch.store.layout for
    # DiskStore) — resolve the engine classes on first touch instead of
    # at import time
    if name == "DiskVectorSearchEngine":
        from repro_torch.store.io_engine import DiskVectorSearchEngine
        return DiskVectorSearchEngine
    if name == "ShardedDiskVectorSearchEngine":
        from repro_torch.store.sharded_store import \
            ShardedDiskVectorSearchEngine
        return ShardedDiskVectorSearchEngine
    raise AttributeError(name)
