"""repro_torch.db — the port's front door (RAM, disk, sharded and tiered
tiers).

    from repro_torch import db as catapultdb

    d = catapultdb.create(catapultdb.IndexSpec(), vectors)   # on the card
    ids, dists, stats = d.search(queries, k=10)
    trace = d.search(queries, k=10, explain=True)          # SearchTrace
    scrape = d.metrics("prometheus")

    spec = catapultdb.IndexSpec(tier="disk", path="index.ctpl")
    with catapultdb.create(spec, vectors) as d:            # CTPL block file
        d.search(queries, k=10)
        io = d.io_stats()                                  # IoStats
        d.save()
    with catapultdb.open("index.ctpl") as d:               # sniff() -> disk
        d.search(queries, k=10)

    spec = catapultdb.IndexSpec(tier="sharded", n_shards=4, path="idx.d")
    spec = catapultdb.IndexSpec(tier="tiered", path="tiered.d",
                                tiered=catapultdb.TieredSpec())

    d = catapultdb.create(catapultdb.IndexSpec(dim=768))    # born empty
    fe = d.serve(ingest=True)                   # ingest while serving
    ticket = fe.ingest.put(rows, keys=row_keys)
    fe.search(queries, k=10)                    # flushes pump the queue

``create(..., device="cpu")`` / ``open(..., device="cpu")`` run the
plain PyTorch path instead.
"""
from repro_torch.db.database import Database
from repro_torch.db.factory import create, open, sniff
from repro_torch.db.spec import (CapabilityError, Caps, IndexSpec,
                                 IngestSpec, IoSpec, SearchRequest,
                                 SearchResult, TieredSpec)
from repro_torch.obs import SearchTrace
from repro_torch.store.cache import IoStats

__all__ = [
    "CapabilityError", "Caps", "Database", "IndexSpec", "IngestSpec",
    "IoSpec", "IoStats",
    "SearchRequest", "SearchResult", "SearchTrace", "TieredSpec", "create",
    "open", "sniff",
]
