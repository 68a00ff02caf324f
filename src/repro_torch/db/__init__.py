"""repro_torch.db — the port's front door (RAM tier).

    from repro_torch import db as catapultdb

    d = catapultdb.create(catapultdb.IndexSpec(), vectors)   # on the card
    ids, dists, stats = d.search(queries, k=10)
    trace = d.search(queries, k=10, explain=True)          # SearchTrace
    scrape = d.metrics("prometheus")

``create(..., device="cpu")`` runs the plain PyTorch path instead.
"""
from repro_torch.db.database import Database
from repro_torch.db.factory import create
from repro_torch.db.spec import (CapabilityError, Caps, IndexSpec,
                                 SearchRequest, SearchResult)
from repro_torch.obs import SearchTrace

__all__ = [
    "CapabilityError", "Caps", "Database", "IndexSpec", "SearchRequest",
    "SearchResult", "SearchTrace", "create",
]
