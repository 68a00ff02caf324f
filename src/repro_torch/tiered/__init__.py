"""repro_torch.tiered — the hot/cold tiered database: RAM-resident hot
rows (on the engine's device) over a cold disk or sharded index, one
engine protocol, locality-driven promotion.  Port of ``repro/tiered``."""
from repro_torch.tiered.engine import (TIERED_FORMAT, TIERED_MANIFEST_NAME,
                                       TIERED_VERSION,
                                       TieredVectorSearchEngine)
from repro_torch.tiered.maintainer import TieredMaintainer

__all__ = [
    "TieredVectorSearchEngine",
    "TieredMaintainer",
    "TIERED_FORMAT",
    "TIERED_MANIFEST_NAME",
    "TIERED_VERSION",
]
