"""The paper's own configuration: the CatapultDB engine at deployment scale.

These are the defaults used across the paper's evaluation (§3.3, §4.5)
plus the production sharding geometry the dry-run compiles: the corpus is
row-sharded over the `model` mesh axis (scatter-gather shard search) and
the query stream over `data` (× `pod`).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    name: str = "catapultdb"
    dim: int = 768                 # MedCPT embedding dim (paper workloads)
    n_vectors: int = 1_000_000     # per model-shard in the dry-run
    max_degree: int = 64           # Vamana R
    alpha: float = 1.2
    lsh_bits: int = 8              # L  (paper optimum)
    bucket_capacity: int = 40      # b  (paper optimum)
    beam_width: int = 16
    k: int = 10
    max_iters: int = 64
    query_batch: int = 4096        # global queries per search step


CONFIG = EngineConfig()


def reduced() -> EngineConfig:
    return dataclasses.replace(
        CONFIG, dim=32, n_vectors=2048, max_degree=8, lsh_bits=4,
        bucket_capacity=8, beam_width=8, k=4, max_iters=24,
        query_batch=64)
