"""repro_torch.core — CatapultDB's search machinery in PyTorch.

Vamana construction, DiskANN beam search (Algorithm 1), random-hyperplane
LSH, the catapult buckets and Algorithm 2, FilteredVamana support,
FreshVamana updates, the LSH-APG baseline, the RAM-tier engine, and the
two baselines of the paper's comparisons: the HNSW-style hierarchy
(``core.hnsw``) and the Proximity cache (``core.proximity_cache``).
"""
from repro_torch.core.beam_search import (SearchSpec, beam_search,
                                          beam_search_l2, l2_dist_fn)
from repro_torch.core.buckets import (BucketState, evict_ids, lookup,
                                      make_buckets, publish)
from repro_torch.core.catapult import (CatapultState, catapulted_lookup,
                                       make_catapult_state)
from repro_torch.core.filters import (build_stitched_graph,
                                      label_entry_points,
                                      make_filter_mask_fn,
                                      refresh_label_entries)
from repro_torch.core.insert import consolidate, delete, insert_batch
from repro_torch.core.lsh_apg import LshApgIndex, build_lsh_apg, entry_points
from repro_torch.core.engine import (DiskStore, RamStore, SearchStats,
                                     VectorSearchEngine, brute_force_knn,
                                     recall_at_k)
from repro_torch.core.lsh import LSHParams, hash_codes, make_lsh
from repro_torch.core.vamana import (VamanaParams, build_vamana,
                                     medoid_index, robust_prune)

__all__ = [
    "SearchSpec", "beam_search", "beam_search_l2", "l2_dist_fn",
    "BucketState", "evict_ids", "make_buckets", "lookup", "publish",
    "CatapultState", "catapulted_lookup", "make_catapult_state",
    "SearchStats", "VectorSearchEngine", "brute_force_knn", "recall_at_k",
    "RamStore", "DiskStore", "VamanaParams", "build_vamana", "medoid_index",
    "robust_prune", "LSHParams", "hash_codes", "make_lsh",
    "build_stitched_graph", "label_entry_points", "make_filter_mask_fn",
    "refresh_label_entries", "consolidate", "delete", "insert_batch",
    "LshApgIndex", "build_lsh_apg", "entry_points",
]
