"""Synthetic workloads (numpy), copied from the reference's generators."""
from repro_torch.data.workloads import (Workload, make_medrag_zipf,
                                        make_papers, make_shifted_zipf,
                                        make_tripclick, make_uniform)

__all__ = ["Workload", "make_medrag_zipf", "make_papers",
           "make_shifted_zipf", "make_tripclick", "make_uniform"]
