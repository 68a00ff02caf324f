"""Synthetic workloads (numpy), copied from the reference's generators."""
from repro_torch.data.workloads import Workload, make_papers, make_tripclick

__all__ = ["Workload", "make_papers", "make_tripclick"]
