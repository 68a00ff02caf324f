"""Serving: the micro-batching vector-search frontend."""
from repro_torch.serving.engine import VectorSearchFrontend

__all__ = ["VectorSearchFrontend"]
