"""Serving: LM continuous batching (``ServingEngine``), the
micro-batching vector-search frontend and the RAG pipeline
(``serving.rag``)."""
from repro_torch.serving.engine import (Request, ServingEngine,
                                        VectorSearchFrontend)

__all__ = ["Request", "ServingEngine", "VectorSearchFrontend"]
