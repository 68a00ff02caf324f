"""Ingest support on the port: the caller-key map (``KeyMap``)."""
from repro_torch.ingest.keys import KeyMap

__all__ = ["KeyMap"]
