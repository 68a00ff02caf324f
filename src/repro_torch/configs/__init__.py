"""Assigned architecture configs (+ the paper's own engine config).

One module per ``--arch <id>``; see ``base.ARCH_IDS`` for the registry
and ``base.SHAPES`` for the assigned input shapes.
"""
from repro_torch.configs.base import ARCH_IDS, SHAPES, ArchConfig, get_config, get_reduced

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "get_config", "get_reduced"]
