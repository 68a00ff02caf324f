"""Random-hyperplane LSH for query-region identification (paper §2.2, §3.2).

Port of ``repro/core/lsh.py``.  ``hash_codes`` runs through
``kernels.ops.lsh_hash``: the CUDA kernel on the card, its plain version
on the CPU.

The hyperplanes come from a ``torch.Generator`` where the reference draws
them with ``jax.random``; the two give different numbers from the same
seed, so parity tests transplant the reference's hyperplanes
(``repro_torch.convert``) instead of reseeding.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """Hyperplane normals: (n_bits, dim) float32 rows drawn from N(0, I)."""

    hyperplanes: torch.Tensor

    @property
    def n_bits(self) -> int:
        return self.hyperplanes.shape[0]

    @property
    def n_buckets(self) -> int:
        return 2 ** self.hyperplanes.shape[0]


def make_lsh(generator: torch.Generator, n_bits: int, dim: int,
             device="cuda") -> LSHParams:
    """Draw ``n_bits`` hyperplane normals from the standard normal.

    The draw happens on the generator's device (the CPU for the engine's
    generator, so the same seed gives the same planes on every device)
    and the result moves to ``device``."""
    device = resolve_device(device)
    h = torch.randn((n_bits, dim), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return LSHParams(hyperplanes=h.to(device))


def hash_bits(params: LSHParams, q: torch.Tensor) -> torch.Tensor:
    """Per-hyperplane sign bits.  q: (..., dim) -> (..., n_bits) int32."""
    return (q @ params.hyperplanes.T >= 0).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., n_bits) {0,1} -> (...,) int32 bucket index, bit i weighted 2**i."""
    weights = 2 ** torch.arange(bits.shape[-1], dtype=torch.int32,
                                device=bits.device)
    return (bits * weights).sum(-1).to(torch.int32)


def hash_codes(params: LSHParams, q: torch.Tensor) -> torch.Tensor:
    """LSH bucket index for each query.  q: (B, dim) f32 -> (B,) int32."""
    return ops.lsh_hash(q, params.hyperplanes)
