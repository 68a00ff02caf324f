"""The fused-hop backends ``core.beam_search`` dispatches on.

A backend IS a dist_fn — a callable ``(queries (B, d), ids (B, M)) ->
(B, M)`` distances, so catapult entry scoring behaves identically on
either backend — that additionally carries the vector table and exposes
``hop_batch``, the whole-batch fused hop.  ``beam_search`` duck-types on
``is_fused_hop``.  Mirrors ``repro/kernels/fused_hop.py:FusedL2Hop`` and
``FusedPQHop``.

On the card ``FusedL2Hop.__call__`` is the gather-distance kernel and
its ``hop_batch`` the fused L2 hop; ``FusedPQHop.__call__`` is the
``pq_adc`` kernel and its ``hop_batch`` the fused PQ hop.  Each pair
shares one distance routine, so the fused and composed hops return
bit-identical beams.  On the CPU all take the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


class FusedL2Hop:
    """Full-precision L2 hop backend over a device vector table."""

    is_fused_hop = True

    def __init__(self, vectors: torch.Tensor):
        self.vectors = vectors

    def __call__(self, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return ops.gather_distance(self.vectors, ids, queries)

    def hop_batch(self, queries, cand_ids, beam_ids, beam_dists, beam_exp):
        return ops.fused_hop_l2(self.vectors, cand_ids, queries, beam_ids,
                                beam_dists, beam_exp)


class FusedPQHop:
    """PQ-ADC hop backend over a device code table + per-query LUTs.

    The LUTs come from ``core.pq.ADCDist``, once per queries tensor, so
    the init, every hop and the ``won`` scoring of a batch share one
    (B, M, K) tensor (the reference rebuilds it on every call; the
    values are the same)."""

    is_fused_hop = True

    def __init__(self, codebook, codes: torch.Tensor):
        from repro_torch.core.pq import ADCDist   # lazy: kernels stay leaf-like
        self.adc = ADCDist(codebook, codes)

    def __call__(self, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return self.adc(queries, ids)

    def hop_batch(self, queries, cand_ids, beam_ids, beam_dists, beam_exp):
        return ops.fused_hop_pq(self.adc.luts(queries), self.adc.codes,
                                cand_ids, beam_ids, beam_dists, beam_exp)
