"""Plain PyTorch versions of the port's hand-written kernels.

Each function is the semantic ground truth its CUDA kernel is held to
(``chip_smoke.py`` on the card) and the path ``ops`` takes for tensors
on the CPU.  They mirror ``repro/kernels/ref.py`` with one difference:
``gather_distance_ref`` is batched to (B, C) — one query per row of ids —
because that is the shape every caller in the port hands it.
"""
from __future__ import annotations

import torch


def gather_distance_ref(vectors: torch.Tensor, ids: torch.Tensor,
                        queries: torch.Tensor) -> torch.Tensor:
    """(N, d), (B, C) int32, (B, d) -> (B, C) squared L2 to each
    gathered row.  Invalid ids (< 0) give +inf."""
    x = vectors[ids.clamp(min=0).long()].float()
    d = torch.square(x - queries[:, None, :].float()).sum(-1)
    return torch.where(ids < 0, torch.inf, d)


def lsh_hash_ref(queries: torch.Tensor,
                 hyperplanes: torch.Tensor) -> torch.Tensor:
    """(B, d), (L, d) -> (B,) int32 bucket codes (bit i = sign of proj i)."""
    bits = (queries.float() @ hyperplanes.float().T >= 0).to(torch.int32)
    weights = 2 ** torch.arange(hyperplanes.shape[0], dtype=torch.int32,
                                device=queries.device)
    return (bits * weights).sum(-1).to(torch.int32)


def _merge_ref(cand_ids, cand_d, beam_ids, beam_d, beam_exp):
    """Batched beam merge: dedup then stable top-L (self-contained
    mirror of ``core.beam_search._merge``'s semantics)."""
    l = beam_ids.shape[1]
    c = cand_ids.shape[1]
    in_beam = ((cand_ids[:, :, None] == beam_ids[:, None, :])
               & (beam_ids[:, None, :] >= 0)).any(2)
    pos = torch.arange(c, device=cand_ids.device)
    earlier = ((cand_ids[:, :, None] == cand_ids[:, None, :])
               & (pos[None, :] < pos[:, None])[None]).any(2)
    fresh = ~(in_beam | earlier) & (cand_ids >= 0)
    cand_d = torch.where(fresh, cand_d, torch.inf)
    ids = torch.cat([beam_ids, cand_ids], 1)
    dists = torch.cat([beam_d, cand_d], 1)
    exp = torch.cat([beam_exp, torch.zeros_like(cand_ids, dtype=torch.bool)],
                    1)
    order = torch.argsort(dists, dim=1, stable=True)[:, :l]
    ids, dists, exp = (ids.gather(1, order), dists.gather(1, order),
                       exp.gather(1, order))
    invalid = ~torch.isfinite(dists)
    ids = torch.where(invalid, -1, ids)
    exp = exp | invalid
    return ids, dists, exp, fresh.sum(1, dtype=torch.int32)


def fused_hop_ref(vectors, cand_ids, queries, beam_ids, beam_dists, beam_exp):
    """Plain version of ``fused_hop_l2``: batched gather + L2 + merge.

    (N, d) table, (B, C) candidate ids, (B, d) queries, (B, L) beam
    state -> (new_ids, new_dists, new_exp, n_fresh), all batched.
    """
    d = gather_distance_ref(vectors, cand_ids, queries)
    return _merge_ref(cand_ids, d, beam_ids, beam_dists, beam_exp)
