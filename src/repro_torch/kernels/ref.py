"""Plain PyTorch versions of the port's hand-written kernels.

Each function is the semantic ground truth its CUDA kernel is held to
(``chip_smoke.py`` on the card) and the path ``ops`` takes for tensors
on the CPU.  They mirror ``repro/kernels/ref.py`` with one difference:
``gather_distance_ref`` and ``pq_adc_ref`` are batched to (B, C) — one
query (one LUT) per row of ids — because that is the shape every caller
in the port hands them; ``pq_adc_ref`` also takes the ids form that
``core.pq.ADCDist`` calls.  ``l2_distance_ref`` computes every (query,
point) block in the direct form, a block of queries at a time, so that
its (rows, C, d) difference stays near ``CHUNK_ELEMS`` elements.
"""
from __future__ import annotations

import torch

# elements of one (rows, C, d) difference block of l2_distance_ref (1 GiB)
CHUNK_ELEMS = 2 ** 28


def l2_distance_ref(queries: torch.Tensor,
                    points: torch.Tensor) -> torch.Tensor:
    """(B, d), (C, d) -> (B, C) squared L2 distances (direct form)."""
    b, c = queries.shape[0], points.shape[0]
    out = torch.empty((b, c), dtype=torch.float32, device=queries.device)
    step = max(1, CHUNK_ELEMS // max(1, c * points.shape[1]))
    x = points.float()
    for lo in range(0, b, step):
        q = queries[lo: lo + step].float()
        out[lo: lo + step] = torch.square(q[:, None, :] - x[None]).sum(-1)
    return out


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


def pq_adc_ref(luts: torch.Tensor, codes: torch.Tensor,
               ids: torch.Tensor | None = None) -> torch.Tensor:
    """(B, M, K) LUTs, (B, C, M) codes -> (B, C) summed asymmetric
    distances ``Σ_m luts[b, m, codes[b, c, m]]``, added in m order.
    With (B, C) ``ids``, ``codes`` is an (N, M) table whose rows the ids
    pick; ids < 0 give +inf."""
    if ids is not None:
        d = pq_adc_ref(luts, codes[ids.clamp(min=0).long()])
        return torch.where(ids < 0, torch.inf, d)
    g = luts.float().gather(2, codes.long().transpose(1, 2))    # (B, M, C)
    acc = g[:, 0]
    for m in range(1, g.shape[1]):
        acc = acc + g[:, m]
    return acc


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


def fused_hop_pq_ref(luts, codes, cand_ids, beam_ids, beam_dists, beam_exp):
    """Plain version of ``fused_hop_pq``: batched code gather + ADC + merge.

    (B, M, K) per-query LUTs, (N, M) code table, (B, C) candidate ids,
    (B, L) beam state -> (new_ids, new_dists, new_exp, n_fresh).
    """
    d = pq_adc_ref(luts, codes, cand_ids)
    return _merge_ref(cand_ids, d, beam_ids, beam_dists, beam_exp)
