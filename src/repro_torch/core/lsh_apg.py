"""LSH-APG baseline (Zhao et al., VLDB'23) — static LSH entry points.

Port of ``repro/core/lsh_apg.py``.  LSH-APG hashes the *indexed data*
once, at build, and starts each query from the rows in its bucket.
Unlike catapults the table never adapts to the workload, goes stale
under inserts (on purpose, as in the reference) and ignores filters.
It uses the catapult layer's random-hyperplane family, so the two
systems differ only in where their entry points come from.

The corpus hash is one launch of the LSH kernel over every row on the
card.  The bucket fill keeps the reference's order, the first ``m``
rows of each bucket in index order: a stable sort of the codes gives
the same table as its Python loop.  The hyperplanes come from a CPU
``torch.Generator``; parity tests transplant the reference's table
(``repro_torch.convert.lsh_apg_index_from_numpy``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import lsh as lsh_mod


@dataclasses.dataclass(frozen=True)
class LshApgIndex:
    lsh: lsh_mod.LSHParams
    table: torch.Tensor   # (2**L, m) int32 data-point ids per bucket, -1 padded


def bucket_table(codes: np.ndarray, n_bits: int,
                 entries_per_bucket: int) -> np.ndarray:
    """(N,) bucket codes -> (2**n_bits, m) int32 table of the first ``m``
    row ids of each bucket in index order, -1 padded."""
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]
    first = np.searchsorted(sorted_codes, sorted_codes, side="left")
    rank = np.arange(codes.size) - first      # position within the bucket
    keep = rank < entries_per_bucket
    table = np.full((2 ** n_bits, entries_per_bucket), -1, np.int32)
    table[sorted_codes[keep], rank[keep]] = order[keep]
    return table


def build_lsh_apg(vectors: torch.Tensor, generator: torch.Generator,
                  n_bits: int = 8, entries_per_bucket: int = 8,
                  device="cuda") -> LshApgIndex:
    """Hash the (N, d) corpus tensor (on ``device``) with hyperplanes
    drawn from ``generator`` and keep the first ``entries_per_bucket``
    rows of each bucket."""
    params = lsh_mod.make_lsh(generator, n_bits, vectors.shape[1], device)
    codes = lsh_mod.hash_codes(params, vectors).cpu().numpy()
    table = bucket_table(codes, n_bits, entries_per_bucket)
    return LshApgIndex(lsh=params, table=torch.as_tensor(
        table, device=params.hyperplanes.device))


def entry_points(index: LshApgIndex, queries: torch.Tensor,
                 medoid: int) -> torch.Tensor:
    """(B, m+1) int32 starting points: bucket rows plus the medoid."""
    codes = lsh_mod.hash_codes(index.lsh, queries)
    cand = index.table[codes.long()]
    med = torch.full((queries.shape[0], 1), medoid, dtype=torch.int32,
                     device=queries.device)
    return torch.cat([cand, med], 1)
