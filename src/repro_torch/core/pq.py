"""Product quantization — DiskANN's in-memory compressed vectors (§4.1.2).

Port of ``repro/core/pq.py``.  Traversal scores candidates with
asymmetric distances (ADC): a per-query lookup table (LUT) of squared
subspace distances to every centroid, summed over the candidate's M
codes (the ``pq_adc`` and ``fused_hop_pq`` kernels on the card).  The
final beam is then reranked at full precision (the ``gather_distance``
kernel), DiskANN's fetch of the full vectors.

Differences from the reference, none of them in the results:

* ``train_pq`` draws its initial centroids from a CPU
  ``torch.Generator`` (the reference uses ``jax.random.choice``, which
  torch cannot replay); the Lloyd iterations are their own function,
  ``lloyd``, so a test can start them from the reference's draw.
* Distances keep the reference's direct form ``Σ (x − c)²`` (codes are
  its argmin, first minimum on ties) but are chunked over rows so the
  (rows, M, K, ds) difference stays near ``CHUNK_ELEMS`` elements, and
  the centroid sums are scattered (``index_add_``) instead of formed by
  an (M, N, K) one-hot product.
* The LUTs are batched, ``query_luts`` -> (B, M, K), and a dist_fn
  builds them once per query batch instead of once per call.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

# elements of one chunk's (rows, M, K, ds) difference tensor (1 GiB f32)
CHUNK_ELEMS = 2 ** 28


@dataclasses.dataclass(frozen=True)
class PQCodebook:
    centroids: torch.Tensor   # (M, K, ds) f32 — M subspaces, K centroids

    @property
    def n_subspaces(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[1]


def _sq_dists(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """(R, M, ds) subvectors, (M, K, ds) centroids -> (R, M, K) squared
    distances in the direct form, as the reference computes them."""
    diff = x[:, :, None, :] - cents[None]
    return diff.square_().sum(-1)


def _row_chunks(n: int, cents: torch.Tensor):
    m, k, ds = cents.shape
    step = max(1, CHUNK_ELEMS // (m * k * ds))
    return ((lo, min(lo + step, n)) for lo in range(0, n, step))


def _assign(sub: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """(N, M, ds) subvectors -> (N, M) int64 index of the nearest
    centroid per subspace (first minimum on ties, as ``jnp.argmin``)."""
    out = torch.empty(sub.shape[:2], dtype=torch.int64, device=sub.device)
    for lo, hi in _row_chunks(sub.shape[0], cents):
        out[lo:hi] = torch.argmin(_sq_dists(sub[lo:hi], cents), dim=-1)
    return out


def _centroid_sums(flat_idx: torch.Tensor, rows: torch.Tensor,
                   n_slots: int) -> torch.Tensor:
    """Sum ``rows`` (R, ds) into ``n_slots`` slots by ``flat_idx`` (R,),
    in an order that is the same on every run: ``index_add_`` on the
    CPU adds serially; on the card its atomics add in no fixed order, so
    there the sums go through ``index_put_(accumulate=True)``, which
    sorts the indices first.  Retraining from one seed must give the
    same codebook, or two engines over one corpus disagree."""
    sums = torch.zeros((n_slots, rows.shape[1]), dtype=rows.dtype,
                       device=rows.device)
    if rows.device.type == "cuda":
        return sums.index_put_((flat_idx,), rows, accumulate=True)
    return sums.index_add_(0, flat_idx, rows)


def lloyd(vectors: torch.Tensor, centroids: torch.Tensor,
          iters: int = 8) -> PQCodebook:
    """``iters`` Lloyd steps per subspace from (M, K, ds) ``centroids``
    over (N, d) ``vectors`` (both on one device).  An empty cluster
    keeps its centroid, as in the reference."""
    n, d = vectors.shape
    m, k, ds = centroids.shape
    if d != m * ds:
        raise ValueError(f"dim {d} != M * ds = {m} * {ds}")
    sub = vectors.reshape(n, m, ds)
    cents = centroids
    slot = torch.arange(m, device=vectors.device) * k        # (M,)
    for _ in range(iters):
        flat = (_assign(sub, cents) + slot).reshape(-1)      # (N*M,)
        sums = _centroid_sums(flat, sub.reshape(n * m, ds), m * k)
        counts = torch.bincount(flat, minlength=m * k).to(vectors.dtype)
        new = sums / counts.clamp(min=1)[:, None]
        cents = torch.where(counts[:, None] > 0, new,
                            cents.reshape(m * k, ds)).reshape(m, k, ds)
    return PQCodebook(centroids=cents)


def train_pq(generator: torch.Generator, vectors, n_subspaces: int,
             n_centroids: int = 256, iters: int = 8,
             device="cuda") -> PQCodebook:
    """Per-subspace k-means (Lloyd's, random init with replacement).

    The initial rows are drawn with ``torch.randint`` on ``generator``'s
    device (the CPU for the engine's generator, so one seed gives one
    codebook on every device); the iterations run on ``device``."""
    device = resolve_device(device)
    x = torch.as_tensor(vectors, dtype=torch.float32, device=device)
    n, d = x.shape
    if d % n_subspaces:
        raise ValueError(f"dim {d} is not a multiple of {n_subspaces} "
                         f"subspaces")
    ds = d // n_subspaces
    init = torch.randint(0, n, (n_subspaces, n_centroids),
                         generator=generator, device=generator.device)
    init = init.to(device)
    sub = x.reshape(n, n_subspaces, ds)
    cents = sub[init, torch.arange(n_subspaces, device=device)[:, None]]
    return lloyd(x, cents, iters)


def encode(cb: PQCodebook, vectors: torch.Tensor) -> torch.Tensor:
    """(N, d) f32 -> (N, M) int32 codes (nearest centroid per subspace)."""
    m, _, ds = cb.centroids.shape
    sub = vectors.reshape(vectors.shape[0], m, ds)
    return _assign(sub, cb.centroids).to(torch.int32)


def query_luts(cb: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """(B, d) queries -> (B, M, K) ADC lookup tables of squared subspace
    distances (direct form, chunked over the batch)."""
    b = queries.shape[0]
    m, k, ds = cb.centroids.shape
    qs = queries.reshape(b, m, ds)
    out = torch.empty((b, m, k), dtype=torch.float32, device=queries.device)
    for lo, hi in _row_chunks(b, cb.centroids):
        out[lo:hi] = _sq_dists(qs[lo:hi], cb.centroids)
    return out


def query_lut(cb: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """One (d,) query -> its (M, K) lookup table."""
    return query_luts(cb, q[None])[0]


class ADCDist:
    """Batched PQ dist_fn: ``(queries (B, d), ids (B, C)) -> (B, C)``
    ADC distances, +inf for ids < 0.

    The LUTs are a pure function of the queries, so they are built once
    per queries tensor and reused: a search batch hands the same tensor
    to its init, every hop and the catapult ``won`` scoring, and builds
    one (B, M, K) LUT tensor instead of one per call."""

    def __init__(self, codebook: PQCodebook, codes: torch.Tensor):
        self.codebook = codebook
        self.codes = codes                # (N, M) int32
        self._queries = None
        self._luts = None

    def luts(self, queries: torch.Tensor) -> torch.Tensor:
        if queries is not self._queries:
            self._queries = queries
            self._luts = query_luts(self.codebook, queries)
        return self._luts

    def __call__(self, queries: torch.Tensor, ids: torch.Tensor):
        return ops.pq_adc(self.luts(queries), self.codes, ids)


def adc_dist_fn(cb: PQCodebook, codes: torch.Tensor) -> ADCDist:
    """dist_fn for beam_search: PQ-approximate distances through the
    ``pq_adc`` kernel (its plain version on the CPU)."""
    return ADCDist(cb, codes)


def rerank(vectors: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
           k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-precision rerank of each lane's final beam (DiskANN's fetch
    of the full vectors): (B, L) ids -> the (B, k) closest ids and their
    squared L2, stable on ties as ``jnp.argsort``; ids < 0 sort last."""
    d = ops.gather_distance(vectors, ids, queries)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    return ids.gather(1, order), d.gather(1, order)
