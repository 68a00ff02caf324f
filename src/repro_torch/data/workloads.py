"""Synthetic evaluation workloads — a copy of the reference's generators.

The port keeps its own copy of ``repro/data/workloads.py``'s
``Workload``, ``_clustered_corpus``, ``make_tripclick``,
``make_medrag_zipf``, ``make_shifted_zipf``, ``make_uniform`` and
``make_papers`` (numpy only), so the same seed gives the same corpus,
labels and queries in both packages.

tripclick — session random-walk over topic clusters: real user traffic's
temporal locality (bursts of related queries) replayed in order.
medrag_zipf — Zipf-skewed paraphrase clusters; shifted_zipf adds a
mid-stream popularity shift (the adapt layer's scenarios); uniform has
no locality at all.
papers — a labeled corpus (label = cluster, the arXiv category) whose
queries each carry their own category predicate (filtered search).
Corpora are Gaussian cluster mixtures on a connected manifold; ambient
d defaults to 24, the intrinsic-dimension regime of real text
embeddings.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Workload:
    name: str
    corpus: np.ndarray                 # (N, d)
    queries: np.ndarray                # (Q, d), replayed in order
    labels: np.ndarray | None = None   # (N,) corpus labels (papers)
    filter_labels: np.ndarray | None = None  # (Q,) query predicates
    meta: dict | None = None           # generator annotations


def _clustered_corpus(n, d, n_clusters, rng, spread=1.0, sep=1.5,
                      background=0.15):
    """Topic clusters embedded in a continuous manifold: density modes
    plus a background fraction, which keeps the corpus greedy-navigable
    while preserving the locality structure the workloads test."""
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * sep
    assign = rng.integers(0, n_clusters, n)
    pts = centers[assign] + spread * rng.normal(size=(n, d)).astype(np.float32)
    nb = int(n * background)
    if nb:
        scale = float(np.abs(centers).max() * 1.2)
        pts[:nb] = rng.normal(size=(nb, d)).astype(np.float32) * scale * 0.6
        assign[:nb] = -1
    return pts.astype(np.float32), centers, assign


def make_tripclick(n=20_000, d=24, n_clusters=64, n_queries=4_096, seed=0,
                   session_len=16, hot_frac=0.2):
    """Temporal locality: sessions orbit a *document* of a popular topic.
    Popularity is heavy-tailed."""
    rng = np.random.default_rng(seed)
    corpus, centers, assign = _clustered_corpus(n, d, n_clusters, rng)
    n_hot = max(1, int(n_clusters * hot_frac))
    popular = rng.permutation(n_clusters)[:n_hot]
    by_topic = [np.nonzero(assign == t)[0] for t in range(n_clusters)]
    qs = []
    while len(qs) < n_queries:
        topic = popular[rng.integers(0, n_hot)] if rng.random() < 0.8 \
            else rng.integers(0, n_clusters)
        docs = by_topic[topic]
        if docs.size == 0:
            continue
        anchor = corpus[docs[rng.integers(0, docs.size)]]
        for _ in range(session_len):
            qs.append(anchor + 0.25 * rng.normal(size=d))
            if len(qs) >= n_queries:
                break
    return Workload("tripclick", corpus,
                    np.asarray(qs, np.float32))


def make_medrag_zipf(n=20_000, d=24, n_clusters=256, n_queries=4_096,
                     seed=1, zipf_a=1.8, paraphrase=0.15):
    """Zipf-sampled paraphrase clusters (the paper's Zipf(0.8) over ranked
    clusters; numpy's one-parameter zipf uses a>1, the rank skew matches)."""
    rng = np.random.default_rng(seed)
    corpus, centers, _ = _clustered_corpus(n, d, n_clusters, rng)
    ranks = rng.zipf(zipf_a, size=n_queries) % n_clusters
    base = rng.permutation(n_clusters)[ranks]
    qs = centers[base] + paraphrase * rng.normal(size=(n_queries, d))
    return Workload("medrag_zipf", corpus, qs.astype(np.float32))


def make_shifted_zipf(n=20_000, d=24, n_clusters=256, n_queries=4_096,
                      seed=1, zipf_a=1.8, paraphrase=0.15, kind="sudden",
                      period=None):
    """medrag_zipf with a mid-stream workload shift (the paper's Fig. 7
    adaptation scenarios).

    Two independent rank→cluster popularity maps A and B over the SAME
    corpus; each query draws its Zipf rank as usual, then resolves it
    through A or B depending on stream position:

      sudden    — A for the first half, B for the second: the hot set
                  swaps instantly (a trending-topic event),
      gradual   — P(B) ramps linearly from 0 to 1 over the middle half
                  of the stream: slow audience migration,
      flipflop  — A/B alternate every ``period`` queries (default Q/8):
                  periodic traffic (time zones, weekday/weekend).

    ``meta['shift_point']`` marks where post-shift measurement starts:
    the swap for sudden, the end of the ramp for gradual, the last flip
    for flipflop.
    """
    rng = np.random.default_rng(seed)
    corpus, centers, _ = _clustered_corpus(n, d, n_clusters, rng)
    ranks = rng.zipf(zipf_a, size=n_queries) % n_clusters
    perm_a = rng.permutation(n_clusters)
    perm_b = rng.permutation(n_clusters)
    i = np.arange(n_queries)
    if kind == "sudden":
        shift = n_queries // 2
        use_b = i >= shift
    elif kind == "gradual":
        ramp = np.clip((i - n_queries // 4) / max(n_queries // 2, 1), 0., 1.)
        use_b = rng.random(n_queries) < ramp
        shift = 3 * n_queries // 4
    elif kind == "flipflop":
        period = period or max(n_queries // 8, 1)
        use_b = (i // period) % 2 == 1
        shift = (n_queries // period) * period - period
    else:
        raise ValueError(f"unknown shift kind {kind!r}")
    cluster = np.where(use_b, perm_b[ranks], perm_a[ranks])
    qs = centers[cluster] + paraphrase * rng.normal(size=(n_queries, d))
    return Workload(f"shifted_zipf_{kind}", corpus, qs.astype(np.float32),
                    meta={"kind": kind, "shift_point": int(shift),
                          "period": int(period or 0)})


def make_uniform(n=20_000, d=24, n_queries=4_096, seed=2):
    rng = np.random.default_rng(seed)
    corpus, _, _ = _clustered_corpus(n, d, 64, rng)
    qs = rng.uniform(-1, 1, size=(n_queries, d)).astype(np.float32) * 4.0
    return Workload("uniform", corpus, qs)


def make_papers(n=20_000, d=24, n_labels=16, n_queries=2_048, seed=3):
    """Labeled corpus; every query carries its own category predicate."""
    rng = np.random.default_rng(seed)
    # no background mass: every paper carries a category label
    corpus, centers, assign = _clustered_corpus(n, d, n_labels, rng,
                                                background=0.0)
    labels = assign.astype(np.int32)       # cluster == arXiv category
    qi = rng.integers(0, n_labels, n_queries)
    qs = centers[qi] + 0.5 * rng.normal(size=(n_queries, d))
    return Workload("papers", corpus, qs.astype(np.float32),
                    labels=labels, filter_labels=qi.astype(np.int32))
