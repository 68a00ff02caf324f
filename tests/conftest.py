"""Shared fixtures: small clustered corpora and prebuilt indices.

Session-scoped so the Vamana build cost is amortized across tests.
NOTE: never set XLA_FLAGS device-count overrides here — smoke tests and
benches must see the single real CPU device; only launch/dryrun.py forges
the 512-device host platform (per its module header).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import VamanaParams, VectorSearchEngine, brute_force_knn


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (repro_torch kernels); skips "
                   "where torch.cuda.is_available() is False")


def make_clustered(n: int, d: int, n_clusters: int, seed: int,
                   spread: float = 1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, n)
    data = centers[assign] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return data.astype(np.float32), centers, assign


SMALL = dict(n=1500, d=16, n_clusters=12, seed=0)
VPARAMS = VamanaParams(max_degree=16, build_beam=32, batch=512, seed=0)


@pytest.fixture(scope="session")
def corpus():
    data, centers, assign = make_clustered(**SMALL)
    return data, centers, assign


@pytest.fixture(scope="session")
def queries(corpus):
    data, centers, _ = corpus
    rng = np.random.default_rng(7)
    idx = rng.integers(0, centers.shape[0], 96)
    q = centers[idx] + 0.5 * rng.normal(size=(96, SMALL["d"])).astype(np.float32)
    return q.astype(np.float32)


@pytest.fixture(scope="session")
def ground_truth(corpus, queries):
    return brute_force_knn(corpus[0], queries, 10)


@pytest.fixture(scope="session")
def diskann_engine(corpus):
    return VectorSearchEngine(mode="diskann", vamana=VPARAMS).build(corpus[0])


@pytest.fixture(scope="session")
def catapult_engine(corpus):
    return VectorSearchEngine(mode="catapult", vamana=VPARAMS).build(corpus[0])
