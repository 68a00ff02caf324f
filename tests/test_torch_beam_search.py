"""repro_torch beam search (Algorithm 1) against the JAX package's, on the
conftest SMALL corpus with the reference's Vamana graph transplanted.

Both packages get the same numpy inputs.  Integer outputs (ids, hops,
ndists, trace, scored, converged) must be exactly equal; distances
agree to rtol 1e-6 (XLA and torch sum the d squares in their own order).
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages re-export a function named beam_search over the module
jbs = importlib.import_module("repro.core.beam_search")
tbs = importlib.import_module("repro_torch.core.beam_search")

INT_FIELDS = ["ids", "hops", "ndists", "trace", "scored", "converged"]


def _compare(jres, tres):
    for fld in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tres, fld).numpy(),
                                      np.asarray(getattr(jres, fld)),
                                      err_msg=fld)
    want = np.asarray(jres.dists)
    got = tres.dists.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-6, atol=0)


def _both(adj, vec, q, starts, **spec):
    jres = jbs.beam_search_l2(jnp.asarray(adj), jnp.asarray(vec),
                              jnp.asarray(q), jnp.asarray(starts),
                              jbs.SearchSpec(**spec))
    tres = tbs.beam_search_l2(torch.as_tensor(adj), torch.as_tensor(vec),
                              torch.as_tensor(q), torch.as_tensor(starts),
                              tbs.SearchSpec(**spec))
    return jres, tres


@pytest.mark.parametrize("hop_backend", ["unfused", "fused"])
@pytest.mark.parametrize("record_scored", [False, True])
def test_beam_search_matches_jax_on_small(corpus, queries, diskann_engine,
                                          hop_backend, record_scored):
    data = corpus[0]
    adj = diskann_engine._adj_np
    starts = np.full((queries.shape[0], 1), diskann_engine.medoid, np.int32)
    jres, tres = _both(adj, data, queries, starts, beam_width=16, k=10,
                       max_iters=80, record_scored=record_scored,
                       hop_backend=hop_backend)
    _compare(jres, tres)
    assert tres.converged.all()
    assert tres.ids.dtype == torch.int32 and tres.dists.dtype == torch.float32


@pytest.mark.parametrize("hop_backend", ["unfused", "fused"])
def test_catapult_shaped_starts_and_iteration_cap(corpus, queries,
                                                  diskann_engine, hop_backend):
    """Start sets with interior -1 slots (a catapult bucket with holes),
    a lane with no valid start at all, and an iteration cap that stops
    lanes before they converge."""
    data = corpus[0]
    rng = np.random.default_rng(5)
    b = queries.shape[0]
    starts = np.full((b, 5), -1, np.int32)
    starts[:, 1] = rng.integers(0, data.shape[0], b)
    starts[:, 3] = rng.integers(0, data.shape[0], b)
    starts[:, 4] = diskann_engine.medoid
    starts[-1] = -1
    jres, tres = _both(diskann_engine._adj_np, data, queries, starts,
                       beam_width=12, k=5, max_iters=6, hop_backend=hop_backend)
    _compare(jres, tres)
    assert not tres.converged[:-1].all()
    assert (tres.ids[-1] == -1).all() and tres.hops[-1] == 0


def test_random_graph_with_holes_matches_jax():
    rng = np.random.default_rng(3)
    n, d, b = 300, 16, 8
    vec = rng.normal(size=(n, d)).astype(np.float32)
    adj = rng.integers(0, n, size=(n, 8)).astype(np.int32)
    adj[rng.random((n, 8)) < 0.2] = -1
    q = rng.normal(size=(b, d)).astype(np.float32)
    starts = np.full((b, 3), -1, np.int32)
    starts[:, 1] = rng.integers(0, n, size=b)
    starts[:, 2] = rng.integers(0, n, size=b)
    jres, tres = _both(adj, vec, q, starts, beam_width=12, k=5, max_iters=40,
                       record_scored=True)
    _compare(jres, tres)


def test_fused_and_unfused_bit_identical_in_port(corpus, queries,
                                                 diskann_engine):
    adj = torch.as_tensor(diskann_engine._adj_np)
    vec = torch.as_tensor(corpus[0])
    q = torch.as_tensor(queries)
    starts = torch.full((q.shape[0], 1), diskann_engine.medoid,
                        dtype=torch.int32)
    res = [tbs.beam_search_l2(adj, vec, q, starts,
                              tbs.SearchSpec(16, 10, 80, hop_backend=hb))
           for hb in ("unfused", "fused")]
    for fld in INT_FIELDS + ["dists"]:
        assert torch.equal(getattr(res[0], fld), getattr(res[1], fld)), fld


def test_result_mask_matches_jax(corpus, queries, diskann_engine):
    """Tombstoned nodes stay traversable but leave the results."""
    data = corpus[0]
    adj = diskann_engine._adj_np
    starts = np.full((queries.shape[0], 1), diskann_engine.medoid, np.int32)
    tomb = np.zeros(data.shape[0], bool)
    tomb[::7] = True
    spec = dict(beam_width=16, k=10, max_iters=80)
    jt = jnp.asarray(tomb)
    jres = jbs.beam_search(
        jnp.asarray(adj), jnp.asarray(queries), jnp.asarray(starts),
        jbs.SearchSpec(**spec), jbs.l2_dist_fn(jnp.asarray(data)),
        result_mask_fn=lambda ids: ~jt[jnp.maximum(ids, 0)])
    tt = torch.as_tensor(tomb)
    tres = tbs.beam_search(
        torch.as_tensor(adj), torch.as_tensor(queries),
        torch.as_tensor(starts), tbs.SearchSpec(**spec),
        tbs.l2_dist_fn(torch.as_tensor(data)),
        result_mask_fn=lambda ids: ~tt[ids.clamp(min=0).long()])
    _compare(jres, tres)
    found = tres.ids.numpy()
    assert not tomb[found[found >= 0]].any()


def test_merge_matches_jax_merge():
    """``_merge`` batched against the reference's per-lane ``_merge``."""
    import jax
    rng = np.random.default_rng(9)
    b, l, c, n = 12, 8, 10, 30
    cand = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    cand_d = np.where(cand < 0, np.inf,
                      rng.integers(0, 4, (b, c)).astype(np.float32))
    bids = rng.integers(-1, n, size=(b, l)).astype(np.int32)
    bd = np.where(bids < 0, np.inf, rng.integers(0, 4, (b, l)))
    bd = bd.astype(np.float32)
    bexp = np.where(bids < 0, True, rng.random((b, l)) < 0.5)
    want = jax.vmap(jbs._merge)(*[jnp.asarray(a) for a in
                                  (bids, bd, bexp, cand, cand_d)])
    got = tbs._merge(*[torch.as_tensor(a) for a in
                       (bids, bd, bexp, cand, cand_d)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
