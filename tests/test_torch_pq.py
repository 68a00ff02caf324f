"""repro_torch PQ traversal against the JAX package on the CPU.

The codebook (and in the facade tests the graph and the catapult state)
is transplanted from the reference: torch cannot replay
``jax.random.choice``.  Then:

* integers exactly equal — codes, ids, hops, ndists, used, won, fresh
  counts, expanded flags;
* distances (LUTs, ADC sums, rerank) rtol 1e-6: XLA and torch may add
  the few terms in another order;
* centroids after the Lloyd iterations rtol 1e-6 with atol 1e-6 of the
  largest component: the port scatters each cluster's points into its
  sum (``index_add_``) where the reference multiplies by a one-hot
  matrix, so the points are added in another order;
* ``l2_distance`` rtol/atol 1e-4 (tests/test_kernels.py's tolerance):
  the Pallas kernel computes the expanded form, the plain version the
  direct one.

Where a near-tie could let one ulp reorder results, the lane is
compared by recall@10 within 1 point instead.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import db as jdb
from repro.core import buckets as jbk
from repro.core import pq as jpq
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.core import pq as tpq
from repro_torch.core.engine import recall_at_k
from repro_torch.kernels import ops
from test_torch_kernels import _assert_dists, _hop_state, _t

M = 4
SPEC = dict(degree=16, build_beam=32, n_bits=4, bucket_capacity=8)


@pytest.fixture(scope="module")
def ref_cb(corpus):
    """The reference's codebook of the SMALL corpus (M=4, K=256)."""
    return jpq.train_pq(jax.random.PRNGKey(0), jnp.asarray(corpus[0]), M)


@pytest.fixture(scope="module")
def port_cb(ref_cb):
    return convert.pq_codebook_from_numpy(np.asarray(ref_cb.centroids),
                                          device="cpu")


def _near_tied(d2, rtol=1e-6):
    """(..., K) distances -> (...) bool: the two smallest within rtol."""
    two = np.sort(d2, axis=-1)[..., :2]
    return two[..., 1] - two[..., 0] <= rtol * np.abs(two[..., 1])


def test_lloyd_matches_jax_from_the_reference_init(corpus):
    x = corpus[0]
    n = x.shape[0]
    key = jax.random.PRNGKey(3)
    want = jpq.train_pq(key, jnp.asarray(x), M)
    # the reference's own initial draw (repro/core/pq.py train_pq)
    init = np.asarray(jax.random.choice(key, n, (M, 256), replace=True))
    c0 = x.reshape(n, M, -1)[init, np.arange(M)[:, None]]
    got = tpq.lloyd(torch.as_tensor(x), torch.as_tensor(c0), iters=8)
    w = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), w, rtol=1e-6,
                               atol=1e-6 * np.abs(w).max())
    np.testing.assert_array_equal(
        tpq.encode(got, torch.as_tensor(x)).numpy(),
        np.asarray(jpq.encode(want, jnp.asarray(x))))


def test_train_pq_is_deterministic_in_its_seed(corpus):
    x = corpus[0]
    cbs = [tpq.train_pq(torch.Generator().manual_seed(s), x, M,
                        device="cpu") for s in (5, 5, 6)]
    assert cbs[0].centroids.shape == (M, 256, 4)
    assert torch.equal(cbs[0].centroids, cbs[1].centroids)
    assert not torch.equal(cbs[0].centroids, cbs[2].centroids)
    codes = tpq.encode(cbs[0], torch.as_tensor(x))
    assert codes.dtype == torch.int32 and codes.shape == (x.shape[0], M)
    assert int(codes.min()) >= 0 and int(codes.max()) < 256


def test_encode_matches_jax_except_near_ties(corpus, ref_cb, port_cb):
    x = corpus[0]
    got = tpq.encode(port_cb, torch.as_tensor(x)).numpy()
    want = np.asarray(jpq.encode(ref_cb, jnp.asarray(x)))
    cents = np.asarray(ref_cb.centroids)
    d2 = ((x.reshape(-1, M, 1, 4) - cents[None]) ** 2).sum(-1)
    ok = ~_near_tied(d2)
    np.testing.assert_array_equal(got[ok], want[ok])
    assert ok.mean() > 0.99


def test_query_luts_match_jax(queries, ref_cb, port_cb):
    want = np.stack([np.asarray(jpq.query_lut(ref_cb, jnp.asarray(q)))
                     for q in queries[:24]])
    got = tpq.query_luts(port_cb, torch.as_tensor(queries[:24]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        tpq.query_lut(port_cb, torch.as_tensor(queries[3])).numpy(),
        want[3], rtol=1e-6)


def test_adc_dist_fn_and_rerank_match_jax(corpus, queries, ref_cb, port_cb):
    x = corpus[0]
    rng = np.random.default_rng(11)
    codes = jpq.encode(ref_cb, jnp.asarray(x))
    ids = rng.integers(-1, x.shape[0], size=(24, 40)).astype(np.int32)
    ids[0] = -1
    q = queries[:24]
    want = np.asarray(jax.vmap(jpq.adc_dist_fn(ref_cb, codes))(
        jnp.asarray(q), jnp.asarray(ids)))
    got = tpq.adc_dist_fn(port_cb, torch.as_tensor(np.array(codes)))(
        *_t(q, ids))
    _assert_dists(got.numpy(), want)

    k = 10
    want_ids, want_d = jax.vmap(lambda qq, ii: jpq.rerank(
        jnp.asarray(x), qq, ii, k))(jnp.asarray(q), jnp.asarray(ids))
    got_ids, got_d = tpq.rerank(*_t(x, q, ids), k)
    _assert_dists(got_d.numpy(), np.asarray(want_d))
    full = np.sort(np.where(ids < 0, np.inf,
                            ((x[np.maximum(ids, 0)] - q[:, None]) ** 2
                             ).sum(-1)), axis=1)[:, : k + 1]
    with np.errstate(invalid="ignore"):              # inf - inf
        gaps = np.diff(full, axis=1)
    tie_free = ((gaps > 1e-6 * full[:, 1:]) | ~np.isfinite(full[:, 1:])).all(1)
    np.testing.assert_array_equal(got_ids.numpy()[tie_free],
                                  np.asarray(want_ids)[tie_free])
    assert got_ids.dtype == torch.int32 and (got_ids[0] == -1).all()


@pytest.mark.parametrize("c,all_invalid_lane", [(40, True), (1, False),
                                                 (64, False)])
def test_pq_adc_ids_form_matches_jax_adc_dist_fn(corpus, queries, ref_cb,
                                                 port_cb, c,
                                                 all_invalid_lane):
    """``ops.pq_adc(luts, table, ids)`` against the reference's composed
    ADC distance (``adc_dist_fn`` on the transplanted codebook, its codes
    and the same ids, -1 among them) to the tolerance of
    ``test_adc_dist_fn_and_rerank_match_jax``, and bit for bit against
    the table form over the gathered rows."""
    x = corpus[0]
    rng = np.random.default_rng(c)
    codes = jpq.encode(ref_cb, jnp.asarray(x))
    ids = rng.integers(-1, x.shape[0], size=(24, c)).astype(np.int32)
    if all_invalid_lane:
        ids[3] = -1
    q = queries[:24]
    want = np.asarray(jax.vmap(jpq.adc_dist_fn(ref_cb, codes))(
        jnp.asarray(q), jnp.asarray(ids)))
    table, tids = _t(np.array(codes), ids)
    luts = tpq.query_luts(port_cb, torch.as_tensor(q))
    got = ops.pq_adc(luts, table, tids)
    _assert_dists(got.numpy(), want)
    rows = table[tids.clamp(min=0).long()]
    assert torch.equal(got, torch.where(tids < 0, torch.inf,
                                        ops.pq_adc(luts, rows)))
    assert torch.isinf(got[tids < 0]).all() and got.dtype == torch.float32


@pytest.mark.parametrize("m,k,c", [(4, 8, 16), (8, 256, 77), (16, 64, 128)])
def test_pq_adc_plain_matches_jax(m, k, c):
    rng = np.random.default_rng(m + k + c)
    b = 3
    luts = (rng.normal(size=(b, m, k)) ** 2).astype(np.float32)
    codes = rng.integers(0, k, size=(b, c, m)).astype(np.int32)
    got = ops.pq_adc(*_t(luts, codes)).numpy()
    want = np.stack([np.asarray(jops.pq_adc(jnp.asarray(luts[i]),
                                            jnp.asarray(codes[i])))
                     for i in range(b)])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n,b,c,l,m,k", [(64, 1, 3, 5, 4, 8),
                                         (200, 6, 10, 8, 8, 16),
                                         (300, 12, 24, 12, 4, 32)])
def test_fused_hop_pq_plain_matches_jax(n, b, c, l, m, k):
    rng = np.random.default_rng(n + b)
    luts = (rng.normal(size=(b, m, k)) ** 2).astype(np.float32)
    codes = rng.integers(0, k, size=(n, m)).astype(np.int32)
    cand, bids, bd, bexp = _hop_state(rng, n, b, c, l)
    got = ops.fused_hop_pq(*_t(luts, codes, cand, bids, bd, bexp))
    want = jops.fused_hop_pq(*[jnp.asarray(a) for a in
                               (luts, codes, cand, bids, bd, bexp)])
    for name, g, w in zip(["ids", "dists", "exp", "nfresh"], got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "dists":
            _assert_dists(g, w)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_large_codebook_matches_jax():
    """M=64, K=256 at d=128: a 64 KB LUT a query, beyond the 48 KB of
    shared memory a block has on the card without the opt-in.  With the
    reference's codebook transplanted, codes, LUTs, ``pq_adc`` and the
    fused PQ hop are held to the JAX package (its kernels in Pallas
    interpret mode)."""
    rng = np.random.default_rng(21)
    n, d, m, b = 1500, 128, 64, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    cb = jpq.train_pq(jax.random.PRNGKey(1), jnp.asarray(x), m)
    port = convert.pq_codebook_from_numpy(np.asarray(cb.centroids),
                                          device="cpu")
    codes = np.asarray(jpq.encode(cb, jnp.asarray(x)))
    cents = np.asarray(cb.centroids)
    d2 = ((x.reshape(n, m, 1, d // m) - cents[None]) ** 2).sum(-1)
    ok = ~_near_tied(d2)
    np.testing.assert_array_equal(
        tpq.encode(port, torch.as_tensor(x)).numpy()[ok], codes[ok])
    assert ok.mean() > 0.99

    luts = np.stack([np.asarray(jpq.query_lut(cb, jnp.asarray(qq)))
                     for qq in q])
    assert luts.shape == (b, m, 256) and luts[0].nbytes > 48 * 1024
    np.testing.assert_allclose(
        tpq.query_luts(port, torch.as_tensor(q)).numpy(), luts, rtol=1e-6)

    cand, bids, _, _ = _hop_state(rng, n, b, 24, 10)
    rows = codes[np.maximum(cand, 0)]
    want = np.stack([np.asarray(jops.pq_adc(jnp.asarray(luts[i]),
                                            jnp.asarray(rows[i])))
                     for i in range(b)])
    np.testing.assert_allclose(ops.pq_adc(*_t(luts, rows)).numpy(), want,
                               rtol=1e-6)

    # a beam of true ADC distances, so candidates compete for its slots
    sub = np.arange(m)
    bd = luts[np.arange(b)[:, None, None], sub,
              codes[np.maximum(bids, 0)]].sum(-1)
    bd = np.where(bids < 0, np.inf, bd).astype(np.float32)
    order = np.argsort(bd, axis=1, kind="stable")
    bids, bd = (np.take_along_axis(bids, order, 1),
                np.take_along_axis(bd, order, 1))
    bexp = (bids < 0) | (rng.random(bids.shape) < 0.5)
    got = ops.fused_hop_pq(*_t(luts, codes, cand, bids, bd, bexp))
    want = jops.fused_hop_pq(*[jnp.asarray(a) for a in
                               (luts, codes, cand, bids, bd, bexp)])
    for name, g, w in zip(["ids", "dists", "exp", "nfresh"], got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "dists":
            _assert_dists(g, w)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert np.isfinite(got[1].numpy()).all()


@pytest.mark.parametrize("b,c,d", [(8, 8, 16), (37, 203, 64),
                                   (128, 256, 128), (1, 5, 768),
                                   (130, 127, 96)])
def test_l2_distance_plain_matches_jax(b, c, d):
    rng = np.random.default_rng(b + c + d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    x = rng.normal(size=(c, d)).astype(np.float32)
    got = ops.l2_distance(*_t(q, x)).numpy()
    want = np.asarray(jops.l2_distance(jnp.asarray(q), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got.shape == (b, c) and got.dtype == np.float32


def test_cpu_pq_wrappers_take_the_plain_path_without_counting():
    rng = np.random.default_rng(0)
    luts = (rng.normal(size=(3, 4, 8)) ** 2).astype(np.float32)
    codes = rng.integers(0, 8, size=(40, 4)).astype(np.int32)
    cand, bids, bd, bexp = _hop_state(rng, 40, 3, 5, 4)
    before = dict(ops.LAUNCHES)
    ops.pq_adc(*_t(luts, codes[cand.clip(0)]))
    ops.fused_hop_pq(*_t(luts, codes, cand, bids, bd, bexp))
    ops.l2_distance(*_t(rng.normal(size=(3, 8)).astype(np.float32),
                        rng.normal(size=(5, 8)).astype(np.float32)))
    assert ops.LAUNCHES == before


def test_cpu_pq_adc_ids_form_takes_the_plain_path_without_counting():
    rng = np.random.default_rng(1)
    luts = (rng.normal(size=(3, 4, 8)) ** 2).astype(np.float32)
    codes = rng.integers(0, 8, size=(40, 4)).astype(np.int32)
    cand = _hop_state(rng, 40, 3, 5, 4)[0]
    before = dict(ops.LAUNCHES)
    got = ops.pq_adc(*_t(luts, codes, cand))
    assert ops.LAUNCHES == before
    assert got.shape == (3, 5) and got.device.type == "cpu"


@pytest.mark.parametrize("case", ["codes_dtype", "codes_shape", "lut_dim",
                                  "beam_shape", "l2_dim", "ids_dtype",
                                  "ids_rank", "ids_lanes", "table_dtype",
                                  "table_subspaces", "table_empty"])
def test_pq_wrappers_reject_what_the_kernels_do_not_take(case):
    luts = torch.zeros((2, 4, 8))
    codes = torch.zeros((2, 3, 4), dtype=torch.int32)
    table = torch.zeros((10, 4), dtype=torch.int32)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    beam = (torch.zeros((2, 5), dtype=torch.int32), torch.zeros((2, 5)),
            torch.zeros((2, 5), dtype=torch.bool))
    err = TypeError if case in ("codes_dtype", "ids_dtype",
                                "table_dtype") else ValueError
    with pytest.raises(err):
        if case == "codes_dtype":
            ops.pq_adc(luts, codes.long())
        elif case == "codes_shape":
            ops.pq_adc(luts, torch.zeros((2, 3, 5), dtype=torch.int32))
        elif case == "lut_dim":
            ops.fused_hop_pq(luts, table[:, :3].contiguous(), ids, *beam)
        elif case == "beam_shape":
            ops.fused_hop_pq(luts, table, ids, beam[0][:, :4].contiguous(),
                             *beam[1:])
        elif case == "ids_dtype":
            ops.pq_adc(luts, table, ids.long())
        elif case == "ids_rank":
            ops.pq_adc(luts, table, ids[None])
        elif case == "ids_lanes":
            ops.pq_adc(luts, table, torch.zeros((3, 3), dtype=torch.int32))
        elif case == "table_dtype":
            ops.pq_adc(luts, table.float(), ids)
        elif case == "table_subspaces":
            ops.pq_adc(luts, table[:, :3].contiguous(), ids)
        elif case == "table_empty":
            ops.pq_adc(luts, table[:0], ids - 1)
        else:
            ops.l2_distance(torch.zeros((2, 8)), torch.zeros((3, 7)))


def _pq_twins(corpus, graph, mode, hop_backend):
    """Reference and port databases over one graph, with the port given
    the reference's codebook (and catapult state)."""
    ref = jdb.create(jdb.IndexSpec(mode=mode, hop_backend=hop_backend,
                                   pq=M, **SPEC), corpus[0], prebuilt=graph)
    port = tdb.create(tdb.IndexSpec(mode=mode, hop_backend=hop_backend,
                                    pq=M, **SPEC), corpus[0], prebuilt=graph,
                      device="cpu")
    eng = port.backend
    eng._init_aux(corpus[0], pq_codebook=convert.pq_codebook_from_numpy(
        np.asarray(ref.backend._pq.centroids), device="cpu"))
    eng._sync_device()
    if mode == "catapult":
        cat = ref.backend._cat
        eng._cat = convert.catapult_state_from_numpy(
            np.asarray(cat.lsh.hyperplanes), jbk.to_arrays(cat.buckets),
            device="cpu")
    np.testing.assert_array_equal(eng._codes_np, ref.backend._codes_np)
    return ref, port


@pytest.mark.parametrize("mode,hop_backend", [("catapult", "unfused"),
                                              ("catapult", "fused"),
                                              ("diskann", "unfused"),
                                              ("diskann", "fused")])
def test_pq_facade_matches_jax(corpus, queries, ground_truth, diskann_engine,
                               mode, hop_backend):
    graph = (diskann_engine._adj_np, diskann_engine.medoid)
    ref, port = _pq_twins(corpus, graph, mode, hop_backend)
    for rnd in range(2):
        for lo in (0, 32, 64):
            q = queries[lo: lo + 32]
            r, p = ref.search(q, k=10), port.search(q, k=10)
            for fld in ("hops", "ndists", "used", "won"):
                np.testing.assert_array_equal(getattr(p.stats, fld),
                                              getattr(r.stats, fld),
                                              err_msg=f"{fld} round {rnd}")
            _assert_dists(p.dists, r.dists)
            same = (p.ids == r.ids).all(1)
            # a lane may differ only through a near-tie; it then holds
            # recall@10 within 1 point of the reference's
            if not same.all():
                truth = ground_truth[lo: lo + 32]
                assert abs(recall_at_k(p.ids, truth)
                           - recall_at_k(r.ids, truth)) <= 0.01
            assert same.mean() >= 0.95
    if mode == "catapult":
        assert p.stats.used.all() and p.stats.won.any()
    assert p.ids.dtype == np.int32 and p.dists.dtype == np.float32


def test_pq_search_builds_luts_once_per_batch(corpus, queries,
                                              diskann_engine, monkeypatch):
    graph = (diskann_engine._adj_np, diskann_engine.medoid)
    port = tdb.create(tdb.IndexSpec(pq=M, **SPEC), corpus[0],
                      prebuilt=graph, device="cpu")
    calls = []
    real = tpq.query_luts
    monkeypatch.setattr(tpq, "query_luts",
                        lambda cb, q: calls.append(q.shape) or real(cb, q))
    for lo in (0, 16, 32):
        port.search(queries[lo: lo + 16], k=10)
    assert calls == [(16, 16)] * 3


def test_pq_explain_times_the_rerank(corpus, queries, diskann_engine):
    graph = (diskann_engine._adj_np, diskann_engine.medoid)
    port = tdb.create(tdb.IndexSpec(pq=M, **SPEC), corpus[0],
                      prebuilt=graph, device="cpu")
    tr = port.search(queries[:8], k=5, explain=True)
    assert tr.stage_ms("rerank") > 0 and tr.stage_ms("route") > 0
    assert tr.ids.shape == (8, 5)
