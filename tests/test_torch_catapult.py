"""repro_torch routing and build layers against the JAX package: LSH,
catapult buckets (serial-LRU publish, evictions), Algorithm 2 and the
Vamana build.

Bucket tables, used/won, ids, hops and ndists must be exactly equal;
distances agree to rtol 1e-6.  LSH state is transplanted (torch cannot
replay jax.random).  The Vamana build must agree on >= 99% of adjacency
rows as sets and on recall within 1 point.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import VPARAMS
from repro.core import buckets as jbk
from repro.core import catapult as jcat
from repro.core import engine as jeng
from repro.core import lsh as jlsh
from repro.core import vamana as jvam
from repro_torch import convert
from repro_torch.core import buckets as tbk
from repro_torch.core import catapult as tcat
from repro_torch.core import engine as teng
from repro_torch.core import lsh as tlsh
from repro_torch.core import vamana as tvam

jbs = importlib.import_module("repro.core.beam_search")
tbs = importlib.import_module("repro_torch.core.beam_search")


def _assert_buckets_equal(tstate, jstate):
    want = jbk.to_arrays(jstate)
    got = tbk.to_arrays(tstate)
    for name in ("ids", "stamp", "tag", "step"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert got[name].dtype == want[name].dtype, name


def _colliding_stream(rng, b, n_buckets, n_ids):
    """Few hot buckets, repeated destinations, -1 lanes, mixed tags."""
    h = rng.integers(0, n_buckets, b).astype(np.int32)
    d = rng.integers(-1, n_ids, b).astype(np.int32)
    d[::5] = d[0]                                  # repeats
    t = rng.choice(np.array([-1, -1, 0, 1], np.int32), b)
    return h, d, t


@pytest.mark.parametrize("n_buckets,cap,b", [(4, 3, 40), (16, 8, 200),
                                             (2, 40, 300)])
def test_publish_matches_jax(n_buckets, cap, b):
    rng = np.random.default_rng(n_buckets + cap)
    js = jbk.make_buckets(n_buckets, cap)
    ts = tbk.make_buckets(n_buckets, cap, device="cpu")
    for _ in range(3):
        h, d, t = _colliding_stream(rng, b, n_buckets, 3 * cap)
        js = jbk.publish(js, jnp.asarray(h), jnp.asarray(d), jnp.asarray(t))
        ts = tbk.publish(ts, torch.as_tensor(h), torch.as_tensor(d),
                         torch.as_tensor(t))
        _assert_buckets_equal(ts, js)
        jl = jbk.lookup(js, jnp.asarray(h))
        tl = tbk.lookup(ts, torch.as_tensor(h))
        for g, w in zip(tl, jl):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("how", ["ids", "buckets", "stale", "where"])
def test_evictions_match_jax(how):
    rng = np.random.default_rng(1)
    js, ts = jbk.make_buckets(8, 6), tbk.make_buckets(8, 6, device="cpu")
    h, d, t = _colliding_stream(rng, 120, 8, 30)
    js = jbk.publish(js, jnp.asarray(h), jnp.asarray(d), jnp.asarray(t))
    ts = tbk.publish(ts, torch.as_tensor(h), torch.as_tensor(d),
                     torch.as_tensor(t))
    if how == "ids":
        dead = np.array([d[0], 3, 7, 29], np.int32)
        js, ts = jbk.evict_ids(js, jnp.asarray(dead)), tbk.evict_ids(ts, dead)
    elif how == "buckets":
        mask = np.arange(8) % 3 == 0
        js = jbk.evict_buckets(js, jnp.asarray(mask))
        ts = tbk.evict_buckets(ts, mask)
    elif how == "stale":
        js, ts = jbk.evict_stale(js, 25), tbk.evict_stale(ts, 25)
    else:
        mask = rng.random((8, 6)) < 0.4
        js = jbk.evict_where(js, jnp.asarray(mask))
        ts = tbk.evict_where(ts, torch.as_tensor(mask))
    _assert_buckets_equal(ts, js)


def test_bucket_arrays_round_trip_from_the_reference():
    rng = np.random.default_rng(2)
    js = jbk.make_buckets(4, 5)
    h, d, t = _colliding_stream(rng, 30, 4, 12)
    js = jbk.publish(js, jnp.asarray(h), jnp.asarray(d), jnp.asarray(t))
    ts = tbk.from_arrays(jbk.to_arrays(js), device="cpu")
    _assert_buckets_equal(ts, js)
    back = jbk.from_arrays(tbk.to_arrays(ts))
    _assert_buckets_equal(ts, back)


def test_hash_codes_match_jax_with_transplanted_planes(corpus, queries):
    jp = jlsh.make_lsh(jax.random.PRNGKey(0), 8, queries.shape[1])
    planes = np.asarray(jp.hyperplanes)
    tp = tlsh.LSHParams(hyperplanes=torch.tensor(planes))
    q = np.concatenate([queries, corpus[0][:200]])
    want = np.asarray(jlsh.hash_codes(jp, jnp.asarray(q)))
    got = tlsh.hash_codes(tp, torch.as_tensor(q)).numpy()
    proj = q.astype(np.float64) @ planes.astype(np.float64).T
    scale = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(planes, axis=1)
    ok = ~(np.abs(proj) <= 1e-5 * scale).any(1)
    np.testing.assert_array_equal(got[ok], want[ok])
    bits = tlsh.hash_bits(tp, torch.as_tensor(q))
    np.testing.assert_array_equal(tlsh.pack_bits(bits).numpy()[ok], want[ok])


def test_make_lsh_is_deterministic_per_seed():
    a = tlsh.make_lsh(torch.Generator().manual_seed(3), 8, 16, device="cpu")
    b = tlsh.make_lsh(torch.Generator().manual_seed(3), 8, 16, device="cpu")
    assert torch.equal(a.hyperplanes, b.hyperplanes)
    assert a.n_bits == 8 and a.n_buckets == 256


@pytest.mark.parametrize("hop_backend", ["unfused", "fused"])
def test_catapulted_lookup_matches_jax(corpus, queries, diskann_engine,
                                       hop_backend):
    """Three batches through Algorithm 2 in both packages from the same
    transplanted state; a publish mask masks a third of the last batch."""
    data = corpus[0]
    adj, med = diskann_engine._adj_np, diskann_engine.medoid
    jstate = jcat.make_catapult_state(jax.random.PRNGKey(0), data.shape[1],
                                      n_bits=4, capacity=6)
    tstate = convert.catapult_state_from_numpy(
        np.asarray(jstate.lsh.hyperplanes), jbk.to_arrays(jstate.buckets),
        device="cpu")
    jspec = jbs.SearchSpec(beam_width=16, k=10, max_iters=80,
                           hop_backend=hop_backend)
    tspec = tbs.SearchSpec(beam_width=16, k=10, max_iters=80,
                           hop_backend=hop_backend)
    jdist = jeng._mk_dist(jnp.asarray(data), 0, None, None, hop_backend)
    tdist = teng._mk_dist(torch.as_tensor(data), hop_backend)
    rng = np.random.default_rng(4)
    for i in range(3):
        q = queries + 0.05 * i * rng.normal(size=queries.shape).astype(
            np.float32)
        pm = None if i < 2 else (np.arange(q.shape[0]) % 3 != 0)
        jstate, jres, jst = jcat.catapulted_lookup(
            jstate, jnp.asarray(adj), jnp.asarray(q), jspec, jdist,
            jnp.int32(med),
            publish_mask=None if pm is None else jnp.asarray(pm))
        tstate, tres, tst = tcat.catapulted_lookup(
            tstate, torch.as_tensor(adj), torch.as_tensor(q), tspec, tdist,
            med, publish_mask=None if pm is None else torch.as_tensor(pm))
        for fld in ("ids", "hops", "ndists", "trace"):
            np.testing.assert_array_equal(getattr(tres, fld).numpy(),
                                          np.asarray(getattr(jres, fld)),
                                          err_msg=fld)
        np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists),
                                   rtol=1e-6)
        for fld in ("used", "won"):
            np.testing.assert_array_equal(getattr(tst, fld).numpy(),
                                          np.asarray(getattr(jst, fld)),
                                          err_msg=fld)
        _assert_buckets_equal(tstate.buckets, jstate.buckets)
    assert tst.used.any() and tst.won.any()


def test_catapulted_lookup_rejects_filters():
    """A destination whose label fails a filtered lane's predicate never
    starts that lane, which falls back to its label's entry point;
    unfiltered lanes take every destination and the medoid."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(40, 4)).astype(np.float32)
    labels = (np.arange(40) % 2).astype(np.int32)
    state = tcat.make_catapult_state(torch.Generator().manual_seed(0), 4,
                                     n_bits=1, capacity=3, device="cpu")
    on1 = np.array([1, 3, 5], np.int32)
    arrays = tbk.to_arrays(state.buckets)
    arrays["ids"][:] = on1
    arrays["stamp"][:] = np.arange(3)
    state = tcat.CatapultState(lsh=state.lsh,
                               buckets=tbk.from_arrays(arrays, device="cpu"))
    entries = torch.tensor([10, 11], dtype=torch.int32)
    fl = torch.tensor([0, 1, -1], dtype=torch.int32)
    _, res, st = tcat.catapulted_lookup(
        state, torch.full((40, 2), -1, dtype=torch.int32),
        torch.as_tensor(data[:3]), tbs.SearchSpec(4, 4, 4),
        tbs.l2_dist_fn(torch.as_tensor(data)), 7, filter_labels=fl,
        node_labels=torch.as_tensor(labels), label_entry=entries)
    assert st.used.tolist() == [False, True, True]
    # no edges: each lane's beam holds exactly its valid starts
    starts = [set(r) - {-1} for r in res.ids.tolist()]
    assert starts == [{10}, {1, 3, 5, 11}, {1, 3, 5, 7}]


@pytest.mark.parametrize("p", [0, 17, 401, 1499])
def test_robust_prune_matches_jax_package(corpus, p):
    data = corpus[0]
    rng = np.random.default_rng(p)
    cand = rng.integers(-1, data.shape[0], 120).astype(np.int32)
    cand[:5] = p                                      # self and repeats
    for alpha in (1.0, 1.2):
        np.testing.assert_array_equal(
            tvam.robust_prune(p, cand, data, alpha, 16),
            jvam.robust_prune(p, cand, data, alpha, 16))


def test_init_graph_and_medoid_match(corpus):
    data = corpus[0]
    np.testing.assert_array_equal(
        tvam._random_regular_init(300, 8, np.random.default_rng(0)),
        jvam._random_regular_init(300, 8, np.random.default_rng(0)))
    assert tvam.medoid_index(data) == jvam.medoid_index(data)


def test_build_vamana_matches_jax(corpus, queries, ground_truth,
                                  diskann_engine):
    data = corpus[0]
    params = tvam.VamanaParams(max_degree=VPARAMS.max_degree,
                               build_beam=VPARAMS.build_beam,
                               batch=VPARAMS.batch, seed=VPARAMS.seed)
    adj, med = tvam.build_vamana(data, params, device="cpu")
    jadj = diskann_engine._adj_np
    assert med == diskann_engine.medoid
    same = np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                    for a, b in zip(adj, jadj)])
    assert same >= 0.99, same
    eng = teng.VectorSearchEngine(mode="diskann", device="cpu").build(
        data, prebuilt=(adj, med))
    t_ids, _, _ = eng.search(queries, k=10)
    j_ids, _, _ = diskann_engine.search(queries, k=10)
    t_rec = teng.recall_at_k(t_ids, ground_truth)
    j_rec = jeng.recall_at_k(j_ids, ground_truth)
    assert abs(t_rec - j_rec) <= 0.01, (t_rec, j_rec)
