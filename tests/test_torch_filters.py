"""repro_torch filtered search (paper §3.4) against the JAX package on the
CPU: the FilteredVamana host code, the masked beam search, filtered
Algorithm 2 and the filtered engine in every mode.

Inputs: ``tests/test_filters_insert.py``'s labeled corpus (1,200 x 16, 4
labels, degree 16).  The reference's stitched graph, label entries, LSH
planes, bucket tables and PQ codebook are transplanted.  Integers must be
exactly equal (ids, hops, ndists, trace, scored, used, won, bucket
tables, adjacency, label entries); distances agree to rtol 1e-6.  With
PQ, a lane's ids may differ only through a near-tie of ADC sums (the
rule of ``tests/test_torch_pq.py``).
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro import db as jdb
from repro.core import buckets as jbk
from repro.core import catapult as jcat
from repro.core import engine as jeng
from repro.core import filters as jflt
from repro.core import vamana as jvam
from repro.data import workloads as jwl
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.core import buckets as tbk
from repro_torch.core import catapult as tcat
from repro_torch.core import engine as teng
from repro_torch.core import filters as tflt
from repro_torch.core import vamana as tvam
from repro_torch.core.engine import brute_force_knn, recall_at_k
from repro_torch.data import workloads as twl
from test_torch_beam_search import _compare

jbs = importlib.import_module("repro.core.beam_search")
tbs = importlib.import_module("repro_torch.core.beam_search")

N_LABELS = 4
SPEC = dict(degree=16, build_beam=32, n_bits=4, bucket_capacity=8)
JVP = jvam.VamanaParams(max_degree=16, build_beam=32, batch=512)
TVP = tvam.VamanaParams(max_degree=16, build_beam=32, batch=512)


@pytest.fixture(scope="module")
def labeled():
    data, _, assign = make_clustered(1200, 16, 8, seed=21)
    return data, (assign % N_LABELS).astype(np.int32)


@pytest.fixture(scope="module")
def ref_builds():
    """The reference's Vamana builds, memoized by their inputs, so that the
    port's stitching can be fed the very subgraphs the reference got."""
    memo = {}

    def build(vectors, params, capacity=None, device=None):
        key = (vectors.tobytes(), params.max_degree, params.build_beam,
               params.seed)
        if key not in memo:
            memo[key] = jvam.build_vamana(vectors, jvam.VamanaParams(
                max_degree=params.max_degree, alpha=params.alpha,
                build_beam=params.build_beam, batch=params.batch,
                seed=params.seed))
        adj, med = memo[key]
        return adj.copy(), med

    return build


@pytest.fixture(scope="module")
def stitched(labeled, ref_builds):
    """The reference's stitched graph: (adjacency, medoid, entries)."""
    data, labels = labeled
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jflt, "build_vamana", ref_builds)
        return jflt.build_stitched_graph(data, labels, N_LABELS, JVP)


def _queries(labeled, n=48, seed=5):
    """Queries near corpus rows, each with its row's label; every fourth
    lane unfiltered (-1)."""
    data, labels = labeled
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, data.shape[0], n)
    q = (data[idx] + 0.1 * rng.normal(size=(n, data.shape[1]))).astype(
        np.float32)
    fl = labels[idx].astype(np.int32)
    fl[::4] = -1
    return q, fl


def _assert_on_label(ids, fl, labels):
    valid = (ids >= 0) & (fl[:, None] >= 0)
    got = labels[np.maximum(ids, 0)]
    assert (got[valid] == np.broadcast_to(fl[:, None], ids.shape)[valid]).all()


def test_make_papers_matches_reference():
    want = jwl.make_papers(n=3000, n_queries=64)
    got = twl.make_papers(n=3000, n_queries=64)
    for fld in ("corpus", "queries", "labels", "filter_labels"):
        np.testing.assert_array_equal(getattr(got, fld), getattr(want, fld))
        assert getattr(got, fld).dtype == getattr(want, fld).dtype
    assert got.name == want.name == "papers"


def test_label_entry_points_match_jax(labeled):
    data, labels = labeled
    skewed = labels.copy()
    skewed[skewed == 3] = 1                  # label 3 left with no rows
    for lbl in (labels, skewed):
        np.testing.assert_array_equal(
            tflt.label_entry_points(data, lbl, N_LABELS + 1),
            jflt.label_entry_points(data, lbl, N_LABELS + 1))


def test_build_stitched_graph_matches_jax(labeled, stitched, ref_builds,
                                          monkeypatch):
    """The stitching itself, fed the reference's own Vamana builds."""
    data, labels = labeled
    monkeypatch.setattr(tflt, "build_vamana", ref_builds)
    adj, med, entries = tflt.build_stitched_graph(data, labels, N_LABELS, TVP,
                                                  device="cpu")
    np.testing.assert_array_equal(adj, stitched[0])
    assert med == stitched[1]
    np.testing.assert_array_equal(entries, stitched[2])
    assert adj.dtype == np.int32 and adj.shape == (data.shape[0], 16 + 8)


def test_build_stitched_graph_on_the_port_builds(labeled, stitched):
    """The whole build on the port's own Vamana: rows as sets as in
    ``test_build_vamana_matches_jax``, entries and medoid exactly."""
    data, labels = labeled
    adj, med, entries = tflt.build_stitched_graph(data, labels, N_LABELS, TVP,
                                                  device="cpu")
    same = np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                    for a, b in zip(adj, stitched[0])])
    assert same >= 0.99, same
    assert med == stitched[1]
    np.testing.assert_array_equal(entries, stitched[2])


def test_refresh_label_entries_matches_jax(labeled, stitched):
    data, labels = labeled
    entries = stitched[2]
    rng = np.random.default_rng(3)
    n = data.shape[0]
    tomb = rng.random(n + 40) < 0.2
    tomb[entries[:2]] = True                 # two entries die
    tomb[:n][labels == 3] = True             # and a whole label
    tomb[n:] = True
    got = tflt.refresh_label_entries(entries, data, labels, tomb, n)
    want = jflt.refresh_label_entries(entries, data, labels, tomb, n)
    np.testing.assert_array_equal(got, want)
    assert got[3] == 0 and not tomb[got[:3]].any()


@pytest.mark.parametrize("hop_backend", ["unfused", "fused"])
def test_masked_beam_search_matches_jax(labeled, stitched, hop_backend):
    """The predicate mask on the init and every hop; it keeps the fused
    backend on the composed hop, so both give the reference's results."""
    data, labels = labeled
    adj, med, entries = stitched
    q, fl = _queries(labeled)
    starts = np.where(fl >= 0, entries[np.maximum(fl, 0)], med)[:, None]
    starts = np.concatenate([starts, np.full_like(starts, -1),
                             np.roll(starts, 1, 0)], 1).astype(np.int32)
    spec = dict(beam_width=12, k=8, max_iters=60, record_scored=True,
                hop_backend=hop_backend)
    jres = jbs.beam_search(
        jnp.asarray(adj), jnp.asarray(q), jnp.asarray(starts),
        jbs.SearchSpec(**spec),
        jeng._mk_dist(jnp.asarray(data), 0, None, None, hop_backend),
        neighbor_mask_fn=jflt.make_filter_mask_fn(jnp.asarray(labels),
                                                  jnp.asarray(fl)))
    tres = tbs.beam_search(
        torch.as_tensor(adj), torch.as_tensor(q), torch.as_tensor(starts),
        tbs.SearchSpec(**spec),
        teng._mk_dist(torch.as_tensor(data), hop_backend),
        neighbor_mask_fn=tflt.make_filter_mask_fn(torch.as_tensor(labels),
                                                  torch.as_tensor(fl)))
    _compare(jres, tres)
    _assert_on_label(tres.ids.numpy(), fl, labels)


def test_filter_mask_form_reads_no_masked_row(labeled):
    """The distance call sees a masked neighbour as -1: no row of a node
    that fails the predicate is read."""
    data, labels = labeled
    seen = []
    base = tbs.l2_dist_fn(torch.as_tensor(data))

    def dist(queries, ids):
        seen.append(ids.clone())
        return base(queries, ids)

    q, fl = _queries(labeled, n=8)
    fl[:] = 2
    adj = np.random.default_rng(0).integers(
        0, data.shape[0], (data.shape[0], 8)).astype(np.int32)
    start = int(np.nonzero(labels == 2)[0][0])
    tbs.beam_search(torch.as_tensor(adj), torch.as_tensor(q),
                    torch.full((8, 2), start, dtype=torch.int32),
                    tbs.SearchSpec(8, 4, 10), dist,
                    neighbor_mask_fn=tflt.make_filter_mask_fn(
                        torch.as_tensor(labels), torch.as_tensor(fl)))
    ids = torch.cat([s.reshape(-1) for s in seen[1:]]).numpy()
    assert (labels[ids[ids >= 0]] == 2).all() and (ids >= 0).any()
    assert (ids < 0).sum() > (ids >= 0).sum() / 2   # most were masked


@pytest.mark.parametrize("hop_backend", ["unfused", "fused"])
def test_filtered_catapulted_lookup_matches_jax(labeled, stitched,
                                                hop_backend):
    """Two batches of filtered Algorithm 2 from one transplanted state:
    destinations vetted per lane, per-label fallbacks, tags published."""
    data, labels = labeled
    adj, med, entries = stitched
    jstate = jcat.make_catapult_state(jax.random.PRNGKey(1), data.shape[1],
                                      n_bits=3, capacity=6)
    tstate = convert.catapult_state_from_numpy(
        np.asarray(jstate.lsh.hyperplanes), jbk.to_arrays(jstate.buckets),
        device="cpu")
    spec = dict(beam_width=12, k=8, max_iters=60, hop_backend=hop_backend)
    jl, tl = jnp.asarray(labels), torch.as_tensor(labels)
    jdist = jeng._mk_dist(jnp.asarray(data), 0, None, None, hop_backend)
    tdist = teng._mk_dist(torch.as_tensor(data), hop_backend)
    q, fl = _queries(labeled)
    rng = np.random.default_rng(8)
    for rnd in range(2):
        if rnd:     # the same neighbourhoods under other predicates
            fl = np.where(fl >= 0, (fl + 1) % N_LABELS, -1).astype(np.int32)
            q = q + 0.02 * rng.normal(size=q.shape).astype(np.float32)
        jstate, jres, jst = jcat.catapulted_lookup(
            jstate, jnp.asarray(adj), jnp.asarray(q), jbs.SearchSpec(**spec),
            jdist, jnp.int32(med), filter_labels=jnp.asarray(fl),
            node_labels=jl, label_entry=jnp.asarray(entries),
            neighbor_mask_fn=jflt.make_filter_mask_fn(jl, jnp.asarray(fl)))
        tstate, tres, tst = tcat.catapulted_lookup(
            tstate, torch.as_tensor(adj), torch.as_tensor(q),
            tbs.SearchSpec(**spec), tdist, med,
            filter_labels=torch.as_tensor(fl), node_labels=tl,
            label_entry=torch.as_tensor(entries),
            neighbor_mask_fn=tflt.make_filter_mask_fn(tl,
                                                      torch.as_tensor(fl)))
        _compare(jres, tres)
        for fld in ("used", "won"):
            np.testing.assert_array_equal(getattr(tst, fld).numpy(),
                                          np.asarray(getattr(jst, fld)),
                                          err_msg=f"{fld} round {rnd}")
        want, got = jbk.to_arrays(jstate.buckets), tbk.to_arrays(
            tstate.buckets)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
        _assert_on_label(tres.ids.numpy(), fl, labels)
    # the second round's filtered lanes found the first round's
    # destinations of another label and dropped them
    assert tst.used[fl < 0].any() and not tst.used.all()


def _filtered_twins(labeled, stitched, mode, hop_backend="unfused", pq=None):
    data, labels = labeled
    kw = dict(mode=mode, hop_backend=hop_backend, pq=pq, filters=True,
              **SPEC)
    ref = jdb.create(jdb.IndexSpec(**kw), data, labels, prebuilt=stitched)
    port = tdb.create(tdb.IndexSpec(**kw), data, labels, prebuilt=stitched,
                      device="cpu")
    eng = port.backend
    if pq:
        eng._init_aux(data, pq_codebook=convert.pq_codebook_from_numpy(
            np.asarray(ref.backend._pq.centroids), device="cpu"))
        eng._sync_device()
    if mode == "catapult":
        cat = ref.backend._cat
        eng._cat = convert.catapult_state_from_numpy(
            np.asarray(cat.lsh.hyperplanes), jbk.to_arrays(cat.buckets),
            device="cpu")
    return ref, port


def _assert_results_equal(p, r, pq, truth=None):
    for fld in ("hops", "ndists", "used", "won"):
        np.testing.assert_array_equal(getattr(p.stats, fld),
                                      getattr(r.stats, fld), err_msg=fld)
    fin = np.isfinite(r.dists)
    np.testing.assert_array_equal(np.isfinite(p.dists), fin)
    np.testing.assert_allclose(p.dists[fin], r.dists[fin], rtol=1e-6)
    if not pq:
        np.testing.assert_array_equal(p.ids, r.ids)
        return
    same = (p.ids == r.ids).all(1)
    if not same.all():     # a near-tie of ADC sums: hold recall@k
        assert abs(recall_at_k(p.ids, truth) - recall_at_k(r.ids, truth)) \
            <= 0.01
    assert same.mean() >= 0.95


@pytest.mark.parametrize("mode,hop_backend,pq", [
    ("catapult", "unfused", None), ("catapult", "fused", None),
    ("diskann", "unfused", None), ("catapult", "unfused", 4),
    ("diskann", "fused", 4)])
def test_filtered_engine_matches_jax(labeled, stitched, mode, hop_backend,
                                     pq):
    """``create(IndexSpec(filters=True), vectors, labels)`` in both modes,
    replayed twice, against the reference's: results, stats, bucket
    tables."""
    data, labels = labeled
    ref, port = _filtered_twins(labeled, stitched, mode, hop_backend, pq)
    assert port.caps.filtered and port.n_labels == N_LABELS
    q, fl = _queries(labeled, n=64, seed=6)
    truth = brute_force_knn(data, q, 5, labels=labels, filter_labels=fl)
    for rnd in range(2):
        for lo in (0, 32):
            sl = slice(lo, lo + 32)
            r = ref.search(q[sl], k=5, beam_width=16, filter_labels=fl[sl])
            p = port.search(q[sl], k=5, beam_width=16, filter_labels=fl[sl])
            _assert_results_equal(p, r, pq, truth[sl])
            _assert_on_label(p.ids, fl[sl], labels)
            if mode == "catapult":
                want = jbk.to_arrays(ref.backend._cat.buckets)
                got = tbk.to_arrays(port.backend._cat.buckets)
                for name in want:
                    np.testing.assert_array_equal(got[name], want[name])
    if mode == "catapult":
        assert p.stats.used.any()
    tr = port.search(q[:8], k=5, filter_labels=fl[:8], explain=True,
                     publish=False)
    assert set(tr.entry) <= {"catapult", "label_entry", "medoid"}
    assert tr.entry[0] in ("catapult", "medoid")     # lane 0 is unfiltered


def test_filtered_recall_and_predicate_on_the_port(labeled):
    """The whole filtered build on the port, as the reference's own
    ``test_filtered_recall_reasonable`` holds it."""
    data, labels = labeled
    d = tdb.create(tdb.IndexSpec(degree=16, build_beam=32, filters=True),
                   data, labels, device="cpu")
    q, fl = _queries(labeled, n=64, seed=6)
    fl = np.abs(fl)
    truth = brute_force_knn(data, q, 5, labels=labels, filter_labels=fl)
    for _ in range(2):
        ids, _, _ = d.search(q, k=5, beam_width=16, filter_labels=fl)
    _assert_on_label(ids, fl, labels)
    assert recall_at_k(ids, truth) > 0.85


def test_filter_spec_rules_match_reference(labeled):
    data, labels = labeled
    for kw, lab in ((dict(filters=True), None), (dict(), labels)):
        with pytest.raises(ValueError, match="labels"):
            tdb.create(tdb.IndexSpec(**kw, **SPEC), data, lab, device="cpu")
    d = tdb.create(tdb.IndexSpec(mode="diskann", **SPEC), data[:300],
                   device="cpu")
    with pytest.raises(tdb.CapabilityError):
        d.search(data[:2], filter_labels=np.zeros(2, np.int32))
