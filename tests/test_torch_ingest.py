"""Streaming ingest: ``repro_torch.ingest`` and the ingest half of
``repro_torch.db`` against the reference on the CPU.

Each reference test of ``tests/test_ingest.py`` has a twin here that runs
both packages on the same numpy inputs (the reference's world: 500 x 16,
cutover 128, capacity 200, batches of 64).  Integers are exactly equal:
external ids, ``ext2int``/``int2ext``, phases, cutovers, growths,
consolidations, ticket gids in caller order, keys, hops, ndists,
used/won and bucket tables; distances agree to rtol 1e-6.

Every cutover and generation rebuild is a Vamana build, and the two
packages' builds agree on >= 99% of rows only, so the RAM and disk
twins hook the port's ``factory._build_engine`` (in the test only): at
each build it takes, as ``prebuilt``, the graph the reference built at
the same step, and gets the reference's LSH planes (and, on the disk
tier, its PQ codebook), which the packages draw differently.  The
sharded and tiered tiers take no ``prebuilt``: their twins exchange
saved ingest-born databases between the packages in both directions
and continue the stream without a rebuild.  Every test closes what it
opens and writes under ``tmp_path``.

The twins are split over three files so that no file holds a worker for
long: this one (spec, bootstrap, RAM and disk streaming, keys, the
queue, metrics; its helpers are shared), ``test_torch_ingest_tiers.py``
(sharded streaming, caller-order gids on every tier) and
``test_torch_ingest_persist.py`` (save/open across the packages, the
serve/ingest interleave).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro import db as jdb
from repro.core import buckets as jbk
from repro.db import factory as jfactory
from repro.ingest import KeyMap as JKeyMap
from repro.ingest import locality_order as j_locality_order
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.core import brute_force_knn, recall_at_k
from repro_torch.core import buckets as tbk
from repro_torch.db import factory as tfactory
from repro_torch.ingest import (BootstrapEngine, IngestQueue, KeyMap,
                                locality_order)

D = 16
N = 500


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops while this
    module runs: alone it is as fast as the default, and beside other
    test workers on the same cores it neither spins nor is starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((128, D)).astype(np.float32)
    return corpus, queries, brute_force_knn(corpus, queries, 10)


def _spec(pkg, tier, path=None, **ingest_kw):
    kw = dict(bootstrap_cutover=128, initial_capacity=200, batch_size=64)
    kw.update(ingest_kw)
    return pkg.IndexSpec(tier=tier, mode="catapult", dim=D, degree=16,
                         build_beam=32, seed=0, path=path,
                         n_shards=3 if tier == "sharded" else 2,
                         ingest=pkg.IngestSpec(**kw))


def _rows_of(ids, gids, n):
    inv = np.full(int(gids.max()) + 1, -1, np.int64)
    inv[gids] = np.arange(n)
    ids = np.asarray(ids)
    return np.where(ids >= 0, inv[np.clip(ids, 0, inv.shape[0] - 1)], -1)


def _units(backend):
    inner = getattr(backend, "inner", backend)
    return list(getattr(inner, "shards", None) or [inner])


def _transplant(ref_eng, port_eng):
    """The reference's catapult planes and tables into the port's
    engine, unit by unit (shards, or a tiered engine's cold units)."""
    for js, ts in zip(_units(ref_eng), _units(port_eng)):
        ts._cat = convert.catapult_state_from_numpy(
            np.asarray(js._cat.lsh.hyperplanes),
            jbk.to_arrays(js._cat.buckets), device="cpu")


@pytest.fixture
def hooked(monkeypatch):
    """Route every port build through the reference's graph of the same
    step: the reference builds first (its ``_build_engine`` records the
    engine's graph, planes and codebook), then the port's build takes
    them.  Each test runs the two packages in lockstep, reference
    first."""
    built = []
    orig_ref, orig_port = jfactory._build_engine, tfactory._build_engine

    def ref_build(spec, vectors, labels, n_labels, prebuilt=None):
        eng = orig_ref(spec, vectors, labels, n_labels, prebuilt)
        built.append(dict(
            adj=np.array(eng._adj_np), medoid=int(eng.medoid),
            planes=np.asarray(eng._cat.lsh.hyperplanes),
            buckets=jbk.to_arrays(eng._cat.buckets),
            pq=(np.asarray(eng._pq.centroids) if eng.pq_subspaces
                else None)))
        return eng

    def port_build(spec, vectors, labels, n_labels, prebuilt=None, *,
                   device="cuda"):
        assert prebuilt is None and built, "a port build with no twin"
        ref = built.pop(0)
        eng = orig_port(spec, vectors, labels, n_labels,
                        (ref["adj"], ref["medoid"]), device=device)
        if ref["pq"] is not None:
            eng._init_aux(vectors, pq_codebook=convert.pq_codebook_from_numpy(
                ref["pq"], device="cpu"))
            eng._sync_device()
            eng.store.block_store.write_pq(ref["pq"])
        eng._cat = convert.catapult_state_from_numpy(
            ref["planes"], ref["buckets"], device="cpu")
        return eng

    monkeypatch.setattr(jfactory, "_build_engine", ref_build)
    monkeypatch.setattr(tfactory, "_build_engine", port_build)
    yield built
    assert not built, "a reference build with no port twin"


@pytest.fixture
def opened():
    dbs = []
    yield dbs
    for d in dbs:
        d.close()


def _twin_create(tier, tmp_path, opened, **ingest_kw):
    paths = [(str(tmp_path / f"ref_{tier}"), str(tmp_path / f"port_{tier}"))
             if tier != "ram" else (None, None)][0]
    ref = jdb.create(_spec(jdb, tier, paths[0], **ingest_kw))
    port = tdb.create(_spec(tdb, tier, paths[1], **ingest_kw), device="cpu")
    opened.extend([ref, port])
    return ref, port


def _assert_state(ref, port):
    """The bootstrap engines' integer state, exactly equal."""
    jb, tb = ref.backend, port.backend
    assert tb.phase == jb.phase
    assert (tb.cutovers, tb.growths) == (jb.cutovers, jb.growths)
    assert tb.n_active == jb.n_active and tb.capacity == jb.capacity
    np.testing.assert_array_equal(tb._ext_tomb, jb._ext_tomb)
    if jb.phase == "graph":
        np.testing.assert_array_equal(tb._ext2int, jb._ext2int)
        np.testing.assert_array_equal(tb._gen[1], jb._gen[1])
    assert tb.ingest_stats().keys() == jb.ingest_stats().keys()
    for key, v in jb.ingest_stats().items():
        if not key.endswith("_ms"):
            assert tb.ingest_stats()[key] == v, key


def _assert_search(ref, port, q, k=10, **kw):
    r = ref.search(q, k=k, **kw)
    p = port.search(q, k=k, **kw)
    np.testing.assert_array_equal(p.ids, np.asarray(r.ids))
    np.testing.assert_allclose(p.dists, np.asarray(r.dists), rtol=1e-6)
    for fld in ("hops", "ndists", "used", "won"):
        np.testing.assert_array_equal(np.asarray(getattr(p.stats, fld)),
                                      np.asarray(getattr(r.stats, fld)),
                                      err_msg=fld)
    if getattr(ref.backend, "phase", "graph") == "graph":
        for js, ts in zip(_units(ref.backend), _units(port.backend)):
            want, got = jbk.to_arrays(js._cat.buckets), tbk.to_arrays(
                ts._cat.buckets)
            for name in want:
                np.testing.assert_array_equal(got[name], want[name])
    return p


def _stream_twins(ref, port, corpus, bs=64):
    gids = []
    for lo in range(0, len(corpus), bs):
        g_ref = ref.upsert(corpus[lo: lo + bs])
        g = port.upsert(corpus[lo: lo + bs])
        np.testing.assert_array_equal(g, g_ref)
        assert g.dtype == np.int64
        _assert_state(ref, port)
        gids.append(g)
    return np.concatenate(gids)


# ---------------------------------------------------------------- spec


@pytest.mark.parametrize("bad", [
    dict(batch_size=0), dict(bootstrap="noop"), dict(bootstrap_cutover=1),
    dict(initial_capacity=0), dict(grow_factor=1.0),
    dict(consolidate_threshold=1.5)])
def test_ingest_spec_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        jdb.IngestSpec(**bad)
    with pytest.raises(ValueError) as got:
        tdb.IngestSpec(**bad)
    assert str(got.value) == str(want.value)


def test_ingest_spec_round_trip_and_index_spec_rule():
    s = tdb.IngestSpec(batch_size=32, bootstrap="direct", initial_capacity=64)
    assert tdb.IngestSpec.from_dict(s.to_dict()) == s
    assert tdb.IngestSpec.from_dict({**s.to_dict(), "new_field": 1}) == s
    assert s.to_dict() == jdb.IngestSpec(batch_size=32, bootstrap="direct",
                                         initial_capacity=64).to_dict()
    assert tdb.IngestSpec().to_dict() == jdb.IngestSpec().to_dict()
    for pkg in (jdb, tdb):
        with pytest.raises(ValueError, match="ingest must be an IngestSpec"):
            pkg.IndexSpec(tier="ram", dim=D, ingest={"batch_size": 32})


# ------------------------------------------------------- empty bootstrap


def test_empty_create_serves_immediately(world, tmp_path, opened):
    _, queries, _ = world
    ref, port = _twin_create("ram", tmp_path, opened)
    assert port.backend.bootstrap_phase == "empty" and port.n_active == 0
    assert port.spec.ingest == _spec(tdb, "ram").ingest
    p = _assert_search(ref, port, queries, k=5)
    assert (p.ids == -1).all() and np.isinf(p.dists).all()
    assert port.backend.device == torch.device("cpu")
    assert port.metrics()["catapultdb_ingest_phase"] == 0.0
    for db in (ref, port):
        with pytest.raises(RuntimeError, match="never"):
            db.backend.save()


def test_empty_create_defaults_to_the_card():
    """The device resolves before the first row: an empty database asked
    for on the card raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tdb.create(_spec(tdb, "ram"))


def test_empty_create_rejects_labels_and_prebuilt():
    for kw in (dict(labels=np.zeros(3, np.int32)),
               dict(prebuilt=(np.zeros((2, 2), np.int32), 0))):
        errs = []
        for pkg, dev in ((jdb, {}), (tdb, {"device": "cpu"})):
            with pytest.raises(ValueError) as err:
                pkg.create(pkg.IndexSpec(tier="ram", dim=D), **kw, **dev)
            errs.append(str(err.value))
        assert errs[0] == errs[1]
    errs = []
    for pkg, dev in ((jdb, {}), (tdb, {"device": "cpu"})):
        with pytest.raises(ValueError, match="dim") as err:
            pkg.create(pkg.IndexSpec(tier="ram"), **dev)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


def test_seed_phase_brute_force_is_exact(world, tmp_path, opened):
    corpus, _, _ = world
    ref, port = _twin_create("ram", tmp_path, opened, bootstrap_cutover=256)
    g = port.upsert(corpus[:40])
    np.testing.assert_array_equal(g, ref.upsert(corpus[:40]))
    assert port.backend.bootstrap_phase == "seed"
    assert sorted(g) == list(range(40))
    _assert_state(ref, port)
    truth = brute_force_knn(corpus[:40], corpus[:40], 3)
    p = _assert_search(ref, port, corpus[:40], k=3)
    assert (_rows_of(p.ids, g, 40) == truth).all()
    np.testing.assert_array_equal(p.dists, np.asarray(
        ref.search(corpus[:40], k=3).dists))      # the same numpy sums
    for db in (ref, port):
        db.delete(g[:5])
    _assert_state(ref, port)
    p = _assert_search(ref, port, corpus[:5], k=1)
    assert not np.isin(p.ids.ravel(), g[:5]).any()


def test_direct_bootstrap_cuts_over_on_first_batch(world, tmp_path, opened,
                                                   hooked):
    corpus, queries, _ = world
    ref, port = _twin_create("ram", tmp_path, opened, bootstrap="direct")
    _stream_twins(ref, port, corpus[:64])
    assert port.backend.bootstrap_phase == "graph"
    assert port.backend.cutovers == 1
    assert port.backend.inner.device == torch.device("cpu")
    _assert_search(ref, port, queries[:32])


# ------------------------------------------- streaming parity (tentpole)


@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_streaming_recall_matches_batch_twin(world, tier, tmp_path, opened,
                                             hooked):
    """Stream the whole corpus into twins born empty (growth rebuilds
    included: capacity 200 << 500): equal ext ids and indirection after
    every batch, equal search results, and the port's streamed recall
    within 1 point of a batch-built twin of the same spec."""
    corpus, queries, truth = world
    ref, port = _twin_create(tier, tmp_path, opened)
    gids = _stream_twins(ref, port, corpus)
    assert port.backend.bootstrap_phase == "graph"
    assert port.backend.growths >= 1 and port.n_active == N
    p = _assert_search(ref, port, queries)
    r_stream = recall_at_k(_rows_of(p.ids, gids, N), truth)
    twins = []
    for pkg, dev, name in ((jdb, {}, "ref_tw"), (tdb, {"device": "cpu"},
                                                 "port_tw")):
        path = str(tmp_path / name) if tier != "ram" else None
        spec = dataclasses.replace(_spec(pkg, tier, path), ingest=None)
        twins.append(pkg.create(spec, corpus, **dev))
    opened.extend(twins)
    tw = _assert_search(*twins, queries)
    r_batch = recall_at_k(tw.ids, truth)
    assert r_stream >= r_batch - 0.01, (r_stream, r_batch)


def test_streamed_arrival_order_matches_batch_build(world):
    """With no locality grouping and no growth, the port's streamed
    engine IS its batch build: identical ids and distances."""
    corpus, queries, _ = world
    sub = corpus[:256]
    db = tdb.create(_spec(tdb, "ram", bootstrap_cutover=256,
                          initial_capacity=256, locality_group=False),
                    device="cpu")
    for lo in range(0, 256, 64):
        db.upsert(sub[lo: lo + 64])
    twin = tdb.create(dataclasses.replace(_spec(tdb, "ram"), ingest=None,
                                          spare_capacity=0), sub,
                      device="cpu")
    a, b = db.search(queries, k=10), twin.search(queries, k=10)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)


# --------------------------------------------------------- keyed upsert


def test_keyed_upsert_true_semantics(world, tmp_path, opened, hooked):
    corpus, _, _ = world
    ref, port = _twin_create("ram", tmp_path, opened)
    _stream_twins(ref, port, corpus[:300])
    steps = [lambda db: db.upsert(corpus[:3] + 10.0, keys=["a", "b", "c"]),
             lambda db: db.upsert(corpus[:1] + 20.0, keys=["a"]),
             lambda db: db.delete(keys=["b"])]
    outs = []
    for step in steps:
        r, p = step(ref), step(port)
        if r is not None:
            np.testing.assert_array_equal(p, r)
        outs.append(p)
        _assert_state(ref, port)
        assert dict(port.keys._fwd) == dict(ref.keys._fwd)
    g1, g2 = outs[0], outs[1]
    assert port.keys["a"] == g2[0] != g1[0]
    assert port.tombstones[g1[0]] and not port.tombstones[g2[0]]
    p = _assert_search(ref, port, corpus[:1] + 20.0, k=1)
    assert int(p.ids[0, 0]) == int(g2[0])
    assert port.tombstones[g1[1]] and "b" not in port.keys
    for bad, exc in ((lambda db: db.delete(keys=["b"]), KeyError),
                     (lambda db: db.upsert(corpus[:1], keys=[7]), TypeError),
                     (lambda db: db.upsert(corpus[:1], keys=[True]),
                      TypeError),
                     (lambda db: db.delete(g2, keys=["c"]), TypeError),
                     (lambda db: db.upsert(corpus[:2], keys=["x"]),
                      ValueError)):
        msgs = []
        for db in (ref, port):
            with pytest.raises(exc) as err:
                bad(db)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    _assert_state(ref, port)


def test_keymap_duplicate_keys_last_write_wins():
    for cls in (KeyMap, JKeyMap):
        m = cls()
        old = m.assign([5, 6, 5], np.asarray([10, 11, 12]))
        assert old.tolist() == [-1, -1, 10]
        assert m.get(5) == 12
    m2 = KeyMap.from_arrays(JKeyMap.from_arrays(m.to_arrays()).to_arrays())
    assert m2.get(5) == 12 and m2.get(6) == 11 and len(m2) == 2


# --------------------------------------------------------- ingest queue


def test_locality_order_matches_reference():
    rng = np.random.default_rng(0)
    v = np.repeat(rng.standard_normal((5, D)).astype(np.float32), 8, 0)
    rng.shuffle(v)
    order = locality_order(v, seed=3)
    np.testing.assert_array_equal(order, j_locality_order(v, seed=3))
    assert sorted(order.tolist()) == list(range(len(v)))
    codes = [tuple(np.round(v[i], 4)) for i in order]
    assert sum(1 for a, b in zip(codes, codes[1:]) if a != b) + 1 == 5
    w = rng.standard_normal((300, 24)).astype(np.float32)
    for seed in (0, 7):
        np.testing.assert_array_equal(locality_order(w, seed=seed),
                                      j_locality_order(w, seed=seed))


def test_ingest_queue_batches_and_ticket_order(world, tmp_path, opened,
                                               hooked):
    corpus, _, _ = world
    ref, port = _twin_create("ram", tmp_path, opened, bootstrap="direct")
    _stream_twins(ref, port, corpus[:64])
    qs = [ref.ingest_queue(batch_size=32), port.ingest_queue(batch_size=32)]
    assert isinstance(qs[1], IngestQueue)
    tickets = [(q.put(corpus[64:74]),
                q.put(corpus[74:174], keys=list(range(100)))) for q in qs]
    assert qs[1].depth == 110
    for q in qs:
        assert q.pump() == 32
    assert not tickets[1][1].done()
    for q in qs:
        q.flush()
    assert qs[1].depth == 0
    for tr, tp in zip(tickets[0], tickets[1]):
        np.testing.assert_array_equal(tp.gids, tr.gids)
    t_small, t_big = tickets[1]
    np.testing.assert_array_equal(port.vectors[t_small.gids], corpus[64:74])
    np.testing.assert_array_equal(port.vectors[t_big.gids], corpus[74:174])
    assert len(port.keys) == 100 and dict(port.keys._fwd) == dict(
        ref.keys._fwd)
    _assert_state(ref, port)
    bad = [q.put(np.zeros((2, D + 1), np.float32)) for q in qs]
    for q in qs:
        q.flush()
    msgs = []
    for t in bad:
        with pytest.raises(Exception) as err:
            t.wait(0.0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_ingest_queue_concurrent_producers_keep_caller_order(world):
    """Four producer threads: every gid distinct, each ticket's gids in
    its caller's row order."""
    import threading
    corpus, _, _ = world
    db = tdb.create(_spec(tdb, "ram", bootstrap_cutover=64, batch_size=32,
                          initial_capacity=128), device="cpu")
    q = db.ingest_queue()
    tickets = [None] * 8

    def producer(p):
        for j in range(2):
            lo = (2 * p + j) * 20
            tickets[2 * p + j] = q.put(corpus[lo: lo + 20])
    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    q.flush()
    gids = np.concatenate([t.gids for t in tickets])
    assert len(np.unique(gids)) == 160
    assert db.backend.bootstrap_phase == "graph"
    for i, t in enumerate(tickets):
        np.testing.assert_array_equal(db.vectors[t.gids],
                                      corpus[20 * i: 20 * i + 20])


# -------------------------------------------------------- observability


def test_ingest_metrics_and_trace_spans(world, tmp_path, opened, hooked):
    corpus, queries, _ = world
    ref, port = _twin_create("ram", tmp_path, opened)
    tr = port.search(queries[:2], k=3, explain=True)
    assert any(s.name == "bootstrap" for s in tr.stages)
    for db in (ref, port):
        db.upsert(corpus[:40], keys=list(range(40)))
    m = port.metrics("dict")
    assert m["catapultdb_ingest_phase"] == 1.0
    assert m["catapultdb_ingest_rows_total"] == 40.0
    assert m["catapultdb_ingest_keys"] == 40.0
    _stream_twins(ref, port, corpus[40:300])
    for db in (ref, port):
        q = db.ingest_queue()
        q.put(corpus[300:310])
        q.flush()
    m, want = port.metrics("dict"), ref.metrics("dict")
    assert m["catapultdb_ingest_phase"] == 2.0
    assert m["catapultdb_ingest_cutovers"] == 1.0
    assert m["catapultdb_ingest_growths"] >= 1.0
    assert m["catapultdb_ingest_queue_batches_flushed"] >= 1.0
    names = {k for k in want if k.startswith("catapultdb_ingest")}
    assert names == {k for k in m if k.startswith("catapultdb_ingest")}
    for name in names:
        if not name.endswith("_ms"):
            assert m[name] == want[name], name
    tr = port.search(queries[:2], k=3, explain=True)
    assert any(s.name == "ingest_map" for s in tr.stages)
