"""The whole slice: ``repro_torch.db.create`` + ``search`` against
``repro.db.create`` + ``search`` on the CPU, plus the facade's contracts.

The port gets the reference's graph (``prebuilt=``) and its LSH planes
and bucket tables (``repro_torch.convert``), then both replay the same
batches.  ids, hops, ndists, used, won and the bucket tables must be
exactly equal after every batch; distances agree to rtol 1e-6.
"""
from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro import db as jdb
from repro.core import buckets as jbk
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.core import buckets as tbk

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = dict(degree=16, build_beam=32, n_bits=4, bucket_capacity=8)


@pytest.fixture
def graph(diskann_engine):
    """The reference's Vamana graph of the SMALL corpus (the conftest
    build uses SPEC's geometry), shared by both packages."""
    return diskann_engine._adj_np, diskann_engine.medoid


def _twins(corpus, graph, mode, hop_backend="unfused"):
    ref = jdb.create(jdb.IndexSpec(mode=mode, hop_backend=hop_backend, **SPEC),
                     corpus[0], prebuilt=graph)
    port = tdb.create(tdb.IndexSpec(mode=mode, hop_backend=hop_backend,
                                    **SPEC), corpus[0], prebuilt=graph,
                      device="cpu")
    if mode == "catapult":
        cat = ref.backend._cat
        port.backend._cat = convert.catapult_state_from_numpy(
            np.asarray(cat.lsh.hyperplanes), jbk.to_arrays(cat.buckets),
            device="cpu")
    return ref, port


@pytest.mark.parametrize("mode,hop_backend", [("catapult", "unfused"),
                                              ("catapult", "fused"),
                                              ("diskann", "unfused")])
def test_facade_matches_jax(corpus, queries, graph, mode, hop_backend):
    ref, port = _twins(corpus, graph, mode, hop_backend)
    batches = [queries[i: i + 32] for i in (0, 32, 64)]
    for rnd in range(2):
        for q in batches:
            r = ref.search(q, k=10)
            p = port.search(q, k=10)
            np.testing.assert_array_equal(p.ids, r.ids)
            np.testing.assert_allclose(p.dists, r.dists, rtol=1e-6)
            for fld in ("hops", "ndists", "used", "won"):
                np.testing.assert_array_equal(getattr(p.stats, fld),
                                              getattr(r.stats, fld),
                                              err_msg=f"{fld} round {rnd}")
            if mode == "catapult":
                want = jbk.to_arrays(ref.backend._cat.buckets)
                got = tbk.to_arrays(port.backend._cat.buckets)
                for name in want:
                    np.testing.assert_array_equal(got[name], want[name])
    if mode == "catapult":
        assert p.stats.used.all() and p.stats.won.any()
    assert p.ids.dtype == np.int32 and p.dists.dtype == np.float32


def test_publish_false_leaves_buckets_alone(corpus, queries, graph):
    ref, port = _twins(corpus, graph, "catapult")
    before = tbk.to_arrays(port.backend._cat.buckets)
    p = port.search(queries[:16], k=5, publish=False)
    r = ref.search(queries[:16], k=5, publish=False)
    np.testing.assert_array_equal(p.ids, r.ids)
    after = tbk.to_arrays(port.backend._cat.buckets)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name])


def test_create_defaults_to_the_card():
    """create() without a device asks for the card: where there is none it
    must raise, never continue on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    vec = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tdb.create(tdb.IndexSpec(degree=4, build_beam=8), vec)


def _load_chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _count_wrapper_calls(monkeypatch):
    from repro_torch.kernels import ops
    calls = dict.fromkeys(ops.LAUNCHES, 0)
    for name in calls:
        def wrapped(*args, _name=name, _fn=getattr(ops, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(ops, name, wrapped)
    return calls


@pytest.mark.parametrize("mode,hop_backend,pq,path", [
    pytest.param(mode, hb, pq, path,
                 id=f"{mode}-{hb}" + ("-pq" if pq else "")
                 + ("" if path == "search" else f"-{path}"))
    for mode, hb, pq, path in [
        ("catapult", "unfused", None, "search"),
        ("catapult", "fused", None, "search"),
        ("diskann", "unfused", None, "search"),
        ("catapult", "unfused", 4, "search"),
        ("catapult", "fused", 4, "search"),
        ("diskann", "unfused", 4, "search"),
        ("diskann", "fused", 4, "search"),
        ("catapult", "fused", None, "filtered"),
        ("diskann", "unfused", None, "filtered"),
        ("catapult", "fused", 4, "filtered"),
        ("lsh_apg", "fused", None, "search"),
        ("lsh_apg", "unfused", 4, "search"),
        ("catapult", "fused", None, "two_phase"),
        ("diskann", "unfused", None, "two_phase"),
        ("lsh_apg", "fused", None, "two_phase")]])
def test_chip_smoke_launch_accounting(corpus, queries, graph, monkeypatch,
                                      mode, hop_backend, pq, path):
    """``chip_smoke.expected_launches`` / ``two_phase_launches`` (what the
    card run holds each path's kernel counts to) against the wrapper
    calls a search makes: plain, filtered (a mask keeps every hop
    composed), lsh_apg and two-phase batches."""
    from repro_torch.core.filters import label_entry_points
    smoke = _load_chip_smoke()
    filtered = path == "filtered"
    labels = (corpus[2] % 4).astype(np.int32) if filtered else None
    pre = ((*graph, label_entry_points(corpus[0], labels, 4)) if filtered
           else graph)
    port = tdb.create(tdb.IndexSpec(mode=mode, hop_backend=hop_backend,
                                    pq=pq, filters=filtered, **SPEC),
                      corpus[0], labels, prebuilt=pre, device="cpu")
    calls = _count_wrapper_calls(monkeypatch)
    want = dict.fromkeys(calls, 0)
    iters = []
    for lo in (0, 24, 48):
        q = queries[lo: lo + 24]
        if path == "two_phase":
            hops = port.backend.search_two_phase(q, k=10, phase1_iters=3)[2].hops
            for name, n in smoke.two_phase_launches(mode, hop_backend, hops,
                                                    3).items():
                want[name] += n
            continue
        fl = (np.arange(24) % 5 - 1).astype(np.int32) if filtered else None
        r = port.search(q, k=10, filter_labels=fl)
        iters.append(int(r.stats.hops.max()))
    if path != "two_phase":
        want = smoke.expected_launches(mode, hop_backend, iters, pq=bool(pq),
                                       filtered=filtered)
    assert calls == want


@pytest.mark.parametrize("mode", ["catapult", "lsh_apg"])
def test_chip_smoke_update_and_build_accounting(corpus, graph, monkeypatch,
                                                mode):
    """What ``chip_smoke.py`` holds its new paths to: an upsert's insert
    searches launch ``gather_distance`` alone, a delete and a consolidate
    launch nothing, and an ``lsh_apg`` build hashes the corpus once."""
    calls = _count_wrapper_calls(monkeypatch)
    port = tdb.create(tdb.IndexSpec(mode=mode, spare_capacity=8, **SPEC),
                      corpus[0], prebuilt=graph, device="cpu")
    assert calls["lsh_hash"] == (mode == "lsh_apg")
    assert sum(calls.values()) == calls["lsh_hash"]
    calls.update(dict.fromkeys(calls, 0))
    port.upsert(corpus[0][:8] + 0.5, keys=list(range(8)))
    assert calls["gather_distance"] > 0
    assert sum(calls.values()) == calls["gather_distance"]
    calls.update(dict.fromkeys(calls, 0))
    port.delete(keys=[1, 2])
    port.consolidate()
    assert sum(calls.values()) == 0


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test of many small CPU ops: as fast
    alone, and no spinning beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_chip_smoke_ingest_and_hnsw_launch_accounting(corpus, queries,
                                                      monkeypatch,
                                                      one_torch_thread):
    """What ``chip_smoke.py`` holds this slice's paths to, against the
    wrapper calls of a CPU run: a database born empty launches nothing
    while empty or seeding (``IngestSpy.seed_launches``); its cutover,
    growth and consolidate rebuilds and its inserts launch
    ``gather_distance`` once a search plus once an iteration
    (``build_spy``); its graph-phase searches and the maintainer's folds
    are on ``expected_launches``; an ``HnswEngine`` batch is its descent
    and level-0 searches plus one ``lsh_hash`` in catapult mode
    (``hnsw_launches``)."""
    from repro_torch.adapt import PolicyConfig
    from repro_torch.core import hnsw
    from repro_torch.core.vamana import VamanaParams
    smoke = _load_chip_smoke()
    calls = _count_wrapper_calls(monkeypatch)
    db = tdb.create(tdb.IndexSpec(dim=16, adapt=PolicyConfig(), **SPEC,
                                  ingest=tdb.IngestSpec(
                                      bootstrap_cutover=128,
                                      initial_capacity=256, batch_size=64,
                                      consolidate_threshold=0.2)),
                    device="cpu")
    fe = db.serve(max_batch=32, ingest=True)
    data = corpus[0]
    with smoke.IngestSpy(db.backend, device_type="cpu") as spy:
        for lo in range(0, 128, 64):                   # empty, then seed
            fe.ingest.put(data[lo: lo + 64], keys=list(range(lo, lo + 64)))
            fe.search(queries[:32], k=10)
        assert db.backend.bootstrap_phase == "graph"
        assert sum(calls.values()) == len(spy.builds.iters) + sum(
            spy.builds.iters) > 0
        assert not any(spy.seed_launches.values())
        assert {p for p, _, _ in spy.searches} == {"empty", "seed"}
        for lo in range(128, 320, 64):                 # a growth, inserts
            fe.ingest.put(data[lo: lo + 64], keys=list(range(lo, lo + 64)))
            fe.search(queries[:32], k=10)
        db.delete(keys=list(range(120)))
        for _ in range(40):                            # the consolidate
            fe.search(queries[32:64], k=10)
            if fe.maintainer.consolidations:
                break
    assert db.backend.growths >= 1 and fe.maintainer.consolidations == 1
    assert spy.folds > 0 and calls == spy.expected("unfused")
    calls.update(dict.fromkeys(calls, 0))
    with smoke.build_spy("cpu") as bs:
        eng = hnsw.HnswEngine(mode="catapult", n_bits=4, bucket_capacity=8,
                              device="cpu").build(
            data[:300], VamanaParams(max_degree=16, build_beam=32))
    assert calls == bs.expected()
    for mode in ("catapult", "plain"):
        eng.mode = mode
        for _ in range(2):
            calls.update(dict.fromkeys(calls, 0))
            with smoke.SearchSpy(hnsw, device_type="cpu") as hs:
                eng.search(queries[:24], k=5, beam_width=8)
            assert len(hs.iters) == len(eng.index.level_ids) + 1
            assert calls == smoke.hnsw_launches(mode, hs.iters)


@pytest.mark.parametrize("build", [
    "build_vamana", "make_catapult_state", "make_lsh", "make_buckets",
    "from_arrays", "catapult_state_from_numpy", "engine", "train_pq",
    "pq_codebook_from_numpy"])
def test_public_constructors_default_to_the_card(build):
    """Every public constructor of device state asks for the card when
    the caller names no device, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.core import catapult as tcat
    from repro_torch.core import engine as teng
    from repro_torch.core import lsh as tlsh
    from repro_torch.core import pq as tpq
    from repro_torch.core import vamana as tvam
    vec = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
    arrays = tbk.to_arrays(tbk.make_buckets(4, 2, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    calls = {
        "build_vamana": lambda: tvam.build_vamana(
            vec, tvam.VamanaParams(max_degree=4, build_beam=8)),
        "make_catapult_state": lambda: tcat.make_catapult_state(gen, 8),
        "make_lsh": lambda: tlsh.make_lsh(gen, 4, 8),
        "make_buckets": lambda: tbk.make_buckets(4, 2),
        "from_arrays": lambda: tbk.from_arrays(arrays),
        "catapult_state_from_numpy": lambda: convert.catapult_state_from_numpy(
            vec[:4], arrays),
        "engine": lambda: teng.VectorSearchEngine(),
        "train_pq": lambda: tpq.train_pq(gen, vec, 4),
        "pq_codebook_from_numpy": lambda: convert.pq_codebook_from_numpy(
            np.zeros((4, 8, 2), np.float32)),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[build]()


@pytest.mark.parametrize("field,value", [
    ("tier", "sharded"), ("pq", 4), ("adapt", object()), ("tier", "tiered"),
    ("ingest", object()), ("tiered", object())])
def test_unported_spec_fields_raise_capability_error(field, value):
    """Every spec field the reference takes, the port takes: the sharded
    and tiered tiers are accepted as the reference accepts them (``pq``
    and ``adapt`` with them too), an ``IngestSpec`` is accepted, and an
    ``ingest`` that is not an ``IngestSpec`` or a ``tiered`` that is not a
    ``TieredSpec`` is refused with the reference's ``ValueError``."""
    kw = {field: value}
    if field in ("ingest", "tiered"):
        extra = (dict(tier="tiered", path="unused.d") if field == "tiered"
                 else {})
        msgs = []
        for pkg in (jdb, tdb):
            with pytest.raises(ValueError, match=field) as err:
                pkg.IndexSpec(**kw, **extra)
            msgs.append(str(err.value).split(", got")[0])
        assert msgs[0] == msgs[1]
        if field == "ingest":
            ing = tdb.IngestSpec(batch_size=32)
            assert tdb.IndexSpec(ingest=ing).ingest is ing
        return
    if field in ("pq", "adapt"):
        assert getattr(tdb.IndexSpec(**kw), field) is value
        assert getattr(tdb.IndexSpec(tier="disk", path="unused.ctpl", **kw),
                       field) is value
        kw["tier"] = "sharded"
    kw["path"] = "unused.d"
    got, want = tdb.IndexSpec(**kw), jdb.IndexSpec(**kw)
    assert got.tier == want.tier and got.path == want.path
    assert getattr(got, field) is value and got.tiered is None
    assert got.n_shards == want.n_shards


def test_spec_validation_matches_reference():
    for kw in (dict(tier="bogus"), dict(mode="bogus"),
               dict(hop_backend="bogus"), dict(n_shards=0)):
        with pytest.raises(ValueError):
            jdb.IndexSpec(**kw)
        with pytest.raises(ValueError):
            tdb.IndexSpec(**kw)
    assert tdb.IndexSpec().vamana().max_degree == jdb.IndexSpec().vamana(
        ).max_degree


def test_explain_metrics_and_request_spelling(corpus, queries, graph):
    port = tdb.create(tdb.IndexSpec(**SPEC), corpus[0], prebuilt=graph,
                      device="cpu")
    port.search(queries[:8], k=5)
    tr = port.search(queries[:8], k=5, explain=True)
    assert tr.catapult_used == int(tr.stats.used.sum()) == 8
    assert set(tr.entry) == {"catapult"}
    assert tr.stage_ms("route") > 0 and tr.to_dict()["tier"] == "ram"
    res = port.search(tdb.SearchRequest(queries=queries[:8], k=5,
                                        publish=False))
    np.testing.assert_array_equal(res.ids, tr.ids)
    with pytest.raises(TypeError):
        port.search(tdb.SearchRequest(queries=queries[:8]), k=5)
    m = port.metrics()
    assert m["catapultdb_search_requests_total"] == 3
    assert m["catapultdb_search_explain_total"] == 1
    assert "catapultdb_search_latency_ms" in port.metrics("prometheus")
    assert port.n_active == corpus[0].shape[0] and port.dim == 16
    assert port.warm((4,)) >= 0


@pytest.mark.parametrize("op", ["ingest_queue", "serve"])
def test_unported_database_methods_raise(corpus, graph, op):
    """``ingest_queue`` and ``serve(ingest=True)`` are ported: on a
    database built from vectors both give an ``IngestQueue`` at the
    ``IngestSpec()`` defaults, and its tickets resolve to the gids the
    reference's twin assigns."""
    from repro_torch.ingest import IngestQueue
    dbs = [pkg.create(pkg.IndexSpec(mode="diskann", spare_capacity=16,
                                    **SPEC), corpus[0], prebuilt=graph,
                      **dev)
           for pkg, dev in ((jdb, {}), (tdb, {"device": "cpu"}))]
    if op == "serve":
        queues = [d.serve(ingest=True).ingest for d in dbs]
    else:
        queues = [d.ingest_queue() for d in dbs]
    assert isinstance(queues[1], IngestQueue)
    assert queues[1].batch_size == queues[0].batch_size == 256
    tickets = [q.put(corpus[0][:10] + 0.5, keys=list(range(10)))
               for q in queues]
    for q in queues:
        assert q.flush() == 10
    np.testing.assert_array_equal(tickets[1].gids, tickets[0].gids)
    assert dict(dbs[1].keys._fwd) == dict(dbs[0].keys._fwd)


def test_port_imports_neither_jax_nor_the_reference():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
