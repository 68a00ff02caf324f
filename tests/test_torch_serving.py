"""The serving front end: ``repro_torch.serving.VectorSearchFrontend`` and
``Database.serve``/``attach_maintainer``/``metrics`` against the
reference's on the CPU, plus the serving window and the profiler hooks.

Twin databases share the reference's graph, LSH planes and bucket
tables (``convert``); ids, hops, used/won and bucket tables must be
exactly equal, distances within rtol 1e-6, maintainer snapshots as in
``test_torch_adapt.py``.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from repro import db as jdb
from repro.adapt import PolicyConfig as JPolicy
from repro.core import buckets as jbk
from repro.obs import RollingWindow as JWindow
from repro.serving.engine import VectorSearchFrontend as JFrontend
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.adapt import CatapultMaintainer, PolicyConfig
from repro_torch.core import buckets as tbk
from repro_torch.obs import RollingWindow, profiler
from repro_torch.serving import VectorSearchFrontend

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = dict(degree=16, build_beam=32, n_bits=4, bucket_capacity=8)
ADAPT = dict(observe_every=1, baseline_every=3, min_batches=2, min_base=1,
             ttl_steps=96)


@pytest.fixture
def graph(diskann_engine):
    return diskann_engine._adj_np, diskann_engine.medoid


def _twins(corpus, graph, mode="catapult", **spec):
    ref = jdb.create(jdb.IndexSpec(mode=mode, **SPEC, **spec), corpus[0],
                     prebuilt=graph)
    tspec = dict(spec)
    if "adapt" in tspec:
        tspec["adapt"] = PolicyConfig(**ADAPT)
    port = tdb.create(tdb.IndexSpec(mode=mode, **SPEC, **tspec), corpus[0],
                      prebuilt=graph, device="cpu")
    if mode == "catapult":
        cat = ref.backend._cat
        port.backend._cat = convert.catapult_state_from_numpy(
            np.asarray(cat.lsh.hyperplanes), jbk.to_arrays(cat.buckets),
            device="cpu")
    return ref, port


def _same_buckets(port, ref):
    want = jbk.to_arrays(ref.backend._cat.buckets)
    got = tbk.to_arrays(port.backend._cat.buckets)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _same_stats(got, want):
    for fld in ("hops", "ndists", "used", "won"):
        np.testing.assert_array_equal(getattr(got, fld), getattr(want, fld),
                                      err_msg=fld)


def test_frontend_masks_padded_lanes_out_of_publishes(corpus, graph):
    """Three queries in a batch of 8: the five pad lanes publish nothing
    (the bucket table equals a direct unpadded search's) and the
    returned ids and the reference frontend's are equal."""
    rng = np.random.default_rng(3)
    q = (corpus[0][:3] + 0.05 * rng.normal(size=(3, 16))).astype(np.float32)
    ref, port = _twins(corpus, graph)
    _, direct = _twins(corpus, graph)
    fes = {"ref": JFrontend(ref.backend, k=4, max_batch=8),
           "port": VectorSearchFrontend(port.backend, k=4, max_batch=8)}
    out = {}
    for name, fe in fes.items():
        tickets = [fe.submit(x) for x in q]
        out[name] = fe.flush()
        assert sorted(out[name]) == tickets
    for t in out["ref"]:
        np.testing.assert_array_equal(out["port"][t][0], out["ref"][t][0])
        np.testing.assert_allclose(out["port"][t][1], out["ref"][t][1],
                                   rtol=1e-6)
    direct.search(q, k=4)
    _same_buckets(port, ref)
    assert tbk.to_arrays(port.backend._cat.buckets)["step"] == 3
    want = tbk.to_arrays(direct.backend._cat.buckets)
    got = tbk.to_arrays(port.backend._cat.buckets)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_frontend_mixed_k_tickets_match_jax(corpus, queries, graph):
    """Tickets with their own k and beam group by (k, beam); each gets
    back ids shaped by its k, equal to the reference frontend's, and the
    bucket tables stay equal."""
    ref, port = _twins(corpus, graph)
    fes = [JFrontend(ref.backend, k=5, max_batch=8),
           VectorSearchFrontend(port.backend, k=5, max_batch=8)]
    plan = [dict(), dict(k=3), dict(k=7, beam_width=24), dict(k=3),
            dict(beam_width=24)] * 4
    results = []
    for fe in fes:
        for i, kw in enumerate(plan):
            fe.submit(queries[i], **kw)
        results.append(fe.flush())
        assert fe.pending == 0
    want, got = results
    assert got.keys() == want.keys()
    for t, kw in enumerate(plan):
        assert got[t][0].shape == (kw.get("k", 5),)
        np.testing.assert_array_equal(got[t][0], want[t][0])
        np.testing.assert_allclose(got[t][1], want[t][1], rtol=1e-6)
    assert fes[1].batches_dispatched == fes[0].batches_dispatched == 4
    _same_buckets(port, ref)


def test_frontend_bulk_search_matches_jax(corpus, queries, graph):
    """The bulk path: 70 queries in chunks of 32, ids, dists and the
    per-chunk stats trimmed to the real lanes, all equal to the
    reference's; the window records one flush of 70 queries."""
    ref, port = _twins(corpus, graph)
    q = np.concatenate([queries, queries[:-26]])[:70]
    r = JFrontend(ref.backend, k=6, max_batch=32).search(q)
    fe = VectorSearchFrontend(port.backend, k=6, max_batch=32)
    p = fe.search(q)
    np.testing.assert_array_equal(p[0], r[0])
    np.testing.assert_allclose(p[1], r[1], rtol=1e-6)
    assert [s.hops.shape for s in p[2]] == [(32,), (32,), (6,)]
    for got, want in zip(p[2], r[2]):
        _same_stats(got, want)
    _same_buckets(port, ref)
    snap = fe.window.snapshot()
    assert snap["flushes"] == 1 and snap["queries"] == 70
    assert snap["batch_occupancy"] == pytest.approx((1 + 1 + 6 / 32) / 3)
    empty = fe.search(q[:0])
    assert empty[0].shape == (0, 6) and empty[2] == []


def test_served_maintainer_matches_jax(corpus, queries, graph):
    """``db.serve()`` with an adapt spec on both packages: flushes of 13
    tickets into batches of 8 (so every flush has a padded chunk), the
    maintainer fed the padded shape with ``real_mask``; every ticket's
    ids, every snapshot and the bucket tables after every flush equal."""
    from test_torch_adapt import _assert_snapshot_equal, \
        _assert_telemetry_equal
    ref, port = _twins(corpus, graph, adapt=JPolicy(**ADAPT),
                       adapt_tick_every=2)
    fes = [ref.serve(max_batch=8), port.serve(max_batch=8)]
    assert isinstance(fes[1].maintainer, CatapultMaintainer)
    assert port.maintainer is fes[1].maintainer
    rng = np.random.default_rng(5)
    for flush in range(8):
        rows = rng.integers(0, queries.shape[0], 13)
        got = []
        for fe in fes:
            for x in queries[rows]:
                fe.submit(x)
            got.append(fe.flush())
        for t in got[0]:
            np.testing.assert_array_equal(got[1][t][0], got[0][t][0])
        _same_buckets(port, ref)
        _assert_telemetry_equal(port.backend.adapt_state,
                                ref.backend.adapt_state, f"flush {flush}")
        _assert_snapshot_equal(fes[1].maintainer.snapshot(),
                               fes[0].maintainer.snapshot(), f"flush {flush}")
    s = fes[1].maintainer.snapshot()
    assert s["n_queries"] == 8 * 13 and s["shadows"] > 0 and s["ticks"] > 0


def test_serve_attach_maintainer_and_metrics(corpus, queries, graph):
    """Which serve() calls attach a maintainer; the adapt and serving
    collectors in ``metrics()`` carry the reference's metric names and,
    after the same traffic, its counts."""
    ref, port = _twins(corpus, graph)
    assert port.serve().maintainer is None and port.maintainer is None
    fe = port.serve(max_batch=16, maintain=PolicyConfig(observe_every=1))
    assert fe.maintainer is port.maintainer
    assert fe.maintainer.policy.observe_every == 1
    assert fe.maintainer.tick_every == port.spec.adapt_tick_every
    assert port.serve(maintain=False).maintainer is None
    m = port.attach_maintainer(PolicyConfig(), tick_every=3)
    assert port.maintainer is m and m.tick_every == 3
    assert m.mutate_lock is port._mutate_lock

    ref, port = _twins(corpus, graph)
    fes = [d.serve(max_batch=16, maintain=policy(observe_every=1))
           for d, policy in ((ref, JPolicy), (port, PolicyConfig))]
    for fe in fes:
        fe.search(queries[:20])
    got, want = port.metrics(), ref.metrics()
    for prefix in ("catapultdb_adapt_", "catapultdb_serve_"):
        names = {k for k in want if k.startswith(prefix)}
        assert names and names == {k for k in got if k.startswith(prefix)}
    for name in ("catapultdb_serve_queries", "catapultdb_serve_flushes",
                 "catapultdb_serve_batch_occupancy",
                 "catapultdb_adapt_n_queries", "catapultdb_adapt_enabled",
                 "catapultdb_search_queries_total"):
        assert got.get(name) == want.get(name), name
    assert got["catapultdb_serve_queries"] == 20
    assert got["catapultdb_serve_flushes_total"] == 1
    assert "catapultdb_serve_flush_ms" in port.metrics("prometheus")


def test_serve_and_maintainer_refusals(corpus, graph):
    _, disk = _twins(corpus, graph, mode="diskann")
    assert disk.serve().maintainer is None
    with pytest.raises(tdb.CapabilityError):
        disk.serve(maintain=PolicyConfig())
    with pytest.raises(tdb.CapabilityError):
        disk.attach_maintainer()
    # ingest is ported: the queue rides on the frontend, at the
    # IngestSpec() defaults
    from repro_torch.ingest import IngestQueue
    for q in (disk.serve(ingest=True).ingest, disk.ingest_queue()):
        assert isinstance(q, IngestQueue) and q.batch_size == 256
    with pytest.raises(ValueError, match="catapult"):
        tdb.IndexSpec(mode="diskann", adapt=PolicyConfig())
    assert tdb.IndexSpec(adapt=PolicyConfig()).adapt == PolicyConfig()


def test_create_with_adapt_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    vec = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tdb.create(tdb.IndexSpec(degree=4, build_beam=8,
                                 adapt=PolicyConfig()), vec)


def test_warm_records_each_shape(corpus, graph):
    _, port = _twins(corpus, graph)
    before = tbk.to_arrays(port.backend._cat.buckets)
    port.warm((4, 8))
    assert sorted(port.last_warm_breakdown) == [4, 8]
    m = port.metrics()
    assert m["catapultdb_warm_ms_shape_4"] == port.last_warm_breakdown[4]
    assert m["catapultdb_warm_total_ms"] == port.last_warm_ms
    assert tbk.to_arrays(port.backend._cat.buckets)["step"] == before["step"]


def test_rolling_window_matches_reference():
    ref, port = JWindow(limit=4), RollingWindow(limit=4)
    rng = np.random.default_rng(2)
    for i in range(7):
        kw = dict(queries=int(rng.integers(1, 64)),
                  occupancy=float(rng.random()), ms=float(rng.random() * 9),
                  t_end=float(i) * 0.01)
        ref.record_flush(**kw)
        port.record_flush(**kw)
        assert port.snapshot() == ref.snapshot()
    assert port.as_collector()() == ref.as_collector()()
    with pytest.raises(ValueError):
        RollingWindow(limit=0)


def test_profiler_annotations(tmp_path):
    """Off: one shared no-op context.  Inside ``profile_trace`` the kernel
    wrappers' ranges land in the written Chrome trace."""
    from repro_torch.kernels import ops
    assert not profiler.profiling_enabled()
    assert profiler.annotate("a") is profiler.annotate("b")
    q = torch.randn(16, 8)
    planes = torch.randn(4, 8)
    with profiler.profile_trace(str(tmp_path)):
        assert profiler.profiling_enabled()
        ops.lsh_hash(q, planes)
    assert not profiler.profiling_enabled()
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "repro_torch.kernels.lsh_hash" in names


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("policy", [
    dict(observe_every=2, baseline_every=3, probe_every=2, min_batches=2,
         min_base=1, gate_low=0.5, gate_high=0.05),
    dict(observe_every=1, baseline_every=4, min_batches=2)],
    ids=["gate", "shift"])
def test_chip_smoke_serve_launch_accounting(corpus, queries, graph,
                                            monkeypatch, policy):
    """``chip_smoke.serve_launches`` (what the card run holds a served
    stream's kernel counts to) against the wrapper calls of a served
    stream with catapult, shadow, gated-off, probe and folded batches;
    and ``ServeSpy``'s fold count against the telemetry's."""
    from repro_torch.kernels import ops
    smoke = _load_chip_smoke()
    port = tdb.create(tdb.IndexSpec(**SPEC, adapt=PolicyConfig(**policy),
                                    adapt_tick_every=2), corpus[0],
                      prebuilt=graph, device="cpu")
    fe = port.serve(max_batch=16)
    calls = dict.fromkeys(ops.LAUNCHES, 0)
    for name in calls:
        def wrapped(*args, _name=name, _fn=getattr(ops, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(ops, name, wrapped)
    stream = np.concatenate([queries, queries[::-1], queries])
    with smoke.ServeSpy(port.backend) as spy:
        smoke.serve_stream(fe, stream, 16)
    kinds = {(b["active"], b["enabled"], b["folded"]) for b in spy.batches}
    assert (False, True, True) in kinds          # a folded shadow batch
    if "gate_low" in policy:
        assert (False, False, False) in kinds    # gated off, no fold
        assert (True, False, True) in kinds      # a folded probe
    assert calls == smoke.serve_launches(spy.batches, "unfused")
    tel = port.backend.adapt_state
    assert int(tel.n_batches) + int(tel.n_base) == sum(
        b["folded"] for b in spy.batches)
    assert port.backend.search.__func__ is type(port.backend).search
    wins = spy.wins()
    assert wins.shape == (len(spy.batches),) and (wins >= 0).all()
