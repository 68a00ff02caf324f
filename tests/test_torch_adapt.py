"""The adapt layer: ``repro_torch.adapt`` against ``repro.adapt`` on the CPU.

Telemetry folds, the policy primitives and whole maintainer replays get
the same seeded numpy inputs in both packages; the port's engines get
the reference's graph, LSH planes and bucket tables (``convert``).
Integers (counters, bucket tables, ids, hops) must be exactly equal;
floats within rtol 1e-6 (the EWMAs and histograms come out bit-equal in
practice).  ``drift_score`` sums its 256 terms in another order than
XLA, and right after a drift flush realigns the histograms both scores
are rounding noise near 0, so it is held to rtol 1e-6 or 1e-7 absolute.
"""
from __future__ import annotations

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import db as jdb
from repro.adapt import policy as jpol
from repro.adapt import stats as jts
from repro.core import buckets as jbk
from repro.core import lsh as jlsh_mod
from repro.data import workloads as jwl
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.adapt import CatapultMaintainer
from repro_torch.adapt import policy as tpol
from repro_torch.adapt import stats as tts
from repro_torch.core import buckets as tbk
from repro_torch.core import lsh as tlsh
from repro_torch.data import workloads as twl

SPEC = dict(degree=16, build_beam=32, n_bits=4, bucket_capacity=8)
NB = 256
RTOL = 1e-6
DRIFT_ATOL = 1e-7


@pytest.fixture
def graph(diskann_engine):
    return diskann_engine._adj_np, diskann_engine.medoid


def _twins(corpus, graph, mode="catapult"):
    """A reference database and a port database (CPU) over one graph,
    with the reference's LSH planes and bucket tables in the port."""
    ref = jdb.create(jdb.IndexSpec(mode=mode, **SPEC), corpus[0],
                     prebuilt=graph)
    port = tdb.create(tdb.IndexSpec(mode=mode, **SPEC), corpus[0],
                      prebuilt=graph, device="cpu")
    if mode == "catapult":
        _transplant_cat(ref, port)
    return ref, port


def _transplant_cat(ref, port):
    cat = ref.backend._cat
    port.backend._cat = convert.catapult_state_from_numpy(
        np.asarray(cat.lsh.hyperplanes), jbk.to_arrays(cat.buckets),
        device="cpu")


def _assert_telemetry_equal(port_state, ref_state, where=""):
    for f in dataclasses.fields(jts.TelemetryState):
        want = np.asarray(getattr(ref_state, f.name))
        got = getattr(port_state, f.name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f"{f.name} {where}")
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                       err_msg=f"{f.name} {where}")


def _assert_buckets_equal(port_buckets, ref_buckets, where=""):
    want = jbk.to_arrays(ref_buckets)
    got = tbk.to_arrays(port_buckets)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{name} {where}")


def _assert_snapshot_equal(got: dict, want: dict, where=""):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float):
            atol = DRIFT_ATOL if key == "drift" else 0
            assert g == pytest.approx(w, rel=RTOL, abs=atol), (key, where)
        else:
            assert type(g) is type(w) and g == w, (key, g, w, where)


def _rand_batches(seed: int, n_batches: int, b: int = 32):
    """(hashes, used, won, hops, real) batches over NB buckets."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield (rng.integers(0, NB, b).astype(np.int32),
               rng.random(b) < 0.7, rng.random(b) < 0.4,
               rng.integers(5, 30, b).astype(np.float32),
               rng.random(b) < 0.9)


# --------------------------------------------------------------- telemetry
@pytest.mark.parametrize("alpha,fast,slow", [
    (tts.WIN_ALPHA, tts.FAST_DECAY, tts.SLOW_DECAY), (0.13, 0.31, 0.017)])
def test_update_telemetry_matches_jax(alpha, fast, slow):
    """A stream of catapult, shadow (baseline) and all-padding batches:
    every field after every batch, and the drift score."""
    kw = dict(win_alpha=alpha, fast_decay=fast, slow_decay=slow)
    ref, port = jts.init_telemetry(NB), tts.init_telemetry(NB, "cpu")
    for i, (h, used, won, hops, real) in enumerate(_rand_batches(3, 60)):
        if i == 5:
            real = np.zeros_like(real)
        base = i % 7 == 3
        ref = jts.update_telemetry(ref, jnp.asarray(h), jnp.asarray(used),
                                   jnp.asarray(won), jnp.asarray(hops),
                                   jnp.asarray(real), baseline=base, **kw)
        port = tts.update_telemetry(port, h, used, won, hops, real,
                                    baseline=base, **kw)
        _assert_telemetry_equal(port, ref, f"batch {i}")
        assert float(tts.drift_score(port)) == pytest.approx(
            float(jts.drift_score(ref)), rel=RTOL, abs=DRIFT_ATOL)
        assert tts.hop_saving(port) == pytest.approx(jts.hop_saving(ref),
                                                     rel=RTOL)
    assert int(port.n_base) > 0 and int(port.n_batches) > 0
    assert float(tts.drift_score(tts.init_telemetry(NB, "cpu"))) == 0.0


def test_observe_update_matches_jax():
    """The serving-path fold hashes through the port's ``lsh_hash`` (its
    plain version on the CPU) with the reference's planes."""
    rng = np.random.default_rng(0)
    planes = rng.normal(size=(8, 24)).astype(np.float32)
    jlsh = jlsh_mod.LSHParams(jnp.asarray(planes))
    plsh = tlsh.LSHParams(torch.as_tensor(planes))
    ref, port = jts.init_telemetry(NB), tts.init_telemetry(NB, "cpu")
    for i in range(12):
        q = (rng.normal(size=(48, 24)) * (1 + i % 3)).astype(np.float32)
        used, won = rng.random(48) < 0.8, rng.random(48) < 0.5
        hops = rng.integers(3, 40, 48).astype(np.float32)
        real = np.arange(48) < 40 + i % 9
        base = i % 4 == 2
        ref = jts.observe_update(ref, jlsh, q, used, won, hops, real,
                                 baseline=base)
        port = tts.observe_update(port, plsh, torch.as_tensor(q),
                                  torch.as_tensor(used), torch.as_tensor(won),
                                  torch.as_tensor(hops),
                                  torch.as_tensor(real), baseline=base)
        _assert_telemetry_equal(port, ref, f"batch {i}")
    np.testing.assert_array_equal(tts.hot_buckets(port, 8),
                                  jts.hot_buckets(ref, 8))


def test_telemetry_arrays_roundtrip_across_packages():
    """``telemetry_to_arrays`` output crosses in both directions with
    the same dtypes and bytes."""
    ref = jts.init_telemetry(NB)
    for h, used, won, hops, real in _rand_batches(5, 7):
        ref = jts.update_telemetry(ref, jnp.asarray(h), jnp.asarray(used),
                                   jnp.asarray(won), jnp.asarray(hops),
                                   jnp.asarray(real))
    arrays = jts.telemetry_to_arrays(ref)
    port = convert.telemetry_from_numpy(arrays, device="cpu")
    back = tts.telemetry_to_arrays(port)
    assert back.keys() == arrays.keys()
    for name, a in arrays.items():
        assert back[name].dtype == a.dtype and back[name].tobytes() == \
            a.tobytes(), name
    again = jts.telemetry_to_arrays(jts.telemetry_from_arrays(back))
    for name, a in arrays.items():
        assert again[name].tobytes() == a.tobytes(), name
    assert tts.telemetry_from_arrays({}, device="cpu") is None
    with pytest.raises(KeyError):
        convert.telemetry_from_numpy({}, device="cpu")


# ------------------------------------------------------------------ policy
def _published(n_buckets, cap, rng):
    """The same bucket table in both packages after seeded publishes."""
    ref = jbk.make_buckets(n_buckets, cap)
    port = tbk.make_buckets(n_buckets, cap, device="cpu")
    for _ in range(6):
        h = rng.integers(0, n_buckets, 24).astype(np.int32)
        d = rng.integers(-1, 500, 24).astype(np.int32)
        t = np.full(24, -1, np.int32)
        ref = jbk.publish(ref, jnp.asarray(h), jnp.asarray(d), jnp.asarray(t))
        port = tbk.publish(port, torch.as_tensor(h), torch.as_tensor(d),
                           torch.as_tensor(t))
    return ref, port


@pytest.mark.parametrize("ttl", [0, 1, 20, 60, 500])
def test_ttl_evict_matches_jax(ttl):
    ref, port = _published(16, 6, np.random.default_rng(ttl))
    _assert_buckets_equal(port, ref)
    r_out, r_n = jpol.ttl_evict(ref, ttl)
    p_out, p_n = tpol.ttl_evict(port, ttl)
    assert p_n == r_n and isinstance(p_n, int)
    _assert_buckets_equal(p_out, r_out, f"ttl {ttl}")
    if ttl == 0:
        assert p_out is port and p_n == 0


@pytest.mark.parametrize("shift", [0, 3, 40])
def test_drift_flush_matches_jax(shift):
    """Telemetry built from the same stream, with its hot set moved by
    ``shift`` buckets halfway: score, regions, flushed entries."""
    rng = np.random.default_rng(shift)
    ref_b, port_b = _published(64, 4, rng)
    ref_t, port_t = jts.init_telemetry(64), tts.init_telemetry(64, "cpu")
    on = np.ones(32, bool)
    for i in range(30):
        h = ((np.arange(32) % 8) + (shift if i >= 20 else 0)).astype(
            np.int32) % 64
        hops = np.full(32, 10, np.float32)
        ref_t = jts.update_telemetry(ref_t, jnp.asarray(h), jnp.asarray(on),
                                     jnp.asarray(on), jnp.asarray(hops),
                                     jnp.asarray(on))
        port_t = tts.update_telemetry(port_t, h, on, on, hops, on)
    cfg_r, cfg_p = jpol.PolicyConfig(), tpol.PolicyConfig()
    np.testing.assert_array_equal(
        tpol.drift_regions(port_t, cfg_p.region_threshold),
        jpol.drift_regions(ref_t, cfg_r.region_threshold))
    r_out, r_n, r_trig = jpol.drift_flush(ref_b, ref_t, cfg_r)
    p_out, p_n, p_trig = tpol.drift_flush(port_b, port_t, cfg_p)
    assert (p_n, p_trig) == (r_n, r_trig)
    assert p_trig == (shift == 40)
    _assert_buckets_equal(p_out, r_out)
    np.testing.assert_array_equal(tpol.hot_destinations(p_out, port_t, 4),
                                  jpol.hot_destinations(r_out, ref_t, 4))


def test_policy_config_and_gate_decision_match_jax():
    assert dataclasses.asdict(tpol.PolicyConfig()) == dataclasses.asdict(
        jpol.PolicyConfig())
    cfgs = [(jpol.PolicyConfig(**kw), tpol.PolicyConfig(**kw)) for kw in (
        {}, dict(gate_low=0.04, gate_high=0.08, min_batches=2, min_base=1))]
    for (cr, cp) in cfgs:
        for saving in (None, -0.5, 0.0, 0.01, 0.04, 0.06, 0.08, 0.09, 0.5):
            for enabled in (True, False):
                for nb, nbase in ((0, 0), (1, 1), (2, 1), (9, 9)):
                    assert tpol.gate_decision(saving, enabled, cp, nb, nbase) \
                        == jpol.gate_decision(saving, enabled, cr, nb, nbase)


# -------------------------------------------------------------- maintainer
def _stream(centers, seed=11, b=32):
    """Region A, then a sudden shift to region B, then uniform traffic,
    then B again: catapult, shadow, drift and gate events."""
    rng = np.random.default_rng(seed)
    d = centers.shape[1]

    def around(cs):
        return (centers[rng.choice(cs, b)]
                + 0.4 * rng.normal(size=(b, d))).astype(np.float32)
    return ([around([0, 1, 2]) for _ in range(8)]
            + [around([6, 7, 8]) for _ in range(8)]
            + [(rng.uniform(-1, 1, (b, d)) * 12).astype(np.float32)
               for _ in range(6)]
            + [around([6, 7, 8]) for _ in range(4)])


# "drift": TTL evictions, shadows and drift flushes at the default gate;
# "gate": a gate that closes at the measured saving (~0.07 here) and a
# probe threshold below it, so it reopens and closes again
POLICIES = {
    "drift": dict(observe_every=2, baseline_every=3, probe_every=2,
                  min_batches=2, min_base=1, ttl_steps=96, fast_decay=0.4),
    "gate": dict(observe_every=2, baseline_every=3, probe_every=2,
                 min_batches=2, min_base=1, gate_low=0.08, gate_high=0.05),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_maintainer_replay_matches_jax(corpus, graph, policy):
    """The reference's and the port's maintainers over twin engines,
    batch by batch: dispatch path, ids, hops, every snapshot and the
    bucket table after every batch (so after every tick).  Halfway, a
    third twin takes the reference maintainer's state (buckets,
    telemetry, counters) through ``convert`` and must follow it too."""
    kw = POLICIES[policy]
    ref, port = _twins(corpus, graph)
    rm = ref.attach_maintainer(jpol.PolicyConfig(**kw), tick_every=2)
    pm = port.attach_maintainer(tpol.PolicyConfig(**kw), tick_every=2)
    assert isinstance(pm, CatapultMaintainer) and port.maintainer is pm
    twins = [(port, pm)]
    stream = _stream(corpus[1])
    for i, q in enumerate(stream):
        if i == len(stream) // 2:
            late = tdb.create(tdb.IndexSpec(**SPEC), corpus[0],
                              prebuilt=graph, device="cpu")
            _transplant_cat(ref, late)
            lm = late.attach_maintainer(tpol.PolicyConfig(**kw),
                                        tick_every=2)
            late.backend.adapt_state = convert.telemetry_from_numpy(
                jts.telemetry_to_arrays(ref.backend.adapt_state),
                device="cpu")
            convert.set_maintainer_counters(lm,
                                            convert.maintainer_counters(rm))
            twins.append((late, lm))
        active = ref.backend.catapult_active
        r = ref.search(q, k=10)
        rm.observe(q, r.stats)
        want = rm.snapshot()
        for t, (d, m) in enumerate(twins):
            where = f"batch {i}, twin {t}"
            assert d.backend.catapult_active == active, where
            p = d.search(q, k=10)
            np.testing.assert_array_equal(p.ids, r.ids, err_msg=where)
            for fld in ("hops", "ndists", "used", "won"):
                np.testing.assert_array_equal(getattr(p.stats, fld),
                                              getattr(r.stats, fld),
                                              err_msg=f"{fld} {where}")
            m.observe(q, p.stats)
            _assert_snapshot_equal(m.snapshot(), want, where)
            _assert_buckets_equal(d.backend._cat.buckets,
                                  ref.backend._cat.buckets, where)
            _assert_telemetry_equal(d.backend.adapt_state,
                                    ref.backend.adapt_state, where)
            assert (d.backend.catapult_enabled, d.backend.catapult_override) \
                == (ref.backend.catapult_enabled,
                    ref.backend.catapult_override), where
    assert len(pm.history) == len(rm.history) == rm.ticks
    for got, want in zip(pm.history, rm.history):
        _assert_snapshot_equal(got, want)
    s = pm.snapshot()
    assert s["shadows"] > 0 and s["ticks"] > 0
    if policy == "drift":
        assert s["drift_flushes"] > 0 and s["ttl_evicted"] > 0
        assert s["flushed_entries"] > 0
    else:
        assert s["probes"] > 0 and s["gate_transitions"] >= 2


def test_gated_off_engine_runs_the_diskann_path(corpus, graph, queries,
                                                monkeypatch):
    """A gated-off catapult engine returns exactly a diskann engine's
    ids, dists and hops, calls exactly its kernel wrappers (no route
    ``lsh_hash``) and publishes nothing; the reference's gated engine
    returns the same."""
    from repro_torch.kernels import ops
    ref, port = _twins(corpus, graph)
    _, disk = _twins(corpus, graph, mode="diskann")
    ref.backend.catapult_enabled = port.backend.catapult_enabled = False
    before = tbk.to_arrays(port.backend._cat.buckets)
    calls = {}
    for name in ops.LAUNCHES:
        def wrapped(*args, _name=name, _fn=getattr(ops, name)):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(ops, name, wrapped)
    out = {}
    for tag, d in (("gated", port), ("diskann", disk)):
        calls.clear()
        out[tag] = d.search(queries[:32], k=10), dict(calls)
    (g, g_calls), (k, k_calls) = out["gated"], out["diskann"]
    assert g_calls == k_calls and "lsh_hash" not in g_calls
    np.testing.assert_array_equal(g.ids, k.ids)
    np.testing.assert_array_equal(g.dists, k.dists)
    np.testing.assert_array_equal(g.stats.hops, k.stats.hops)
    assert not g.stats.used.any() and not g.stats.won.any()
    r = ref.search(queries[:32], k=10)
    np.testing.assert_array_equal(g.ids, r.ids)
    np.testing.assert_array_equal(g.stats.hops, r.stats.hops)
    after = tbk.to_arrays(port.backend._cat.buckets)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name])
    port.backend.catapult_override = True        # a probe batch
    assert port.backend.catapult_active
    port.search(queries[:32], k=10)
    assert tbk.to_arrays(port.backend._cat.buckets)["step"] > before["step"]


def test_maintainer_needs_a_catapult_engine(corpus, graph):
    _, disk = _twins(corpus, graph, mode="diskann")
    with pytest.raises(ValueError, match="catapult"):
        CatapultMaintainer(disk.backend)
    with pytest.raises(tdb.CapabilityError):
        disk.attach_maintainer()


def test_background_ticks_race_searches_safely(corpus, graph, queries):
    """Ticks on the maintainer's thread (every millisecond, with a short
    switch interval) while this thread searches and observes: no error,
    ticks happen, ``stop`` joins, and the bucket table stays well formed
    (an entry's id and stamp are empty together, an empty slot has no
    tag, no stamp is ahead of the clock)."""
    _, port = _twins(corpus, graph)
    m = port.attach_maintainer(tpol.PolicyConfig(ttl_steps=64,
                                                 observe_every=1),
                               tick_every=0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        m.start(interval=0.001)
        for lo in range(0, 96, 8):
            q = queries[lo: lo + 8]
            m.observe(q, port.search(q, k=5).stats)
        thread = m._thread
        m.stop()
    finally:
        sys.setswitchinterval(old)
    thread.join(timeout=10)
    assert not thread.is_alive() and m._thread is None
    assert m.ticks > 0
    b = tbk.to_arrays(port.backend._cat.buckets)
    empty = b["ids"] < 0
    assert np.array_equal(empty, b["stamp"] < 0)
    assert (b["tag"][empty] < 0).all() and (b["stamp"] < b["step"]).all()
    assert int(port.backend.adapt_state.n_queries) == 96


# --------------------------------------------------------------- workloads
@pytest.mark.parametrize("name,kw", [
    ("make_medrag_zipf", dict(n=600, n_queries=128)),
    ("make_shifted_zipf", dict(n=600, n_queries=128, kind="sudden")),
    ("make_shifted_zipf", dict(n=600, n_queries=128, kind="gradual")),
    ("make_shifted_zipf", dict(n=600, n_queries=128, kind="flipflop")),
    ("make_uniform", dict(n=600, n_queries=128))])
def test_workload_generators_match_reference(name, kw):
    want, got = getattr(jwl, name)(**kw), getattr(twl, name)(**kw)
    assert got.name == want.name and got.meta == want.meta
    for fld in ("corpus", "queries"):
        a, b = getattr(got, fld), getattr(want, fld)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), fld


def test_maintainer_background_consolidate_matches_jax(corpus, graph):
    """``consolidate_threshold``: a tick past it consolidates once (under
    the database's mutate lock), a tick at the same tombstone fraction
    does not again, and the graph after it equals the reference's."""
    ref, port = _twins(corpus, graph)
    rng = np.random.default_rng(9)
    dead = rng.choice(corpus[0].shape[0], 60, replace=False)
    ms = []
    for d, cfg in ((ref, jpol.PolicyConfig()), (port, tpol.PolicyConfig())):
        d.delete(dead)
        m = type(d.attach_maintainer())(d.backend, cfg, tick_every=0,
                                        consolidate_threshold=0.03,
                                        mutate_lock=d._mutate_lock)
        m.tick()
        m.tick()
        ms.append(m)
    assert ms[1].consolidations == ms[0].consolidations == 1
    np.testing.assert_array_equal(port.backend._adj_np, ref.backend._adj_np)
    assert not np.isin(port.backend._adj_np[~port.backend._tomb_np],
                       dead).any()
