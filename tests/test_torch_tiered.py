"""The hot/cold tiered tier: ``repro_torch.tiered`` against the reference
on the CPU.

Twins open one layout written by either package (``tiered.json``, the
cold ``cold.ctpl`` or ``cold.d/`` shards, ``hot.npz``).  The cold tier's
LSH planes are transplanted from the reference
(``convert.catapult_state_from_numpy``; the packages draw them
differently), and so is the hot RAM graph whenever either package
(re)builds it: the hot build is a Vamana build, which agrees across the
packages on >= 99% of rows, not all.  With the same planes and the same
hot graph, after every search, observe and maintainer tick the merged
ids, hot hits, ``tier_stats()`` counters, the hot gid sets (what was
promoted and demoted) and the cold block reads are equal, and the
merged distances within rtol 1e-6 (the hot tier scores at full
precision, where XLA and torch sum in their own order).

The reference's own claims hold in the port: ids are stable across
promotion and demotion, and promotions cut cold block reads against a
frozen hot set.  The corpus is ``tests/test_tiered.py``'s: 900 x 16 with
all traffic on one cluster.  Every test closes what it opens.
"""
from __future__ import annotations

import shutil
import zipfile

import numpy as np
import pytest

from repro import db as jdb
from repro.adapt import PolicyConfig as JPolicy
from repro.core import buckets as jbk
from repro.db.spec import TieredSpec as JTiered
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.adapt import PolicyConfig
from repro_torch.core import buckets as tbk
from repro_torch.tiered import TieredMaintainer

from conftest import make_clustered

SPEC = dict(degree=16, build_beam=32, build_batch=512, seed=0,
            cache_frames=64, n_bits=4, bucket_capacity=8)
TIERED = dict(hot_fraction=0.05, promote_top=8, demote_after=1)
ADAPT = dict(observe_every=1, baseline_every=3, min_batches=2, min_base=1,
             ttl_steps=96)


@pytest.fixture(scope="module")
def biased_world():
    data, centers, assign = make_clustered(900, 16, 12, seed=31)
    rng = np.random.default_rng(32)
    hot = (centers[4]
           + 0.25 * rng.normal(size=(64, 16))).astype(np.float32)
    scan = data[rng.choice(900, 48, replace=False)]
    return data, hot, scan, (assign % 3).astype(np.int32)


@pytest.fixture
def opened():
    dbs = []
    yield dbs
    for d in dbs:
        d.close()


# ------------------------------------------------------------------ spec

@pytest.mark.parametrize("kw", [
    dict(hot_fraction=0.0), dict(hot_fraction=1.5), dict(hot_capacity=0),
    dict(cold_tier="ram"), dict(promote_top=0), dict(demote_after=0)])
def test_tiered_spec_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        JTiered(**kw)
    with pytest.raises(ValueError) as got:
        tdb.TieredSpec(**kw)
    assert str(got.value) == str(want.value)


def test_tiered_spec_round_trip_and_index_spec_rules():
    cfg = tdb.TieredSpec(hot_fraction=0.2, cold_tier="sharded",
                         demote_after=3)
    assert tdb.TieredSpec.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict() == JTiered(hot_fraction=0.2, cold_tier="sharded",
                                    demote_after=3).to_dict()
    for pkg in (jdb, tdb):
        with pytest.raises(ValueError):
            pkg.IndexSpec(tier="tiered", path="x.d", tiered="not-a-spec")
        with pytest.raises(ValueError):
            pkg.IndexSpec(tier="tiered")           # needs a path
    spec = tdb.IndexSpec(tier="tiered", path="x.d", tiered=cfg)
    assert spec.tiered is cfg


# ---------------------------------------------------------------- parity

def _transplant_cold(ref, port):
    for js, ts in zip(ref.backend.shards, port.backend.shards):
        ts._cat = convert.catapult_state_from_numpy(
            np.asarray(js._cat.lsh.hyperplanes),
            jbk.to_arrays(js._cat.buckets), device="cpu")


def _transplant_hot(ref, port):
    """The reference's hot graph into the port's hot engine (same gid
    set, so the same rows in the same slots)."""
    jh, th = ref.backend.hot, port.backend.hot
    np.testing.assert_array_equal(port.backend._hot_gid,
                                  ref.backend._hot_gid)
    if jh is None:
        assert th is None
        return
    np.testing.assert_array_equal(th._vec_np, np.asarray(jh._vec_np))
    th._adj_np[:] = np.asarray(jh._adj_np)
    th._adj = th._upload(th._adj_np)
    th.medoid = int(jh.medoid)


def _twins(tmp_path, world, opened, built_by="ref", cold_tier="disk",
           filtered=False):
    data, _, _, labels = world
    kw = dict(tier="tiered", mode="catapult", n_shards=2, filters=filtered,
              **SPEC)
    lab = labels if filtered else None
    paths = {"ref": str(tmp_path / "ref.d"), "port": str(tmp_path / "port.d")}
    jspec = jdb.IndexSpec(path=paths["ref"], adapt=JPolicy(**ADAPT),
                          tiered=JTiered(cold_tier=cold_tier, **TIERED), **kw)
    tspec = tdb.IndexSpec(path=paths["port"], adapt=PolicyConfig(**ADAPT),
                          tiered=tdb.TieredSpec(cold_tier=cold_tier,
                                                **TIERED), **kw)
    if built_by == "ref":
        ref = jdb.create(jspec, data, lab)
        opened.append(ref)
        shutil.copytree(paths["ref"], paths["port"])
        port = tdb.open(paths["port"], spec=tspec, device="cpu")
        opened.append(port)
    else:
        port = tdb.create(tspec, data, lab, device="cpu")
        opened.append(port)
        shutil.copytree(paths["port"], paths["ref"])
        ref = jdb.open(paths["ref"], spec=jspec)
        opened.append(ref)
    _transplant_cold(ref, port)
    _transplant_hot(ref, port)
    return ref, port


def _same_state(ref, port, where):
    jb, tb = ref.backend, port.backend
    assert tb.tier_stats() == jb.tier_stats(), where
    np.testing.assert_array_equal(tb._hot_live_gids(), jb._hot_live_gids(),
                                  err_msg=where)
    assert tb._hot_stale == jb._hot_stale, where
    for js, ts in zip(jb.shards, tb.shards):
        want, got = jbk.to_arrays(js._cat.buckets), tbk.to_arrays(
            ts._cat.buckets)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{name} {where}")


def _same_search(ref, port, q, where, **kw):
    r, p = ref.search(q, **kw), port.search(q, **kw)
    np.testing.assert_array_equal(p.ids, r.ids, err_msg=where)
    np.testing.assert_allclose(p.dists, np.asarray(r.dists), rtol=1e-6,
                               err_msg=where)
    for fld in ("hops", "ndists", "used", "won", "block_reads",
                "cache_hits"):
        np.testing.assert_array_equal(getattr(p.stats, fld),
                                      getattr(r.stats, fld),
                                      err_msg=f"{fld} {where}")
    return r, p


def _drive(ref, port, world, rounds=2, filtered=False):
    """Search / observe / tick in lockstep (the hot graph transplanted
    after every rebuild); state equal after every step."""
    _, hot, scan, _ = world
    ms = [ref.attach_maintainer(), port.attach_maintainer()]
    assert isinstance(ms[1], TieredMaintainer)
    assert len(ms[1]._units) == len(ms[0]._units) == len(ref.backend.shards)
    fl = ((np.arange(32) % 4) - 1).astype(np.int32) if filtered else None
    for rnd in range(rounds):
        for lo in (0, 32):
            q = hot[lo: lo + 32]
            r, p = _same_search(ref, port, q, f"round {rnd} batch {lo}",
                                k=5, beam_width=16, filter_labels=fl)
            ms[0].observe(q, r.stats)
            ms[1].observe(q, p.stats)
            _same_state(ref, port, f"observe {rnd}/{lo}")
        rebuilds = port.backend.hot_rebuilds
        for m in ms:
            m.tick()
        if port.backend.hot_rebuilds != rebuilds:
            _transplant_hot(ref, port)
        _same_state(ref, port, f"tick {rnd}")
        assert ms[1].snapshot()["promotions"] == \
            ms[0].snapshot()["promotions"]
        _same_search(ref, port, scan[:24], f"scan {rnd}", k=5, beam_width=16)
    assert tuple(port.io_stats()) == tuple(ref.io_stats())
    return ms


@pytest.mark.parametrize("built_by,cold_tier", [
    ("ref", "disk"), ("port", "disk"), ("ref", "sharded")])
def test_rebalances_match_reference(tmp_path, biased_world, opened,
                                    built_by, cold_tier):
    ref, port = _twins(tmp_path, biased_world, opened, built_by, cold_tier)
    assert port.caps == ref.caps
    assert port.caps.host_views == (cold_tier == "disk")
    _drive(ref, port, biased_world)
    assert port.backend.promotions > 0
    # deletes fan to both tiers: a resident hot row leaves the
    # indirection at once; consolidate rebuilds the hot engine
    dead = port.backend._hot_live_gids()[:3]
    for d in (ref, port):
        d.delete(np.concatenate([dead, [-1]]))
    _same_state(ref, port, "delete")
    _same_search(ref, port, biased_world[1][:32], "after delete", k=5,
                 beam_width=16)
    for d in (ref, port):
        d.consolidate()
    _transplant_hot(ref, port)
    _same_state(ref, port, "consolidate")
    _same_search(ref, port, biased_world[1][:32], "after consolidate", k=5,
                 beam_width=16)


def test_filtered_hot_tier_post_filters_like_reference(tmp_path,
                                                       biased_world, opened):
    ref, port = _twins(tmp_path, biased_world, opened, "port",
                       filtered=True)
    _drive(ref, port, biased_world, rounds=1, filtered=True)
    labels = biased_world[3]
    fl = ((np.arange(32) % 4) - 1).astype(np.int32)
    ids = port.search(biased_world[1][:32], k=5, filter_labels=fl).ids
    lane = np.broadcast_to(fl[:, None], ids.shape)
    bad = (ids >= 0) & (lane >= 0) & (labels[np.maximum(ids, 0)] != lane)
    assert not bad.any()


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return [(name, z.read(name)) for name in z.namelist()]


@pytest.mark.parametrize("saved_by", ["ref", "port"])
def test_saved_layout_resumes_in_the_other_package(tmp_path, biased_world,
                                                   opened, saved_by):
    """After lockstep traffic both save; the files are the reference's
    (manifest text, ``hot.npz`` members, the cold store), and the other
    package opening the saver's copy resumes the same hot gid set,
    staleness and counters, and answers like the saver."""
    ref, port = _twins(tmp_path, biased_world, opened)
    _drive(ref, port, biased_world, rounds=1)
    for d in (ref, port):
        d.save()
    _transplant_hot(ref, port)
    assert (tmp_path / "port.d" / "tiered.json").read_text() == \
        (tmp_path / "ref.d" / "tiered.json").read_text()
    assert _npz_members(tmp_path / "port.d" / "hot.npz") == \
        _npz_members(tmp_path / "ref.d" / "hot.npz")
    for f in ("cold.ctpl", "cold.ctpl.io.json"):
        assert (tmp_path / "port.d" / f).read_bytes() == \
            (tmp_path / "ref.d" / f).read_bytes(), f
    shutil.copytree(tmp_path / f"{saved_by}.d", tmp_path / "copy.d")
    if saved_by == "ref":
        other = tdb.open(str(tmp_path / "copy.d"), device="cpu",
                         spec=tdb.IndexSpec(**SPEC))
        opened.append(other)
        _transplant_cold(ref, other)
        _transplant_hot(ref, other)
        jb, tb, pair = ref.backend, other.backend, (ref, other)
    else:
        other = jdb.open(str(tmp_path / "copy.d"),
                         spec=jdb.IndexSpec(**SPEC))
        opened.append(other)
        _transplant_hot(other, port)
        jb, tb, pair = other.backend, port.backend, (other, port)
    assert other.caps.tier == "tiered"
    np.testing.assert_array_equal(tb._hot_live_gids(), jb._hot_live_gids())
    assert tb._hot_stale == jb._hot_stale
    for key in ("promotions", "demotions", "hot_rebuilds", "rebalances",
                "hot_rows", "hot_capacity"):
        assert tb.tier_stats()[key] == jb.tier_stats()[key], key
    r, p = (d.search(biased_world[1][:32], k=5, beam_width=16,
                     publish=False) for d in pair)
    np.testing.assert_array_equal(p.ids, r.ids)


# ------------------------------------------------- the reference's claims

def _port(tmp_path, world, name, frames=64, **tiered):
    spec = tdb.IndexSpec(tier="tiered", path=str(tmp_path / name),
                         **{**SPEC, "cache_frames": frames},
                         tiered=tdb.TieredSpec(**tiered))
    return tdb.create(spec, world[0], device="cpu")


@pytest.fixture(scope="module")
def small_world():
    """``tests/test_tiered.py``'s facade corpus: 400 x 8."""
    return make_clustered(400, 8, 4, seed=33)


def test_ids_stable_across_promotion_and_demotion(tmp_path, biased_world,
                                                  opened):
    """Global ids never change when rows move between tiers: a resident
    hot copy is its cold row, and the answers to the same queries are
    the same ids at the same distances across rebalances that promoted
    and demoted rows."""
    data, hot, _, _ = biased_world
    db = _port(tmp_path, biased_world, "t.d", **TIERED)
    opened.append(db)
    ids0 = db.search(hot, k=5, beam_width=16, publish=False)
    m = db.attach_maintainer()
    eng = db.backend
    for _ in range(6):
        st = db.search(hot, k=5, beam_width=16).stats
        m.observe(hot, st)
        m.tick()
    assert eng.promotions > 0 and eng.demotions > 0
    live = eng._hot_gid >= 0
    np.testing.assert_array_equal(eng.hot._vec_np[: live.size][live],
                                  data[eng._hot_gid[live]])
    ids1 = db.search(hot, k=5, beam_width=16, publish=False)
    for r in (ids0, ids1):
        d = ((data[np.maximum(r.ids, 0)] - hot[:, None]) ** 2).sum(-1)
        np.testing.assert_allclose(r.dists, d, rtol=1e-5)
    np.testing.assert_array_equal(ids1.ids, ids0.ids)


def test_promotions_cut_cold_block_reads_vs_frozen_hot_set(tmp_path,
                                                           biased_world,
                                                           opened):
    """After the maintainer promotes the measured hot region (and
    tier-pins it in the cold cache), cold block reads a query drop below
    a twin whose hot set stays frozen at its build-time sample, under
    the same scan co-traffic."""
    _, hot, scan, _ = biased_world
    frozen = _port(tmp_path, biased_world, "frozen.d", hot_fraction=0.06,
                   promote_top=12, demote_after=1)
    adaptive = _port(tmp_path, biased_world, "adapt.d", hot_fraction=0.06,
                     promote_top=12, demote_after=1)
    opened.extend([frozen, adaptive])
    m = adaptive.attach_maintainer()
    for db, maint in ((frozen, None), (adaptive, m)):
        for _ in range(4):
            st = db.search(hot, k=5, beam_width=16).stats
            if maint is not None:
                maint.observe(hot, st)
                maint.tick()
    assert adaptive.backend.promotions > 0
    reads = {}
    for name, db in (("frozen", frozen), ("adaptive", adaptive)):
        total = 0
        for _ in range(3):
            db.search(scan, k=5, beam_width=16)
            before = db.io_stats().block_reads
            db.search(hot, k=5, beam_width=16)
            total += db.io_stats().block_reads - before
        reads[name] = total / (3 * hot.shape[0])
    assert reads["adaptive"] < reads["frozen"], reads


# ---------------------------------------------------------------- facade

def test_sniff_prefers_tiered_manifest_over_nested_sharded(tmp_path,
                                                           small_world,
                                                           opened):
    """A tiered layout over a sharded cold tier contains a sharded
    manifest; ``sniff`` says tiered in both packages and ``open``
    reassembles the whole stack."""
    db = _port(tmp_path, small_world, "ts.d", hot_fraction=0.1,
               cold_tier="sharded")
    db.save()
    db.close()
    path = str(tmp_path / "ts.d")
    assert tdb.sniff(path) == jdb.sniff(path) == ("tiered", 1)
    assert tdb.sniff(path + "/cold.d") == jdb.sniff(path + "/cold.d")
    back = tdb.open(path, device="cpu")
    opened.append(back)
    assert back.caps.tier == "tiered" and not back.caps.host_views
    assert back.spec.tiered.cold_tier == "sharded"
    assert back.spec.n_shards == 2 and back.dim == 8


def test_facade_metrics_caps_and_refusals(tmp_path, small_world, opened):
    """Host views on a single-store cold tier and their refusal (naming
    'tiered') on a sharded one; ``metrics()`` carries ``tier_stats()``
    as ``catapultdb_tier_*``; ``serve()`` with an adapt policy attaches a
    ``TieredMaintainer``; ``prebuilt`` is refused."""
    data = small_world[0]
    queries = data[:20] + 0.1
    td = _port(tmp_path, small_world, "cd.d")
    opened.append(td)
    assert td.caps.host_views and td.vectors.shape[0] == td.n_active == 400
    td.search(queries, k=5)
    got = td.metrics()
    for key, v in td.backend.tier_stats().items():
        assert got[f"catapultdb_tier_{key}"] == float(v)
    sh = _port(tmp_path, small_world, "cs.d", cold_tier="sharded")
    opened.append(sh)
    with pytest.raises(tdb.CapabilityError, match="'tiered'"):
        sh.vectors
    with pytest.raises(tdb.CapabilityError, match="'tiered'"):
        sh.tombstones
    served = tdb.open(str(tmp_path / "cd.d"), spec=tdb.IndexSpec(
        adapt=PolicyConfig(**ADAPT)), device="cpu")
    opened.append(served)
    fe = served.serve(max_batch=16, k=5)
    assert isinstance(fe.maintainer, TieredMaintainer)
    for q in queries:
        fe.submit(q)
    assert len(fe.flush()) == 20
    assert served.maintainer.snapshot()["hot_capacity"] == 40   # 0.1 x 400
    spec = tdb.IndexSpec(tier="tiered", path=str(tmp_path / "x.d"), **SPEC)
    with pytest.raises(ValueError, match="single-store only"):
        tdb.create(spec, data, prebuilt=(np.zeros((400, 4), np.int32), 0),
                   device="cpu")


# ------------------------------------------------- chip_smoke accounting

@pytest.mark.parametrize("cold_tier,hop_backend", [("disk", "unfused"),
                                                   ("sharded", "fused")])
def test_chip_smoke_tiered_launch_accounting(tmp_path, biased_world, opened,
                                             monkeypatch, cold_tier,
                                             hop_backend):
    """What the card run holds a tiered replay to (``chip_smoke.
    tiered_replay`` under ``PathSpy`` and ``check_tiered_launches``):
    cold unit searches at the disk formula, hot searches at the RAM
    diskann one, one ``lsh_hash`` a fold, and ticks whose hot inserts
    and rebuilds launch ``gather_distance`` alone — against the wrapper
    calls on the CPU."""
    from test_torch_sharded import _count_cpu_calls, _load_chip_smoke
    smoke = _load_chip_smoke()
    data, hot, _, _ = biased_world
    spec = tdb.IndexSpec(tier="tiered", path=str(tmp_path / "t.d"),
                         hop_backend=hop_backend, n_shards=2,
                         **SPEC, tiered=tdb.TieredSpec(
                             cold_tier=cold_tier, **TIERED))
    d = tdb.create(spec, data, device="cpu")
    opened.append(d)
    m = d.attach_maintainer(PolicyConfig(**smoke.TIER_POLICY))
    _count_cpu_calls(monkeypatch)
    q = np.concatenate([hot, hot + 0.01, hot - 0.01, hot + 0.02] * 2)
    ticks = []
    with smoke.PathSpy(d.backend.shards, d.backend) as spy:
        _, got = smoke.counted(lambda: smoke.tiered_replay(
            d, q, m, ticks, corpus=data))
    split = smoke.check_tiered_launches("cpu", spy, hop_backend, got, ticks)
    assert d.backend.promotions > 0
    assert split["maintenance"]["gather_distance"] > 0
    assert len(spy.hot) == q.shape[0] // smoke.TIER_BATCH
