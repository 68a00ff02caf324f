"""Ingest state across the packages, and ingest while serving.

A database born empty in one package, grown past a cutover and a
growth, keyed and saved, reopens in both packages as a
``BootstrapEngine`` (disk, sharded and tiered tiers, both directions);
with the LSH planes (and a tiered layout's hot graph) transplanted, the
continued streams are equal, and both packages save the same keys npz
member by member and the same ingest spec.  The serve/ingest
interleave runs both packages in lockstep through ``serve(ingest=True,
maintain=True)`` with the maintainer attached at the cutover.  The
world and helpers are ``test_torch_ingest.py``'s.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

from repro import db as jdb
from repro_torch import db as tdb
from repro_torch.ingest import BootstrapEngine

from test_torch_ingest import (_assert_search, _assert_state,  # noqa: F401
                               _spec, _transplant, _twin_create, hooked,
                               one_torch_thread, opened, world)


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def _persisted_files(tier, path):
    keys = path + ".keys.npz" if tier == "disk" else os.path.join(
        path, "keys.npz")
    spec = (path + ".ingest.json" if tier == "disk"
            else os.path.join(path, "manifest.json"))
    return keys, spec


def _grow_and_save(db, corpus):
    gids = []
    for lo in range(0, 300, 64):
        gids.append(db.upsert(corpus[lo: min(lo + 64, 300)]))
    db.upsert(corpus[:2] + 10.0, keys=[100, 101])
    db.delete(keys=[100])
    db.save()
    return np.concatenate(gids)


@pytest.mark.parametrize("tier,born", [
    ("disk", "ref"), ("disk", "port"), ("sharded", "ref"),
    ("sharded", "port")])
def test_ingest_state_persists_and_resumes_across_packages(
        world, tier, born, tmp_path, opened):
    """A database born empty in one package, grown past a cutover and a
    growth, keyed, saved: both packages reopen it as a ``BootstrapEngine``
    with the same ingest spec, keys and indirection, and continue the
    stream in lockstep (ids, searches, keys equal).  Both then save the
    same keys npz (member by member) and the same ingest spec bytes."""
    corpus, queries, _ = world
    path = str(tmp_path / f"{born}_{tier}")
    pkg, dev = (jdb, {}) if born == "ref" else (tdb, {"device": "cpu"})
    db = pkg.create(_spec(pkg, tier, path), **dev)
    gids = _grow_and_save(db, corpus)
    assert db.backend.growths >= 1
    db.close()
    paths = {"ref": str(tmp_path / f"r_{tier}"),
             "port": str(tmp_path / f"p_{tier}")}
    for dst in paths.values():
        (shutil.copytree if tier == "sharded" else _copy_disk)(path, dst)
    ref = jdb.open(paths["ref"])
    port = tdb.open(paths["port"], device="cpu")
    opened.extend([ref, port])
    assert isinstance(port.backend, BootstrapEngine)
    assert port.spec.ingest == _spec(tdb, tier, path).ingest
    assert port.spec.ingest.to_dict() == ref.spec.ingest.to_dict()
    assert 101 in port.keys and 100 not in port.keys
    assert dict(port.keys._fwd) == dict(ref.keys._fwd)
    _assert_state(ref, port)
    _transplant(ref.backend, port.backend)
    _assert_search(ref, port, queries)
    g3 = port.upsert(corpus[2:3] + 10.0, keys=[101])
    np.testing.assert_array_equal(g3, ref.upsert(corpus[2:3] + 10.0,
                                                 keys=[101]))
    assert port.keys[101] == g3[0] and int(g3[0]) > int(np.max(gids))
    for db in (ref, port):
        db.upsert(corpus[300:330], keys=list(range(200, 230)))
        db.delete(keys=list(range(200, 210)))
    _assert_state(ref, port)
    _assert_search(ref, port, queries)
    for db in (ref, port):
        db.save()
    (rk, rs), (pk, ps) = (_persisted_files(tier, paths["ref"]),
                          _persisted_files(tier, paths["port"]))
    assert _npz_members(pk) == _npz_members(rk)
    if tier == "disk":
        assert open(ps, "rb").read() == open(rs, "rb").read()
    else:
        man_p, man_r = json.load(open(ps)), json.load(open(rs))
        assert man_p["ingest"] == man_r["ingest"]
        assert man_p["keys"] == man_r["keys"] == "keys.npz"


def _copy_disk(src, dst):
    for suffix in ("", ".keys.npz", ".ingest.json", ".io.json",
                   ".adapt.npz"):
        if os.path.exists(src + suffix):
            shutil.copy(src + suffix, dst + suffix)


def test_sharded_manifest_keeps_ingest_keys_across_rewrites(world, tmp_path):
    """The sharded manifest is regenerated on every insert — the
    ``ingest``/``keys`` entries survive the rewrite, as the
    reference's."""
    corpus, _, _ = world
    path = str(tmp_path / "man")
    db = tdb.create(_spec(tdb, "sharded", path), device="cpu")
    for lo in range(0, 300, 64):
        db.upsert(corpus[lo: min(lo + 64, 300)])
    db.upsert(corpus[:1], keys=[1])
    db.save()
    db.upsert(corpus[1:40] + 1.0)            # insert after save -> rewrite
    db.save()
    db.close()
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["ingest"] == _spec(jdb, "sharded", path).ingest.to_dict()
    assert manifest["keys"] == "keys.npz"
    for d in (tdb.open(path, device="cpu"), jdb.open(path)):
        assert d.keys[1] >= 0 and isinstance(d.backend.inner.manifest_extra,
                                             dict)
        d.close()


@pytest.mark.parametrize("born", ["ref", "port"])
def test_tiered_ingest_state_exchanges_across_packages(world, born,
                                                       tmp_path, opened):
    """The tiered tier (over a disk cold tier): an ingest-born database
    saved by one package reopens in both as a ``BootstrapEngine``; with
    the cold planes and the hot graph transplanted, continued upserts,
    deletes and searches are equal, and both save the same keys npz and
    ``ingest.json`` bytes."""
    corpus, queries, _ = world
    path = str(tmp_path / f"{born}_t")
    pkg, dev = (jdb, {}) if born == "ref" else (tdb, {"device": "cpu"})
    db = pkg.create(_spec(pkg, "tiered", path), **dev)
    _grow_and_save(db, corpus)
    db.close()
    paths = {"ref": str(tmp_path / "r_t"), "port": str(tmp_path / "p_t")}
    for dst in paths.values():
        shutil.copytree(path, dst)
    ref = jdb.open(paths["ref"])
    port = tdb.open(paths["port"], device="cpu")
    opened.extend([ref, port])
    assert isinstance(port.backend, BootstrapEngine)
    assert port.spec.ingest.to_dict() == ref.spec.ingest.to_dict()
    _assert_state(ref, port)
    _transplant(ref.backend, port.backend)
    _transplant_hot(ref.backend.inner, port.backend.inner)
    _assert_search(ref, port, queries)
    for db in (ref, port):
        db.upsert(corpus[300:330], keys=list(range(200, 230)))
        db.delete(keys=list(range(200, 210)))
    _assert_state(ref, port)
    _assert_search(ref, port, queries)
    np.testing.assert_array_equal(port.vectors, np.asarray(ref.vectors))
    np.testing.assert_array_equal(port.tombstones,
                                  np.asarray(ref.tombstones))
    for db in (ref, port):
        db.save()
    for name in ("keys.npz", "ingest.json"):
        a = os.path.join(paths["port"], name)
        b = os.path.join(paths["ref"], name)
        if name.endswith(".npz"):
            assert _npz_members(a) == _npz_members(b)
        else:
            assert open(a, "rb").read() == open(b, "rb").read()


def _transplant_hot(jt, tt):
    np.testing.assert_array_equal(tt._hot_gid, jt._hot_gid)
    jh, th = jt.hot, tt.hot
    if jh is None:
        assert th is None
        return
    np.testing.assert_array_equal(th._vec_np, np.asarray(jh._vec_np))
    th._adj_np[:] = np.asarray(jh._adj_np)
    th._adj = th._upload(th._adj_np)
    th.medoid = int(jh.medoid)


def test_serve_ingest_interleave_with_deferred_maintainer(world, tmp_path,
                                                          opened, hooked):
    """An empty database straight into ``serve(ingest=True,
    maintain=True)`` in both packages: searches pump the queue, the
    maintainer attaches itself at the cutover (its telemetry on the
    inner engine's device), and its background consolidate reclaims
    tombstones; tickets, searches, keys and maintainer snapshots equal
    after every step."""
    corpus, queries, _ = world
    kw = dict(bootstrap_cutover=64, batch_size=32, initial_capacity=128,
              consolidate_threshold=0.2)
    ref, port = _twin_create("ram", tmp_path, opened, **kw)
    fes = [ref.serve(max_batch=8, maintain=True, ingest=True),
           port.serve(max_batch=8, maintain=True, ingest=True)]
    assert fes[1].maintainer is None

    def both_search(q):
        r, p = fes[0].search(q, k=5), fes[1].search(q, k=5)
        np.testing.assert_array_equal(p[0], np.asarray(r[0]))
        np.testing.assert_allclose(p[1], np.asarray(r[1]), rtol=1e-6)

    tickets = []
    for lo in range(0, 400, 40):
        pair = [fe.ingest.put(corpus[lo: lo + 40],
                              keys=list(range(lo, lo + 40))) for fe in fes]
        tickets.append(pair)
        both_search(queries)
        _assert_state(ref, port)
    for fe in fes:
        fe.ingest.flush()
    for tr, tp in tickets:
        np.testing.assert_array_equal(tp.gids, tr.gids)
    assert port.n_active == 400 and len(port.keys) == 400
    m = fes[1].maintainer
    assert m is not None
    assert m.engine is port.backend
    assert all(u.adapt_state.n_queries.device == torch.device("cpu")
               for u in m._units)
    for db in (ref, port):
        db.delete(keys=list(range(150)))
    assert port.backend.tombstone_fraction() >= 0.2
    for _ in range(60):          # the reference's budget, left at the tick
        both_search(queries)
        if m.consolidations and fes[0].maintainer.consolidations:
            break
    snap_r, snap_p = fes[0].maintainer.snapshot(), m.snapshot()
    for key in ("consolidations", "ticks", "ttl_evicted", "flushed_entries",
                "drift_flushes", "gate_transitions", "probes", "shadows",
                "n_queries", "enabled"):
        assert snap_p[key] == snap_r[key], key
    assert snap_p["consolidations"] >= 1
    assert port.backend.tombstone_fraction() < 0.2
    _assert_state(ref, port)
    ids = port.search(corpus[200:203], k=1).ids
    for r in range(3):
        assert int(ids[r, 0]) == port.keys[200 + r]
