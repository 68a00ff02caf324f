"""The disk tier: ``repro_torch.db`` over a CTPL block file against
``repro.db`` on the CPU, in both directions of file exchange.

Reference -> port: the reference creates a disk database over the
conftest's graph (``prebuilt=``), the port ``open``s a copy of its file.
Port -> reference: the other way round.  Either way the port then gets
the reference's LSH planes (``convert.catapult_state_from_numpy``; the
port draws its planes from a ``torch.Generator``, the reference from
``jax.random``), and both replay the same batches.  After every batch
ids, hops, ndists, used, won, ``block_reads``, ``cache_hits`` and the
bucket tables are exactly equal, and the rerank distances bit-equal:
both rerank in numpy float32 over the same fetched bytes.

Files either package writes from the same state are byte-identical:
the CTPL block file and ``.io.json`` whole; the ``.adapt.npz`` and
``.keys.npz`` member by member (names, order and ``.npy`` bytes), since
a zip container stamps each member with its write time.

Every test closes the databases it opens (their memmaps and reader
threads) and writes under ``tmp_path``.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import shutil
import warnings
import zipfile

import numpy as np
import pytest
import torch

from repro import db as jdb
from repro.adapt import PolicyConfig as JPolicy
from repro.core import buckets as jbk
from repro.store import io_engine as jio
from repro.store import layout as jlayout
from repro.store.cache import ZERO_IO_STATS as J_ZERO
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.adapt import PolicyConfig
from repro_torch.core import buckets as tbk
from repro_torch.core.filters import label_entry_points
from repro_torch.store import io_engine as tio
from repro_torch.store import layout as tlayout

from test_torch_ingest import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = dict(degree=16, build_beam=32, n_bits=4, bucket_capacity=8,
            cache_frames=64)
ADAPT = dict(observe_every=1, baseline_every=3, min_batches=2, min_base=1,
             ttl_steps=96)
N_LABELS = 4


@pytest.fixture
def graph(diskann_engine):
    return diskann_engine._adj_np, diskann_engine.medoid


@pytest.fixture
def opened():
    """Databases a test opens; all closed when it ends, pass or fail."""
    dbs = []
    yield dbs
    for d in dbs:
        d.close()


def _labels(corpus):
    return (corpus[2] % N_LABELS).astype(np.int32)


def _lane_labels(b):
    return (np.arange(b) % (N_LABELS + 1) - 1).astype(np.int32)


def _copy_store(src, dst):
    shutil.copyfile(src, dst)
    shutil.copyfile(str(src) + ".io.json", str(dst) + ".io.json")


def _transplant(ref, port):
    """The reference's catapult planes and buckets into the port."""
    cat = ref.backend._cat
    port.backend._cat = convert.catapult_state_from_numpy(
        np.asarray(cat.lsh.hyperplanes), jbk.to_arrays(cat.buckets),
        device="cpu")


def _disk_twins(tmp_path, corpus, graph, opened, mode="catapult",
                hop_backend="unfused", filtered=False, built_by="ref",
                adapt=False, **spec):
    """A reference and a port disk database over one graph.  The one
    ``built_by`` names creates the file; the other opens a copy."""
    labels = _labels(corpus) if filtered else None
    pre = ((*graph, label_entry_points(corpus[0], labels, N_LABELS))
           if filtered else graph)
    paths = {"ref": str(tmp_path / "ref.ctpl"),
             "port": str(tmp_path / "port.ctpl")}
    kw = dict(tier="disk", mode=mode, hop_backend=hop_backend,
              filters=filtered, **SPEC, **spec)
    jspec = jdb.IndexSpec(path=paths["ref"], **kw,
                          **({"adapt": JPolicy(**ADAPT)} if adapt else {}))
    tspec = tdb.IndexSpec(path=paths["port"], **kw,
                          **({"adapt": PolicyConfig(**ADAPT)} if adapt
                             else {}))
    if built_by == "ref":
        ref = jdb.create(jspec, corpus[0], labels, prebuilt=pre)
        opened.append(ref)
        _copy_store(paths["ref"], paths["port"])
        port = tdb.open(paths["port"], mode=mode, spec=tspec, device="cpu")
        opened.append(port)
    else:
        port = tdb.create(tspec, corpus[0], labels, prebuilt=pre,
                          device="cpu")
        opened.append(port)
        _copy_store(paths["port"], paths["ref"])
        ref = jdb.open(paths["ref"], mode=mode, spec=jspec)
        opened.append(ref)
    if mode == "catapult":
        _transplant(ref, port)
    return ref, port


def _same_buckets(port, ref, where=""):
    if port.backend.mode != "catapult":
        return
    want = jbk.to_arrays(ref.backend._cat.buckets)
    got = tbk.to_arrays(port.backend._cat.buckets)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{name} {where}")


def _same_search(ref, port, q, where="", **kw):
    """One batch through both; everything the search returns equal."""
    r, p = ref.search(q, **kw), port.search(q, **kw)
    np.testing.assert_array_equal(p.ids, r.ids, err_msg=where)
    assert p.dists.dtype == np.float32
    assert p.dists.tobytes() == np.asarray(r.dists).tobytes(), where
    for fld in ("hops", "ndists", "used", "won", "block_reads",
                "cache_hits"):
        np.testing.assert_array_equal(getattr(p.stats, fld),
                                      getattr(r.stats, fld),
                                      err_msg=f"{fld} {where}")
    _same_buckets(port, ref, where)
    return r, p


def _same_cache(port, ref):
    pc, rc = port.backend.cache, ref.backend.cache
    assert tuple(pc.io_stats) == tuple(rc.io_stats)
    np.testing.assert_array_equal(pc.frame_node, rc.frame_node)
    np.testing.assert_array_equal(pc.pinned, rc.pinned)
    assert list(pc._rotating) == list(rc._rotating)


def _replay(ref, port, queries, filtered=False, rounds=2):
    for rnd in range(rounds):
        for lo in (0, 32, 64):
            q = queries[lo: lo + 32]
            fl = _lane_labels(q.shape[0]) if filtered else None
            _same_search(ref, port, q, f"round {rnd} batch {lo}", k=10,
                         filter_labels=fl)
    _same_cache(port, ref)


CASES = [("catapult", "unfused", False), ("catapult", "fused", False),
         ("diskann", "unfused", False), ("diskann", "fused", False),
         ("catapult", "unfused", True), ("diskann", "fused", True)]


@pytest.mark.parametrize("mode,hop_backend,filtered", [
    pytest.param(*c, id=f"{c[0]}-{c[1]}" + ("-filtered" if c[2] else ""))
    for c in CASES])
def test_reference_file_opened_by_port_matches_jax(
        tmp_path, corpus, queries, graph, opened, mode, hop_backend,
        filtered):
    ref, port = _disk_twins(tmp_path, corpus, graph, opened, mode,
                            hop_backend, filtered)
    eng = port.backend
    assert isinstance(eng, tio.DiskVectorSearchEngine)
    assert eng.pq_subspaces == ref.backend.pq_subspaces == 8
    np.testing.assert_array_equal(eng._codes_np, ref.backend._codes_np)
    assert tuple(eng._vec.shape) == (1, 16)     # no vector table uploaded
    _replay(ref, port, queries, filtered)
    if mode == "catapult":
        assert port.search(queries[:32], k=10).stats.used.all()


@pytest.mark.parametrize("mode,hop_backend,filtered", [
    ("catapult", "unfused", False), ("diskann", "fused", False),
    ("catapult", "fused", True)])
def test_port_file_opened_by_reference_matches_jax(
        tmp_path, corpus, queries, graph, opened, mode, hop_backend,
        filtered):
    ref, port = _disk_twins(tmp_path, corpus, graph, opened, mode,
                            hop_backend, filtered, built_by="port")
    np.testing.assert_array_equal(port.backend._codes_np,
                                  ref.backend._codes_np)
    _replay(ref, port, queries, filtered)


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return [(name, z.read(name)) for name in z.namelist()]


def _same_files(port_path, ref_path):
    port_path, ref_path = str(port_path), str(ref_path)
    for ext in ("", ".io.json"):
        with open(port_path + ext, "rb") as f, open(ref_path + ext, "rb") as g:
            assert f.read() == g.read(), ext or "ctpl"
    for ext in (".adapt.npz", ".keys.npz"):
        exists = [pathlib.Path(p + ext).exists()
                  for p in (port_path, ref_path)]
        assert exists[0] == exists[1], ext
        if exists[0]:
            assert _npz_members(port_path + ext) == \
                _npz_members(ref_path + ext), ext


def test_save_writes_the_reference_files(tmp_path, corpus, queries, graph,
                                         opened):
    """Maintainers fed the same batches, a keyed upsert and a delete,
    then ``save()`` by each package: the same files."""
    ref, port = _disk_twins(tmp_path, corpus, graph, opened,
                            spare_capacity=16)
    ms = [ref.attach_maintainer(JPolicy(**ADAPT)),
          port.attach_maintainer(PolicyConfig(**ADAPT))]
    for lo in (0, 32, 64, 0):
        q = queries[lo: lo + 32]
        r, p = _same_search(ref, port, q, f"batch {lo}", k=10)
        ms[0].observe(q, r.stats)
        ms[1].observe(q, p.stats)
    new = corpus[0][:12] + 0.25
    keys = [f"row{i}" for i in range(12)]
    for d in (ref, port):
        d.upsert(new, keys=keys)
        d.delete(keys=keys[:3])
        d.save()
    _same_files(tmp_path / "port.ctpl", tmp_path / "ref.ctpl")
    assert pathlib.Path(str(tmp_path / "port.ctpl") + ".adapt.npz").exists()
    # and each reopens the other's files to the same state
    _copy_store(tmp_path / "port.ctpl", tmp_path / "port2.ctpl")
    for ext in (".adapt.npz", ".keys.npz"):
        shutil.copyfile(str(tmp_path / "port.ctpl") + ext,
                        str(tmp_path / "port2.ctpl") + ext)
    again = jdb.open(str(tmp_path / "port2.ctpl"),
                     spec=jdb.IndexSpec(**{k: v for k, v in SPEC.items()
                                           if k != "cache_frames"}))
    opened.append(again)
    assert again.keys["row5"] == port.keys["row5"] == ref.keys["row5"]
    assert jbk.to_arrays(again.backend._cat.buckets)["step"] == \
        tbk.to_arrays(port.backend._cat.buckets)["step"]


@pytest.mark.parametrize("filtered", [False, True])
def test_mutations_write_identical_block_files(tmp_path, corpus, queries,
                                               graph, opened, filtered):
    """Keyed upsert, a true upsert, delete by key and consolidate on both
    packages: after every step the two block files are byte-identical
    and the next batch's results equal."""
    ref, port = _disk_twins(tmp_path, corpus, graph, opened,
                            filtered=filtered, spare_capacity=40)
    rng = np.random.default_rng(4)
    new = (corpus[0][rng.integers(0, corpus[0].shape[0], 32)]
           + 0.3 * rng.normal(size=(32, 16))).astype(np.float32)
    lab = rng.integers(0, N_LABELS, 32).astype(np.int32)
    keys = list(range(100, 132))
    steps = [
        ("upsert", lambda d: d.upsert(new, lab if filtered else None,
                                      keys=keys)),
        ("reupsert", lambda d: d.upsert(new[:8] + 0.01,
                                        lab[:8] if filtered else None,
                                        keys=keys[:8])),
        ("delete", lambda d: d.delete(keys=keys[16:])),
        ("delete_ids", lambda d: d.delete(np.array([3, 77, -1]))),
        ("consolidate", lambda d: d.consolidate())]
    for name, step in steps:
        got = [step(d) for d in (ref, port)]
        if name != "delete" and name != "delete_ids":
            assert np.array_equal(np.asarray(got[0]), np.asarray(got[1])), \
                name
        assert (tmp_path / "port.ctpl").read_bytes() == \
            (tmp_path / "ref.ctpl").read_bytes(), name
        assert port.backend.medoid == ref.backend.medoid
        q = np.concatenate([new[:16], queries[:16]])
        fl = _lane_labels(32) if filtered else None
        _same_search(ref, port, q, name, k=10, filter_labels=fl)
    live = [port.keys.get(k) for k in keys[:8]]
    assert all(g >= 0 for g in live)
    assert not port.tombstones[live].any()


def test_pipeline_ids_match_the_synchronous_engine(tmp_path, corpus,
                                                  queries, graph, opened):
    """``IoSpec(pipeline=True)`` moves I/O accounting, never results:
    ids, distances and hops equal the synchronous engine's."""
    ref, sync = _disk_twins(tmp_path, corpus, graph, opened)
    _copy_store(tmp_path / "ref.ctpl", tmp_path / "piped.ctpl")
    piped = tdb.open(str(tmp_path / "piped.ctpl"),
                     spec=tdb.IndexSpec(io=tdb.IoSpec(pipeline=True,
                                                      workers=3,
                                                      queue_depth=32),
                                        **SPEC), device="cpu")
    opened.append(piped)
    cat = sync.backend._cat
    piped.backend._cat = convert.catapult_state_from_numpy(
        cat.lsh.hyperplanes.numpy(), tbk.to_arrays(cat.buckets),
        device="cpu")
    assert piped.backend.pipeline is not None and piped.spec.io.pipeline
    for rnd in range(2):
        for lo in (0, 32, 64):
            q = queries[lo: lo + 32]
            a, b = sync.search(q, k=10), piped.search(q, k=10)
            np.testing.assert_array_equal(b.ids, a.ids)
            assert b.dists.tobytes() == a.dists.tobytes()
            np.testing.assert_array_equal(b.stats.hops, a.stats.hops)
    assert piped.io_stats().prefetch_issued > 0
    assert sync.io_stats().prefetch_issued == 0


def test_save_and_open_resume_the_port_state(tmp_path, corpus, queries,
                                             graph, opened):
    """save() then open(): with ``publish=False`` the reopened database
    returns the live one's ids; buckets, the adapt gate, the key map and
    the persisted ``IoSpec`` come back; an explicit ``spec.io`` wins."""
    io = tdb.IoSpec(admission="locality")
    path = str(tmp_path / "p.ctpl")
    live = tdb.create(tdb.IndexSpec(tier="disk", path=path, io=io,
                                    adapt=PolicyConfig(**ADAPT),
                                    spare_capacity=8, **SPEC),
                      corpus[0], prebuilt=graph, device="cpu")
    opened.append(live)
    fe = live.serve(max_batch=32)
    for x in queries:
        fe.submit(x)
    fe.flush()
    live.upsert(corpus[0][:4] + 0.5, keys=[7, 8, 9, 10])
    live.delete(keys=[8])
    live.save()
    assert tdb.sniff(path) == ("disk", tlayout.VERSION)
    back = tdb.open(path, spec=tdb.IndexSpec(**SPEC), device="cpu")
    opened.append(back)
    assert back.spec.io == io and back.spec.tier == "disk"
    assert back.spec.pq == live.backend.pq_subspaces
    assert dict(back.keys._fwd) == dict(live.keys._fwd)
    for name, want in tbk.to_arrays(live.backend._cat.buckets).items():
        np.testing.assert_array_equal(
            tbk.to_arrays(back.backend._cat.buckets)[name], want)
    assert back.backend.adapt_state is not None
    np.testing.assert_array_equal(back.tombstones, live.tombstones)
    for lo in (0, 48):
        q = queries[lo: lo + 48]
        a = live.search(q, k=10, publish=False)
        b = back.search(q, k=10, publish=False)
        np.testing.assert_array_equal(b.ids, a.ids)
        assert b.dists.tobytes() == a.dists.tobytes()
    other = tdb.open(path, spec=tdb.IndexSpec(io=tdb.IoSpec(), **SPEC),
                     device="cpu")
    opened.append(other)
    assert other.spec.io == tdb.IoSpec()
    assert tio.read_io_sidecar(path) == io


def _rule(case, tmp_path, corpus, graph, opened):
    """Run ``case`` against (reference, port); returns the two outcomes
    (exception type name and message, or the value)."""
    out = []
    for pkg, lay, io_mod in ((jdb, jlayout, jio), (tdb, tlayout, tio)):
        kw = {} if pkg is jdb else {"device": "cpu"}
        path = tmp_path / f"{pkg.__name__.split('.')[0]}.ctpl"
        try:
            if case == "lsh_apg_spec":
                pkg.IndexSpec(tier="disk", path=str(path), mode="lsh_apg")
            elif case == "lsh_apg_engine":
                io_mod.DiskVectorSearchEngine(mode="lsh_apg", **kw)
            elif case == "no_path":
                pkg.IndexSpec(tier="disk")
            elif case == "io_dict":
                pkg.IndexSpec(tier="disk", path=str(path),
                              io={"pipeline": True})
            elif case == "io_object":
                pkg.IndexSpec(tier="disk", path=str(path), io=object())
            elif case == "two_phase":
                d = pkg.create(pkg.IndexSpec(tier="disk", path=str(path),
                                             **SPEC), corpus[0],
                               prebuilt=graph, **kw)
                opened.append(d)
                d.backend.search_two_phase(corpus[0][:4], k=3)
            elif case in ("version", "size", "pre_v3_labels"):
                st = lay.write_store(str(path), corpus[0][:50],
                                     graph[0][:50], medoid=0,
                                     labels=(np.zeros(50, np.int32)
                                             if case == "pre_v3_labels"
                                             else None))
                st.close()
                raw = bytearray(path.read_bytes())
                if case == "version":
                    raw[4:8] = (9).to_bytes(4, "little")
                elif case == "size":
                    raw += b"\0" * 8
                path.write_bytes(bytes(raw))
                opened.append(pkg.open(str(path), **kw))
            elif case == "not_ctpl":
                path.write_bytes(b"not a store at all")
                pkg.sniff(str(path))
            elif case == "sidecar_geometry":
                d = pkg.create(pkg.IndexSpec(tier="disk", path=str(path),
                                             **SPEC), corpus[0],
                               prebuilt=graph, **kw)
                d.close()
                np.savez(str(path) + ".adapt.npz",
                         ids=np.full((4, 3), -1, np.int32),
                         stamp=np.zeros((4, 3), np.int32),
                         tag=np.zeros((4, 3), np.int32),
                         step=np.int32(0))
                opened.append(pkg.open(str(path), **kw))
            elif case == "ram_save":
                d = pkg.create(pkg.IndexSpec(**{k: v for k, v in SPEC.items()
                                                if k != "cache_frames"}),
                               corpus[0], prebuilt=graph, **kw)
                d.save()
            out.append(("ok", None))
        except Exception as e:      # the outcome under comparison
            msg = str(e)
            out.append((type(e).__name__, msg))
    return out


@pytest.mark.parametrize("case", [
    "lsh_apg_spec", "lsh_apg_engine", "no_path", "io_dict", "io_object",
    "two_phase", "version", "size", "pre_v3_labels", "not_ctpl",
    "sidecar_geometry", "ram_save"])
def test_disk_rules_match_reference(tmp_path, corpus, graph, opened, case):
    """What the reference refuses the port refuses, with the same
    exception type and message."""
    ref, port = _rule(case, tmp_path, corpus, graph, opened)
    assert ref[0] != "ok"
    assert port[0] == ref[0]
    if case not in ("not_ctpl",):
        assert port[1] == ref[1]
    else:       # the message names the path, which differs
        assert port[1].split(":")[0] == ref[1].split(":")[0]


@pytest.mark.parametrize("case", ["sharded_dir", "tiered_dir", "ext2int",
                                  "ingest_json", "tier_sharded",
                                  "tier_tiered"])
def test_unported_layouts_raise_before_opening(tmp_path, corpus, graph,
                                               opened, case):
    """Sharded and tiered layouts open as the reference opens them: a
    directory the port creates ``sniff``s the same in both packages and
    each opens it to the same tier, rows and capabilities; their specs
    are accepted as the reference's are.  A keys sidecar carrying the
    bootstrap external-id indirection of a database born empty, and an
    ``ingest.json`` sidecar, open in both packages to the same state: a
    resumed ``BootstrapEngine`` over the same rows, the same persisted
    ``IngestSpec``."""
    path = tmp_path / "x.ctpl"
    if case.startswith("tier_"):
        kw = dict(tier=case[5:], path=str(tmp_path / "x.d"))
        assert tdb.IndexSpec(**kw).tier == jdb.IndexSpec(**kw).tier
        return
    if case.endswith("_dir"):
        tier = case[: -len("_dir")]
        path = tmp_path / "layout.d"
        extra = ({"tiered": tdb.TieredSpec(hot_fraction=0.02)}
                 if tier == "tiered" else {"n_shards": 2})
        d = tdb.create(tdb.IndexSpec(tier=tier, path=str(path), **SPEC,
                                     **extra), corpus[0], device="cpu")
        opened.append(d)
        d.save()
        assert tdb.sniff(str(path)) == jdb.sniff(str(path)) == (tier, 1)
        dbs = [tdb.open(str(path), device="cpu"), jdb.open(str(path))]
        opened.extend(dbs)
        for x in dbs:
            assert x.caps == d.caps and x.caps.tier == tier
            assert x.n_active == corpus[0].shape[0] and x.dim == 16
        return
    d = tdb.create(tdb.IndexSpec(tier="disk", path=str(path), **SPEC),
                   corpus[0], prebuilt=graph, device="cpu")
    d.close()
    if case == "ext2int":
        np.savez(str(path) + ".keys.npz", key_kind=np.array("none"),
                 key_values=np.empty(0, np.int64),
                 key_gids=np.empty(0, np.int64),
                 ext2int=np.arange(4), ext_tomb=np.zeros(4, bool))
    else:
        (tmp_path / "x.ctpl.ingest.json").write_text('{"batch_size": 32}')
    dbs = [tdb.open(str(path), device="cpu"), jdb.open(str(path))]
    opened.extend(dbs)
    port, ref = dbs
    assert port.spec.ingest.to_dict() == ref.spec.ingest.to_dict()
    assert port.n_active == ref.n_active and port.caps == ref.caps
    if case == "ext2int":
        from repro_torch.ingest import BootstrapEngine
        assert isinstance(port.backend, BootstrapEngine)
        assert port.n_active == 4 and port.backend.bootstrap_phase == "graph"
        np.testing.assert_array_equal(port.backend._gen[1],
                                      np.asarray(ref.backend._gen[1]))
        np.testing.assert_array_equal(port.vectors, np.asarray(ref.vectors))
    else:
        assert port.spec.ingest == tdb.IngestSpec(batch_size=32)


@pytest.mark.parametrize("call", ["io_stats", "io_stats_reset",
                                  "cache_stats", "reset_io"])
def test_ram_io_stats_match_reference(corpus, graph, call):
    """The repair: a RAM database reports the all-zero ``IoStats`` /
    ``CacheStats`` as the reference's does (``reset`` a no-op), with the
    same deprecation warnings."""
    spec = {k: v for k, v in SPEC.items() if k != "cache_frames"}
    out = []
    for pkg, kw in ((jdb, {}), (tdb, {"device": "cpu"})):
        d = pkg.create(pkg.IndexSpec(mode="diskann", **spec), corpus[0],
                       prebuilt=graph, **kw)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            if call == "io_stats":
                got = d.io_stats()
            elif call == "io_stats_reset":
                got = d.io_stats(reset=True)
            elif call == "cache_stats":
                got = d.cache_stats
            else:
                got = d.reset_io()
        out.append((type(got).__name__, None if got is None else tuple(got),
                    [(x.category.__name__, str(x.message)) for x in w]))
    assert out[1] == out[0]
    if call.startswith("io_stats"):
        assert out[1][1] == tuple(J_ZERO)
    assert tdb.IoStats._fields == jdb.IoStats._fields


def test_explain_and_metrics_match_reference(tmp_path, corpus, queries,
                                             graph, opened):
    """``explain=True`` on the disk tier: the route, fetch and rerank
    stages, ``blocks_read``/``cache_hits`` from the stats; the I/O
    counters and collectors in ``metrics()`` equal the reference's."""
    ref, port = _disk_twins(tmp_path, corpus, graph, opened)
    for lo in (0, 32):
        _same_search(ref, port, queries[lo: lo + 32], k=10)
    tr = [d.search(queries[64:96], k=10, explain=True) for d in (ref, port)]
    assert [s.name for s in tr[1].stages] == [s.name for s in tr[0].stages] \
        == ["route", "fetch", "rerank"]
    np.testing.assert_array_equal(tr[1].blocks_read, tr[0].blocks_read)
    np.testing.assert_array_equal(tr[1].cache_hits, tr[0].cache_hits)
    assert tr[1].to_dict()["blocks_read_mean"] == \
        tr[0].to_dict()["blocks_read_mean"] > 0
    m = [d.metrics() for d in (ref, port)]
    names = [n for n in m[0] if n.startswith(("catapultdb_io_",
                                              "catapultdb_cache_"))]
    assert len(names) == 12
    for name in names:
        assert m[1][name] == m[0][name], name
    assert m[1]["catapultdb_io_block_reads_total"] > 0
    assert port.io_stats(reset=True) == tuple(ref.io_stats(reset=True))
    # the cold start re-pins the medoid: one block read, in both
    assert port.io_stats() == tuple(ref.io_stats())
    assert port.io_stats().hits == 0


def test_disk_serve_with_maintainer_matches_jax(tmp_path, corpus, queries,
                                                graph, opened):
    """``serve()`` with the maintainer over disk twins: the maintainer's
    re-pinning of hot catapult destinations (``unit._cache``) runs, and
    after every flush the cache's frames, pins and rotating pins, the
    maintainer's snapshot and the bucket tables equal the reference's."""
    from test_torch_adapt import _assert_snapshot_equal
    ref, port = _disk_twins(tmp_path, corpus, graph, opened, adapt=True,
                            adapt_tick_every=2)
    fes = [ref.serve(max_batch=8), port.serve(max_batch=8)]
    rng = np.random.default_rng(5)
    repinned = []
    real = port.backend.cache.pin_rotating
    port.backend.cache.pin_rotating = lambda ids: repinned.append(
        np.asarray(ids).copy()) or real(ids)
    for flush in range(8):
        rows = rng.integers(0, queries.shape[0], 13)
        got = []
        for fe in fes:
            for x in queries[rows]:
                fe.submit(x)
            got.append(fe.flush())
        for t in got[0]:
            np.testing.assert_array_equal(got[1][t][0], got[0][t][0])
            assert got[1][t][1].tobytes() == np.asarray(got[0][t][1]).tobytes()
        _same_buckets(port, ref, f"flush {flush}")
        _same_cache(port, ref)
        _assert_snapshot_equal(fes[1].maintainer.snapshot(),
                               fes[0].maintainer.snapshot(), f"flush {flush}")
    s = fes[1].maintainer.snapshot()
    assert s["ticks"] > 0 and s["shadows"] > 0
    assert len(repinned) > 0 and port.backend.cache._rotating


def test_device_mirrors_are_copies_and_the_vector_table_stays_on_disk(
        tmp_path, corpus, queries, graph, opened):
    """On the CPU a tensor of a memmap view would alias the block file:
    the engine's device mirrors are contiguous copies; the vector table
    on the device is the (1, d) dummy after create, insert and open."""
    path = str(tmp_path / "m.ctpl")
    d = tdb.create(tdb.IndexSpec(tier="disk", path=path, spare_capacity=8,
                                 **SPEC), corpus[0], prebuilt=graph,
                   device="cpu")
    opened.append(d)
    eng = d.backend
    for t in (eng._adj, eng._codes, eng._tomb):
        assert t.is_contiguous()
    before = int(eng._adj[0, 0])
    eng._adj_np[0, 0] = -7                     # the block file's page
    assert int(eng._adj[0, 0]) == before
    eng._adj_np[0, 0] = before
    d.upsert(corpus[0][:4] + 0.5)
    assert tuple(eng._vec.shape) == (1, 16)
    np.testing.assert_array_equal(eng._adj.numpy(), eng._adj_np)
    np.testing.assert_array_equal(eng._codes.numpy(), eng._codes_np)
    d.save()
    back = tdb.open(path, spec=tdb.IndexSpec(**SPEC), device="cpu")
    opened.append(back)
    assert tuple(back.backend._vec.shape) == (1, 16)
    np.testing.assert_array_equal(back.backend._codes_np, eng._codes_np)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdb.open(path)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("mode,hop_backend,filtered", [
    ("catapult", "unfused", False), ("catapult", "fused", False),
    ("diskann", "unfused", False), ("catapult", "fused", True)])
def test_chip_smoke_disk_launch_accounting(tmp_path, corpus, queries, graph,
                                           opened, monkeypatch, mode,
                                           hop_backend, filtered):
    """``chip_smoke.expected_launches(..., disk=True)`` (what the card run
    holds each disk path to) against the wrapper calls of disk searches:
    the PQ traversal's launches and no ``gather_distance`` (the rerank
    is on the host); an upsert's insert search runs on
    ``gather_distance`` alone."""
    from test_torch_db import _count_wrapper_calls
    smoke = _load_chip_smoke()
    labels = _labels(corpus) if filtered else None
    pre = ((*graph, label_entry_points(corpus[0], labels, N_LABELS))
           if filtered else graph)
    d = tdb.create(tdb.IndexSpec(tier="disk", path=str(tmp_path / "a.ctpl"),
                                 mode=mode, hop_backend=hop_backend,
                                 filters=filtered, spare_capacity=8, **SPEC),
                   corpus[0], labels, prebuilt=pre, device="cpu")
    opened.append(d)
    calls = _count_wrapper_calls(monkeypatch)
    iters = []
    for lo in (0, 32, 64):
        fl = _lane_labels(32) if filtered else None
        r = d.search(queries[lo: lo + 32], k=10, filter_labels=fl)
        iters.append(int(r.stats.hops.max()))
    assert calls == smoke.expected_launches(mode, hop_backend, iters,
                                            pq=True, filtered=filtered,
                                            disk=True)
    assert calls["gather_distance"] == 0
    calls.update(dict.fromkeys(calls, 0))
    d.upsert(corpus[0][:4] + 0.5, labels[:4] if filtered else None)
    assert calls["gather_distance"] > 0
    assert sum(calls.values()) == calls["gather_distance"]
