"""The sharded tier: ``repro_torch.core.sharded`` and
``repro_torch.store.sharded_store`` against the reference on the CPU.

* ``merge_topk``/``rebase_ids`` on inputs with ties and -1 lanes: the
  reference's ids and distances.
* The mesh search: the reference runs ``make_sharded_search`` on a
  (2, 4) mesh of 8 forged host devices in a subprocess (one for this
  module; ``XLA_FLAGS`` must precede its JAX import) over
  ``tests/test_sharded_engine.py``'s corpus and writes its state and
  each step's results to an ``.npz``; the port's one-card loop takes the
  same state and queries, and after each of three steps its ids, every
  device's bucket table and step are equal, its distances within rtol
  1e-6.  The port's own ``build_sharded_state`` agrees with the
  reference's graphs on at least 99% of rows, as ``build_vamana`` does.
* The sharded store: both packages open the same shard files, written
  by one package and read by the other in both directions.  The port
  draws its LSH planes from a ``torch.Generator``, so each shard's
  planes are transplanted (``convert.catapult_state_from_numpy``); then
  after every batch ids, hops, ndists, used, won, block reads, cache
  hits and every shard's bucket table are equal and the merged
  distances bit-equal (both rerank in numpy float32 over the same
  bytes).  ``save()`` of both writes the same manifest text, shard
  files and ``.buckets.npz`` members (compared member by member: a zip
  stamps write times); mutations leave byte-identical shard files.

The corpus is ``tests/test_sharded_store.py``'s: 1,600 x 16, S = 4.
Every test closes what it opens and writes under ``tmp_path``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from repro import db as jdb
from repro.adapt import PolicyConfig as JPolicy
from repro.adapt import stats as jstats
from repro.core import buckets as jbk
from repro.core import sharded as jsh
from repro.store import sharded_store as jss
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.adapt import PolicyConfig
from repro_torch.adapt import stats as tstats
from repro_torch.core import buckets as tbk
from repro_torch.core import sharded as tsh
from repro_torch.core.beam_search import SearchSpec
from repro_torch.core.engine import brute_force_knn, recall_at_k
from repro_torch.serving import VectorSearchFrontend
from repro_torch.store import sharded_store as tss

from conftest import make_clustered

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D, S = 1600, 16, 4
SPARE = 32
SPEC = dict(tier="sharded", n_shards=S, degree=16, build_beam=32, n_bits=4,
            bucket_capacity=8, cache_frames=64)
ADAPT = dict(observe_every=1, baseline_every=3, min_batches=2, min_base=1,
             ttl_steps=96)
N_LABELS = 4

# the reference's mesh search on 8 forged host devices; writes the
# initial state and every step's outputs to the .npz named by argv[1]
MESH_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.beam_search import SearchSpec
from repro.core.sharded import (build_sharded_state, make_sharded_search,
                                mesh_context)

mesh = jax.make_mesh((2, 4), ("data", "model"))
rng = np.random.default_rng(0)
centers = rng.normal(size=(16, 24)).astype(np.float32) * 2
vecs = (centers[rng.integers(0, 16, 1600)]
        + rng.normal(size=(1600, 24))).astype(np.float32)
state = build_sharded_state(vecs, n_shards=4, n_devices=8,
                            max_degree=12, lsh_bits=4, bucket_cap=8)
spec = SearchSpec(beam_width=12, k=5, max_iters=64)
step = make_sharded_search(mesh, spec, 400, 4)
q = (centers[rng.integers(0, 16, 64)]
     + 0.3 * rng.normal(size=(64, 24))).astype(np.float32)
out = {name: np.asarray(getattr(state, name)) for name in state._fields}
out["queries"] = q
with mesh_context(mesh):
    jq = jax.device_put(jnp.asarray(q), NamedSharding(mesh, P("data", None)))
    st = state
    for rep in range(3):
        st, ids, dists = step(st, jq)
        out[f"ids{rep}"] = np.asarray(ids)
        out[f"dists{rep}"] = np.asarray(dists)
        for name in ("bucket_ids", "bucket_stamp", "bucket_step"):
            out[f"{name}{rep}"] = np.asarray(getattr(st, name))
np.savez(sys.argv[1], **out)
"""


# ------------------------------------------------------------ merge helpers

@pytest.mark.parametrize("s,q,kk,k", [(4, 8, 5, 5), (2, 16, 3, 6),
                                      (3, 5, 4, 2)])
def test_merge_topk_and_rebase_match_reference(s, q, kk, k):
    """Ties (distances drawn from a few values), -1 lanes carrying +inf,
    and a k that is not the per-shard k: the reference's merge."""
    rng = np.random.default_rng(s * 100 + k)
    local = rng.integers(-1, 50, size=(s, q, kk)).astype(np.int32)
    dists = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0]), size=(s, q, kk))
    dists = np.where(local < 0, np.inf, dists).astype(np.float32)
    offsets = [50 * i for i in range(s)]
    want = np.stack([np.asarray(jsh.rebase_ids(local[i], offsets[i]))
                     for i in range(s)])
    got = torch.stack([tsh.rebase_ids(torch.from_numpy(local[i]),
                                      offsets[i]) for i in range(s)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    wi, wd = jsh.merge_topk(want, dists, k)
    gi, gd = tsh.merge_topk(got, torch.from_numpy(dists), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


# ------------------------------------------------------------- mesh search

@pytest.fixture(scope="module", autouse=True)
def mesh_run(tmp_path_factory):
    """The reference's three mesh steps, one subprocess for the module,
    started when its first test sets up so that it runs beside the
    store tests (the mesh tests come last and wait for it)."""
    out = tmp_path_factory.mktemp("mesh") / "mesh.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", MESH_SCRIPT, str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def mesh_ref(mesh_run):
    proc, out = mesh_run
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
    with np.load(out) as z:
        return dict(z)


# ----------------------------------------------------------- sharded store

@pytest.fixture(scope="module")
def world():
    data, centers, assign = make_clustered(n=N, d=D, n_clusters=10, seed=2)
    rng = np.random.default_rng(3)
    q = (centers[rng.integers(0, 10, 64)]
         + 0.4 * rng.normal(size=(64, D))).astype(np.float32)
    return data, q, (assign % N_LABELS).astype(np.int32)


@pytest.fixture(scope="module")
def built(world, tmp_path_factory):
    """Shard directories each package built once (with spare capacity
    for the mutation tests); tests open copies."""
    data, _, labels = world
    root = tmp_path_factory.mktemp("sharded")
    dirs = {"ref": str(root / "ref"), "port": str(root / "port"),
            "port_filtered": str(root / "port_filtered")}
    jdb.create(jdb.IndexSpec(path=dirs["ref"], spare_capacity=SPARE,
                             **SPEC), data).close()
    tdb.create(tdb.IndexSpec(path=dirs["port"], spare_capacity=SPARE,
                             **SPEC), data, device="cpu").close()
    tdb.create(tdb.IndexSpec(path=dirs["port_filtered"], filters=True,
                             **SPEC), data, labels, device="cpu").close()
    return dirs


@pytest.fixture
def opened():
    dbs = []
    yield dbs
    for d in dbs:
        d.close()


def _transplant(ref, port):
    """Every shard's reference planes and buckets into the port."""
    for js, ts in zip(ref.backend.shards, port.backend.shards):
        ts._cat = convert.catapult_state_from_numpy(
            np.asarray(js._cat.lsh.hyperplanes),
            jbk.to_arrays(js._cat.buckets), device="cpu")


def _twins(tmp_path, built, opened, src="ref", mode="catapult",
           hop_backend="unfused", adapt=False):
    """A reference and a port database, each over its own copy of the
    shard directory ``src`` built."""
    kw = {k: v for k, v in SPEC.items() if k not in ("tier", "n_shards")}
    kw.update(hop_backend=hop_backend)
    paths = {side: str(tmp_path / side) for side in ("ref", "port")}
    for p in paths.values():
        shutil.copytree(built[src], p)
    ref = jdb.open(paths["ref"], mode=mode, spec=jdb.IndexSpec(
        **kw, **({"adapt": JPolicy(**ADAPT)} if adapt else {})))
    opened.append(ref)
    port = tdb.open(paths["port"], mode=mode, spec=tdb.IndexSpec(
        **kw, **({"adapt": PolicyConfig(**ADAPT)} if adapt else {})),
        device="cpu")
    opened.append(port)
    if mode == "catapult":
        _transplant(ref, port)
    return ref, port


def _same_buckets(port, ref, where=""):
    if port.backend.mode != "catapult":
        return
    for s, (js, ts) in enumerate(zip(ref.backend.shards,
                                     port.backend.shards)):
        want, got = jbk.to_arrays(js._cat.buckets), tbk.to_arrays(
            ts._cat.buckets)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"shard {s} {name} "
                                                  f"{where}")


def _same_search(ref, port, q, where="", io=True, **kw):
    """One batch through both; everything the search returns equal
    (``io=False``: all but the block reads and cache hits, for twins
    whose caches differ)."""
    r, p = ref.search(q, **kw), port.search(q, **kw)
    np.testing.assert_array_equal(p.ids, r.ids, err_msg=where)
    assert p.dists.tobytes() == np.asarray(r.dists).tobytes(), where
    for fld in ("hops", "ndists", "used", "won") + (
            ("block_reads", "cache_hits") if io else ()):
        np.testing.assert_array_equal(getattr(p.stats, fld),
                                      getattr(r.stats, fld),
                                      err_msg=f"{fld} {where}")
    _same_buckets(port, ref, where)
    return r, p


def _replay(ref, port, queries, rounds=2, filtered=False):
    for rnd in range(rounds):
        for lo in (0, 32):
            q = queries[lo: lo + 32]
            fl = ((np.arange(32) % (N_LABELS + 1)) - 1).astype(np.int32) \
                if filtered else None
            _same_search(ref, port, q, f"round {rnd} batch {lo}", k=8,
                         filter_labels=fl)
    assert tuple(port.io_stats()) == tuple(ref.io_stats())


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return [(name, z.read(name)) for name in z.namelist()]


def _same_dirs(port_dir, ref_dir):
    """Every file of two shard directories: the manifest and CTPL/.io.json
    byte for byte, the npz member by member."""
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names
    for name in names:
        a, b = os.path.join(port_dir, name), os.path.join(ref_dir, name)
        if name.endswith(".npz"):
            assert _npz_members(a) == _npz_members(b), name
        else:
            assert pathlib.Path(a).read_bytes() == \
                pathlib.Path(b).read_bytes(), name


@pytest.mark.parametrize("mode,hop_backend", [
    ("catapult", "unfused"), ("catapult", "fused"), ("diskann", "unfused")])
def test_reference_shards_opened_by_port_match_jax(
        tmp_path, world, built, opened, mode, hop_backend):
    ref, port = _twins(tmp_path, built, opened, "ref", mode, hop_backend)
    eng = port.backend
    assert isinstance(eng, tss.ShardedDiskVectorSearchEngine)
    assert eng.n_shards == S and port.caps == ref.caps
    np.testing.assert_array_equal(eng.offsets, ref.backend.offsets)
    for js, ts in zip(ref.backend.shards, eng.shards):
        np.testing.assert_array_equal(ts._codes_np, js._codes_np)
        assert tuple(ts._vec.shape) == (1, D)   # no vector table uploaded
    # the second round replays the first's queries over warm buckets
    _replay(ref, port, world[1], rounds=2 if hop_backend == "unfused" else 1)
    if mode == "catapult":
        assert port.search(world[1][:32], k=8).stats.used.all()


@pytest.mark.parametrize("src,mode,hop_backend", [
    ("port", "catapult", "unfused"), ("port", "diskann", "fused"),
    ("port_filtered", "catapult", "unfused")])
def test_port_shards_opened_by_reference_match_jax(
        tmp_path, world, built, opened, src, mode, hop_backend):
    ref, port = _twins(tmp_path, built, opened, src, mode, hop_backend)
    assert port.caps.filtered == ref.caps.filtered == (src != "port")
    _replay(ref, port, world[1], filtered=src != "port")


def test_port_shard_builds_match_reference_builds(built):
    """The port's own per-shard builds (seed + s) against the
    reference's: >= 99% of rows equal, same medoids, offsets and
    manifest text."""
    ref = jss.ShardedDiskVectorSearchEngine.load(built["ref"])
    port = tss.ShardedDiskVectorSearchEngine.load(built["port"],
                                                  device="cpu")
    try:
        for js, ts in zip(ref.shards, port.shards):
            same = (np.asarray(ts._adj_np) == np.asarray(js._adj_np)
                    ).all(1).mean()
            assert same >= 0.99, same
            assert ts.medoid == js.medoid
        np.testing.assert_array_equal(port.offsets, ref.offsets)
    finally:
        ref.close()
        port.close()
    man = [pathlib.Path(built[side], "manifest.json").read_text()
           for side in ("ref", "port")]
    assert man[0] == man[1]


def test_save_writes_the_reference_files(tmp_path, world, built, opened):
    """Maintainers fed the same batches, a keyed upsert and a delete, then
    ``save()`` by each package: the same directory, file by file."""
    ref, port = _twins(tmp_path, built, opened, adapt=True)
    ms = [ref.attach_maintainer(JPolicy(**ADAPT)),
          port.attach_maintainer(PolicyConfig(**ADAPT))]
    q_all = world[1]
    for lo in (0, 32, 0, 32):
        q = q_all[lo: lo + 32]
        r, p = _same_search(ref, port, q, f"batch {lo}", k=8)
        ms[0].observe(q, r.stats)
        ms[1].observe(q, p.stats)
    new = world[0][:12] + 0.25
    keys = [f"row{i}" for i in range(12)]
    for d in (ref, port):
        d.upsert(new, keys=keys)
        d.delete(keys=keys[:3])
        d.save()
    _same_dirs(str(tmp_path / "port"), str(tmp_path / "ref"))
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert manifest["keys"] == "keys.npz"
    assert (tmp_path / "port" / "shard_0000.buckets.npz").exists()


def test_mutations_write_identical_shard_files(tmp_path, world, built,
                                               opened):
    """Least-loaded insert routing, delete (with -1 padding) and
    consolidate: after each step every shard file is byte-identical and
    the next batch's results equal."""
    ref, port = _twins(tmp_path, built, opened)
    rng = np.random.default_rng(4)
    data, q_all, _ = world
    new = (data[rng.integers(0, N, SPARE)]
           + 0.3 * rng.normal(size=(SPARE, D))).astype(np.float32)
    steps = [("insert", lambda d: d.upsert(new[:20])),
             ("insert_more", lambda d: d.upsert(new[20:])),
             ("delete", lambda d: d.delete(np.array([3, 500, 1233, -1]))),
             ("consolidate", lambda d: d.consolidate())]
    for name, step in steps:
        got = [step(d) for d in (ref, port)]
        if name.startswith("insert"):
            np.testing.assert_array_equal(np.asarray(got[1]),
                                          np.asarray(got[0]))
        for s in range(S):
            f = f"shard_{s:04d}.ctpl"
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "ref" / f).read_bytes(), (name, f)
        assert (tmp_path / "port" / "manifest.json").read_text() == \
            (tmp_path / "ref" / "manifest.json").read_text(), name
        assert port.n_active == ref.n_active
        _same_search(ref, port, np.concatenate([new[:16], q_all[:16]]),
                     name, k=8)
    with pytest.raises(RuntimeError, match="capacity"):
        port.upsert(new[:1])
    assert port.backend.tombstone_fraction() == \
        ref.backend.tombstone_fraction()


@pytest.mark.parametrize("saved_by", ["ref", "port"])
def test_saved_state_resumes_in_the_other_package(tmp_path, world, built,
                                                  opened, saved_by):
    """One package serves and saves (buckets and telemetry in each
    shard's ``.buckets.npz``, the gate in the manifest); the other opens
    a copy and resumes the saver's bucket tables, answering the next
    ``publish=False`` batch like the saver.  (Both reference databases
    draw the same planes from the seeds, and the port twin holds them
    transplanted; a port that opens a reference file gets them too.)"""
    ref, port = _twins(tmp_path, built, opened, adapt=True)
    saver = ref if saved_by == "ref" else port
    m = saver.attach_maintainer()
    for lo in (0, 32):      # (a third batch would arm a shadow baseline)
        q = world[1][lo: lo + 32]
        m.observe(q, saver.search(q, k=8).stats)
    saver.save()
    shutil.copytree(tmp_path / saved_by, tmp_path / "copy")
    if saved_by == "ref":
        port = tdb.open(str(tmp_path / "copy"), device="cpu")
        opened.append(port)
        for js, ts in zip(ref.backend.shards, port.backend.shards):
            ts._cat = convert.catapult_state_from_numpy(
                np.asarray(js._cat.lsh.hyperplanes),
                tbk.to_arrays(ts._cat.buckets), device="cpu")
    else:
        ref = jdb.open(str(tmp_path / "copy"))
        opened.append(ref)
    assert port.caps == ref.caps and port.spec.n_shards == ref.spec.n_shards
    for js, ts in zip(ref.backend.shards, port.backend.shards):
        assert ts.adapt_state is not None and js.adapt_state is not None
        want = jstats.telemetry_to_arrays(js.adapt_state)
        got = tstats.telemetry_to_arrays(ts.adapt_state)
        for name in want:
            np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                          err_msg=name)
    _same_buckets(port, ref, "resumed")
    # the reopened twin's cache is cold, the saver's warm
    _same_search(ref, port, world[1][:32], "resumed", io=False, k=8,
                 publish=False)


def test_database_surface_matches_reference(tmp_path, world, built, opened):
    """Caps, dim, the host-view refusal naming the tier, ``io_stats``
    (summed over shards) before and after a reset, ``sniff``, the
    refusal of ``prebuilt`` and an ``explain`` trace with per-shard
    children."""
    ref, port = _twins(tmp_path, built, opened)
    assert port.caps == ref.caps and not port.caps.host_views
    assert port.dim == ref.dim == D
    for d in (ref, port):
        with pytest.raises(Exception, match="'sharded'") as err:
            d.vectors
        assert type(err.value).__name__ == "CapabilityError"
    _replay(ref, port, world[1], rounds=1)
    assert tuple(port.io_stats(reset=True)) == tuple(ref.io_stats(reset=True))
    assert tuple(port.io_stats()) == tuple(ref.io_stats())
    assert tdb.sniff(str(tmp_path / "port")) == jdb.sniff(
        str(tmp_path / "ref")) == ("sharded", 1)
    for pkg, kw in ((jdb, {}), (tdb, {"device": "cpu"})):
        with pytest.raises(ValueError, match="single-store only"):
            pkg.create(pkg.IndexSpec(path=str(tmp_path / "x"), **SPEC),
                       world[0], prebuilt=(np.zeros((N, 4), np.int32), 0),
                       **kw)
    tr = port.search(world[1][:32], k=8, explain=True, publish=False)
    assert [sh["name"] for sh in tr.shards] == [f"shard_{s}"
                                                for s in range(S)]
    assert tr.stage_ms("scatter") > 0 and tr.stage_ms("merge") > 0
    assert tr.blocks_read is not None


@pytest.mark.parametrize("case", ["no_manifest", "bad_format",
                                  "bad_version", "ingest_entry"])
def test_manifest_refusals_match_reference(tmp_path, built, case):
    """What the reference's loader refuses the port refuses, with the
    same exception type; a manifest ``ingest`` entry resumes the same
    ``IngestSpec`` in both packages."""
    d = tmp_path / "m.d"
    shutil.copytree(built["ref"], d)
    man = json.loads((d / "manifest.json").read_text())
    if case == "no_manifest":
        (d / "manifest.json").unlink()
    elif case == "bad_format":
        man["format"] = "something-else"
    elif case == "bad_version":
        man["version"] = 7
    else:
        man["ingest"] = {"batch_size": 64}
    if case != "no_manifest":
        (d / "manifest.json").write_text(json.dumps(man))
    if case == "ingest_entry":
        port = tdb.open(str(d), device="cpu")
        ref = jdb.open(str(d))
        try:
            assert port.spec.ingest == tdb.IngestSpec(batch_size=64)
            assert port.spec.ingest.to_dict() == ref.spec.ingest.to_dict()
            assert port.backend.manifest_extra == {"ingest": {
                "batch_size": 64}} == ref.backend.manifest_extra
        finally:
            port.close()
            ref.close()
        return
    errors = []
    for load in (jss.ShardedDiskVectorSearchEngine.load,
                 lambda p: tss.ShardedDiskVectorSearchEngine.load(
                     p, device="cpu")):
        with pytest.raises((ValueError, OSError)) as err:
            load(str(d))
        errors.append(type(err.value))
    assert errors[0] == errors[1]


def test_frontend_routes_batches_to_the_sharded_tier(tmp_path, world, built,
                                                     opened):
    """The port's micro-batching frontend over a sharded database gives
    the reference frontend's ids, flush by flush."""
    from repro.serving.engine import VectorSearchFrontend as JFrontend
    ref, port = _twins(tmp_path, built, opened)
    fes = [JFrontend(ref.backend, k=8, max_batch=16),
           VectorSearchFrontend(port.backend, k=8, max_batch=16)]
    q = world[1]
    out = []
    for fe in fes:
        tickets = [fe.submit(qq) for qq in q[:40]]
        res = fe.flush()
        out.append(np.stack([res[t][0] for t in tickets]))
    np.testing.assert_array_equal(out[1], out[0])
    # ids are capacity-ranged: row r of shard s is offsets[s] + r - s*N/S
    rows = brute_force_knn(world[0], q[:40], 8)
    shard = rows // (N // S)
    truth = port.backend.offsets[shard] + rows - shard * (N // S)
    assert recall_at_k(out[1], truth) > 0.9


# ------------------------------------------------- chip_smoke accounting

def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _count_cpu_calls(monkeypatch):
    """Every kernel wrapper called on the CPU counts into ``ops.LAUNCHES``
    (as a launch on the card does, through the same lock), so the chip
    script's ``counted``/``PathSpy`` read these searches as they read a
    card run's."""
    from repro_torch.kernels import ops
    for name in ops.LAUNCHES:
        monkeypatch.setitem(ops.LAUNCHES, name, 0)

        def wrapped(*args, _name=name, _fn=getattr(ops, name)):
            ops._count(_name)
            return _fn(*args)
        monkeypatch.setattr(ops, name, wrapped)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return ops.LAUNCHES


@pytest.mark.parametrize("mode,hop_backend", [
    ("catapult", "unfused"), ("catapult", "fused"), ("diskann", "unfused")])
def test_chip_smoke_sharded_launch_accounting(tmp_path, world, built, opened,
                                              monkeypatch, mode,
                                              hop_backend):
    """``chip_smoke.PathSpy`` (what the card run holds a sharded search
    to: each shard's search at the disk formula) against the wrapper
    calls of searches whose shards run on the pool's threads, over
    a maintainer's shadow batch too."""
    smoke = _load_chip_smoke()
    d = tdb.open(str(shutil.copytree(built["port"], tmp_path / "d")),
                 mode=mode,
                 spec=tdb.IndexSpec(hop_backend=hop_backend, **(
                     {"adapt": PolicyConfig(**ADAPT)}
                     if mode == "catapult" else {})),
                 device="cpu")
    opened.append(d)
    _count_cpu_calls(monkeypatch)
    m = d.attach_maintainer() if mode == "catapult" else None
    with smoke.PathSpy(d.backend.shards) as spy:
        def drive():
            for lo in (0, 32, 0, 32, 0):
                q = world[1][lo: lo + 32]
                st = d.search(q, k=8).stats
                if m is not None:
                    m.observe(q, st)
        _, got = smoke.counted(drive)
    want = spy.expected(hop_backend)
    want["lsh_hash"] += spy.folds
    assert got == want and got["gather_distance"] == 0
    assert len(spy.cold) == 5 * S
    if m is not None:          # the shadow batch ran every shard diskann
        assert m.shadows == 1
        assert [p for p, _ in spy.cold].count("diskann") == S


def test_chip_smoke_mesh_launch_accounting(mesh_ref, monkeypatch):
    """``chip_smoke.spy_lookups`` and the catapult RAM formula against the
    wrapper calls of the mesh search's device steps."""
    smoke = _load_chip_smoke()
    z = mesh_ref
    state = tsh.ShardedEngineState(*[torch.from_numpy(z[name]) for name in
                                     tsh.ShardedEngineState._fields])
    step = tsh.make_sharded_search((2, 4), SearchSpec(beam_width=12, k=5,
                                                      max_iters=64), 400, 4)
    _count_cpu_calls(monkeypatch)
    (_, iters), got = smoke.counted(lambda: smoke.spy_lookups(
        lambda: step(state, torch.from_numpy(z["queries"]))))
    assert len(iters) == 8
    assert got == smoke.expected_launches("catapult", "unfused", iters)


def test_launch_counts_survive_many_threads():
    """The launch counter is shared by the sharded tier's pool threads:
    with a tiny switch interval and more threads than cores no
    increment is lost."""
    import threading
    from repro_torch.kernels import ops
    before = ops.LAUNCHES["l2_distance"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [ops._count("l2_distance") for _ in range(2000)])
            for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert ops.LAUNCHES["l2_distance"] - before == 2000 * len(threads)
    ops.LAUNCHES["l2_distance"] = before


def test_mesh_search_matches_forged_device_reference(mesh_ref):
    z = mesh_ref
    state = tsh.ShardedEngineState(*[torch.from_numpy(z[name]) for name in
                                     tsh.ShardedEngineState._fields])
    step = tsh.make_sharded_search((2, 4), SearchSpec(beam_width=12, k=5,
                                                      max_iters=64), 400, 4)
    q = torch.from_numpy(z["queries"])
    for rep in range(3):
        state, ids, dists = step(state, q)
        np.testing.assert_array_equal(ids.numpy(), z[f"ids{rep}"],
                                      err_msg=f"step {rep}")
        np.testing.assert_allclose(dists.numpy(), z[f"dists{rep}"],
                                   rtol=1e-6)
        for name in ("bucket_ids", "bucket_stamp", "bucket_step"):
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          z[f"{name}{rep}"],
                                          err_msg=f"{name} step {rep}")
    assert int(state.bucket_step.sum()) > 0
    truth = brute_force_knn(z["vectors"], z["queries"], 5)
    assert recall_at_k(ids.numpy(), truth) > 0.9


def test_port_build_sharded_state_matches_reference_graphs(mesh_ref):
    """The port's own per-shard Vamana builds (seed + s) against the
    reference's: >= 99% of rows equal, medoids equal, empty per-device
    tables of the reference's shape."""
    z = mesh_ref
    st = tsh.build_sharded_state(z["vectors"], n_shards=4, n_devices=8,
                                 max_degree=12, lsh_bits=4, bucket_cap=8,
                                 device="cpu")
    same = (st.adjacency.numpy() == z["adjacency"]).all(1).mean()
    assert same >= 0.99, same
    np.testing.assert_array_equal(st.medoids.numpy(), z["medoids"])
    for name in ("bucket_ids", "bucket_stamp", "bucket_step"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), z[name])
    assert tuple(st.hyperplanes.shape) == z["hyperplanes"].shape
    with pytest.raises(ValueError):
        tsh.build_sharded_state(z["vectors"][:1601 - 400], n_shards=4,
                                device="cpu")
