"""repro_torch.store's host modules against the reference's, on the CPU.

``layout``, ``cache`` and ``pipeline`` are copies of the reference's
numpy modules (the port imports nothing of the reference package), so
they are held to them exactly:

* ``layout``: the same inputs give byte-identical CTPL files (header,
  blocks and every tail section, written in any order), each package
  reads the other's file back, and both refuse the same broken files
  with the same message;
* ``cache``: one request sequence (demand fetches, pins, rotating and
  tier pins, invalidation) gives equal fetched bytes, per-call
  hits/misses, counters, resident frames and pin sets under both
  admission policies;
* ``pipeline``: speculative reads drained before each demand fetch give
  equal counters (undrained, they depend on thread timing).
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.store import cache as jcache
from repro.store import layout as jlayout
from repro.store import pipeline as jpipeline
from repro_torch.store import cache as tcache
from repro_torch.store import layout as tlayout
from repro_torch.store import pipeline as tpipeline

N, D, R = 300, 12, 7


def _graph(seed=3, n=N):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    adj = rng.integers(-1, n, size=(n, R)).astype(np.int32)
    labels = rng.integers(0, 5, size=n).astype(np.int32)
    return vecs, adj, labels


def _write(mod, path, labeled, tail_order):
    """A store with every tail section, written in ``tail_order``."""
    vecs, adj, labels = _graph()
    rng = np.random.default_rng(9)
    store = mod.write_store(str(path), vecs, adj, medoid=17,
                            labels=labels if labeled else None,
                            capacity=N + 20)
    tomb = np.zeros(N + 20, bool)
    tomb[N:] = True
    tomb[rng.integers(0, N, 30)] = True
    writes = {"pq": lambda: store.write_pq(
                  rng.normal(size=(4, 16, D // 4)).astype(np.float32)),
              "tombs": lambda: store.write_tombstones(tomb),
              "entries": lambda: store.write_label_entries(
                  np.arange(5, dtype=np.int32) * 3)}
    for name in tail_order:
        if name != "entries" or labeled:
            writes[name]()
    store.flush(n_active=N - 5, medoid=21)
    store.close()
    return path.read_bytes()


@pytest.mark.parametrize("labeled,tail_order", [
    (False, ("pq", "tombs")), (True, ("pq", "tombs", "entries")),
    (True, ("entries", "tombs", "pq"))])
def test_layout_files_match_reference(tmp_path, labeled, tail_order):
    got = _write(tlayout, tmp_path / "port.ctpl", labeled, tail_order)
    want = _write(jlayout, tmp_path / "ref.ctpl", labeled, tail_order)
    assert got == want
    assert got[:4] == b"CTPL" and len(got) > tlayout.HEADER_SIZE
    # each package reads the other's file, section by section
    for mod, other in ((tlayout, "ref.ctpl"), (jlayout, "port.ctpl")):
        bs = mod.open_store(str(tmp_path / other), mode="r")
        ref = jlayout.open_store(str(tmp_path / "ref.ctpl"), mode="r")
        assert vars(bs.header) == vars(ref.header)
        np.testing.assert_array_equal(bs.vectors, ref.vectors)
        np.testing.assert_array_equal(bs.adjacency, ref.adjacency)
        np.testing.assert_array_equal(bs.labels, ref.labels)
        np.testing.assert_array_equal(bs.read_pq(), ref.read_pq())
        np.testing.assert_array_equal(bs.read_tombstones(),
                                      ref.read_tombstones())
        if labeled:
            np.testing.assert_array_equal(bs.read_label_entries(),
                                          ref.read_label_entries())
        bs.close()
        ref.close()


def _broken(path, case):
    """Damage a fresh store file the way ``case`` names."""
    vecs, adj, _ = _graph()
    jlayout.write_store(str(path), vecs, adj, medoid=0).close()
    raw = bytearray(path.read_bytes())
    if case == "magic":
        raw[:4] = b"XXXX"
    elif case == "version":
        raw[4:8] = (jlayout.VERSION + 1).to_bytes(4, "little")
    elif case == "old_version":
        raw[4:8] = (0).to_bytes(4, "little")
    elif case == "truncated":
        raw = raw[:-100]
    elif case == "block_size":
        raw[32:36] = (int.from_bytes(raw[32:36], "little")
                      + 512).to_bytes(4, "little")
    elif case == "header":
        raw = raw[:40]
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("case", ["magic", "version", "old_version",
                                  "truncated", "block_size", "header"])
def test_layout_refusals_match_reference(tmp_path, case):
    path = tmp_path / "bad.ctpl"
    _broken(path, case)
    msgs = []
    for mod in (jlayout, tlayout):
        with pytest.raises(mod.StoreFormatError) as err:
            mod.open_store(str(path))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_read_only_store_refuses_writes_like_reference(tmp_path):
    path = tmp_path / "ro.ctpl"
    jlayout.write_store(str(path), *_graph()[:2], medoid=0).close()
    msgs = []
    for mod in (jlayout, tlayout):
        ro = mod.open_store(str(path), mode="r")
        for write in (ro.flush, lambda: ro.write_tombstones(
                np.zeros(N, bool))):
            with pytest.raises(mod.StoreFormatError) as err:
                write()
            msgs.append(str(err.value))
        ro.close()
    assert msgs[:2] == msgs[2:]


def _cache_run(cmod, lmod, path, admission):
    """One request sequence against a 24-frame cache; everything it
    observes, in order."""
    bs = lmod.open_store(str(path), mode="r")
    cache = cmod.NodeCache(bs, capacity=24, admission=admission)
    rng = np.random.default_rng(5)
    seen = []

    def snap():
        seen.append((tuple(cache.stats), tuple(cache.io_stats),
                     sorted(cache.frame_of), cache.pinned.tolist(),
                     cache.frame_node.tolist(), cache.hand,
                     cache.hit_rate, cache.resident))

    cache.pin(np.array([0, 5]))
    for rnd in range(12):
        reqs = [np.unique(rng.integers(0, N, size=rng.integers(0, 9)))
                for _ in range(4)]
        for vecs, adj, hits, misses in cache.fetch_batch(reqs):
            seen.append((vecs.tobytes(), adj.tobytes(), hits, misses))
        got = cache.fetch(np.array([rnd, rnd + 1, 0]))
        seen.append(tuple(np.asarray(a).tobytes() if isinstance(a, np.ndarray)
                          else a for a in got))
        if rnd % 3 == 0:
            cache.pin_rotating(rng.integers(0, N, 4))
        if rnd == 5:
            cache.set_tier_pins(np.arange(40, 46))
        if rnd == 8:
            cache.invalidate()
            cache.pin(3)
        seen.append((cache.prefetch(int(rng.integers(0, N))),
                     cache.contains(7), cache.missing(np.arange(10))))
        snap()
    cache.reset_counters()
    snap()
    bs.close()
    return seen


@pytest.mark.parametrize("admission", ["clock", "locality"])
def test_node_cache_matches_reference(tmp_path, admission):
    vecs, adj, _ = _graph()
    path = tmp_path / "c.ctpl"
    jlayout.write_store(str(path), vecs, adj, medoid=0).close()
    got = _cache_run(tcache, tlayout, path, admission)
    want = _cache_run(jcache, jlayout, path, admission)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    assert tcache.ZERO_IO_STATS == jcache.ZERO_IO_STATS
    assert tcache.IoStats._fields == jcache.IoStats._fields
    assert tcache.ADMISSION_POLICIES == jcache.ADMISSION_POLICIES
    with pytest.raises(ValueError):
        tcache.NodeCache(None, capacity=1)


def _pipeline_run(cmod, pmod, lmod, path, admission):
    bs = lmod.open_store(str(path), mode="r")
    cache = cmod.NodeCache(bs, capacity=32, admission=admission)
    pipe = pmod.IoPipeline(cache, workers=3, queue_depth=16)
    rng = np.random.default_rng(8)
    seen = []
    try:
        for _ in range(6):
            pipe.advance()
            seen.append(pipe.speculate(rng.integers(0, N, 24)))
            pipe.drain()
            reqs = [np.unique(rng.integers(0, N, 6)) for _ in range(3)]
            pipe.submit(np.unique(np.concatenate(reqs)))
            pipe.drain()
            out = cache.fetch_batch(reqs)
            seen.append([(v.tobytes(), a.tobytes(), h, m)
                         for v, a, h, m in out])
            seen.append((tuple(cache.io_stats), pipe.outstanding))
    finally:
        pipe.close()
        bs.close()
    return seen


@pytest.mark.parametrize("admission", ["clock", "locality"])
def test_io_pipeline_drained_matches_reference(tmp_path, admission):
    vecs, adj, _ = _graph()
    path = tmp_path / "p.ctpl"
    jlayout.write_store(str(path), vecs, adj, medoid=0).close()
    got = _pipeline_run(tcache, tpipeline, tlayout, path, admission)
    want = _pipeline_run(jcache, jpipeline, jlayout, path, admission)
    assert got == want
