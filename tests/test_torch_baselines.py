"""The paper's two baselines in the port: the HNSW-style hierarchy
(``repro_torch.core.hnsw``) and the Proximity cache
(``repro_torch.core.proximity_cache``), against the reference on the CPU.

HNSW: the upper levels' subsets come from the same
``np.random.default_rng(seed)`` in both packages, so the port's own
build picks the reference's level ids exactly; each level's graph is a
Vamana build (>= 99% of rows agree), so the search checks carry the
reference's hierarchy across with ``convert.hnsw_index_from_numpy`` and
its LSH planes with ``LSHParams``.  Then descent entries, ids, hops,
ndists, used and the bucket tables are equal after every pass, and
distances agree to rtol 1e-6.  The corpus is ``tests/test_hnsw.py``'s.

Proximity: hits, cached ids, LRU stamps and the step are equal after
every batch, on ``tests/test_baselines.py``'s two scenarios.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import db as jdb
from repro.core import buckets as jbk
from repro.core import hnsw as jhnsw
from repro.core import proximity_cache as jpc
from repro.core.beam_search import SearchSpec as JSpec
from repro.core.vamana import VamanaParams as JVP
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.core import brute_force_knn, recall_at_k
from repro_torch.core import buckets as tbk
from repro_torch.core import hnsw as thnsw
from repro_torch.core import proximity_cache as tpc
from repro_torch.core.beam_search import SearchSpec
from repro_torch.core.lsh import LSHParams
from repro_torch.core.vamana import VamanaParams

from conftest import make_clustered

VP = dict(max_degree=16, build_beam=32, batch=512)


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
def corpus_h():
    data, centers, _ = make_clustered(2000, 16, 12, seed=5)
    return data, centers


def _carry(ref_index):
    return convert.hnsw_index_from_numpy(
        np.asarray(ref_index.vectors), ref_index.level_ids,
        [np.asarray(a) for a in ref_index.level_adj],
        np.asarray(ref_index.base_adj), ref_index.entry, device="cpu")


@pytest.fixture(scope="module")
def hnsw_pair(corpus_h):
    ref = jhnsw.build_hnsw(corpus_h[0], JVP(**VP), level_scale=8, seed=0)
    return ref, _carry(ref)


def test_hierarchy_structure_matches_reference(corpus_h):
    """The port's own build beside the reference's on the first 600 rows:
    the same level ids (same rng), levels shrinking and nested, every
    graph's shape and the top entry equal."""
    sub = corpus_h[0][:600]
    ref = jhnsw.build_hnsw(sub, JVP(**VP), level_scale=4, seed=0)
    port = thnsw.build_hnsw(sub, VamanaParams(**VP), level_scale=4,
                            seed=0, device="cpu")
    assert len(port.level_ids) == len(ref.level_ids) >= 1
    for a, b in zip(port.level_ids, ref.level_ids):
        np.testing.assert_array_equal(a, b)
    assert port.entry == ref.entry
    sizes = [len(i) for i in port.level_ids]
    assert sizes == sorted(sizes, reverse=True)
    prev = np.arange(port.base_adj.shape[0])
    for ids, adj, jadj in zip(port.level_ids, port.level_adj,
                              ref.level_adj):
        assert set(ids.tolist()) <= set(prev.tolist())
        assert tuple(adj.shape) == tuple(jadj.shape)
        prev = ids
    assert tuple(port.base_adj.shape) == tuple(ref.base_adj.shape)


def test_descent_lands_near_query_as_reference(corpus_h, hnsw_pair):
    data, centers = corpus_h
    ref, port = hnsw_pair
    rng = np.random.default_rng(1)
    q = (centers[rng.integers(0, 12, 32)]
         + 0.3 * rng.normal(size=(32, 16))).astype(np.float32)
    entries = thnsw.descend(port, torch.as_tensor(q)).numpy()
    np.testing.assert_array_equal(
        entries, np.asarray(jhnsw.descend(ref, jnp.asarray(q))))
    d_entry = ((data[entries] - q) ** 2).sum(1)
    d_top = ((data[port.entry] - q) ** 2).sum(1)
    assert d_entry.mean() < d_top.mean()


def test_hnsw_recall_matches_reference(corpus_h, hnsw_pair):
    data, _ = corpus_h
    ref, port = hnsw_pair
    rng = np.random.default_rng(2)
    q = (data[rng.integers(0, 2000, 64)]
         + 0.05 * rng.normal(size=(64, 16))).astype(np.float32)
    res = thnsw.search(port, torch.as_tensor(q),
                       SearchSpec(beam_width=16, k=5, max_iters=96))
    want = jhnsw.search(ref, jnp.asarray(q),
                        JSpec(beam_width=16, k=5, max_iters=96))
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(res.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-6)
    np.testing.assert_array_equal(res.hops.numpy(), np.asarray(want.hops))
    truth = brute_force_knn(data, q, 5)
    assert recall_at_k(res.ids.numpy(), truth) > 0.9


def test_catapults_transparent_over_hnsw(corpus_h, hnsw_pair):
    """The headline over the second substrate, in both packages on one
    hierarchy (the module's; ``HnswEngine.build`` draws the planes and
    empty buckets as below): cold catapult == plain, warm fewer hops and
    distances, recall never worse; every pass's ids, stats and bucket
    tables equal."""
    import jax
    from repro.core import lsh as jlsh
    data, centers = corpus_h
    rng = np.random.default_rng(3)
    q = (centers[rng.integers(0, 12, 96)]
         + 0.3 * rng.normal(size=(96, 16))).astype(np.float32)
    ref_cat = jhnsw.HnswEngine(mode="catapult", seed=0)
    ref_cat.index = hnsw_pair[0]
    ref_cat._lsh = jlsh.make_lsh(jax.random.PRNGKey(0), 8, 16)
    ref_cat._buckets = jbk.make_buckets(2 ** 8, 40)
    ref_plain = jhnsw.HnswEngine(mode="plain", seed=0)
    ref_plain.index = ref_cat.index
    carried = hnsw_pair[1]
    ports = {}
    for mode in ("plain", "catapult"):
        eng = thnsw.HnswEngine(mode=mode, seed=0, device="cpu")
        eng.index = carried
        eng._lsh = LSHParams(hyperplanes=torch.tensor(
            np.asarray(ref_cat._lsh.hyperplanes)))
        eng._buckets = tbk.make_buckets(2 ** 8, 40, device="cpu")
        ports[mode] = eng

    def both(ref_eng, port_eng):
        r = ref_eng.search(q, k=3, beam_width=4)
        p = port_eng.search(q, k=3, beam_width=4)
        np.testing.assert_array_equal(p[0], r[0])
        np.testing.assert_allclose(p[1], r[1], rtol=1e-6)
        for key in ("hops", "ndists", "used"):
            np.testing.assert_array_equal(p[2][key], r[2][key])
        if port_eng.mode == "catapult":
            want = jbk.to_arrays(ref_eng._buckets)
            got = tbk.to_arrays(port_eng._buckets)
            for name in want:
                np.testing.assert_array_equal(got[name], want[name])
        return p

    ids_p, _, st_p = both(ref_plain, ports["plain"])
    ids_c0, _, _ = both(ref_cat, ports["catapult"])
    np.testing.assert_array_equal(ids_p, ids_c0)
    for _ in range(2):
        ids_c, _, st_c = both(ref_cat, ports["catapult"])
    truth = brute_force_knn(data, q, 3)
    assert st_c["used"].mean() > 0.9
    assert st_c["hops"].mean() <= st_p["hops"].mean()
    assert st_c["ndists"].mean() < st_p["ndists"].mean()
    assert recall_at_k(ids_c, truth) >= recall_at_k(ids_p, truth) - 0.02


def test_hnsw_engine_build_on_the_port(corpus_h):
    """``HnswEngine.build`` end to end on the port: the reference's level
    ids, planes of the engine's shape, and the catapult pass after the
    first using its buckets."""
    data, _ = corpus_h
    sub = data[:300]
    eng = thnsw.HnswEngine(mode="catapult", seed=0, n_bits=4,
                           bucket_capacity=8, device="cpu").build(
                               sub, VamanaParams(**VP))
    rng = np.random.default_rng(0)
    keep = max(300 // 16, 4)
    want = np.sort(rng.choice(np.arange(300), size=keep, replace=False))
    np.testing.assert_array_equal(eng.index.level_ids[0], want)
    assert tuple(eng._lsh.hyperplanes.shape) == (4, 16)
    first = eng.search(sub[:32], k=3, beam_width=8)
    second = eng.search(sub[:32], k=3, beam_width=8)
    assert not first[2]["used"].any() and second[2]["used"].all()


# ------------------------------------------------------------ proximity


def _cache_equal(port, ref):
    np.testing.assert_array_equal(port.stamp.numpy(), np.asarray(ref.stamp))
    np.testing.assert_array_equal(port.values.numpy(),
                                  np.asarray(ref.values))
    np.testing.assert_array_equal(port.keys.numpy(), np.asarray(ref.keys))
    assert port.step == int(ref.step)


def _probe_equal(port, ref, q, tau):
    p = tpc.cache_probe(port, torch.as_tensor(q), tau)
    r = jpc.cache_probe(ref, jnp.asarray(q), jnp.float32(tau))
    np.testing.assert_array_equal(p.hit.numpy(), np.asarray(r.hit))
    np.testing.assert_array_equal(p.ids.numpy(), np.asarray(r.ids))
    return p


def test_proximity_cache_hit_miss():
    port = tpc.make_cache(capacity=8, dim=4, k=3, device="cpu")
    ref = jpc.make_cache(capacity=8, dim=4, k=3)
    q = np.eye(4, dtype=np.float32)
    ids = np.arange(12, dtype=np.int32).reshape(4, 3)
    port = tpc.cache_insert(port, torch.as_tensor(q), torch.as_tensor(ids),
                            torch.ones(4, dtype=torch.bool))
    ref = jpc.cache_insert(ref, jnp.asarray(q), jnp.asarray(ids),
                           jnp.ones(4, bool))
    _cache_equal(port, ref)
    hit = _probe_equal(port, ref, q + 0.001, 0.1)
    assert hit.hit.all()
    np.testing.assert_array_equal(hit.ids.numpy(), ids)
    miss = _probe_equal(port, ref, q + 10.0, 0.1)
    assert not miss.hit.any()
    # LRU past capacity, with a masked lane: the oldest slots go first
    more = np.random.default_rng(0).normal(size=(9, 4)).astype(np.float32)
    mids = np.arange(27, dtype=np.int32).reshape(9, 3) + 100
    mask = np.ones(9, bool)
    mask[4] = False
    port = tpc.cache_insert(port, torch.as_tensor(more),
                            torch.as_tensor(mids), torch.as_tensor(mask))
    ref = jpc.cache_insert(ref, jnp.asarray(more), jnp.asarray(mids),
                           jnp.asarray(mask))
    _cache_equal(port, ref)
    _probe_equal(port, ref, more, 0.01)
    flushed = tpc.flush(port)
    _cache_equal(flushed, jpc.flush(ref))
    assert flushed.keys.device == torch.device("cpu")


def test_proximity_cache_probe_chunks_large_batches(monkeypatch):
    """A probe works in chunks of queries (no (B, C, d) tensor); chunked
    and whole answers are equal."""
    rng = np.random.default_rng(1)
    keys = rng.normal(size=(64, 8)).astype(np.float32)
    state = tpc.cache_insert(
        tpc.make_cache(64, 8, 2, device="cpu"), torch.as_tensor(keys),
        torch.as_tensor(np.arange(128, dtype=np.int32).reshape(64, 2)),
        torch.ones(64, dtype=torch.bool))
    q = torch.as_tensor(keys[rng.integers(0, 64, 200)]
                        + 0.01 * rng.normal(size=(200, 8)).astype(np.float32))
    whole = tpc.cache_probe(state, q, 0.05)
    monkeypatch.setattr(tpc, "PROBE_ELEMENTS", 64 * 8 * 3)   # 3 queries
    parts = tpc.cache_probe(state, q, 0.05)
    np.testing.assert_array_equal(parts.hit.numpy(), whole.hit.numpy())
    np.testing.assert_array_equal(parts.ids.numpy(), whole.ids.numpy())
    assert whole.hit.all()


def test_proximity_cache_staleness_under_insertion():
    """Fig. 2 in both packages: the cache's lists go stale when the
    database changes; hits, ids and stamps equal after every batch."""
    data, centers, _ = make_clustered(600, 8, 4, seed=51)
    spec = dict(mode="diskann", degree=16, build_beam=32, spare_capacity=300)
    ref_db = jdb.create(jdb.IndexSpec(**spec), data)
    port_db = tdb.create(tdb.IndexSpec(**spec), data, device="cpu",
                         prebuilt=(np.asarray(ref_db.backend._adj_np),
                                   int(ref_db.backend.medoid)))
    rng = np.random.default_rng(52)
    q = (centers[1] + 0.1 * rng.normal(size=(32, 8))).astype(np.float32)
    ref = jpc.make_cache(capacity=64, dim=8, k=3)
    port = tpc.make_cache(capacity=64, dim=8, k=3, device="cpu")
    ids = port_db.search(q, k=3, beam_width=16).ids
    np.testing.assert_array_equal(
        ids, np.asarray(ref_db.search(q, k=3, beam_width=16).ids))
    ref = jpc.cache_insert(ref, jnp.asarray(q), jnp.asarray(ids),
                           jnp.ones(32, bool))
    port = tpc.cache_insert(port, torch.as_tensor(q), torch.as_tensor(ids),
                            torch.ones(32, dtype=torch.bool))
    _cache_equal(port, ref)
    better = (centers[1] + 0.01 * rng.normal(size=(60, 8))).astype(np.float32)
    np.testing.assert_array_equal(port_db.upsert(better),
                                  ref_db.upsert(better))
    truth = brute_force_knn(port_db.vectors, q, 3)
    hit = _probe_equal(port, ref, q, 1e3)
    stale_recall = recall_at_k(hit.ids.numpy(), truth)
    fresh = port_db.search(q, k=3, beam_width=16).ids
    np.testing.assert_array_equal(
        fresh, np.asarray(ref_db.search(q, k=3, beam_width=16).ids))
    assert stale_recall < 0.5 < recall_at_k(fresh, truth)
