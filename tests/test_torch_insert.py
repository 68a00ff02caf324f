"""repro_torch FreshVamana updates against the JAX package on the CPU:
``core/insert.py`` step by step, the engine's insert -> delete ->
consolidate with and without labels and PQ, and the facade's keyed
upsert/delete.

Inputs: ``tests/test_filters_insert.py``'s labeled corpus (1,200 x 16, 4
labels, degree 16) over the reference's Vamana graph; the catapult
state and PQ codebook are transplanted.  Adjacency, tombstones, medoid,
label entries, codes, bucket tables, ids, hops and ndists must be
exactly equal after every step; distances agree to rtol 1e-6.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro import db as jdb
from repro.core import buckets as jbk
from repro.core import filters as jflt
from repro.core import insert as jins
from repro.core import vamana as jvam
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.core import buckets as tbk
from repro_torch.core import insert as tins
from repro_torch.core import vamana as tvam

N_LABELS = 4
SPEC = dict(degree=16, build_beam=32, n_bits=4, bucket_capacity=8)
JVP = jvam.VamanaParams(max_degree=16, build_beam=32, batch=512)
TVP = tvam.VamanaParams(max_degree=16, build_beam=32, batch=512)


@pytest.fixture(scope="module")
def labeled():
    data, centers, assign = make_clustered(1200, 16, 8, seed=21)
    return data, (assign % N_LABELS).astype(np.int32), centers


@pytest.fixture(scope="module")
def graph(labeled):
    """The reference's Vamana graph of the labeled corpus, and its label
    entry points: a valid ``prebuilt`` for filtered and plain twins."""
    data, labels, _ = labeled
    adj, med = jvam.build_vamana(data, JVP)
    return adj, med, jflt.label_entry_points(data, labels, N_LABELS)


def _new_rows(labeled, n, seed, far=False):
    data, _, centers = labeled
    rng = np.random.default_rng(seed)
    if far:     # out of distribution: RobustPrune drops most back-edges
        return (centers[0] + 30.0 + 0.05 * rng.normal(size=(n, 16))).astype(
            np.float32)
    idx = rng.integers(0, data.shape[0], n)
    return (data[idx] + 0.3 * rng.normal(size=(n, 16))).astype(np.float32)


@pytest.mark.parametrize("mirrors", ["shared", "copies"])
def test_insert_delete_consolidate_steps_match_jax(labeled, graph, mirrors):
    """``insert_batch`` (twice, the second batch far out of distribution),
    ``delete`` and ``consolidate`` on the host arrays.  The device tables
    either share the host arrays' memory (a CPU engine's) or are copies
    that the port keeps current row by row; either way they must end
    equal to the host arrays."""
    data, _, _ = labeled
    adj, med, _ = graph
    n, cap = data.shape[0], data.shape[0] + 80
    ja, ta = np.full((cap, 16), -1, np.int32), np.full((cap, 16), -1, np.int32)
    ja[:n] = ta[:n] = adj
    jv, tv = np.zeros((cap, 16), np.float32), np.zeros((cap, 16), np.float32)
    jv[:n] = tv[:n] = data
    mirror = torch.as_tensor if mirrors == "shared" else torch.tensor
    tables = (mirror(ta), mirror(tv))
    na = n
    for seed, far in ((1, False), (2, True)):
        new = _new_rows(labeled, 40, seed, far)
        got = tins.insert_batch(ta, tv, na, new, med, TVP, *tables)
        na = jins.insert_batch(ja, jv, na, new, med, JVP)
        assert got == na
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tables[0].numpy(), ta)
        np.testing.assert_array_equal(tables[1].numpy(), tv)
    # the far batch forced in-edges
    assert (ja[:n] >= n + 40).any()

    tomb = np.zeros(cap, bool)
    tomb[na:] = True
    dead = np.random.default_rng(3).choice(na, 120, replace=False)
    tt, jt = tins.delete(tomb, dead), jins.delete(tomb, dead)
    np.testing.assert_array_equal(tt, jt)
    assert not tomb[dead].any()            # a copy, not in place
    rep = tins.consolidate(ta, tv, tt, na, TVP)
    assert rep == jins.consolidate(ja, jv, jt, na, JVP) > 0
    np.testing.assert_array_equal(ta, ja)
    assert (ta[dead] == -1).all() and not np.isin(ta, dead).any()


def _twins(labeled, graph, mode="catapult", filtered=False, pq=None,
           hop_backend="unfused"):
    data, labels, _ = labeled
    kw = dict(mode=mode, pq=pq, filters=filtered, spare_capacity=100,
              hop_backend=hop_backend, **SPEC)
    lab = labels if filtered else None
    pre = graph if filtered else graph[:2]
    ref = jdb.create(jdb.IndexSpec(**kw), data, lab, prebuilt=pre)
    port = tdb.create(tdb.IndexSpec(**kw), data, lab, prebuilt=pre,
                      device="cpu")
    eng = port.backend
    if pq:
        eng._init_aux(data, pq_codebook=convert.pq_codebook_from_numpy(
            np.asarray(ref.backend._pq.centroids), device="cpu"))
        eng._sync_device()
    if mode == "catapult":
        cat = ref.backend._cat
        eng._cat = convert.catapult_state_from_numpy(
            np.asarray(cat.lsh.hyperplanes), jbk.to_arrays(cat.buckets),
            device="cpu")
    return ref, port


def _assert_state_equal(port, ref):
    t, j = port.backend, ref.backend
    np.testing.assert_array_equal(t._adj_np, j._adj_np)
    np.testing.assert_array_equal(t._vec_np, j._vec_np)
    np.testing.assert_array_equal(t._tomb_np, j._tomb_np)
    assert t.medoid == int(j.medoid) and t.n_active == j.n_active
    # the device tables follow the host arrays
    np.testing.assert_array_equal(t._adj.numpy(), t._adj_np)
    np.testing.assert_array_equal(t._tomb.numpy(), t._tomb_np)
    if j.filtered:
        np.testing.assert_array_equal(t._labels_np, j._labels_np)
        np.testing.assert_array_equal(t._label_entry_np,
                                      np.asarray(j._label_entry))
        np.testing.assert_array_equal(t._label_entry.numpy(),
                                      t._label_entry_np)
    if j.pq_subspaces:
        np.testing.assert_array_equal(t._codes_np, j._codes_np)
        np.testing.assert_array_equal(t._codes.numpy(), t._codes_np)
    if j.mode == "catapult":
        want, got = jbk.to_arrays(j._cat.buckets), tbk.to_arrays(
            t._cat.buckets)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    assert t.tombstone_fraction() == j.tombstone_fraction()


def _assert_search_equal(port, ref, q, fl):
    r = ref.search(q, k=5, beam_width=16, filter_labels=fl)
    p = port.search(q, k=5, beam_width=16, filter_labels=fl)
    np.testing.assert_array_equal(p.ids, r.ids)
    fin = np.isfinite(r.dists)
    np.testing.assert_array_equal(np.isfinite(p.dists), fin)
    np.testing.assert_allclose(p.dists[fin], r.dists[fin], rtol=1e-6)
    for fld in ("hops", "ndists", "used", "won"):
        np.testing.assert_array_equal(getattr(p.stats, fld),
                                      getattr(r.stats, fld), err_msg=fld)
    return p


@pytest.mark.parametrize("filtered,pq", [(False, None), (True, None),
                                         (False, 4), (True, 4)])
def test_engine_updates_match_jax(labeled, graph, filtered, pq):
    """insert -> search -> delete (the medoid and a label entry among the
    dead) -> search -> consolidate -> search, on twin engines."""
    data, labels, _ = labeled
    ref, port = _twins(labeled, graph, filtered=filtered, pq=pq)
    rng = np.random.default_rng(11)
    new = _new_rows(labeled, 48, 12)
    new_labels = rng.integers(0, N_LABELS, 48).astype(np.int32)
    lab = new_labels if filtered else None
    q = np.concatenate([new[:16] + 0.01, data[:16] + 0.01]).astype(np.float32)
    fl = (np.concatenate([new_labels[:16], labels[:16]]) if filtered
          else None)

    _assert_search_equal(port, ref, q, fl)
    got = port.backend.insert(new, lab)
    np.testing.assert_array_equal(got, ref.backend.insert(new, lab))
    _assert_state_equal(port, ref)
    p = _assert_search_equal(port, ref, q, fl)
    if not filtered:    # the new rows' labels are random to their region
        assert (p.ids[:16, 0] >= data.shape[0]).mean() > 0.9

    dead = np.unique(np.concatenate([
        p.ids[:, 0], [ref.backend.medoid],
        np.asarray(ref.backend._label_entry)[:2] if filtered else [],
        [-1]]).astype(np.int64))
    port.backend.delete(dead)
    ref.backend.delete(dead)
    _assert_state_equal(port, ref)
    p = _assert_search_equal(port, ref, q, fl)
    assert not np.isin(p.ids, dead[dead >= 0]).any()

    assert port.backend.consolidate() == ref.backend.consolidate() > 0
    _assert_state_equal(port, ref)
    p = _assert_search_equal(port, ref, q, fl)
    assert not np.isin(p.ids, dead[dead >= 0]).any()


@pytest.mark.parametrize("filtered", [False, True])
def test_facade_upsert_and_delete_by_key_match_jax(labeled, graph, filtered):
    """Keyed upserts (a true upsert replaces the old row), deletes by key
    and by id, and the ingest counters, against the reference facade."""
    data, labels, _ = labeled
    ref, port = _twins(labeled, graph, filtered=filtered)
    new = _new_rows(labeled, 30, 21)
    lab = (np.arange(30) % N_LABELS).astype(np.int32) if filtered else None
    keys = [f"doc{i}" for i in range(30)]
    for db in (ref, port):
        db.upsert(new, lab, keys=keys)
    again = slice(5, 15)
    got = port.upsert(new[again] + 0.05, None if lab is None else lab[again],
                      keys=keys[again])
    want = ref.upsert(new[again] + 0.05, None if lab is None else lab[again],
                      keys=keys[again])
    np.testing.assert_array_equal(got, want)
    assert port.keys["doc5"] == got[0] and len(port.keys) == 30
    assert port.tombstones[data.shape[0] + 5] and not port.tombstones[got[0]]
    for db in (ref, port):
        db.delete(keys=["doc0", "doc7"])
        db.delete(ids=np.array([3, -1]))
    _assert_state_equal(port, ref)
    q = new[:12] + 0.01
    fl = lab[:12] if filtered else None
    p = _assert_search_equal(port, ref, q, fl)
    gone = [data.shape[0], data.shape[0] + 5, data.shape[0] + 7, got[2], 3]
    assert not np.isin(p.ids, gone).any()
    assert port.consolidate() == ref.consolidate()
    _assert_state_equal(port, ref)
    m, jm = port.metrics(), ref.metrics()
    for name in ("rows", "batches", "reupserts", "deletes", "keys"):
        key = f"catapultdb_ingest_{name}" + ("" if name == "keys"
                                              else "_total")
        assert m[key] == jm[key], key
    np.testing.assert_array_equal(port.vectors, ref.vectors)
    np.testing.assert_array_equal(port.tombstones, ref.tombstones)
    assert port.n_labels == ref.n_labels


def test_facade_update_rules_match_reference(labeled, graph):
    data, labels, _ = labeled
    plain = tdb.create(tdb.IndexSpec(mode="diskann", spare_capacity=4,
                                     **SPEC), data, prebuilt=graph[:2],
                       device="cpu")
    filtered = tdb.create(tdb.IndexSpec(mode="diskann", filters=True,
                                        spare_capacity=4, **SPEC), data,
                          labels, prebuilt=graph, device="cpu")
    assert plain.caps.mutable and not plain.caps.filtered
    with pytest.raises(tdb.CapabilityError):
        plain.upsert(data[:1], np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="labels"):
        filtered.upsert(data[:1])
    with pytest.raises(ValueError, match="keys"):
        plain.upsert(data[:2], keys=["a"])
    with pytest.raises(TypeError):
        plain.delete()
    with pytest.raises(TypeError):
        plain.delete(ids=[1], keys=["a"])
    plain.upsert(data[:1], keys=[7])
    with pytest.raises(KeyError):
        plain.delete(keys=[8])
    with pytest.raises(TypeError):
        plain.upsert(data[:1], keys=["x"])       # int keys already
    with pytest.raises(ValueError, match="capacity"):
        plain.upsert(data[:4])
