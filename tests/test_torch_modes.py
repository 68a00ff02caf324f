"""repro_torch's remaining search modes against the JAX package on the
CPU: the LSH-APG baseline (``core/lsh_apg.py`` and ``mode='lsh_apg'``)
and ``VectorSearchEngine.search_two_phase``.

Inputs: ``tests/test_filters_insert.py``'s labeled corpus (1,200 x 16, 4
labels, degree 16) over the reference's Vamana graph.  The LSH-APG
hyperplanes and table, the catapult state and the PQ codebook are
transplanted (torch cannot replay ``jax.random``).  ids, hops, ndists,
used, won, bucket and LSH-APG tables must be exactly equal; distances
agree to rtol 1e-6.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clustered
from repro import db as jdb
from repro.core import buckets as jbk
from repro.core import filters as jflt
from repro.core import lsh as jlsh
from repro.core import lsh_apg as japg
from repro.core import vamana as jvam
from repro_torch import convert
from repro_torch import db as tdb
from repro_torch.core import buckets as tbk
from repro_torch.core import lsh as tlsh
from repro_torch.core import lsh_apg as tapg
from repro_torch.core.engine import VectorSearchEngine

N_LABELS = 4
SPEC = dict(degree=16, build_beam=32, n_bits=4, bucket_capacity=8)
JVP = jvam.VamanaParams(max_degree=16, build_beam=32, batch=512)


@pytest.fixture(scope="module")
def labeled():
    data, centers, assign = make_clustered(1200, 16, 8, seed=21)
    return data, (assign % N_LABELS).astype(np.int32), centers


@pytest.fixture(scope="module")
def graph(labeled):
    data, labels, _ = labeled
    adj, med = jvam.build_vamana(data, JVP)
    return adj, med, jflt.label_entry_points(data, labels, N_LABELS)


def _queries(labeled, n=64, seed=9):
    data, labels, _ = labeled
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, data.shape[0], n)
    return ((data[idx] + 0.2 * rng.normal(size=(n, 16))).astype(np.float32),
            labels[idx])


def _twins(labeled, graph, mode, hop_backend="unfused", pq=None,
           filtered=False):
    data, labels, _ = labeled
    kw = dict(mode=mode, hop_backend=hop_backend, pq=pq, filters=filtered,
              spare_capacity=16, **SPEC)
    lab, pre = (labels, graph) if filtered else (None, graph[:2])
    ref = jdb.create(jdb.IndexSpec(**kw), data, lab, prebuilt=pre)
    port = tdb.create(tdb.IndexSpec(**kw), data, lab, prebuilt=pre,
                      device="cpu")
    eng, jeng = port.backend, ref.backend
    if pq:
        eng._init_aux(data, pq_codebook=convert.pq_codebook_from_numpy(
            np.asarray(jeng._pq.centroids), device="cpu"))
        eng._sync_device()
    if mode == "catapult":
        eng._cat = convert.catapult_state_from_numpy(
            np.asarray(jeng._cat.lsh.hyperplanes),
            jbk.to_arrays(jeng._cat.buckets), device="cpu")
    if mode == "lsh_apg":
        eng._apg = convert.lsh_apg_index_from_numpy(
            np.asarray(jeng._apg.lsh.hyperplanes), np.asarray(jeng._apg.table),
            device="cpu")
    return ref, port


def _assert_equal(got, want, stats=("hops", "ndists", "used", "won")):
    (pi, pd, ps), (ri, rd, rs) = got, want
    np.testing.assert_array_equal(pi, ri)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    np.testing.assert_allclose(pd[fin], rd[fin], rtol=1e-6)
    for fld in stats:
        np.testing.assert_array_equal(getattr(ps, fld), getattr(rs, fld),
                                      err_msg=fld)


def test_bucket_table_matches_the_reference_fill():
    """The stable-sort fill against the reference's Python loop, on codes
    with overfull, single and empty buckets."""
    rng = np.random.default_rng(0)
    codes = np.concatenate([np.zeros(20, np.int32),
                            rng.integers(1, 12, 300).astype(np.int32), [15]])
    rng.shuffle(codes)
    want = np.full((16, 5), -1, np.int32)
    fill = np.zeros(16, np.int32)
    for i, c in enumerate(codes):
        if fill[c] < 5:
            want[c, fill[c]] = i
            fill[c] += 1
    np.testing.assert_array_equal(tapg.bucket_table(codes, 4, 5), want)


def test_build_lsh_apg_matches_jax(labeled, monkeypatch):
    """The whole build from the reference's hyperplanes: table equal."""
    data, _, _ = labeled
    key = jax.random.PRNGKey(4)
    want = japg.build_lsh_apg(data, key, 6, 5)
    planes = np.asarray(want.lsh.hyperplanes)
    # every corpus row hashes as in the reference (the closest projection
    # to 0 is 2e-6 of |x| |h|), so the two tables hold the same rows
    np.testing.assert_array_equal(
        tlsh.hash_codes(tlsh.LSHParams(hyperplanes=torch.tensor(planes)),
                        torch.as_tensor(data)).numpy(),
        np.asarray(jlsh.hash_codes(want.lsh, jnp.asarray(data))))
    monkeypatch.setattr(tapg.lsh_mod, "make_lsh",
                        lambda gen, n_bits, dim, device: tlsh.LSHParams(
                            hyperplanes=torch.tensor(planes)))
    got = tapg.build_lsh_apg(torch.as_tensor(data), None, 6, 5, device="cpu")
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    assert got.table.dtype == torch.int32
    q = data[:40] + 0.01
    np.testing.assert_array_equal(
        tapg.entry_points(got, torch.as_tensor(q), 17).numpy(),
        np.asarray(japg.entry_points(want, jnp.asarray(q), jnp.int32(17))))


def test_lsh_apg_engine_draws_its_own_planes(labeled):
    """mode='lsh_apg' draws its planes from seed + 2: neither the catapult
    draw (seed) nor the PQ draw (seed + 1) changes."""
    data, _, _ = labeled
    eng = VectorSearchEngine(mode="lsh_apg", n_bits=4, seed=5, device="cpu")
    eng.build(data[:300], prebuilt=(np.full((300, 4), -1, np.int32), 0))
    want = tlsh.make_lsh(torch.Generator().manual_seed(7), 4, 16,
                         device="cpu")
    assert torch.equal(eng._apg.lsh.hyperplanes, want.hyperplanes)
    codes = tlsh.hash_codes(want, torch.as_tensor(data[:300])).numpy()
    np.testing.assert_array_equal(eng._apg.table.numpy(),
                                  tapg.bucket_table(codes, 4, 8))


@pytest.mark.parametrize("hop_backend,pq,filtered", [
    ("unfused", None, False), ("fused", None, False), ("unfused", 4, False),
    ("unfused", None, True)])
def test_lsh_apg_search_matches_jax(labeled, graph, hop_backend, pq,
                                    filtered):
    """mode='lsh_apg' through the facade, replayed twice: equal to the
    reference, and the same hops on the replay (the table never adapts)."""
    ref, port = _twins(labeled, graph, "lsh_apg", hop_backend, pq, filtered)
    q, lab = _queries(labeled)
    fl = lab if filtered else None
    first = None
    for _ in range(2):
        for lo in (0, 32):
            sl = slice(lo, lo + 32)
            got = port.search(q[sl], k=5, beam_width=12,
                              filter_labels=None if fl is None else fl[sl])
            want = ref.search(q[sl], k=5, beam_width=12,
                              filter_labels=None if fl is None else fl[sl])
            _assert_equal(got, want)
        if first is None:
            first = got.stats.hops
    np.testing.assert_array_equal(got.stats.hops, first)
    assert not got.stats.used.any()


@pytest.mark.parametrize("mode,hop_backend", [
    ("catapult", "unfused"), ("catapult", "fused"), ("diskann", "unfused"),
    ("lsh_apg", "fused")])
def test_search_two_phase_matches_jax(labeled, graph, mode, hop_backend):
    """Two batches of ``search_two_phase`` with a short phase 1 (so most
    lanes straggle into phase 2): ids, dists, hops, ndists and the
    phase-1 used/won equal to the reference's, and the bucket tables."""
    ref, port = _twins(labeled, graph, mode, hop_backend)
    q, _ = _queries(labeled, n=48)
    for rnd in range(2):
        for p1 in (3, 40):
            got = port.backend.search_two_phase(q, k=5, beam_width=12,
                                                phase1_iters=p1)
            want = ref.backend.search_two_phase(q, k=5, beam_width=12,
                                                phase1_iters=p1)
            _assert_equal(got, want)
            if mode == "catapult":
                w = jbk.to_arrays(ref.backend._cat.buckets)
                g = tbk.to_arrays(port.backend._cat.buckets)
                for name in w:
                    np.testing.assert_array_equal(g[name], w[name])
    if mode == "catapult":
        assert got[2].won.any()
    assert (got[2].hops > 3).any()


def test_search_two_phase_keeps_the_reference_quirk(labeled, graph):
    """Phase 2 runs without a result mask, in both packages, so it can
    return tombstoned ids: the port returns what the reference does."""
    ref, port = _twins(labeled, graph, "diskann")
    q, _ = _queries(labeled, n=32, seed=3)
    ids, _, _ = port.search(q, k=5, beam_width=12)
    dead = np.unique(ids[:, :2])
    for db in (ref, port):
        db.delete(ids=dead)
    got = port.backend.search_two_phase(q, k=5, beam_width=12,
                                        phase1_iters=2)
    want = ref.backend.search_two_phase(q, k=5, beam_width=12,
                                        phase1_iters=2)
    _assert_equal(got, want)
    assert np.isin(got[0], dead).any()
