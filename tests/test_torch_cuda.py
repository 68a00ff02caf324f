"""repro_torch on the card: each CUDA kernel against its plain version,
the two hop backends bit-identical (full precision and PQ), and no CUDA
tensor reaching a plain version.  Every test here needs an NVIDIA GPU
and skips without one.

The module imports neither JAX nor the reference package, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: distances rtol 1e-5 (the kernel's warp-strided sum and
torch's reduction add the d squares in different orders); PQ distances
rtol 1e-6 (sums of M LUT entries); ids, expanded flags and fresh counts
exactly equal where no two distances tie within that tolerance; LSH
codes equal except where a projection sits within 1e-5 * |q| * |h| of
0; the two forms of ``pq_adc`` and the fused and composed PQ hops bit
for bit; ``l2_distance`` rtol/atol 1e-4 (the kernel's expanded form against
the plain version's direct form).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda
RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _hop_inputs(rng, n, b, c, l, d):
    """Realistic mid-traversal hop: beam dists are true distances, -1
    holes, a duplicate, a beam id among the candidates, an all -1 lane."""
    vec = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32))
    cand = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    bids = rng.integers(-1, n, size=(b, l)).astype(np.int32)
    if c > 2:
        cand[0, 0] = -1
        cand[:, 2] = cand[:, 1]
        cand[:, -1] = bids[:, 0]
    cand[-1] = -1
    cand, bids = torch.as_tensor(cand), torch.as_tensor(bids)
    bd = ref.gather_distance_ref(vec, bids, q)
    bd, order = torch.sort(bd, dim=1, stable=True)
    bids = bids.gather(1, order)
    bexp = (bids < 0) | torch.as_tensor(rng.random((b, l)) < 0.5)
    return vec, cand, q, bids.contiguous(), bd.contiguous(), bexp


def _pq_tables(rng, n, b, m, k, dev):
    """(B, M, K) LUTs of squared values and an (N, M) code table."""
    luts = torch.as_tensor((rng.normal(size=(b, m, k)) ** 2)
                           .astype(np.float32), device=dev)
    codes = torch.as_tensor(rng.integers(0, k, size=(n, m)).astype(np.int32),
                            device=dev)
    return luts, codes


def _close(got, want):
    got, want = got.cpu(), want.cpu()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    m = torch.isfinite(want)
    torch.testing.assert_close(got[m], want[m], rtol=RTOL, atol=0)


@pytest.mark.parametrize("n,b,c,l,d", [(500, 16, 32, 16, 64),
                                       (4000, 128, 41, 16, 768),
                                       (4000, 256, 64, 16, 768),
                                       (300, 5, 1, 2, 24),
                                       (300, 3, 200, 40, 33)])
def test_kernels_match_plain(dev, n, b, c, l, d):
    rng = np.random.default_rng(n + c + d)
    cpu = _hop_inputs(rng, n, b, c, l, d)
    gpu = [t.to(dev) for t in cpu]
    start = dict(ops.LAUNCHES)
    _close(ops.gather_distance(*gpu[:3]), ops.gather_distance(*cpu[:3]))
    got = ops.fused_hop_l2(*gpu)
    want = ops.fused_hop_l2(*cpu)
    _close(got[1], want[1])
    assert torch.equal(got[3].cpu(), want[3])
    nxt = want[1][:, 1:]
    tie_free = ((nxt - want[1][:, :-1] > 2 * RTOL * nxt.abs())
                | ~torch.isfinite(nxt)).all(1)
    for i in (0, 2):
        assert torch.equal(got[i].cpu()[tie_free], want[i][tie_free])
    h = torch.as_tensor(rng.normal(size=(8, d)).astype(np.float32))
    codes = ops.lsh_hash(gpu[2], h.to(dev)).cpu()
    proj = cpu[2].double() @ h.double().T
    scale = cpu[2].norm(dim=1)[:, None].double() * h.norm(dim=1).double()
    ok = ~(proj.abs() <= RTOL * scale).any(1)
    assert torch.equal(codes[ok], ops.lsh_hash(cpu[2], h)[ok])
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] - start[k] for k in start} == {
        "gather_distance": 1, "lsh_hash": 1, "fused_hop_l2": 1,
        "fused_hop_pq": 0, "pq_adc": 0, "l2_distance": 0}


def test_cuda_tensors_never_reach_the_plain_versions(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")
    rng = np.random.default_rng(0)
    gpu = [t.to(dev) for t in _hop_inputs(rng, 100, 4, 8, 4, 16)]
    luts, codes = _pq_tables(rng, 100, 4, 8, 256, dev)
    for name in ("gather_distance_ref", "lsh_hash_ref", "fused_hop_ref",
                 "_merge_ref", "pq_adc_ref", "fused_hop_pq_ref",
                 "l2_distance_ref"):
        monkeypatch.setattr(ref, name, refuse)
    ops.gather_distance(*gpu[:3])
    ops.fused_hop_l2(*gpu)
    ops.lsh_hash(gpu[2], gpu[0][:8].contiguous())
    ops.pq_adc(luts, codes[gpu[1].clamp(min=0).long()])
    ops.pq_adc(luts, codes, gpu[1])
    ops.fused_hop_pq(luts, codes, *gpu[1:2], *gpu[3:])
    ops.l2_distance(gpu[2], gpu[0])
    torch.cuda.synchronize()


def test_oversized_fused_hop_raises(dev):
    rng = np.random.default_rng(1)
    gpu = [t.to(dev) for t in _hop_inputs(rng, 100, 2, 6000, 4, 16)]
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_hop_l2(*gpu)


def test_fused_and_unfused_search_bit_identical(dev):
    from repro_torch.core.beam_search import SearchSpec, beam_search_l2
    rng = np.random.default_rng(3)
    n, d, b = 3000, 96, 64
    vec = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                          device=dev)
    adj = rng.integers(0, n, size=(n, 16)).astype(np.int32)
    adj[rng.random((n, 16)) < 0.2] = -1
    adj = torch.as_tensor(adj, device=dev)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                        device=dev)
    starts = torch.full((b, 3), -1, dtype=torch.int32, device=dev)
    starts[:, 1:] = torch.as_tensor(rng.integers(0, n, size=(b, 2)),
                                    dtype=torch.int32, device=dev)
    res = [beam_search_l2(adj, vec, q, starts,
                          SearchSpec(16, 10, 64, record_scored=True,
                                     hop_backend=hb))
           for hb in ("unfused", "fused")]
    for fld in ["ids", "dists", "hops", "ndists", "trace", "scored",
                "converged"]:
        assert torch.equal(getattr(res[0], fld), getattr(res[1], fld)), fld


def test_database_on_the_card_matches_the_cpu(dev):
    """The facade on the card and on the CPU over one graph: recall@10
    within 1 point and catapults used on the replay."""
    from repro_torch import db
    from repro_torch.core.engine import brute_force_knn, recall_at_k
    from repro_torch.core.vamana import (VamanaParams, build_vamana)
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 4
    vec = (centers[rng.integers(0, 8, 1200)]
           + rng.normal(size=(1200, 16))).astype(np.float32)
    graph = build_vamana(vec, VamanaParams(max_degree=16, build_beam=32),
                         device=dev)
    qs = (centers[rng.integers(0, 8, 64)]
          + 0.5 * rng.normal(size=(64, 16))).astype(np.float32)
    truth = brute_force_knn(vec, qs, 10)
    spec = db.IndexSpec(degree=16, build_beam=32)
    recalls = {}
    for where in ("cuda", "cpu"):
        d = db.create(spec, vec, prebuilt=graph, device=where)
        d.search(qs, k=10)
        ids, _, stats = d.search(qs, k=10)
        recalls[where] = recall_at_k(ids, truth)
        assert stats.used.all()
    assert abs(recalls["cuda"] - recalls["cpu"]) <= 0.01, recalls


@pytest.mark.parametrize("n,b,c,l,m,k", [(500, 16, 32, 16, 8, 256),
                                         (100000, 512, 64, 16, 8, 256),
                                         (100000, 512, 41, 16, 8, 256),
                                         (300, 5, 1, 2, 4, 16),
                                         (300, 3, 200, 40, 16, 64),
                                         (300, 7, 37, 9, 5, 32),
                                         (20000, 256, 64, 16, 64, 256),
                                         (20000, 256, 41, 16, 96, 256)])
def test_pq_kernels_match_plain(dev, n, b, c, l, m, k):
    """Both PQ kernels against their plain versions, and the fused hop bit
    for bit against the composed one; (64, 256) and (96, 256) are LUTs of
    64 and 96 KB, beyond 48 KB of shared memory without the opt-in."""
    rng = np.random.default_rng(n + c + m)
    luts, codes = _pq_tables(rng, n, b, m, k, dev)
    _, cand, _, bids, _, _ = _hop_inputs(rng, n, b, c, l, 4)
    cand, bids = cand.to(dev), bids.to(dev)
    bd = torch.where(bids < 0, torch.inf, ref.pq_adc_ref(
        luts, codes[bids.clamp(min=0).long()]))
    bd, order = torch.sort(bd, dim=1, stable=True)
    bids = bids.gather(1, order).contiguous()
    bd = bd.contiguous()
    bexp = (bids < 0) | torch.as_tensor(rng.random((b, l)) < 0.5,
                                        device=dev)
    start = dict(ops.LAUNCHES)
    rows = codes[cand.clamp(min=0).long()]
    got_adc = ops.pq_adc(luts, rows)
    torch.testing.assert_close(got_adc, ref.pq_adc_ref(luts, rows),
                               rtol=1e-6, atol=0)
    got = ops.fused_hop_pq(luts, codes, cand, bids, bd, bexp)
    # bit for bit the composed hop: the plain merge over pq_adc's sums
    composed = ref._merge_ref(cand, torch.where(cand < 0, torch.inf,
                                                got_adc), bids, bd, bexp)
    for g, w in zip(got, composed):
        assert torch.equal(g, w)
    want = ref.fused_hop_pq_ref(luts, codes, cand, bids, bd, bexp)
    assert torch.equal(got[3], want[3])
    nxt = want[1][:, 1:]
    tie_free = ((nxt - want[1][:, :-1] > 2e-6 * nxt.abs())
                | ~torch.isfinite(nxt)).all(1)
    for i in (0, 2):
        assert torch.equal(got[i][tie_free], want[i][tie_free])
    torch.cuda.synchronize()
    assert {kk: ops.LAUNCHES[kk] - start[kk] for kk in start} == {
        "gather_distance": 0, "lsh_hash": 0, "fused_hop_l2": 0,
        "fused_hop_pq": 1, "pq_adc": 1, "l2_distance": 0}


@pytest.mark.parametrize("m", [8, 16, 96, 5])
@pytest.mark.parametrize("c", [41, 64])
@pytest.mark.parametrize("offset", [0, 1])
def test_pq_adc_ids_form_matches_table_form(dev, m, c, offset):
    """The id form (code rows read by id in the kernel) bit for bit the
    table form over the rows torch gathers, +inf exactly at the -1 ids
    (a whole lane of them too), within rtol 1e-6 of the plain version;
    and the fused PQ hop bit for bit the composed hop built on it.  M=5
    and a table that starts 4 bytes past a 16-byte boundary (offset 1)
    take the one-code-at-a-time path."""
    rng = np.random.default_rng(m + c + offset)
    n, b, l, k = 20000, 300, 16, 256
    luts = _pq_tables(rng, 1, b, m, k, dev)[0]
    flat = torch.as_tensor(rng.integers(0, k, size=(n * m + offset,))
                           .astype(np.int32), device=dev)
    codes = flat[offset:].view(n, m)
    assert (codes.data_ptr() % 16 == 0) == (offset == 0)
    _, cand, _, bids, _, _ = _hop_inputs(rng, n, b, c, l, 4)
    cand, bids = cand.to(dev), bids.to(dev)
    start = dict(ops.LAUNCHES)
    got = ops.pq_adc(luts, codes, cand)
    rows = codes[cand.clamp(min=0).long()]
    table_form = ops.pq_adc(luts, rows)
    assert torch.equal(torch.isinf(got), cand < 0)
    assert torch.equal(got, torch.where(cand < 0, torch.inf, table_form))
    want = ref.pq_adc_ref(luts, codes, cand)
    m_ok = cand >= 0
    torch.testing.assert_close(got[m_ok], want[m_ok], rtol=1e-6, atol=0)

    bd, order = torch.sort(ref.pq_adc_ref(luts, codes, bids), dim=1,
                           stable=True)
    bids = bids.gather(1, order).contiguous()
    bexp = (bids < 0) | torch.as_tensor(rng.random((b, l)) < 0.5,
                                        device=dev)
    fused = ops.fused_hop_pq(luts, codes, cand, bids, bd.contiguous(), bexp)
    composed = ref._merge_ref(cand, got, bids, bd.contiguous(), bexp)
    for g, w in zip(fused, composed):
        assert torch.equal(g, w)
    torch.cuda.synchronize()
    assert {kk: ops.LAUNCHES[kk] - start[kk] for kk in start} == {
        "gather_distance": 0, "lsh_hash": 0, "fused_hop_l2": 0,
        "fused_hop_pq": 1, "pq_adc": 2, "l2_distance": 0}


@pytest.mark.parametrize("b,d,l,offset", [
    *[(37, d, l, 0) for d in (24, 768, 777) for l in (1, 8, 30)],
    (4096, 768, 8, 0), (256, 24, 8, 0), (1, 24, 8, 0), (37, 768, 8, 1),
    (333, 128, 13, 0)])
def test_lsh_hash_matches_plain(dev, b, d, l, offset):
    """Codes equal the plain version's except for bits whose projection
    lies within 1e-5 * |q| * |h| of 0; B=37 is no multiple of the 8 or
    32 queries a block takes, and offset 1 (queries 4 bytes past a
    16-byte boundary) takes the one-float-at-a-time path."""
    rng = np.random.default_rng(b + d + l)
    flat = torch.as_tensor(rng.normal(size=(b * d + offset,))
                           .astype(np.float32), device=dev)
    q = flat[offset:].view(b, d)
    h = torch.as_tensor(rng.normal(size=(l, d)).astype(np.float32),
                        device=dev)
    start = ops.LAUNCHES["lsh_hash"]
    got = ops.lsh_hash(q, h)
    want = ref.lsh_hash_ref(q, h)
    proj = q.double() @ h.double().T
    scale = q.double().norm(dim=1)[:, None] * h.double().norm(dim=1)
    weights = 2 ** torch.arange(l, dtype=torch.int64, device=dev)
    near = ((proj.abs() <= RTOL * scale).long() * weights).sum(1)
    assert not ((got ^ want).long() & ~near).any()
    assert got.dtype == torch.int32 and got.shape == (b,)
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** l
    assert ops.LAUNCHES["lsh_hash"] == start + 1


@pytest.mark.parametrize("b,c,d", [(8, 8, 16), (37, 203, 64),
                                   (1000, 777, 768), (130, 127, 33),
                                   (1, 5, 768), (300, 260, 100)])
def test_l2_distance_matches_plain(dev, b, c, d):
    rng = np.random.default_rng(b + c + d)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                        device=dev)
    x = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32),
                        device=dev)
    torch.testing.assert_close(ops.l2_distance(q, x),
                               ref.l2_distance_ref(q, x), rtol=1e-4,
                               atol=1e-4)


def test_pq_hop_ties_break_like_a_stable_sort(dev):
    """LUT entries of 0, 1 and 2 make most ADC sums tie exactly: the fused
    hop equals the plain version (a stable argsort) bit for bit."""
    rng = np.random.default_rng(9)
    n, b, c, l, m, k = 5000, 300, 64, 16, 8, 16
    luts = torch.as_tensor(rng.integers(0, 3, (b, m, k)).astype(np.float32),
                           device=dev)
    codes = torch.as_tensor(rng.integers(0, k, (n, m)).astype(np.int32),
                            device=dev)
    _, cand, _, bids, _, _ = _hop_inputs(rng, n, b, c, l, 4)
    cand, bids = cand.to(dev), bids.to(dev)
    bd = torch.where(bids < 0, torch.inf, ref.pq_adc_ref(
        luts, codes[bids.clamp(min=0).long()]))
    bd, order = torch.sort(bd, dim=1, stable=True)
    bids = bids.gather(1, order).contiguous()
    bexp = (bids < 0) | torch.as_tensor(rng.random((b, l)) < 0.5, device=dev)
    got = ops.fused_hop_pq(luts, codes, cand, bids, bd.contiguous(), bexp)
    want = ref.fused_hop_pq_ref(luts, codes, cand, bids, bd.contiguous(),
                                bexp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_oversized_lut_raises(dev):
    """A 256 KB LUT, beyond the 227 KB of shared memory a block can have:
    neither PQ kernel stages the LUT, so both take it and equal their
    plain versions (pq_adc in both forms)."""
    rng = np.random.default_rng(2)
    luts, codes = _pq_tables(rng, 100, 2, 256, 256, dev)    # 256 KB LUT
    cand = torch.as_tensor(rng.integers(-1, 100, (2, 4)), dtype=torch.int32,
                           device=dev)
    rows = codes[cand.clamp(min=0).long()]
    torch.testing.assert_close(ops.pq_adc(luts, rows),
                               ref.pq_adc_ref(luts, rows), rtol=1e-6, atol=0)
    got = ops.pq_adc(luts, codes, cand)
    want = ref.pq_adc_ref(luts, codes, cand)
    assert torch.equal(torch.isinf(got), cand < 0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    beam = (torch.full((2, 3), -1, dtype=torch.int32, device=dev),
            torch.full((2, 3), torch.inf, device=dev),
            torch.ones((2, 3), dtype=torch.bool, device=dev))
    got = ops.fused_hop_pq(luts, codes, cand, *beam)
    for g, w in zip(got, ref.fused_hop_pq_ref(luts, codes, cand, *beam)):
        assert torch.equal(g, w)


def test_l2_distance_unaligned_inputs(dev):
    """Bases off 16 bytes stage with 4-byte copies: same answer."""
    rng = np.random.default_rng(4)
    q = torch.as_tensor(rng.normal(size=(70 * 64 + 1,)).astype(np.float32),
                        device=dev)[1:].view(70, 64)
    x = torch.as_tensor(rng.normal(size=(90 * 64 + 3,)).astype(np.float32),
                        device=dev)[3:].view(90, 64)
    assert q.data_ptr() % 16 and x.data_ptr() % 16
    torch.testing.assert_close(ops.l2_distance(q, x),
                               ref.l2_distance_ref(q, x), rtol=1e-4,
                               atol=1e-4)


def test_fused_and_unfused_pq_search_bit_identical(dev):
    from repro_torch.core import pq
    from repro_torch.core.beam_search import SearchSpec, beam_search
    from repro_torch.kernels.fused_hop import FusedPQHop
    rng = np.random.default_rng(5)
    n, d, b = 3000, 32, 64
    vec = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                          device=dev)
    cb = pq.train_pq(torch.Generator().manual_seed(0), vec, 8, device=dev)
    codes = pq.encode(cb, vec)
    adj = rng.integers(0, n, size=(n, 16)).astype(np.int32)
    adj[rng.random((n, 16)) < 0.2] = -1
    adj = torch.as_tensor(adj, device=dev)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                        device=dev)
    starts = torch.full((b, 3), -1, dtype=torch.int32, device=dev)
    starts[:, 1:] = torch.as_tensor(rng.integers(0, n, size=(b, 2)),
                                    dtype=torch.int32, device=dev)
    res = [beam_search(adj, q, starts,
                       SearchSpec(16, 16, 64, record_scored=True,
                                  hop_backend=hb), dist)
           for hb, dist in (("unfused", pq.adc_dist_fn(cb, codes)),
                            ("fused", FusedPQHop(cb, codes)))]
    for fld in ["ids", "dists", "hops", "ndists", "trace", "scored",
                "converged"]:
        assert torch.equal(getattr(res[0], fld), getattr(res[1], fld)), fld


def test_pq_database_on_the_card_matches_the_cpu(dev):
    """PQ traversal on the card and on the CPU over one graph: fused and
    unfused ids equal on the card, recall@10 within 1 point of the CPU."""
    from repro_torch import db
    from repro_torch.core.engine import brute_force_knn, recall_at_k
    from repro_torch.core.vamana import VamanaParams, build_vamana
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 4
    vec = (centers[rng.integers(0, 8, 1200)]
           + rng.normal(size=(1200, 16))).astype(np.float32)
    graph = build_vamana(vec, VamanaParams(max_degree=16, build_beam=32),
                         device=dev)
    qs = (centers[rng.integers(0, 8, 64)]
          + 0.5 * rng.normal(size=(64, 16))).astype(np.float32)
    truth = brute_force_knn(vec, qs, 10)
    ids = {}
    for where, hb in (("cuda", "unfused"), ("cuda", "fused"),
                      ("cpu", "unfused")):
        d = db.create(db.IndexSpec(degree=16, build_beam=32, pq=4,
                                   hop_backend=hb), vec, prebuilt=graph,
                      device=where)
        d.search(qs, k=10)
        ids[where, hb], _, stats = d.search(qs, k=10)
        assert stats.used.all()
    np.testing.assert_array_equal(ids["cuda", "fused"], ids["cuda", "unfused"])
    assert abs(recall_at_k(ids["cuda", "unfused"], truth)
               - recall_at_k(ids["cpu", "unfused"], truth)) <= 0.01


def test_pq96_database_on_the_card_matches_the_cpu(dev):
    """IndexSpec(pq=96) at d=768 (a 96 KB LUT a query) over a random
    regular graph: fused and unfused ids equal on the card, recall@10
    within 1 point of the CPU twin."""
    from repro_torch import db
    from repro_torch.core.engine import brute_force_knn, recall_at_k
    from repro_torch.core.vamana import _random_regular_init, medoid_index
    rng = np.random.default_rng(13)
    n, d = 2000, 768
    centers = rng.normal(size=(16, d)).astype(np.float32)
    vec = (centers[rng.integers(0, 16, n)]
           + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    qs = (centers[rng.integers(0, 16, 64)]
          + 0.5 * rng.normal(size=(64, d))).astype(np.float32)
    graph = (_random_regular_init(n, 32, rng), medoid_index(vec))
    truth = brute_force_knn(vec, qs, 10)
    ids = {}
    for where, hb in (("cuda", "unfused"), ("cuda", "fused"),
                      ("cpu", "unfused")):
        d96 = db.create(db.IndexSpec(dim=d, degree=32, pq=96,
                                     hop_backend=hb), vec, prebuilt=graph,
                        device=where)
        d96.search(qs, k=10)
        ids[where, hb] = d96.search(qs, k=10).ids
    np.testing.assert_array_equal(ids["cuda", "fused"], ids["cuda", "unfused"])
    assert abs(recall_at_k(ids["cuda", "unfused"], truth)
               - recall_at_k(ids["cpu", "unfused"], truth)) <= 0.01


def _labeled_corpus(seed, n=1200, d=16, n_labels=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32) * 4
    assign = rng.integers(0, 8, n)
    vec = (centers[assign] + rng.normal(size=(n, d))).astype(np.float32)
    pick = rng.integers(0, 8, 64)
    qs = (centers[pick] + 0.5 * rng.normal(size=(64, d))).astype(np.float32)
    return vec, (assign % n_labels).astype(np.int32), qs, \
        (pick % n_labels).astype(np.int32)


@pytest.mark.parametrize("mode,pq", [("catapult", None), ("diskann", None),
                                     ("catapult", 4)])
def test_filtered_database_on_the_card_matches_the_cpu(dev, mode, pq):
    """A filtered database on the card and on the CPU over one stitched
    graph: every id satisfies its lane's predicate, the fused backend
    returns the unfused ids (a mask keeps both composed), recall@10
    against a label-filtered brute force within 1 point of the CPU."""
    from repro_torch import db
    from repro_torch.core.engine import brute_force_knn, recall_at_k
    from repro_torch.core.filters import build_stitched_graph
    from repro_torch.core.vamana import VamanaParams
    vec, labels, qs, fl = _labeled_corpus(17)
    graph = build_stitched_graph(vec, labels, 4, VamanaParams(
        max_degree=16, build_beam=32), device=dev)
    truth = brute_force_knn(vec, qs, 10, labels=labels, filter_labels=fl)
    ids = {}
    for where, hb in (("cuda", "unfused"), ("cuda", "fused"),
                      ("cpu", "unfused")):
        d = db.create(db.IndexSpec(mode=mode, degree=16, build_beam=32,
                                   filters=True, pq=pq, hop_backend=hb),
                      vec, labels, prebuilt=graph, device=where)
        d.search(qs, k=10, filter_labels=fl)
        ids[where, hb] = got = d.search(qs, k=10, filter_labels=fl).ids
        ok = got >= 0
        assert ok.any()
        assert (labels[got[ok]] == np.broadcast_to(fl[:, None],
                                                   got.shape)[ok]).all()
    np.testing.assert_array_equal(ids["cuda", "fused"], ids["cuda", "unfused"])
    assert abs(recall_at_k(ids["cuda", "unfused"], truth)
               - recall_at_k(ids["cpu", "unfused"], truth)) <= 0.01


@pytest.mark.parametrize("filtered", [False, True])
def test_mutated_database_on_the_card_matches_the_cpu(dev, filtered):
    """Keyed upserts (one a true upsert), deletes by key and a
    consolidate on the card and on the CPU from one graph: adjacency,
    tombstones, medoid and label entries equal after every step (the
    insert searches run on the card, the surgery on the host), no dead
    id returned, recall@10 over live rows within 1 point."""
    from repro_torch import db
    from repro_torch.core.engine import brute_force_knn, recall_at_k
    from repro_torch.core.filters import label_entry_points
    from repro_torch.core.vamana import VamanaParams, build_vamana
    vec, labels, qs, fl = _labeled_corpus(19)
    adj, med = build_vamana(vec, VamanaParams(max_degree=16, build_beam=32),
                            device=dev)
    graph = (adj, med, label_entry_points(vec, labels, 4))
    rng = np.random.default_rng(20)
    new = (vec[rng.integers(0, 1200, 96)]
           + 0.3 * rng.normal(size=(96, 16))).astype(np.float32)
    new_labels = rng.integers(0, 4, 96).astype(np.int32)
    dbs = {}
    for where in ("cuda", "cpu"):
        dbs[where] = db.create(
            db.IndexSpec(degree=16, build_beam=32, filters=filtered,
                         spare_capacity=128),
            vec, labels if filtered else None,
            prebuilt=graph if filtered else graph[:2], device=where)

    def step(fn):
        for d in dbs.values():
            fn(d)
        a, b = dbs["cuda"].backend, dbs["cpu"].backend
        np.testing.assert_array_equal(a._adj_np, b._adj_np)
        np.testing.assert_array_equal(a._tomb_np, b._tomb_np)
        assert a.medoid == b.medoid
        np.testing.assert_array_equal(a._adj.cpu().numpy(), a._adj_np)
        if filtered:
            np.testing.assert_array_equal(a._label_entry_np,
                                          b._label_entry_np)

    lab = new_labels if filtered else None
    step(lambda d: d.upsert(new, lab, keys=list(range(96))))
    step(lambda d: d.upsert(new[:16] + 0.05,
                            None if lab is None else lab[:16],
                            keys=list(range(16))))
    step(lambda d: d.delete(keys=list(range(16, 48))))
    step(lambda d: d.consolidate())
    live = ~dbs["cpu"].tombstones
    f = fl if filtered else None
    truth = brute_force_knn(dbs["cpu"].vectors, qs, 10, labels=(
        dbs["cpu"].backend._labels_np[:live.size] if filtered else None),
        filter_labels=f, exclude=np.nonzero(~live)[0])
    rec = {}
    for where, d in dbs.items():
        ids = d.search(qs, k=10, filter_labels=f).ids
        assert live[ids[ids >= 0]].all()
        rec[where] = recall_at_k(ids, truth)
    assert abs(rec["cuda"] - rec["cpu"]) <= 0.01, rec


def test_observe_update_on_the_card_matches_the_cpu(dev):
    """The telemetry fold on the card (``lsh_hash`` kernel, index_add_,
    the float64 fused multiply-adds) equals its CPU run: integers and
    histograms exactly, EWMAs exactly, over catapult, shadow and padded
    batches; one ``lsh_hash`` launch a fold and no host sync needed."""
    from repro_torch.adapt import stats as ts
    from repro_torch.core.lsh import LSHParams
    rng = np.random.default_rng(23)
    planes = rng.normal(size=(8, 768)).astype(np.float32)
    states = {"cpu": ts.init_telemetry(256, "cpu"),
              "cuda": ts.init_telemetry(256, dev)}
    lsh = {"cpu": LSHParams(torch.as_tensor(planes)),
           "cuda": LSHParams(torch.as_tensor(planes, device=dev))}
    for i in range(10):
        q = rng.normal(size=(512, 768)).astype(np.float32)
        used, won = rng.random(512) < 0.8, rng.random(512) < 0.5
        hops = rng.integers(3, 60, 512).astype(np.float32)
        real = np.arange(512) < 400 + 10 * i
        for where in states:
            d = "cpu" if where == "cpu" else dev
            before = ops.LAUNCHES["lsh_hash"]
            states[where] = ts.observe_update(
                states[where], lsh[where], torch.as_tensor(q, device=d),
                *(torch.as_tensor(x, device=d) for x in (used, won, hops,
                                                         real)),
                baseline=i % 3 == 1)
            assert ops.LAUNCHES["lsh_hash"] - before == (where == "cuda")
    a = ts.telemetry_to_arrays(states["cuda"])
    b = ts.telemetry_to_arrays(states["cpu"])
    for name in b:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert float(ts.drift_score(states["cuda"])) == pytest.approx(
        float(ts.drift_score(states["cpu"])), rel=1e-6, abs=1e-7)


def test_gated_off_engine_on_the_card_runs_diskann(dev):
    """A gated-off catapult engine on the card launches no route
    ``lsh_hash`` and exactly a diskann engine's kernels, with its ids;
    a served maintainer is attached by ``serve()`` on the card by
    default, and its folds run on the card."""
    from repro_torch import db
    from repro_torch.adapt import PolicyConfig
    from repro_torch.core.vamana import VamanaParams, build_vamana
    vec, _, qs, _ = _labeled_corpus(29)
    graph = build_vamana(vec, VamanaParams(max_degree=16, build_beam=32),
                         device=dev)
    spec = dict(degree=16, build_beam=32)
    cat = db.create(db.IndexSpec(adapt=PolicyConfig(), **spec), vec,
                    prebuilt=graph)
    disk = db.create(db.IndexSpec(mode="diskann", **spec), vec,
                     prebuilt=graph)
    assert cat.backend.device.type == "cuda"
    cat.backend.catapult_enabled = False
    got = {}
    for name, d in (("gated", cat), ("diskann", disk)):
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        r = d.search(qs, k=10)
        torch.cuda.synchronize()
        got[name] = (r, dict(ops.LAUNCHES))
    assert got["gated"][1]["lsh_hash"] == 0
    assert got["gated"][1] == got["diskann"][1]
    np.testing.assert_array_equal(got["gated"][0].ids, got["diskann"][0].ids)
    np.testing.assert_array_equal(got["gated"][0].stats.hops,
                                  got["diskann"][0].stats.hops)
    cat.backend.catapult_enabled = True
    fe = cat.serve(max_batch=32)
    assert fe.maintainer is cat.maintainer is not None
    fe.search(qs)
    state = cat.backend.adapt_state
    assert state.recent.device.type == "cuda" and int(state.n_queries) > 0


def _disk_twins(tmp_path, dev, vec, labels=None, prebuilt=None, **spec):
    """A disk database created on the card and a CPU twin that opens a
    copy of its block file (so both traverse with one codebook)."""
    import shutil
    from repro_torch import db
    path = str(tmp_path / "card.ctpl")
    card = db.create(db.IndexSpec(tier="disk", path=path, degree=16,
                                  build_beam=32, filters=labels is not None,
                                  **spec), vec, labels, prebuilt=prebuilt,
                     device=dev)
    for ext in ("", ".io.json"):
        shutil.copyfile(path + ext, str(tmp_path / "cpu.ctpl") + ext)
    cpu = db.open(str(tmp_path / "cpu.ctpl"), mode=spec.get("mode"),
                  spec=db.IndexSpec(**spec), device="cpu")
    return card, cpu


@pytest.mark.parametrize("mode,hop_backend,filtered", [
    ("catapult", "unfused", False), ("catapult", "fused", False),
    ("diskann", "unfused", False), ("catapult", "unfused", True)])
def test_disk_database_on_the_card_matches_the_cpu(dev, tmp_path, mode,
                                                   hop_backend, filtered):
    """A disk database on the card against its CPU twin over a copy of its
    file: over two replayed rounds, ids, distances, hops, block reads and
    cache hits are equal, and per search the PQ traversal's kernels run
    with no ``gather_distance`` launch (the rerank is on the host)."""
    from repro_torch.core.filters import build_stitched_graph
    from repro_torch.core.vamana import VamanaParams, build_vamana
    vec, labels, qs, fl = _labeled_corpus(31)
    params = VamanaParams(max_degree=16, build_beam=32)
    if filtered:
        graph = build_stitched_graph(vec, labels, 4, params, device=dev)
    else:
        graph = build_vamana(vec, params, device=dev)
        labels = fl = None
    card, cpu = _disk_twins(tmp_path, dev, vec, labels, graph, mode=mode,
                            hop_backend=hop_backend)
    try:
        assert card.backend.device.type == "cuda"
        got = {}
        for name, d in (("cuda", card), ("cpu", cpu)):
            got[name] = []
            for rnd in range(2):
                for k in ops.LAUNCHES:
                    ops.LAUNCHES[k] = 0
                r = d.search(qs, k=10, filter_labels=fl)
                torch.cuda.synchronize()
                assert ops.LAUNCHES["gather_distance"] == 0
                if name == "cuda":
                    assert sum(ops.LAUNCHES.values()) > 0
                got[name].append(r)
        for rnd, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
            np.testing.assert_array_equal(a.ids, b.ids, f"round {rnd}")
            assert a.dists.tobytes() == b.dists.tobytes(), rnd
            for fld in ("hops", "block_reads", "cache_hits"):
                np.testing.assert_array_equal(
                    getattr(a.stats, fld), getattr(b.stats, fld),
                    f"{fld}, round {rnd}")
    finally:
        card.close()
        cpu.close()


def test_disk_engine_leaves_the_vector_table_off_the_card(dev, tmp_path):
    """The disk engine's device memory holds adjacency, codes and
    tombstones, not the (n, d) vector table — after create, an upsert
    and a reopen; the vector table on the card is the (1, d) dummy."""
    from repro_torch import db
    from repro_torch.core.vamana import _random_regular_init
    rng = np.random.default_rng(37)
    n, d = 20000, 256
    vec = rng.normal(size=(n, d)).astype(np.float32)
    graph = (_random_regular_init(n, 16, rng), 0)
    path = str(tmp_path / "m.ctpl")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    card = db.create(db.IndexSpec(tier="disk", path=path, degree=16,
                                  spare_capacity=64), vec, prebuilt=graph,
                     device=dev)
    try:
        held = torch.cuda.memory_allocated() - base
        assert held < vec.nbytes / 4, (held, vec.nbytes)
        assert tuple(card.backend._vec.shape) == (1, d)
        card.upsert(vec[:32] + 0.1)
        assert torch.cuda.memory_allocated() - base < vec.nbytes / 4
        assert tuple(card.backend._vec.shape) == (1, d)
        card.save()
    finally:
        card.close()
    before = torch.cuda.memory_allocated()
    back = db.open(path, device=dev)
    try:
        assert torch.cuda.memory_allocated() - before < vec.nbytes / 4
        assert tuple(back.backend._vec.shape) == (1, d)
        back.search(vec[:16], k=5)
    finally:
        back.close()


def test_disk_serve_on_the_card_matches_the_cpu(dev, tmp_path):
    """``serve()`` with the maintainer on disk twins: after every flush the
    card twin's maintainer events, bucket tables and cache pins equal
    the CPU twin's."""
    from repro_torch.adapt import PolicyConfig
    from repro_torch.core import buckets as bk
    from repro_torch.core.vamana import VamanaParams, build_vamana
    vec, _, qs, _ = _labeled_corpus(41)
    graph = build_vamana(vec, VamanaParams(max_degree=16, build_beam=32),
                         device=dev)
    policy = PolicyConfig(observe_every=1, baseline_every=3, min_batches=2,
                          min_base=1, ttl_steps=96)
    card, cpu = _disk_twins(tmp_path, dev, vec, prebuilt=graph,
                            adapt=policy, adapt_tick_every=2,
                            cache_frames=64)
    try:
        fes = [card.serve(max_batch=8), cpu.serve(max_batch=8)]
        rng = np.random.default_rng(5)
        events = ("ticks", "ttl_evicted", "flushed_entries", "drift_flushes",
                  "gate_transitions", "shadows", "probes")
        for _ in range(8):
            rows = rng.integers(0, qs.shape[0], 13)
            for fe in fes:
                for x in qs[rows]:
                    fe.submit(x)
                fe.flush()
            s = [fe.maintainer.snapshot() for fe in fes]
            assert {k: s[0][k] for k in events} == {k: s[1][k] for k in events}
            a, b = (bk.to_arrays(d.backend._cat.buckets) for d in (card, cpu))
            for name in ("ids", "stamp"):
                np.testing.assert_array_equal(a[name], b[name])
            ca, cb = card.backend.cache, cpu.backend.cache
            np.testing.assert_array_equal(ca.pinned, cb.pinned)
            assert list(ca._rotating) == list(cb._rotating)
        assert s[0]["ticks"] > 0
    finally:
        card.close()
        cpu.close()


@pytest.mark.parametrize("mode,hop_backend", [
    ("catapult", "unfused"), ("catapult", "fused"), ("diskann", "unfused")])
def test_sharded_database_on_the_card_matches_the_cpu(dev, tmp_path, mode,
                                                      hop_backend):
    """A sharded database created on the card against a CPU twin over a
    copy of its directory: over two replayed rounds ids, distances, hops,
    block reads and cache hits are equal; each search's shards launch
    from the pool's threads, one ``lsh_hash`` a shard in catapult mode
    and no ``gather_distance`` (the reranks are on the host)."""
    import shutil
    from repro_torch import db
    vec, _, qs, _ = _labeled_corpus(43)
    path = tmp_path / "card.d"
    card = db.create(db.IndexSpec(tier="sharded", n_shards=3, degree=16,
                                  build_beam=32, cache_frames=48, mode=mode,
                                  hop_backend=hop_backend, path=str(path)),
                     vec, device=dev)
    shutil.copytree(path, tmp_path / "cpu.d")
    cpu = db.open(str(tmp_path / "cpu.d"), spec=db.IndexSpec(
        cache_frames=48, hop_backend=hop_backend), device="cpu")
    try:
        assert all(s.device == dev for s in card.backend.shards)
        got = {"cuda": [], "cpu": []}
        for name, d in (("cuda", card), ("cpu", cpu)):
            for rnd in range(2):
                for k in ops.LAUNCHES:
                    ops.LAUNCHES[k] = 0
                got[name].append(d.search(qs, k=10))
                torch.cuda.synchronize()
                assert ops.LAUNCHES["gather_distance"] == 0
                if name == "cuda":
                    assert ops.LAUNCHES["lsh_hash"] == (
                        3 if mode == "catapult" else 0)
        for rnd, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
            np.testing.assert_array_equal(a.ids, b.ids, f"round {rnd}")
            assert a.dists.tobytes() == b.dists.tobytes(), rnd
            for fld in ("hops", "block_reads", "cache_hits"):
                np.testing.assert_array_equal(
                    getattr(a.stats, fld), getattr(b.stats, fld),
                    f"{fld}, round {rnd}")
    finally:
        card.close()
        cpu.close()


def test_mesh_search_on_the_card_matches_the_cpu(dev):
    """The one-card mesh search (a (2, 4) mesh of virtual devices) from
    one state on the card and on the CPU: ids, every device's bucket
    table and step equal after each of three steps."""
    from repro_torch.core import sharded as sh
    from repro_torch.core.beam_search import SearchSpec
    vec, _, qs, _ = _labeled_corpus(47)
    n = vec.shape[0] // 4 * 4
    cpu = sh.build_sharded_state(vec[:n], n_shards=4, n_devices=8,
                                 max_degree=12, lsh_bits=4, bucket_cap=8,
                                 device="cpu")
    card = sh.ShardedEngineState(*[t.to(dev) for t in cpu])
    step = sh.make_sharded_search((2, 4), SearchSpec(12, 5, 64), n // 4, 4)
    q = torch.as_tensor(qs[: qs.shape[0] // 2 * 2])
    for rep in range(3):
        card, a, _ = step(card, q.to(dev))
        cpu, b, _ = step(cpu, q)
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
        for name in ("bucket_ids", "bucket_stamp", "bucket_step"):
            assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
    assert int(cpu.bucket_step.sum()) > 0


@pytest.mark.parametrize("cold_tier", ["disk", "sharded"])
def test_tiered_database_on_the_card_matches_the_cpu(dev, tmp_path,
                                                     cold_tier):
    """A tiered database created on the card and a CPU twin over a copy of
    its directory, the card's hot graph put into the CPU twin after every
    hot (re)build (a Vamana build on each side): with the maintainer
    ticking, the hot gid sets and tier counters after every tick and the
    cold block reads of every search are equal."""
    import shutil
    from repro_torch import db
    from repro_torch.adapt import PolicyConfig
    vec, _, qs, _ = _labeled_corpus(53)
    spec = dict(degree=16, build_beam=32, cache_frames=48, n_bits=4,
                bucket_capacity=8, n_shards=2,
                adapt=PolicyConfig(observe_every=1, baseline_every=3,
                                   min_batches=2, min_base=1))
    path = tmp_path / "card.d"
    card = db.create(db.IndexSpec(tier="tiered", path=str(path),
                                  tiered=db.TieredSpec(
                                      hot_fraction=0.05, promote_top=8,
                                      demote_after=1, cold_tier=cold_tier),
                                  **spec), vec, device=dev)
    shutil.copytree(path, tmp_path / "cpu.d")
    cpu = db.open(str(tmp_path / "cpu.d"), spec=db.IndexSpec(**spec),
                  device="cpu")

    def same_hot():
        a, b = card.backend, cpu.backend
        np.testing.assert_array_equal(a._hot_gid, b._hot_gid)
        if a.hot is not None:
            b.hot._adj_np[:] = a.hot._adj_np
            b.hot._adj = b.hot._upload(b.hot._adj_np)
            b.hot.medoid = a.hot.medoid

    try:
        same_hot()
        ms = [card.attach_maintainer(), cpu.attach_maintainer()]
        for rnd in range(4):
            for lo in (0, 32):
                q = qs[lo: lo + 32]
                r = [d.search(q, k=5, beam_width=16) for d in (card, cpu)]
                np.testing.assert_array_equal(r[0].stats.block_reads,
                                              r[1].stats.block_reads)
                for m, x in zip(ms, r):
                    m.observe(q, x.stats)
            rebuilds = card.backend.hot_rebuilds
            for m in ms:
                m.tick()
            if card.backend.hot_rebuilds != rebuilds:
                same_hot()
            assert card.backend.tier_stats() == cpu.backend.tier_stats()
            np.testing.assert_array_equal(card.backend._hot_live_gids(),
                                          cpu.backend._hot_live_gids())
        assert card.backend.promotions > 0
        assert card.backend.hot.device == dev
    finally:
        card.close()
        cpu.close()


def _ingest_twins_equal(card, cpu):
    a, b = card.backend, cpu.backend
    assert (a.phase, a.cutovers, a.growths, a.capacity) == (
        b.phase, b.cutovers, b.growths, b.capacity)
    np.testing.assert_array_equal(a._ext_tomb, b._ext_tomb)
    np.testing.assert_array_equal(a._ext2int, b._ext2int)
    np.testing.assert_array_equal(a._gen[1], b._gen[1])
    assert dict(card.keys._fwd) == dict(cpu.keys._fwd)


@pytest.mark.parametrize("tier", ["ram", "disk", "sharded", "tiered"])
def test_ingest_born_database_on_the_card_matches_the_cpu(dev, tmp_path,
                                                          monkeypatch, tier):
    """A database born empty on the card and its CPU twin: equal ext ids,
    phases, indirection and search ids.  On the RAM tier the twins stream
    in lockstep, the CPU twin's builds taking the card's graph (a Vamana
    build on each device may part on a near-tie of float sums); on the
    persisted tiers the card streams, saves, and a card and a CPU twin
    reopen copies (the tiered CPU twin with the card's hot graph) and
    continue with keyed upserts and deletes, no rebuild."""
    import shutil
    from repro_torch import db
    from repro_torch.db import factory
    from repro_torch.ingest import BootstrapEngine
    vec, _, qs, _ = _labeled_corpus(71, n=448)
    spec = dict(dim=16, degree=16, build_beam=32, n_bits=4,
                bucket_capacity=8, n_shards=2, cache_frames=48,
                ingest=db.IngestSpec(bootstrap_cutover=64,
                                     initial_capacity=128, batch_size=64))

    def stream(dbs, lo, hi):
        for a in range(lo, hi, 64):
            gids = [d.upsert(vec[a: a + 64], keys=list(range(a, a + 64)))
                    for d in dbs]
            for g in gids[1:]:
                np.testing.assert_array_equal(g, gids[0])

    if tier == "ram":
        graphs, real = [], factory._build_engine

        def build(spec, vectors, labels, n_labels, prebuilt=None, *,
                  device="cuda"):
            if torch.device(device).type == "cuda":
                eng = real(spec, vectors, labels, n_labels, prebuilt,
                           device=device)
                graphs.append((eng._adj_np.copy(), int(eng.medoid)))
                return eng
            return real(spec, vectors, labels, n_labels, graphs.pop(0),
                        device=device)

        monkeypatch.setattr(factory, "_build_engine", build)
        twins = [db.create(db.IndexSpec(**spec), device=w)
                 for w in (dev, "cpu")]
        stream(twins, 0, 384)
        assert twins[0].backend.growths >= 1 and not graphs
    else:
        born = str(tmp_path / "born")
        d = db.create(db.IndexSpec(tier=tier, path=born, **spec),
                      device=dev)
        stream([d], 0, 320)
        assert d.backend.growths == 2
        d.save()
        d.close()
        twins = []
        for name, where in (("card", dev), ("cpu", "cpu")):
            p = str(tmp_path / name)
            if tier == "disk":
                for suffix in ("", ".io.json", ".keys.npz", ".ingest.json"):
                    shutil.copy(born + suffix, p + suffix)
            else:
                shutil.copytree(born, p)
            twins.append(db.open(p, device=where))
        if tier == "tiered":
            a, b = twins[0].backend.inner, twins[1].backend.inner
            b.hot._adj_np[:] = a.hot._adj_np
            b.hot._adj = b.hot._upload(b.hot._adj_np)
            b.hot.medoid = a.hot.medoid
        stream(twins, 320, 384)
    card, cpu = twins
    try:
        assert isinstance(card.backend, BootstrapEngine)
        assert card.backend.inner.device == dev
        for d in twins:
            d.delete(keys=list(range(0, 40)))
        _ingest_twins_equal(card, cpu)
        for lo in (0, 32):
            r = [d.search(qs[lo: lo + 32], k=5, beam_width=16)
                 for d in twins]
            np.testing.assert_array_equal(r[0].ids, r[1].ids)
            np.testing.assert_array_equal(r[0].stats.hops, r[1].stats.hops)
            assert not np.isin(r[0].ids,
                               np.nonzero(card.backend._ext_tomb)[0]).any()
    finally:
        card.close()
        cpu.close()


def test_hnsw_on_the_card_matches_the_cpu(dev):
    """``HnswEngine`` built on the card, and CPU twins over the same
    hierarchy and planes: two passes in each mode give equal ids and
    hops, and warm catapults take fewer hops than the plain search."""
    from repro_torch import convert
    from repro_torch.core import buckets as bk
    from repro_torch.core import hnsw
    from repro_torch.core.lsh import LSHParams
    from repro_torch.core.vamana import VamanaParams
    vec, _, qs, _ = _labeled_corpus(73, n=1500)
    cat = hnsw.HnswEngine(mode="catapult", n_bits=4, bucket_capacity=8,
                          device=dev).build(
        vec, VamanaParams(max_degree=16, build_beam=32))
    ix = cat.index
    assert ix.base_adj.device.type == "cuda" and ix.level_ids
    plain = hnsw.HnswEngine(mode="plain", device=dev)
    plain.index = ix
    cpu_ix = convert.hnsw_index_from_numpy(
        ix.vectors.cpu().numpy(), ix.level_ids,
        [a.cpu().numpy() for a in ix.level_adj], ix.base_adj.cpu().numpy(),
        ix.entry, device="cpu")
    hops = {}
    for eng in (plain, cat):
        twin = hnsw.HnswEngine(mode=eng.mode, n_bits=4, bucket_capacity=8,
                               device="cpu")
        twin.index = cpu_ix
        if eng.mode == "catapult":
            twin._lsh = LSHParams(hyperplanes=cat._lsh.hyperplanes.cpu())
            twin._buckets = bk.make_buckets(16, 8, device="cpu")
        for _ in range(2):
            a = eng.search(qs, k=5, beam_width=8)
            b = twin.search(qs, k=5, beam_width=8)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[2]["hops"], b[2]["hops"])
        hops[eng.mode] = a[2]["hops"].mean()
    assert hops["catapult"] < hops["plain"]


def test_moe_step_repeats_itself_without_deterministic_mode(dev):
    """Reduced deepseek-moe-16b's loss and every gradient, twice on the
    card with ``torch.use_deterministic_algorithms`` off, bit for bit:
    the MoE combine adds each token's slots in a fixed order
    (``models.moe._combine``) and the dispatch gather's backward
    scatters unique rows."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.models.steps import loss_and_grads
    assert not torch.are_deterministic_algorithms_enabled()
    cfg = dataclasses.replace(get_reduced("deepseek-moe-16b"),
                              dtype="float32")
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 64),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    runs = [loss_and_grads(cfg, model, batch) for _ in range(2)]
    (loss_a, grads_a), (loss_b, grads_b) = runs
    assert torch.equal(loss_a, loss_b)
    assert grads_a.keys() == grads_b.keys()
    for name in grads_a:
        assert torch.equal(grads_a[name], grads_b[name]), name
