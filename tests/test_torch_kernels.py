"""repro_torch kernels: plain versions against the JAX package's kernels
(Pallas interpret mode on the CPU) and the wrappers' contracts.  The CUDA
kernels are held to these plain versions on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: integer outputs (ids, expanded flags, fresh counts, LSH
codes) exactly equal; distances rtol 1e-6, because XLA and torch may
sum the d squares in a different order.  LSH codes may differ only where
a projection sits within rounding of 0.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref


def _hop_state(rng, n, b, c, l):
    """Mid-traversal hop state: sorted beams, -1 holes, a converged lane,
    an interior -1 before valid candidates and a duplicated candidate."""
    cand = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    cand[-1] = -1                      # fully-converged lane: no-op hop
    if b > 1 and c > 1:
        cand[0, 0] = -1                # interior hole before valid ids
    if b > 2 and c > 2:
        cand[1, 2] = cand[1, 1]        # duplicate among candidates
    bids = rng.integers(-1, n, size=(b, l)).astype(np.int32)
    bd = np.where(bids < 0, np.inf,
                  (rng.random((b, l)) * 10).astype(np.float32))
    bexp = np.where(bids < 0, True, rng.random((b, l)) < 0.5)
    order = np.argsort(bd, axis=1)
    return (cand, np.take_along_axis(bids, order, 1),
            np.take_along_axis(bd, order, 1).astype(np.float32),
            np.take_along_axis(bexp, order, 1))


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _assert_dists(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,b,c,d", [(50, 3, 8, 16), (500, 5, 33, 64),
                                     (1000, 2, 41, 128)])
def test_gather_distance_plain_matches_jax(n, b, c, d):
    rng = np.random.default_rng(n + c)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    got = ops.gather_distance(*_t(x, ids, q)).numpy()
    want = np.stack([np.asarray(jops.gather_distance(
        jnp.asarray(x), jnp.asarray(ids[i]), jnp.asarray(q[i])))
        for i in range(b)])
    _assert_dists(got, want)
    assert np.all(np.isinf(got[ids < 0]))


@pytest.mark.parametrize("b,l,d", [(4, 4, 16), (100, 8, 64), (256, 16, 128),
                                   (256, 8, 24), (37, 30, 777), (5, 1, 768)])
def test_lsh_hash_plain_matches_jax(b, l, d):
    rng = np.random.default_rng(b + l)
    q = rng.normal(size=(b, d)).astype(np.float32)
    h = rng.normal(size=(l, d)).astype(np.float32)
    got = ops.lsh_hash(*_t(q, h)).numpy()
    want = np.asarray(jops.lsh_hash(jnp.asarray(q), jnp.asarray(h)))
    proj = q.astype(np.float64) @ h.astype(np.float64).T
    scale = np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(h, axis=1)
    near_zero = (np.abs(proj) <= 1e-5 * scale).any(1)
    np.testing.assert_array_equal(got[~near_zero], want[~near_zero])
    assert got.dtype == np.int32 and got.max() < 2 ** l


@pytest.mark.parametrize("n,b,c,l", [(64, 1, 3, 5), (200, 6, 10, 8),
                                     (500, 16, 32, 16), (100, 4, 1, 2),
                                     (300, 8, 41, 16)])
def test_fused_hop_plain_matches_jax(n, b, c, l):
    rng = np.random.default_rng(n + b + c + l)
    vec = rng.normal(size=(n, 24)).astype(np.float32)
    q = rng.normal(size=(b, 24)).astype(np.float32)
    cand, bids, bd, bexp = _hop_state(rng, n, b, c, l)
    got = ops.fused_hop_l2(*_t(vec, cand, q, bids, bd, bexp))
    want = jops.fused_hop_l2(*[jnp.asarray(a)
                               for a in (vec, cand, q, bids, bd, bexp)])
    for name, g, w in zip(["ids", "dists", "exp", "nfresh"], got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "dists":
            _assert_dists(g, w)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_cpu_tensors_take_the_plain_path_without_counting():
    rng = np.random.default_rng(0)
    vec = rng.normal(size=(40, 8)).astype(np.float32)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    cand, bids, bd, bexp = _hop_state(rng, 40, 3, 5, 4)
    before = dict(ops.LAUNCHES)
    ops.gather_distance(*_t(vec, cand, q))
    ops.lsh_hash(*_t(q, vec[:4]))
    ops.fused_hop_l2(*_t(vec, cand, q, bids, bd, bexp))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("case", ["dtype_ids", "dtype_vec", "shape",
                                  "contiguity", "lsh_bits"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    vec = torch.zeros((10, 8))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    q = torch.zeros((2, 8))
    if case == "dtype_ids":
        with pytest.raises(TypeError):
            ops.gather_distance(vec, ids.long(), q)
    elif case == "dtype_vec":
        with pytest.raises(TypeError):
            ops.gather_distance(vec.double(), ids, q)
    elif case == "shape":
        with pytest.raises(ValueError):
            ops.gather_distance(vec, ids, torch.zeros((3, 8)))
    elif case == "contiguity":
        with pytest.raises(ValueError):
            ops.gather_distance(vec, torch.zeros((3, 2), dtype=torch.int32).T,
                                q)
    else:
        with pytest.raises(ValueError):
            ops.lsh_hash(q, torch.zeros((31, 8)))


def test_plain_merge_is_stable_on_ties():
    """Equal distances keep beam-then-candidate index order (the order of
    a stable argsort and of the reference's first-minimum loop)."""
    beam_ids = torch.tensor([[5, 7, -1]], dtype=torch.int32)
    beam_d = torch.tensor([[1.0, 2.0, np.inf]])
    beam_exp = torch.tensor([[True, False, True]])
    cand = torch.tensor([[9, 3, 7, -1]], dtype=torch.int32)
    cand_d = torch.tensor([[1.0, 1.0, 0.5, 0.0]])
    ids, d, exp, nf = ref._merge_ref(cand, cand_d, beam_ids, beam_d, beam_exp)
    assert ids.tolist() == [[5, 9, 3]]
    assert d.tolist() == [[1.0, 1.0, 1.0]]
    assert exp.tolist() == [[True, False, False]]
    assert nf.tolist() == [2]
