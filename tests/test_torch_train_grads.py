"""The port's backward pass against the reference's, five architectures.

Each reduced architecture (``get_reduced``, in float32) is drawn once by
the reference's ``M.init(cfg, PRNGKey(0))`` and carried into the port
with ``convert.model_params_from_numpy`` (never re-seeded).  One numpy
batch of 2 x 32 tokens (two chunks of the reduced SSM scans) goes
through the reference's jitted ``jax.value_and_grad(M.loss_fn)`` and
through the port's ``loss_fn`` and ``torch.autograd.grad``, with remat
and without.

Tolerances: the loss to rtol 1e-5; every gradient leaf, a stacked
reference leaf row by row against the port's per-layer tensor, as a
share of the largest |g| of that leaf (or row): the reference's init
(fan-in = depth for every stacked weight) drives activations to ~1e8,
so an element-wise rtol is meaningless.  That share is f32's own error,
not the port's: against a float64 run of the same batch, the reference's
f32 gradients part by up to 2.6e-4 of a leaf's largest |g| (falcon-
mamba's scan; seamless-m4t 9.7e-4) and the port's by up to 1.8e-4
(seamless 1.1e-3), and the two packages from each other by at most
1.7e-4 (zamba2; seamless 1.4e-3).  So ``GRAD_TOL`` = 3e-4, and
``GRAD_TOL_ENCDEC`` = 2e-3 for seamless-m4t (its forward logits need
3e-4 already, ``tests/test_torch_models.py``).  A wrong term would part
by a share near 1.  Remat changes no gradient: the port's
``remat=True`` and ``remat=False`` gradients are bit-equal.

``tests/test_torch_train_grads_b.py`` runs the other five architectures
through the same fixture (so that ``--dist loadfile`` spreads them), and
the flash attention, SSM scan and MoE routing gradients part by part.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_reduced
from repro.models import model as JM
from repro_torch import convert
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

from test_torch_ingest import one_torch_thread  # noqa: F401

B, S = 2, 32
GRAD_TOL = 3e-4
GRAD_TOL_ENCDEC = 2e-3
ARCHS_A = ARCH_IDS[:5]


def batch_for(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(B, S, cfg.frontend_dim)).astype(np.float32)
    return out


def port_grads(cfg, model, batch, remat):
    """(loss, {port name: gradient}) through autograd."""
    params = dict(model.named_parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = TM.loss_fn(cfg, model, tb, remat=remat)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def grad_twins(arch):
    """The reference's and the port's loss and gradients for ``arch``."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = JM.init(cfg, jax.random.PRNGKey(0))
    batch = batch_for(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b)))(params, jb)
    model = convert.model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    ref = convert.unstack_tree(cfg, jax.tree_util.tree_map(np.asarray,
                                                           grads))
    return dict(cfg=cfg, ref_loss=float(loss), ref=ref,
                remat=port_grads(cfg, model, batch, True),
                plain=port_grads(cfg, model, batch, False))


def grad_share(got, want) -> float:
    """max |got - want| as a share of max |want| (one leaf or row)."""
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check_loss(tw):
    np.testing.assert_allclose(tw["remat"][0], tw["ref_loss"], rtol=1e-5)


def check_grads(tw):
    got = tw["remat"][1]
    assert sorted(got) == sorted(tw["ref"])
    tol = GRAD_TOL_ENCDEC if tw["cfg"].family == "encdec" else GRAD_TOL
    worst = {name: grad_share(g, tw["ref"][name]) for name, g in got.items()}
    bad = {k: v for k, v in worst.items() if not v <= tol}
    assert not bad, bad


def check_remat(tw):
    for name, g in tw["remat"][1].items():
        assert torch.equal(g, tw["plain"][1][name]), name
    assert tw["remat"][0] == tw["plain"][0]


@pytest.fixture(scope="module", params=ARCHS_A)
def twins(request):
    return grad_twins(request.param)


def test_loss_matches_reference(twins):
    check_loss(twins)


def test_gradients_match_reference(twins):
    check_grads(twins)


def test_remat_changes_no_gradient(twins):
    check_remat(twins)


def test_loss_under_autograd_takes_no_cache(monkeypatch):
    """The training path never reaches the in-place cache writes: no
    layer gets a cache, ``write_at`` is never called, and a backward
    pass runs for every architecture."""
    seen = []
    real_layer = TT._layer

    def layer(cache, i):
        seen.append(cache is not None)
        return real_layer(cache, i)

    def write_at(*a, **kw):
        raise AssertionError("write_at on the training path")

    monkeypatch.setattr(TT, "_layer", layer)
    monkeypatch.setattr(TA, "write_at", write_at)
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        model = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
        _, grads = port_grads(cfg, model, batch_for(cfg, 1), True)
        assert all(torch.isfinite(g).all() for g in grads.values()), arch
    assert seen and not any(seen)
