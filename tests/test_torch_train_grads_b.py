"""The port's backward pass against the reference's: the other five
architectures, then flash attention, the SSM scan and MoE routing part
by part.

The architectures run ``test_torch_train_grads.py``'s fixture and
tolerances (loss rtol 1e-5; each gradient leaf within ``GRAD_TOL`` of
its largest |g|, seamless-m4t within ``GRAD_TOL_ENCDEC``; remat
bit-equal to no remat).  The parts use seeded normal inputs in float32,
where f32 error is small, so they hold tighter (``PART_TOL`` = 1e-5 of
each gradient's largest magnitude):

* ``flash_attention`` over 4 x 4 blocks of 8 (GQA, causal or not, a
  window, a softcap): the gradients of q, k and v against ``jax.grad``
  through the reference's checkpointed q- and kv-block scans, with the
  port's checkpoints on and off (bit-equal);
* ``fused_ssm_scan`` over 3 chunks of 4, both variants: the gradients
  of every input and of the initial state;
* MoE routing with gradients flowing: the routing integers exactly
  equal, the gate values' and probabilities' gradients with respect to
  the tokens and the router.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.models import attention as JA
from repro.models import moe as JMoE
from repro.models import ssm as JS
from repro_torch.models import attention as TA
from repro_torch.models import moe as TMoE
from repro_torch.models import ssm as TS

from test_torch_ingest import one_torch_thread  # noqa: F401
from test_torch_model_parts import _qkv, _rng, _f32, _ssm_inputs
from test_torch_train_grads import (check_grads, check_loss, check_remat,
                                    grad_twins)

ARCHS_B = ARCH_IDS[5:]
PART_TOL = 1e-5


def _share(got, want) -> float:
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_grads(fn, inputs, weights):
    """Gradients of sum_i <fn(inputs)[i], weights[i]> w.r.t. inputs."""
    ts = [torch.from_numpy(np.array(a)).requires_grad_(True)
          for a in inputs]
    outs = fn(*ts)
    total = sum(torch.sum(o * torch.from_numpy(w))
                for o, w in zip(outs, weights))
    return torch.autograd.grad(total, ts)


def _ref_grads(fn, inputs, weights):
    def total(*xs):
        return sum(jnp.sum(o * w) for o, w in zip(fn(*xs), weights))
    return jax.grad(total, argnums=tuple(range(len(inputs))))(
        *map(jnp.asarray, inputs))


@pytest.fixture(scope="module", params=ARCHS_B)
def twins(request):
    return grad_twins(request.param)


def test_loss_matches_reference(twins):
    check_loss(twins)


def test_gradients_match_reference(twins):
    check_grads(twins)


def test_remat_changes_no_gradient(twins):
    check_remat(twins)


@pytest.mark.parametrize("window,causal,cap", [
    (1 << 30, True, None), (12, True, 20.0), (1 << 30, False, None),
    (9, False, 50.0)])
def test_flash_attention_gradients_match_reference(window, causal, cap):
    rng = _rng(11)
    q, k, v = _qkv(rng, 2, 32, 32, 8, 2, 16)       # GQA: 4 heads a group
    w = [_f32(rng, 2, 32, 8, 16)]
    pos = np.arange(32)
    kw = dict(window=window, causal=causal, attn_softcap=cap, block_q=8,
              block_k=8)
    tp = torch.from_numpy(pos)
    want = _ref_grads(lambda q, k, v: (JA.flash_attention(
        q, k, v, pos, pos, **kw),), (q, k, v), w)
    for remat in (True, False):
        got = _port_grads(lambda q, k, v: (TA.flash_attention(
            q, k, v, tp, tp, remat=remat, **kw),), (q, k, v), w)
        for g, r in zip(got, want):
            assert _share(g, r) <= PART_TOL
        if remat:
            first = got
    for a, b in zip(first, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_ssm_scan_gradients_match_reference(variant):
    rng = _rng(12)
    ins = _ssm_inputs(rng, variant)
    want_y, want_h = JS.fused_ssm_scan(*map(jnp.asarray, ins), 4, variant)
    w = [_f32(rng, *np.shape(want_y)), _f32(rng, *np.shape(want_h))]
    want = _ref_grads(lambda *a: JS.fused_ssm_scan(*a, 4, variant), ins, w)
    got = _port_grads(lambda *a: TS.fused_ssm_scan(*a, 4, variant), ins, w)
    for name, g, r in zip(("dt", "a", "b", "c", "x", "h0"), got, want):
        assert _share(g, r) <= PART_TOL, name


@pytest.mark.parametrize("t,e,k,cap", [(48, 16, 6, 8), (20, 4, 2, 8)])
def test_moe_routing_integers_equal_while_gradients_flow(t, e, k, cap):
    rng = _rng(13)
    xt, router = _f32(rng, t, 32), _f32(rng, 32, e)
    txt = torch.from_numpy(xt).requires_grad_(True)
    trouter = torch.from_numpy(router).requires_grad_(True)
    got = TMoE._route(txt, trouter, e, k, cap)
    want = JMoE._route(jnp.asarray(xt), jnp.asarray(router), e, k, cap)
    for g, r in zip(got[:4], want[:4]):       # flat_e, pos, keep, tok_idx
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not bool(got[2].all())             # the capacity cut bites
    w = [_f32(rng, t, k), _f32(rng, t, e)]
    want_g = _ref_grads(lambda x, r: JMoE._route(x, r, e, k, cap)[4:],
                        (xt, router), w)
    got_g = torch.autograd.grad(
        torch.sum(got[4] * torch.from_numpy(w[0]))
        + torch.sum(got[5] * torch.from_numpy(w[1])), (txt, trouter))
    for g, r in zip(got_g, want_g):
        assert _share(g, r) <= PART_TOL
