"""The port's model layers, one at a time, against the reference's.

Same numpy inputs (seeded), float32, through each function of
``repro.models`` and its counterpart in ``repro_torch.models``:
``rms_norm``, ``rope``, ``softcap``, ``gated_mlp`` (both kinds),
``unembed`` with the padded-vocab mask (seamless-m4t's 256,206 pads to
256,256), ``dense_attention`` and ``flash_attention`` (GQA, a window,
the softcap, several blocks), the MoE capacity and routing (the routing
integers exactly equal), ``fused_ssm_scan`` for both variants (with a
ragged chunk), ``causal_conv1d`` with its decode state, and the
associative scan itself.  Floats hold to rtol 1e-5 (atol 1e-6), the scan
to 1e-6 of its largest magnitude.

The port's own ``init`` is held to the reference's declarations: leaf
shapes and dtypes, ones and zeros exactly, and every normal leaf's mean
and standard deviation within five standard errors of 0 and
``scale / sqrt(shape[0])`` of the reference's STACKED leaf (fan-in =
depth for every per-layer weight, the reference's quirk); the
reference's own draws pass the same check.
"""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_reduced
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import ssm as JS
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import stack

from test_torch_ingest import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy()
                               if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), rtol=rtol,
                               atol=atol)


def test_rms_norm_softcap_and_rope():
    rng = _rng()
    x, g = _f32(rng, 2, 5, 64, scale=3.0), _f32(rng, 64)
    _close(TL.rms_norm(_t(x), _t(g), 1e-6), JL.rms_norm(x, g, 1e-6))
    _close(TL.softcap(_t(x), 2.5), JL.softcap(jnp.asarray(x), 2.5))
    assert TL.softcap(_t(x), None) is not None
    q = _f32(rng, 2, 7, 4, 16)
    for theta in (10_000.0, 1_000_000.0):
        for pos in (np.arange(7), np.arange(7) + 40):
            _close(TL.rope(_t(q), _t(pos), theta),
                   JL.rope(jnp.asarray(q), jnp.asarray(pos), theta),
                   atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_gated_mlp(kind):
    rng = _rng(1)
    x = _f32(rng, 3, 4, 32)
    wi, wo = _f32(rng, 32, 96, scale=0.2), _f32(rng, 48, 32, scale=0.2)
    got = TL.gated_mlp(types.SimpleNamespace(wi=_t(wi), wo=_t(wo)), _t(x),
                       kind)
    _close(got, JL.gated_mlp({"wi": wi, "wo": wo}, jnp.asarray(x), kind))


@pytest.mark.parametrize("vocab,cap", [(256_206, None), (256_206, 30.0),
                                       (256, None)])
def test_unembed_masks_padded_vocab(vocab, cap):
    rng = _rng(2)
    vpad = TL.padded_vocab(vocab)
    assert vpad == JL.padded_vocab(vocab)
    table, x = _f32(rng, vpad, 8, scale=0.5), _f32(rng, 2, 3, 8)
    got = TL.unembed(types.SimpleNamespace(table=_t(table)), _t(x), cap=cap,
                     vocab=vocab)
    want = JL.unembed({"table": table}, jnp.asarray(x), cap=cap, vocab=vocab)
    _close(got, want, atol=1e-5)
    if vocab != vpad:
        assert vpad == 256_256
        assert (got[..., vocab:] == -1e9).all()
        assert (got[..., :vocab] > -1e8).all()


def _qkv(rng, b, sq, sk, h, kv, dh):
    return (_f32(rng, b, sq, h, dh), _f32(rng, b, sk, kv, dh),
            _f32(rng, b, sk, kv, dh))


@pytest.mark.parametrize("window,causal,cap", [
    (1 << 30, True, None), (5, True, 20.0), (1 << 30, False, None),
    (9, False, 50.0)])
def test_dense_and_flash_attention(window, causal, cap):
    rng = _rng(3)
    q, k, v = _qkv(rng, 2, 32, 32, 8, 2, 16)       # GQA: 4 heads a group
    pos = np.arange(32)
    kw = dict(window=window, causal=causal, attn_softcap=cap)
    tq, tk, tv, tp = _t(q), _t(k), _t(v), _t(pos)
    want = JA.dense_attention(q, k, v, pos, pos, **kw)
    _close(TA.dense_attention(tq, tk, tv, tp, tp, **kw), want)
    # several query and KV blocks: the online softmax's rescaling runs
    fl = dict(kw, block_q=8, block_k=8)
    want_fl = JA.flash_attention(q, k, v, pos, pos, **fl)
    _close(TA.flash_attention(tq, tk, tv, tp, tp, **fl), want_fl)
    _close(TA.flash_attention(tq, tk, tv, tp, tp, **kw), want, atol=1e-5)


def test_decode_attention_against_a_longer_cache():
    rng = _rng(4)
    q, k, v = _qkv(rng, 2, 1, 24, 4, 1, 16)        # MQA, one query
    qp, kp = np.array([10]), np.arange(24)
    for window in (1 << 30, 4):
        _close(TA.dense_attention(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                  window=window),
               JA.dense_attention(q, k, v, qp, kp, window=window))


@pytest.mark.parametrize("t,e,k,f", [(32, 8, 2, 1.25), (12, 64, 6, 1.25),
                                     (4096, 128, 2, 1.25), (2, 64, 6, 1.25),
                                     (100_000, 64, 6, 1.25)])
def test_capacity(t, e, k, f):
    assert TMoE._capacity(t, e, k, f) == JMoE._capacity(t, e, k, f)


@pytest.mark.parametrize("t,e,k,cap,lo,hi", [(64, 8, 2, 8, 0, 8),
                                             (48, 16, 6, 8, 4, 12),
                                             (20, 4, 2, 8, 0, 4)])
def test_route_integers_exactly_equal(t, e, k, cap, lo, hi):
    rng = _rng(5)
    xt, router = _f32(rng, t, 32), _f32(rng, 32, e)
    got = TMoE._route(_t(xt), _t(router), e, k, cap, expert_lo=lo,
                      expert_hi=hi)
    want = JMoE._route(jnp.asarray(xt), jnp.asarray(router), e, k, cap,
                       expert_lo=lo, expert_hi=hi)
    for g, w in zip(got[:4], want[:4]):          # flat_e, pos, keep, tok_idx
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(got[4], want[4])                      # gate values
    _close(got[5], want[5])                      # probs
    assert not bool(got[2].all())                # the capacity cut bites


def test_moe_layer_with_shared_experts_and_dense_residual():
    rng = _rng(6)
    cfg = dataclasses.replace(get_reduced("deepseek-moe-16b"),
                              dtype="float32", dense_residual=True)
    params = JL.init_from_decl(JMoE.moe_decl(cfg), jax.random.PRNGKey(3),
                               jnp.float32)
    x = _f32(rng, 2, 16, cfg.d_model)
    want_y, want_aux = JMoE.moe_layer(params, jnp.asarray(x), cfg,
                                      mlp_kind=cfg.mlp)
    mod = TMoE.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for name in ("router", "wi", "wo"):
            getattr(mod, name).copy_(_t(params[name]))
        for sub in ("shared", "dense"):
            for name in ("wi", "wo"):
                getattr(getattr(mod, sub), name).copy_(_t(params[sub][name]))
    got_y, got_aux = TMoE.moe_layer(mod, _t(x), cfg, mlp_kind=cfg.mlp)
    scale = float(np.abs(np.asarray(want_y)).max())
    _close(got_y, want_y, atol=1e-5 * scale)
    _close(got_aux, want_aux)


@pytest.mark.parametrize("n", list(range(1, 10)) + [16, 33])
def test_associative_scan_order_matches_lax(n):
    rng = _rng(7)
    a, b = _f32(rng, 2, n, 3), _f32(rng, 2, n, 3)
    got = TS.associative_scan(TS._assoc, (_t(a), _t(b)), axis=1)
    want = jax.lax.associative_scan(JS._assoc, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    for g, w in zip(got, want):
        _close(g, w)
    ints = rng.integers(0, 100, (n, 2))
    got = TS.associative_scan(lambda x, y: (x[0] + y[0],),
                              (_t(ints),), axis=0)[0]
    np.testing.assert_array_equal(got.numpy(), np.cumsum(ints, axis=0))


def _ssm_inputs(rng, variant, b=2, s=12, di=16, n=4, nh=4):
    hd = di // nh
    dt = np.abs(_f32(rng, b, s, di if variant == "mamba1" else nh)) * 0.5
    a = -np.exp(_f32(rng, *((di, n) if variant == "mamba1" else (nh,))))
    bm, cm = _f32(rng, b, s, n), _f32(rng, b, s, n)
    x = _f32(rng, *((b, s, di) if variant == "mamba1" else (b, s, nh, hd)))
    h0 = _f32(rng, *((b, di, n) if variant == "mamba1" else (b, nh, hd, n)))
    return dt, a, bm, cm, x, h0


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
@pytest.mark.parametrize("chunk", [1, 4, 8, 16])
def test_fused_ssm_scan(variant, chunk):
    """s = 12: chunk 8 falls to 6 (ragged prompts), 16 to 12."""
    ins = _ssm_inputs(_rng(8), variant)
    got_y, got_h = TS.fused_ssm_scan(*map(_t, ins), chunk, variant)
    want_y, want_h = JS.fused_ssm_scan(*map(jnp.asarray, ins), chunk,
                                       variant)
    for g, w in ((got_y, want_y), (got_h, want_h)):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= \
            1e-6 * float(np.abs(w).max())


def test_causal_conv1d_with_decode_state():
    rng = _rng(9)
    x, w = _f32(rng, 2, 7, 12), _f32(rng, 12, 4)
    state = _f32(rng, 2, 3, 12)
    for st in (None, state):
        got = TS.causal_conv1d(_t(x), _t(w), None if st is None else _t(st))
        want = JS.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st))
        for g, wv in zip(got, want):
            _close(g, wv)
    # one token at a time through the state equals the whole sequence
    y_all, st_all = TS.causal_conv1d(_t(x), _t(w))
    st, ys = None, []
    for i in range(7):
        y, st = TS.causal_conv1d(_t(x[:, i: i + 1]), _t(w), st)
        ys.append(y)
    _close(torch.cat(ys, 1), y_all.numpy())
    _close(st, st_all.numpy())


def _decl_leaves(tree, path=()):
    if JL.is_leaf_decl(tree):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _decl_leaves(tree[k], path + (k,))


def _port_leaf(model, path):
    """The port's parameters for a reference leaf path, stacked as the
    reference stacks them (a ModuleList on the path is the leading axis)."""
    parts, stacked = [model], False
    for name in path:
        nxt = []
        for m in parts:
            child = getattr(m, name)
            if isinstance(child, torch.nn.ModuleList):
                stacked = True
                nxt.extend(child)
            else:
                nxt.append(child)
        parts = nxt
    return torch.stack(parts) if stacked else parts[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_init_draws_the_reference_leaf_distributions(arch):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    decl = JM.model_decl(cfg)
    ref = JM.init(cfg, jax.random.PRNGKey(0))
    model = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(d["shape"])) for _, d in _decl_leaves(decl))
    for path, d in _decl_leaves(decl):
        got = _port_leaf(model, path).detach().numpy()
        want = np.asarray(ref_leaf(ref, path))
        assert got.shape == d["shape"] == want.shape, path
        assert got.dtype == want.dtype == np.float32, path
        if d["init"] in ("ones", "zeros") or d["scale"] is None:
            fill = 0.0 if d["init"] == "zeros" else 1.0
            assert (got == fill).all() and (want == fill).all(), path
            continue
        fan_in = d["shape"][0]
        sigma = d["scale"] / fan_in ** 0.5
        n = got.size
        for leaf in (got, want):
            assert abs(leaf.mean()) <= 5 * sigma / n ** 0.5, path
            assert abs(leaf.std() / sigma - 1) <= 5 / (2 * n) ** 0.5, path


def ref_leaf(tree, path):
    for name in path:
        tree = tree[name]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_layout_matches_reference(arch):
    cfg = get_reduced(arch)
    want = JM.init_cache(cfg, 3, 10)
    got = TM.init_cache(cfg, 3, 10, "cpu")

    def walk(g, w):
        assert isinstance(g, dict) == isinstance(w, dict)
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                walk(g[k], w[k])
            return
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()
    walk(got, want)


def test_gated_stack_blocks_draw_with_the_stacked_fan_in():
    cfg = dataclasses.replace(get_reduced("gemma-2b"), dtype="float32")
    blocks = stack(lambda c, dt, dev, stack: TL.GatedMLP(
        c.d_model, c.d_ff, dt, dev, stack), cfg, 5, torch.float32, "cpu")
    for blk in blocks:
        assert blk._init["wi"] == (1.0, 5) and blk._init["wo"] == (1.0, 5)
    alone = TL.GatedMLP(cfg.d_model, cfg.d_ff, torch.float32, "cpu")
    assert alone._init["wi"] == (1.0, cfg.d_model)
    assert alone._init["wo"] == (1.0, cfg.d_ff)


def test_steps_run_the_model_functions_without_autograd():
    from repro_torch.models import steps
    cfg = dataclasses.replace(get_reduced("gemma-2b"), dtype="float32")
    model = TM.init(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = _rng(10)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 8)))}
    loss = steps.make_eval_step(cfg)(model, batch)
    assert float(loss) == float(TM.loss_fn(cfg, model, batch))
    got_l, got_c = steps.make_prefill_step(cfg)(
        model, batch, TM.init_cache(cfg, 2, 10, "cpu"))
    want_l, want_c = TM.prefill(cfg, model, batch,
                                TM.init_cache(cfg, 2, 10, "cpu"))
    assert torch.equal(got_l, want_l) and not got_l.requires_grad
    tok = got_l.argmax(-1)
    got_d, _ = steps.make_decode_step(cfg)(model, tok, got_c, 8)
    want_d, _ = TM.decode_step(cfg, model, tok, want_c, 8)
    assert torch.equal(got_d, want_d)
