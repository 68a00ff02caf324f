"""The training substrate against the reference: data pipeline,
optimizer, gradient compression, checkpoints, elastic plan, stragglers.

Twins of ``tests/test_substrate.py``, each run on both packages with the
same inputs and held to the reference's output where it has one:

* ``TokenPipeline`` batches (tokens and the vlm/encdec extras) exactly
  equal for the same ``(seed, step, host_id)``, host shards included,
  and ``Prefetcher``'s order;
* ``adamw.schedule`` at every step of a warmup and a decay, and three
  ``adamw.update``s on one random tree (a leaf the reference updates
  layer by layer among them) with f32 and with bfloat16 moments:
  parameters, moments, ``grad_norm`` and ``lr`` within rtol 1e-6 (a
  bfloat16 moment equal, or one bf16 step apart where the f32 values it
  rounds part by an ulp); the quadratic decreases to the
  reference's values; the clip caps the update;
* ``compress_int8``'s ``q`` and ``scale`` exactly equal (round half to
  even), ``compress_bf16`` bit-equal, error feedback's residual equal;
* checkpoints: the port's bf16 round trip, ``LATEST`` and
  ``AsyncCheckpointer``; and across the packages, one training state
  (bfloat16 and float32 leaves, an int32 step, stacked and unstacked
  leaves) saved by each: the same manifest leaf list and every leaf file
  byte for byte, then each package restores the other's, bit-equal;
* ``choose_mesh_shape`` equal for n in 1..600 (the reference's
  hypothesis range), with its validity rules;
* ``StepMonitor``'s flags and actions equal on the same time series.

The reference's ``zero1_pspecs`` (ZeRO-1 moment sharding) is twinned
in ``tests/test_torch_dist.py``, beside the mesh it places moments on.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.ft import checkpoint as jckpt
from repro.ft.elastic import choose_mesh_shape as j_choose
from repro.ft.straggler import StepMonitor as JStepMonitor
from repro.ft.straggler import StragglerPolicy as JStragglerPolicy
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro_torch.data.pipeline import Prefetcher, TokenPipeline
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.elastic import choose_mesh_shape
from repro_torch.ft.straggler import StepMonitor, StragglerPolicy
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc

from test_torch_ingest import one_torch_thread  # noqa: F401

EXTRAS = {"patches": ((4, 6), np.float32), "frames": ((16, 3), np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x) -> np.ndarray:
    """Any leaf (numpy, jax or torch, bf16 included) as raw bytes."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint8)
        return np.ascontiguousarray(x.numpy()).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# ------------------------------------------------------------------ pipeline
@pytest.mark.parametrize("step", [0, 3, 4, 17])
def test_pipeline_batches_equal_reference(step):
    port = TokenPipeline(1000, 16, 8, seed=5, extras=EXTRAS)
    ref = JTokenPipeline(1000, 16, 8, seed=5, extras=EXTRAS)
    got, want = port.batch_at(step), ref.batch_at(step)
    assert sorted(got) == sorted(want) == ["frames", "patches", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(port.batch_at(step)["tokens"],
                                  got["tokens"])
    assert not np.array_equal(port.batch_at(step + 1)["tokens"],
                              got["tokens"])


def test_pipeline_host_shards_equal_reference():
    for host in (0, 1):
        p = TokenPipeline(1000, 16, 8, n_hosts=2, host_id=host)
        r = JTokenPipeline(1000, 16, 8, n_hosts=2, host_id=host)
        assert p.local_batch == r.local_batch == 4
        np.testing.assert_array_equal(p.batch_at(2)["tokens"],
                                      r.batch_at(2)["tokens"])
    assert not np.array_equal(
        TokenPipeline(1000, 16, 8, n_hosts=2, host_id=0).batch_at(0)
        ["tokens"],
        TokenPipeline(1000, 16, 8, n_hosts=2, host_id=1).batch_at(0)
        ["tokens"])


def test_prefetcher_orders_batches_as_reference():
    p = TokenPipeline(100, 8, 2)
    r = JTokenPipeline(100, 8, 2)
    pf, jpf = Prefetcher(p.batch_at, start_step=5, depth=2), \
        JPrefetcher(r.batch_at, start_step=5, depth=2)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(pf.next()["tokens"],
                                          jpf.next()["tokens"])
    finally:
        pf.close()
        jpf.close()
    assert not pf._t.is_alive()


# ------------------------------------------------------------------ optimizer
def test_schedule_equals_reference():
    for cfg_kw in (dict(warmup=5, total_steps=30),
                   dict(warmup=0, total_steps=10, min_lr_frac=0.0),
                   dict(warmup=100, total_steps=20)):
        cfg = adamw.AdamWConfig(**cfg_kw)
        jcfg = jadamw.AdamWConfig(**cfg_kw)
        for step in range(0, 40):
            np.testing.assert_allclose(
                adamw.schedule(cfg, step),
                float(jadamw.schedule(jcfg, jnp.int32(step))), rtol=1e-6)


def _ref_tree(rng):
    """A random f32 tree; ``b.d`` is (8, 2, 3): the reference updates it
    one layer at a time (``fori_loop``)."""
    return {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(3).astype(np.float32),
                  "d": rng.standard_normal((8, 2, 3)).astype(np.float32)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_three_updates_equal_reference(moments):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup=2, total_steps=6, grad_clip=2.0,
              moment_dtype=moments)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    tree = _ref_tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jadamw.init(jparams, moment_dtype=jnp.dtype(moments))
    params = {k: _t(v) for k, v in _flat(tree).items()}
    state = adamw.init(params, moment_dtype=moments)
    jupdate = jax.jit(lambda g, s, p: jadamw.update(jcfg, g, s, p))
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32),
            tree)
        jparams, jstate, jm = jupdate(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        params, state, m = adamw.update(
            cfg, {k: _t(v) for k, v in _flat(grads).items()}, state, params)
        assert state.step == int(jstate.step) == step + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
        for mine, theirs in ((params, jparams), (state.mu, jstate.mu),
                             (state.nu, jstate.nu)):
            theirs = _flat(jax.tree_util.tree_map(np.asarray, theirs))
            for k, want in theirs.items():
                got = mine[k]
                assert str(got.dtype).split(".")[-1] == str(want.dtype), k
                if got.dtype == torch.bfloat16:
                    # one rounding of the same f32 value: equal, or one
                    # bf16 step apart where the f32 values part by an ulp
                    diff = np.abs(got.float().numpy()
                                  - want.astype(np.float32))
                    step_ = np.abs(want.astype(np.float32)) * 2.0 ** -7
                    assert (diff <= step_ + 1e-30).all(), k
                else:
                    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                               atol=1e-7, err_msg=k)


def test_adamw_decreases_quadratic_as_reference():
    kw = dict(lr=0.1, warmup=0, total_steps=100, weight_decay=0.0,
              grad_clip=1e9)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    params = {"w": torch.tensor([3.0, -2.0])}
    jparams = {"w": jnp.asarray([3.0, -2.0])}
    state, jstate = adamw.init(params), jadamw.init(jparams)
    for _ in range(60):
        params, state, _ = adamw.update(cfg, {"w": 2 * params["w"]}, state,
                                        params)
        jparams, jstate, _ = jadamw.update(jcfg, {"w": 2 * jparams["w"]},
                                           jstate, jparams)
    assert float(params["w"].abs().max()) < 0.5
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]),
                               rtol=1e-5, atol=1e-6)


def test_adamw_grad_clip_caps_update_as_reference():
    kw = dict(lr=1.0, warmup=0, grad_clip=1.0, weight_decay=0.0)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    params = {"w": torch.zeros(4)}
    new, _, m = adamw.update(cfg, {"w": torch.full((4,), 100.0)},
                             adamw.init(params), params)
    jnew, _, jm = jadamw.update(jcfg, {"w": jnp.full(4, 100.0)},
                                jadamw.init({"w": jnp.zeros(4)}),
                                {"w": jnp.zeros(4)})
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=1e-6)


# ------------------------------------------------------------------ compress
def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64,)).astype(np.float32),
            "m": {"x": (rng.normal(size=(5, 7)) * 1e-3).astype(np.float32),
                  # exact halves of the scale: round half to even
                  "h": (np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
                        / 127.0).astype(np.float32)}}


def test_int8_compression_equals_reference():
    g = _grads(0)
    comp = gc.compress_int8(jax.tree_util.tree_map(_t, g))
    want = jgc.compress_int8(jax.tree_util.tree_map(jnp.asarray, g))
    for path in (("w",), ("m", "x"), ("m", "h")):
        got_c, want_c = comp, want
        for p in path:
            got_c, want_c = got_c[p], want_c[p]
        np.testing.assert_array_equal(got_c.q.numpy(), np.asarray(want_c.q))
        assert _bits(got_c.scale).tobytes() == _bits(want_c.scale).tobytes()
    rec = gc.decompress(comp)
    err = float((rec["w"] - _t(g["w"])).abs().max())
    assert err <= float(np.abs(g["w"]).max()) / 127 + 1e-6
    bf = gc.compress_bf16(jax.tree_util.tree_map(_t, g))
    jbf = jgc.compress_bf16(jax.tree_util.tree_map(jnp.asarray, g))
    assert _bits(bf["w"]).tobytes() == _bits(jbf["w"]).tobytes()


def test_error_feedback_residual_equals_reference():
    g = {"w": torch.full((8,), 0.3)}
    jg = {"w": jnp.full((8,), 0.3, jnp.float32)}
    ef, jef = gc.ef_init(g), jgc.ef_init(jg)
    comps, jcomps = [], []
    for _ in range(2):
        comp, ef = gc.ef_compress(g, ef, kind="int8")
        jcomp, jef = jgc.ef_compress(jg, jef, kind="int8")
        comps.append(comp)
        jcomps.append(jcomp)
        np.testing.assert_array_equal(ef.residual["w"].numpy(),
                                      np.asarray(jef.residual["w"]))
    total = gc.decompress(comps[0])["w"] + gc.decompress(comps[1])["w"]
    np.testing.assert_allclose(total.numpy(), 0.6, atol=0.01)
    _, ef16 = gc.ef_compress(g, gc.ef_init(g), kind="bf16")
    _, jef16 = jgc.ef_compress(jg, jgc.ef_init(jg), kind="bf16")
    np.testing.assert_array_equal(ef16.residual["w"].numpy(),
                                  np.asarray(jef16.residual["w"]))


# ------------------------------------------------------------------ ckpt
def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"a": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5,
            "b": {"c": torch.arange(5, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), tree, step=7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored, step = ckpt.restore(str(tmp_path), tree)
    assert step == 7
    assert restored["a"].dtype == torch.bfloat16
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_latest_pointer_moves(tmp_path):
    tree = {"x": torch.zeros(2)}
    ckpt.save(str(tmp_path), tree, step=1)
    ckpt.save(str(tmp_path), tree, step=2)
    assert ckpt.latest_step(str(tmp_path)) == 2
    _, s = ckpt.restore(str(tmp_path), tree, step=1)
    assert s == 1
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]


def test_async_checkpointer(tmp_path):
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    x = torch.ones(8)
    c.save_async({"x": x}, 3)
    x.add_(1)                      # training goes on writing in place
    c.wait()
    assert c.last_saved == 3 and ckpt.latest_step(str(tmp_path)) == 3
    restored, _ = ckpt.restore(str(tmp_path), {"x": 0})
    assert torch.equal(restored["x"], torch.ones(8))


def _state(rng):
    """One training state as the reference's numpy tree: bf16 params
    (a stacked leaf among them), f32 moments, an int32 step."""
    params = {"embed": {"table": rng.normal(size=(16, 4))},
              "final_norm": rng.normal(size=(4,)),
              "layers": {"w": rng.normal(size=(3, 4, 4)),
                         "ln": rng.normal(size=(3, 4))}}
    params = jax.tree_util.tree_map(
        lambda a: a.astype(ml_dtypes.bfloat16), params)
    mu = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(
        lambda a: rng.random(size=a.shape).astype(np.float32), params)
    return {"params": params,
            "opt": jadamw.AdamWState(mu=mu, nu=nu, step=np.int32(9))}


def _as_port(tree):
    """The same state with torch leaves and the port's AdamWState."""
    conv = (lambda a: torch.from_numpy(np.asarray(a).view(np.int16))
            .view(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16
            else torch.from_numpy(np.asarray(a)))
    t = jax.tree_util.tree_map(conv, tree["params"])
    opt = tree["opt"]
    return {"params": t, "opt": adamw.AdamWState(
        mu=jax.tree_util.tree_map(conv, opt.mu),
        nu=jax.tree_util.tree_map(conv, opt.nu), step=np.int32(opt.step))}


def test_checkpoints_cross_between_packages(tmp_path):
    state = _state(np.random.default_rng(3))
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(port_dir, _as_port(state), step=9)
    jckpt.save(ref_dir, state, step=9)
    # the same files: leaf order, shapes, dtypes and bytes
    pm, rm = (json.loads(open(os.path.join(d, "step_000000009",
                                           "manifest.json")).read())
              for d in (port_dir, ref_dir))
    assert pm["leaves"] == rm["leaves"] and pm["step"] == rm["step"] == 9
    assert [m["dtype"] for m in pm["leaves"]][:5] == ["float32"] * 5
    for m in pm["leaves"]:
        a, b = (open(os.path.join(d, "step_000000009", m["file"]),
                     "rb").read() for d in (port_dir, ref_dir))
        assert a == b, m
    assert open(os.path.join(port_dir, "LATEST")).read() == \
        open(os.path.join(ref_dir, "LATEST")).read()
    # each restores the other's, bit for bit
    want = jax.tree_util.tree_leaves(state)
    ref_got, step = jckpt.restore(port_dir, state)
    assert step == 9
    for g, w in zip(jax.tree_util.tree_leaves(ref_got), want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert _bits(g).tobytes() == _bits(w).tobytes()
    port_got, step = ckpt.restore(ref_dir, _as_port(state))
    assert step == 9 and isinstance(port_got["opt"], adamw.AdamWState)
    got = ckpt._flatten(port_got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits(g).tobytes() == _bits(w).tobytes()
    assert int(port_got["opt"].step) == 9


# ------------------------------------------------------------------ elastic
def test_choose_mesh_shape_equals_reference():
    for n in range(1, 601):
        plan, want = choose_mesh_shape(n), j_choose(n)
        assert (plan.data, plan.model, plan.idle, plan.used) == \
            (want.data, want.model, want.idle, want.used), n
        assert plan.used + plan.idle == n and 16 % plan.model == 0
    plan = choose_mesh_shape(512)
    assert plan.idle == 0 and plan.model == 16 and plan.data == 32
    assert choose_mesh_shape(511).idle < 16


# ------------------------------------------------------------------ straggler
@pytest.mark.parametrize("series", ["outlier", "noise"])
def test_straggler_monitor_equals_reference(series):
    rng = np.random.default_rng(0)
    if series == "outlier":
        times = [0.10] * 16 + [1.0, 1.0, 0.1, 1.0, 1.0, 1.0, 1.0]
        kw = dict(warmup=0, patience=2, threshold=3.0)
    else:
        times = list(0.1 + 0.002 * rng.random(64))
        kw = dict(warmup=0, patience=3)
    mon = StepMonitor(StragglerPolicy(**kw))
    jmon = JStepMonitor(JStragglerPolicy(**kw))
    flags = [mon.record(t) for t in times]
    assert flags == [jmon.record(t) for t in times]
    assert mon.actions == jmon.actions and mon.median == jmon.median
    assert bool(mon.actions) == (series == "outlier")
