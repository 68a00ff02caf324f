"""The training driver end to end, against the reference.

Twins of ``tests/test_train_loop.py``'s first two tests (the loss falls
on reduced gemma-2b at the reference's settings; the restart drill on
reduced falcon-mamba-7b resumes within rtol 1e-5 of a straight run),
then parity with the reference:

* ``make_train_step`` for 3 steps from the reference's ``M.init`` and
  ``adamw.init`` (transplanted through ``convert``), beside the
  reference's jitted step, f32: the losses within rtol 1e-5, ``lr``
  within rtol 1e-6, ``grad_norm`` within ``GNORM_RTOL`` = 2e-3 (after
  the first update the gradients are taken at parameters that part by
  f32 error: falcon-mamba's scan parted by 1.2e-3 at step 2, the others
  by <= 2e-4).  The final parameters: no element parts by more than
  ``PARAM_TOL`` = 0.5 of the summed learning rates, and at most
  ``PARAM_SHARE`` = 5% of the elements by more than 1e-3 of it.  An
  AdamW step moves each element by about ``lr`` whatever its gradient's
  size, so an element whose gradient is near zero (f32 error is ~2e-4
  of a leaf's largest |g| in both packages, ``test_torch_train_grads``)
  moves by up to ``lr`` in a direction that error picks: gemma-2b,
  deepseek-moe-16b and falcon-mamba-7b showed 0.05, 0.04 and 0.36 of
  the summed rates at most, on 0.05%, 0.03% and 3.0% of the elements
  (falcon-mamba's first ``in_proj``: 7%);
* resume across the packages: the reference trains reduced gemma-2b
  (f32) 4 steps and checkpoints; the port resumes from that directory to
  step 8; its losses of steps 4-7 hold to the reference's own 8-step
  run within ``RESUME_RTOL`` = 1e-4;
* ``python -m repro_torch.launch.train --reduced --steps 3 --device
  cpu`` prints the reference driver's lines: the same steps, the same
  fields and formats;
* ``launch/roofline``: ``count_params`` (all and active), ``model_flops``,
  ``_cache_bytes`` and ``analytic_hbm_bytes`` equal to the reference's
  for all 10 architectures and every shape kind; only the constants
  (the H100's, not the TPU v5e's) differ.
"""
from __future__ import annotations

import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, SHAPES, get_config, get_reduced
from repro.launch import roofline as jroof
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.models.steps import make_train_step as j_make_train_step
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.launch import roofline
from repro_torch.launch import train as ttrain
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw

from test_torch_ingest import one_torch_thread  # noqa: F401
from test_torch_train_grads import batch_for

GNORM_RTOL = 2e-3
PARAM_TOL, PARAM_SHARE = 0.5, 0.05
RESUME_RTOL = 1e-4
QUIET = dict(log=lambda *a: None)


def test_train_loss_decreases():
    cfg = t_get_reduced("gemma-2b")
    opt = adamw.AdamWConfig(lr=3e-3, warmup=5, total_steps=60)
    _, _, losses = ttrain.train(cfg, steps=60, global_batch=8, seq_len=32,
                                opt_cfg=opt, device="cpu", **QUIET)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < first - 0.1, (first, last)


def test_restart_is_bit_identical(tmp_path):
    cfg = t_get_reduced("falcon-mamba-7b")
    opt = adamw.AdamWConfig(total_steps=12, warmup=2)
    kw = dict(global_batch=4, seq_len=32, opt_cfg=opt, device="cpu",
              **QUIET)
    ttrain.train(cfg, steps=8, ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    _, _, resumed = ttrain.train(cfg, steps=12, ckpt_dir=str(tmp_path),
                                 resume=True, **kw)
    _, _, full = ttrain.train(cfg, steps=12, **kw)
    assert len(resumed) == 4
    np.testing.assert_allclose(resumed, full[8:], rtol=1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-moe-16b",
                                  "falcon-mamba-7b"])
def test_three_train_steps_match_reference(arch):
    kw = dict(lr=1e-3, warmup=1, total_steps=3)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = JM.init(cfg, jax.random.PRNGKey(0))
    jstate = jadamw.init(params)
    model = convert.model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    state = convert.adamw_state_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    jstep = jax.jit(j_make_train_step(cfg, jadamw.AdamWConfig(**kw)))
    step = make_train_step(cfg, adamw.AdamWConfig(**kw))
    for i in range(3):
        b = batch_for(cfg, i)
        params, jstate, jm = jstep(params, jstate,
                                   {k: jnp.asarray(v) for k, v in b.items()})
        model, state, m = step(model, state,
                               {k: torch.from_numpy(v) for k, v in b.items()})
        assert state.step == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GNORM_RTOL)
    lr_sum = sum(adamw.schedule(adamw.AdamWConfig(**kw), s)
                 for s in (1, 2, 3))
    want = convert.unstack_tree(cfg, jax.tree_util.tree_map(np.asarray,
                                                            params))
    got = convert.model_params_to_numpy(model)
    got = convert.unstack_tree(cfg, got)
    assert sorted(got) == sorted(want)
    apart = total = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= PARAM_TOL * lr_sum, name
        apart += int((diff > 1e-3 * lr_sum).sum())
        total += diff.size
    assert apart <= PARAM_SHARE * total, (apart, total)


def test_resume_across_packages_continues_the_reference(tmp_path):
    cfg = dataclasses.replace(get_reduced("gemma-2b"), dtype="float32")
    tcfg = dataclasses.replace(t_get_reduced("gemma-2b"), dtype="float32")
    kw = dict(global_batch=4, seq_len=32, **QUIET)
    jopt = jadamw.AdamWConfig(lr=3e-3, warmup=2, total_steps=8)
    opt = adamw.AdamWConfig(lr=3e-3, warmup=2, total_steps=8)
    jtrain.train(cfg, steps=4, ckpt_dir=str(tmp_path), ckpt_every=4,
                 opt_cfg=jopt, **kw)
    _, _, want = jtrain.train(cfg, steps=8, opt_cfg=jopt, **kw)
    model, state, got = ttrain.train(tcfg, steps=8, ckpt_dir=str(tmp_path),
                                     resume=True, opt_cfg=opt, device="cpu",
                                     **kw)
    assert state.step == 8 and len(got) == 4
    np.testing.assert_allclose(got, want[4:], rtol=RESUME_RTOL)


LINE = re.compile(r"^\[train\] step=(\d+) loss=\d+\.\d{4} gnorm=\d+\.\d{3} "
                  r"t=\d+\.\d{3}s$")


def test_cli_prints_the_reference_lines(capsys, monkeypatch):
    ttrain.main(["--arch", "gemma-2b", "--reduced", "--steps", "3",
                 "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "gemma-2b",
                                      "--reduced", "--steps", "3"])
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert LINE.match(g) and LINE.match(w), (g, w)
        assert LINE.match(g).group(1) == LINE.match(w).group(1)


def test_roofline_arithmetic_equals_reference():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    kinds = sorted({kind for _, _, kind in SHAPES.values()})
    assert kinds == ["decode", "prefill", "train"]
    for arch in ARCH_IDS:
        cfg, tcfg = get_config(arch), t_get_config(arch)
        for active in (False, True):
            assert roofline.count_params(tcfg, active) == \
                jroof.count_params(cfg, active)
        for seq, batch, _ in SHAPES.values():
            assert roofline._cache_bytes(tcfg, seq, batch) == \
                jroof._cache_bytes(cfg, seq, batch)
            for kind in kinds:
                assert roofline.model_flops(tcfg, kind, seq, batch) == \
                    jroof.model_flops(cfg, kind, seq, batch)
                assert roofline.analytic_hbm_bytes(tcfg, kind, seq, batch) \
                    == jroof.analytic_hbm_bytes(cfg, kind, seq, batch)
    terms = roofline.RooflineTerms(flops=989e12, hbm_bytes=6.7e12,
                                   coll_bytes=0.0, coll_breakdown={},
                                   chips=1, model_flops=494.5e12)
    assert terms.t_compute == 1.0 and terms.t_memory == 2.0
    assert terms.dominant == "memory" and terms.useful_ratio == 0.5
