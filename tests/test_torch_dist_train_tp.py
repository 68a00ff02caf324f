"""Tensor parallelism of ssm, hybrid, vlm and encdec against one device.

The reference trains these families under any mesh through GSPMD, whose
constraints change layouts only, so its mesh step is the one-device
step.  The port's ranks hold their slices per ``M.pspecs`` (mamba1's
``in_proj`` as ``[x_r | z_r]``, mamba2's as ``[z_r | x_r | B_r | C_r |
dt_r]`` and its ``conv_w`` rows as ``[x_r | B_r | C_r]``:
``convert.rank_layout``) and run Megatron's collectives
(``models.parallel``) in the mamba blocks, the shared attention block,
the encoder and the decoder's cross-attention, and around the vlm
``projector`` and the encdec ``enc_proj`` (``join_from_model``).

One gloo world of 4 (``RANKS_SCRIPT``, one torch thread a rank, run by
``subprocess.run`` with a time limit) runs every case:

* one step of reduced falcon-mamba-7b, zamba2-7b, internvl2-26b and
  seamless-m4t-large-v2 (f32) on (1, 2) (``make_mesh_from_plan`` over
  ranks 0-1, ranks 2-3 idle) and (2, 2), from the port's init with every
  matrix scaled by ``SCALE`` (carried as numpy), against the one-device
  step: the loss within ``LOSS_RTOL``, ``grad_norm`` within
  ``GNORM_RTOL``, every gradient gathered to the full leaf within
  ``GRAD_TOL`` of its largest, every parameter within ``STEP_TOL`` of
  the learning rate (``test_torch_dist_train.py``'s rule).  Scaled,
  because at the raw init (fan-in = depth, activations near 1e8) a
  reordered f32 sum alone moves these archs' gradients by up to 3.7e-4
  of a leaf's largest (zamba2 2.0e-4, seamless-m4t 3.7e-4 measured on
  (1, 2)), the f32 floor that ``test_torch_train_grads`` measured
  between the packages; scaled, the activations stay O(1), the same
  comparison parts by under 3e-6 on every leaf but mamba2's
  ``d_skip`` (4 elements, each a sum of 2,048 products that cancel to
  about 1e-4 of their size: 1.6e-5 on zamba2's layer 1, an absolute
  9e-9), so ``GRAD_TOL`` is 5e-5, and a wrong term would part by a
  share near 1;
* the replicated leaves (the norms' gammas, ``final_norm``, mamba2's
  ``a_log``/``d_skip``, which a rank uses only for its own heads) after
  the step: bit-equal on every rank of the mesh;
* a zamba2 checkpoint written under (2, 2) at step 2 and resumed under
  (4, 1) to step 4, and one written under (4, 1) and resumed under
  (2, 2): the losses within ``RESUME_RTOL`` of a straight one-device
  run.

And without processes: the mamba blocks' rank layouts (a rank's block
holds its block of each part) and their inverses.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.models.steps import loss_and_grads
from repro_torch.optim import adamw

from test_torch_dist_train import (GNORM_RTOL, LOSS_RTOL, OPT, RESUME_RTOL,
                                   ROOT, STEP_TOL, _batch, _env, _flat,
                                   _share, _tree)
from test_torch_ingest import one_torch_thread  # noqa: F401

ARCHS = ("falcon-mamba-7b", "zamba2-7b", "internvl2-26b",
         "seamless-m4t-large-v2")
MESHES = {"m12": (1, 2), "m22": (2, 2)}
SCALE = 0.15
GRAD_TOL = 5e-5
WORLD_TIMEOUT = 300

# argv: the inputs .npz, the world's own directory (its store, the
# checkpoint, rank<r>.npz written there)
RANKS_SCRIPT = r"""
import dataclasses, os, sys

import numpy as np
import torch
import torch.multiprocessing as mp

B, S = 4, 16
OPT = dict(lr=1e-3, warmup=1, total_steps=3)
ARCHS = ("falcon-mamba-7b", "zamba2-7b", "internvl2-26b",
         "seamless-m4t-large-v2")


def tree(z, prefix):
    out = {}
    for key, v in z.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = out
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = v
    return out


def f32(arch):
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def one_step(rank, res, z, mesh, tag, arch):
    from repro_torch import convert
    from repro_torch.launch.mesh import local_batch
    from repro_torch.launch.train import RankPlan
    from repro_torch.models.steps import loss_and_grads, make_train_step
    from repro_torch.optim import adamw
    cfg = f32(arch)
    plan = RankPlan(cfg, mesh)
    if plan.groups is None:
        return
    model = plan.shard(convert.model_params_from_numpy(
        cfg, tree(z, f"{arch}/params"), "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in
             local_batch(tree(z, f"{arch}/batch"), mesh).items()}
    key = f"{tag}/{arch}"
    _, grads = loss_and_grads(cfg, model, batch, groups=plan.groups)
    for name, g in grads.items():
        full = convert.rank_full(name, g, plan.param_specs[name], mesh,
                                 plan.shapes[name], cfg)
        if rank == 0:
            res[f"{key}/g/{name}"] = full.numpy()
    zero1 = plan.zero1()
    state = adamw.init(dict(model.named_parameters()), zero1=zero1)
    step = make_train_step(cfg, adamw.AdamWConfig(**OPT),
                           groups=plan.groups, zero1=zero1)
    model, state, m = step(model, state, batch)
    res[f"{key}/loss"], res[f"{key}/gnorm"] = float(m["loss"]), \
        float(m["grad_norm"])
    for name, p in model.named_parameters():
        if all(e is None for e in plan.param_specs[name]):
            res[f"{key}/rep/{name}"] = p.detach().numpy().copy()
    params, _, _ = plan.full_state(model, state)
    if rank == 0:
        for name, p in params.items():
            res[f"{key}/p/{name}"] = p.numpy()


def resume(rank, res, first, second, ckpt, tag):
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    cfg = f32("zamba2-7b")
    kw = dict(global_batch=B, seq_len=S, device="cpu", ckpt_dir=ckpt,
              opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup=2, total_steps=4),
              log=lambda *a: None)
    train(cfg, steps=2, ckpt_every=2, mesh=first, **kw)
    _, state, losses = train(cfg, steps=4, resume=True, mesh=second, **kw)
    if state is not None:
        res[f"resume/{tag}/losses"] = np.asarray(losses)
        res[f"resume/{tag}/step"] = state.step


def rank_main(rank, world, inputs, own):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.ft.elastic import MeshPlan, make_mesh_from_plan
    from repro_torch.launch import mesh as tm
    tm.init_world("cpu", init_method=f"file://{own}/store", rank=rank,
                  world_size=world)
    res = {}
    try:
        z = dict(np.load(inputs))
        meshes = {"m12": make_mesh_from_plan(MeshPlan(1, 2, 2), "cpu"),
                  "m22": tm.make_local_mesh(2, 2, "cpu"),
                  "m41": tm.make_local_mesh(4, 1, "cpu")}
        for arch in ARCHS:
            for tag in ("m12", "m22"):
                one_step(rank, res, z, meshes[tag], tag, arch)
        resume(rank, res, meshes["m22"], meshes["m41"],
               os.path.join(own, "ckpt"), "m22_m41")
        # and back: restored into mamba2's rank layouts under model = 2
        resume(rank, res, meshes["m41"], meshes["m22"],
               os.path.join(own, "ckpt_back"), "m41_m22")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(own, f"rank{rank}.npz"), **res)


if __name__ == "__main__":
    inputs, own = sys.argv[1], sys.argv[2]
    mp.spawn(rank_main, args=(4, inputs, own), nprocs=4)
"""


def _f32(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _scaled_init(cfg, seed):
    model = TM.init(cfg, torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.mul_(SCALE)
    return model


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each arch's scaled init and batch."""
    d = tmp_path_factory.mktemp("dist_train_tp")
    inp = {}
    for i, arch in enumerate(ARCHS):
        cfg = _f32(arch)
        inp.update(_flat(convert.model_params_to_numpy(
            _scaled_init(cfg, 31 + i)), f"{arch}/params"))
        inp.update({f"{arch}/batch/{k}": v
                    for k, v in _batch(cfg, 13 + i).items()})
    np.savez(d / "inputs.npz", **inp)
    return d, inp


@pytest.fixture(scope="module")
def world(inputs):
    d, _ = inputs
    own = d / "world"
    own.mkdir()
    (own / "ranks.py").write_text(RANKS_SCRIPT)
    r = subprocess.run([sys.executable, str(own / "ranks.py"),
                        str(d / "inputs.npz"), str(own)], env=_env(),
                       capture_output=True, text=True,
                       timeout=WORLD_TIMEOUT, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = []
    for rank in range(4):
        with np.load(own / f"rank{rank}.npz") as z:
            out.append(dict(z))
    return out


@pytest.fixture(scope="module")
def one_device(inputs):
    """{arch: (loss, grad_norm, {name: gradient}, {name: parameter})}
    of the one-device step."""
    from repro_torch.models.steps import make_train_step
    _, inp = inputs
    out = {}
    for arch in ARCHS:
        cfg = _f32(arch)
        model = convert.model_params_from_numpy(
            cfg, _tree(inp, f"{arch}/params"), "cpu")
        batch = {k: torch.from_numpy(v)
                 for k, v in _tree(inp, f"{arch}/batch").items()}
        _, grads = loss_and_grads(cfg, model, batch)
        state = adamw.init(dict(model.named_parameters()))
        model, state, m = make_train_step(cfg, adamw.AdamWConfig(**OPT))(
            model, state, batch)
        out[arch] = (float(m["loss"]), float(m["grad_norm"]),
                     {n: g.numpy() for n, g in grads.items()},
                     {n: p.detach().numpy()
                      for n, p in model.named_parameters()})
    return out


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_one_device(world, one_device, arch, tag):
    loss, gnorm, grads, params = one_device[arch]
    key = f"{tag}/{arch}"
    data, model = MESHES[tag]
    for res in world[:data * model]:
        np.testing.assert_allclose(res[f"{key}/loss"], loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res[f"{key}/gnorm"], gnorm,
                                   rtol=GNORM_RTOL)
    worst = {n: _share(world[0][f"{key}/g/{n}"], g)
             for n, g in grads.items()}
    assert max(worst.values()) <= GRAD_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    for name, p in params.items():
        diff = np.abs(world[0][f"{key}/p/{name}"] - p).max()
        assert diff <= STEP_TOL * OPT["lr"], (name, diff / OPT["lr"])


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaves_stay_bit_equal(world, arch, tag):
    data, model = MESHES[tag]
    key = f"{tag}/{arch}/rep/"
    names = [k for k in world[0] if k.startswith(key)]
    assert any(k.endswith("final_norm") for k in names)
    if arch == "zamba2-7b":
        assert sum(k.endswith(("a_log", "d_skip")) for k in names) == \
            2 * _f32(arch).n_layers
    for res in world[1:data * model]:
        for k in names:
            assert np.array_equal(res[k], world[0][k]), k


@pytest.mark.parametrize("tag", ["m22_m41", "m41_m22"])
def test_zamba2_checkpoint_resumes_under_another_mesh(world, tag):
    """Written under (2, 2) at step 2, resumed under (4, 1) to step 4,
    and the other way round (the restore cuts mamba2's ``in_proj`` and
    ``conv_w`` into their rank layouts)."""
    _, _, want = ttrain.train(
        _f32("zamba2-7b"), steps=4, global_batch=4, seq_len=16,
        device="cpu", opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup=2,
                                                total_steps=4),
        log=lambda *a: None)
    for res in world:
        assert int(res[f"resume/{tag}/step"]) == 4
        np.testing.assert_allclose(res[f"resume/{tag}/losses"], want[2:],
                                   rtol=RESUME_RTOL)


@pytest.mark.parametrize("arch, name, parts", [
    ("falcon-mamba-7b", "layers.0.mixer.in_proj", ("x", "z")),
    ("zamba2-7b", "layers.mamba.0.mixer.in_proj",
     ("z", "x", "B", "C", "dt")),
    ("zamba2-7b", "layers.mamba.0.mixer.conv_w", ("x", "B", "C"))])
def test_mamba_rank_layouts(arch, name, parts):
    """Block r of the rank layout cut ``model`` ways holds block r of
    every part, in part order; the inverse restores the leaf."""
    cfg = _f32(arch)
    sizes = {"x": cfg.d_inner, "z": cfg.d_inner, "B": cfg.ssm_state,
             "C": cfg.ssm_state, "dt": cfg.ssm_heads}
    dim = -2 if name.endswith("conv_w") else -1
    n = sum(sizes[p] for p in parts)
    shape = (n, 3) if dim == -2 else (5, n)
    full = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    for m in (1, 2, 4):
        to, back = convert.rank_layout(name, m, cfg)
        laid = to(full)
        assert torch.equal(back(laid), full)
        split = full.split([sizes[p] for p in parts], dim=dim)
        for r, block in enumerate(laid.chunk(m, dim=dim)):
            want = torch.cat([q.chunk(m, dim=dim)[r] for q in split],
                             dim=dim)
            assert torch.equal(block, want), (m, r)
    assert convert.rank_layout("layers.0.moe.shared.wi", 2, cfg) is None
    assert convert.rank_layout("layers.0.moe.wi", 2, cfg) is None
