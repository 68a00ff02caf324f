"""Training across ranks: the port's mesh step against its one-device step.

The reference trains under any mesh through GSPMD, whose constraints
change layouts only, so its mesh step is the one-device step.  The port
holds each rank's slices and calls the collectives itself
(``models.parallel``, ``launch.train.RankPlan``); these tests hold it to
its own one-device step on the CPU (``test_torch_dist_train_ref.py``
holds it to the reference's forged-device run).

One gloo world of 4 ranks (``RANKS_SCRIPT``, one torch thread a rank,
run by ``subprocess.run`` with a time limit so that a hang fails one
test) runs every case and writes ``rank<r>.npz``; this process computes
the one-device twins:

* one step of reduced gemma-2b (f32) from one transplanted init (drawn
  here, carried as numpy through ``convert.model_params_from_numpy``,
  then cut by ``RankPlan.shard``) on (2, 1) and (1, 2) meshes (from
  ``make_mesh_from_plan`` over ranks 0-1; ranks 2-3 idle), (2, 2) and
  (4, 1): the loss within ``LOSS_RTOL``, ``grad_norm`` within
  ``GNORM_RTOL``; every parameter after the step within ``STEP_TOL`` of
  the learning rate of the one-device step's, and at most
  ``STEP_SHARE`` of the elements beyond 1e-3 of it.  (Not within 1e-6
  of the leaf's largest magnitude: AdamW's first step moves an element
  by ``lr * g / (|g| + eps)``, so an element whose gradient is within
  the f32 error of a reordered sum of zero moves by a fraction of ``lr``
  that this error picks; gemma-2b's ``wk`` parted by 0.081 ``lr``, 3.1e-5
  of its largest magnitude, on 0.022% of the elements at most); each rank's
  moments have ``zero1_pspecs``' local shapes (the slices of a leaf
  sharded over ``data`` hold its numel over ``data``, over ``model``
  too where the parameter splits there);
* data parallelism alone, (2, 1), for one reduced arch of each other
  family but MoE (falcon-mamba-7b, zamba2-7b, internvl2-26b,
  seamless-m4t-large-v2), at the same tolerances; falcon-mamba's
  ``d_skip`` has ZeRO-1 split its layer axis;
* ``train(mesh=(2, 2))`` for 3 steps: the replicated leaves (norm
  gammas, ``final_norm``) bit-equal on every rank, and the losses
  beside the one-device ``train``'s;
* gemma-2b's single KV head cut inside at ``model = 2`` (K and V
  rebuilt by ``gather_from_model``) and the gated MLP's gate/up cut of
  ``wi``: one block's forward and backward (``attention_block``, the
  dense FFN) on (1, 2) against the full block's, every gradient gathered
  to the full leaf (``wi`` back to ``[gate | up]``);
* a checkpoint written under (2, 2) at step 2 and resumed under (4, 1)
  to step 4 (and falcon-mamba's under (2, 1), its ``d_skip`` moments
  held a layer a data rank): the losses within ``RESUME_RTOL`` of a
  straight one-device run;
* ``python -m torch.distributed.run --nproc-per-node 2 -m
  repro_torch.launch.train --arch gemma-2b --reduced --steps 3 --device
  cpu``: the reference driver's lines, printed once (rank 0), on the
  (1, 2) mesh ``choose_mesh_shape(2)`` picks.

And without processes: ``train`` refuses plain axis sizes above 1 and a
mesh that an arch does not cut evenly.  The MoE family and the tensor
parallelism of the other families: ``test_torch_dist_train_moe.py``,
``test_torch_dist_train_moe_ref.py``, ``test_torch_dist_train_tp.py``.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pathlib
import re
import socket
import subprocess
import sys
from math import prod

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.models.attention import attention_block
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw

from test_torch_ingest import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "gemma-2b"
DP_ARCHS = ("falcon-mamba-7b", "zamba2-7b", "internvl2-26b",
            "seamless-m4t-large-v2")
MESHES = {"m21": (2, 1), "m12": (1, 2), "m22": (2, 2), "m41": (4, 1)}
B, S = 4, 16
OPT = dict(lr=1e-3, warmup=1, total_steps=3)
LOSS_RTOL, GNORM_RTOL = 1e-6, 1e-5
STEP_TOL, STEP_SHARE = 0.25, 1e-3      # of lr; elements beyond 1e-3 lr
BLOCK_TOL = 1e-6               # of the largest magnitude, block outputs
RESUME_RTOL = 1e-4             # test_torch_train_loop.py's
TRAIN3 = dict(steps=3, global_batch=B, seq_len=S)
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
DP_ARCHS = ("falcon-mamba-7b", "zamba2-7b", "internvl2-26b",
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
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw
    cfg = f32(arch)
    plan = RankPlan(cfg, mesh)
    if plan.groups is None:
        return
    model = plan.shard(convert.model_params_from_numpy(
        cfg, tree(z, f"{arch}/params"), "cpu"))
    zero1 = plan.zero1()
    state = adamw.init(dict(model.named_parameters()), zero1=zero1)
    step = make_train_step(cfg, adamw.AdamWConfig(**OPT),
                           groups=plan.groups, zero1=zero1)
    batch = local_batch(tree(z, f"{arch}/batch"), mesh)
    model, state, m = step(model, state, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    key = f"{tag}/{arch}"
    res[f"{key}/loss"], res[f"{key}/gnorm"] = float(m["loss"]), \
        float(m["grad_norm"])
    for name, t in state.mu.items():
        res[f"{key}/mu_shape/{name}"] = np.asarray(t.shape, np.int64)
    params, _, _ = plan.full_state(model, state)
    if rank == 0:
        for name, p in params.items():
            res[f"{key}/p/{name}"] = p.numpy()


def blocks(rank, res, z, mesh):
    from repro_torch import convert
    from repro_torch.launch.train import RankPlan
    from repro_torch.models import parallel as par
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import attention_block
    cfg = f32("gemma-2b")
    plan = RankPlan(cfg, mesh)
    if plan.groups is None:
        return
    model = plan.shard(convert.model_params_from_numpy(
        cfg, tree(z, "gemma-2b/params"), "cpu"))
    p = model.layers[0]
    x = torch.from_numpy(z["block/x"]).requires_grad_()
    gy = torch.from_numpy(z["block/gy"])
    pos = torch.arange(S)
    with par.parallel_context(plan.groups):
        y, _ = attention_block(p.attn, x, pos, cfg=cfg,
                               window=cfg.layer_windows(S)[0], remat=False)
        names = ("wq", "wk", "wv", "wo")
        g = torch.autograd.grad(y, [x] + [getattr(p.attn, n) for n in names],
                                gy)
        res["attn/y"], res["attn/gx"] = y.detach().numpy(), g[0].numpy()
        for n, gl in zip(names, g[1:]):
            full = f"layers.0.attn.{n}"
            res[f"attn/g/{n}"] = convert.rank_full(
                full, gl, plan.param_specs[full], mesh,
                plan.shapes[full]).numpy()
        y, _ = tf._dense_ffn(cfg)(p, x)
        g = torch.autograd.grad(y, [x, p.mlp.wi, p.mlp.wo], gy)
        res["mlp/y"], res["mlp/gx"] = y.detach().numpy(), g[0].numpy()
        for n, gl in zip(("wi", "wo"), g[1:]):
            full = f"layers.0.mlp.{n}"
            res[f"mlp/g/{n}"] = convert.rank_full(
                full, gl, plan.param_specs[full], mesh,
                plan.shapes[full]).numpy()
    res["mlp/wi_local"] = p.mlp.wi.detach().numpy()


def three_steps(rank, res, mesh):
    from repro_torch.launch.train import RankPlan, train
    from repro_torch.optim import adamw
    cfg = f32("gemma-2b")
    model, _, losses = train(cfg, global_batch=B, seq_len=S, steps=3,
                             device="cpu", mesh=mesh,
                             opt_cfg=adamw.AdamWConfig(**OPT),
                             log=lambda *a: None)
    res["three/losses"] = np.asarray(losses)
    specs = RankPlan(cfg, mesh).param_specs
    for name, p in model.named_parameters():
        if all(e is None for e in specs[name]):
            res[f"three/rep/{name}"] = p.detach().numpy()


def resume(rank, res, first, second, ckpt, arch):
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    cfg = f32(arch)
    kw = dict(global_batch=B, seq_len=S, device="cpu", ckpt_dir=ckpt,
              opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup=2, total_steps=4),
              log=lambda *a: None)
    train(cfg, steps=2, ckpt_every=2, mesh=first, **kw)
    _, state, losses = train(cfg, steps=4, resume=True, mesh=second, **kw)
    if state is not None:
        res[f"resume/{arch}/losses"] = np.asarray(losses)
        res[f"resume/{arch}/step"] = state.step


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
        meshes = {"m21": make_mesh_from_plan(MeshPlan(2, 1, 2), "cpu"),
                  "m12": make_mesh_from_plan(MeshPlan(1, 2, 2), "cpu"),
                  "m22": tm.make_local_mesh(2, 2, "cpu"),
                  "m41": tm.make_local_mesh(4, 1, "cpu")}
        for tag, mesh in meshes.items():
            one_step(rank, res, z, mesh, tag, "gemma-2b")
        for arch in DP_ARCHS:
            one_step(rank, res, z, meshes["m21"], "m21", arch)
        blocks(rank, res, z, meshes["m12"])
        three_steps(rank, res, meshes["m22"])
        resume(rank, res, meshes["m22"], meshes["m41"],
               os.path.join(own, "ckpt"), "gemma-2b")
        # ZeRO-1 splits falcon-mamba's d_skip over its layer axis
        resume(rank, res, meshes["m21"], meshes["m21"],
               os.path.join(own, "ckpt_ssm"), "falcon-mamba-7b")
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


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _flat(tree, prefix) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _share(got, want) -> float:
    """max |got - want| as a share of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(cfg, seed) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, S, cfg.frontend_dim)) \
            .astype(np.float32)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each arch's transplanted init and batch, and the block inputs."""
    d = tmp_path_factory.mktemp("dist_train")
    inp = {}
    for i, arch in enumerate((ARCH,) + DP_ARCHS):
        cfg = _f32(arch)
        model = TM.init(cfg, torch.Generator().manual_seed(7 + i), "cpu")
        inp.update(_flat(convert.model_params_to_numpy(model),
                         f"{arch}/params"))
        inp.update({f"{arch}/batch/{k}": v
                    for k, v in _batch(cfg, i).items()})
    rng = np.random.default_rng(5)
    d_model = _f32(ARCH).d_model
    inp["block/x"] = rng.normal(size=(B, S, d_model)).astype(np.float32)
    inp["block/gy"] = rng.normal(size=(B, S, d_model)).astype(np.float32)
    np.savez(d / "inputs.npz", **inp)
    return d, inp


@pytest.fixture(scope="module")
def world(inputs):
    d, inp = inputs
    own = d / "world"
    own.mkdir()
    script = own / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    r = subprocess.run([sys.executable, str(script), str(d / "inputs.npz"),
                        str(own)], env=_env(), capture_output=True,
                       text=True, timeout=WORLD_TIMEOUT, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = []
    for rank in range(4):
        with np.load(own / f"rank{rank}.npz") as z:
            out.append(dict(z))
    return out


def _tree(inp, prefix) -> dict:
    out = {}
    for key, v in inp.items():
        if key.startswith(prefix + "/"):
            node = out
            parts = key[len(prefix) + 1:].split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = v
    return out


def _params_agree(got: dict, want: dict, prefix: str) -> None:
    """The mesh step's parameters against the one-device step's."""
    lr = OPT["lr"]
    apart = total = 0
    for name, w in want.items():
        diff = np.abs(got[f"{prefix}/{name}"] - w)
        assert diff.max() <= STEP_TOL * lr, (name, diff.max() / lr)
        apart += int((diff > 1e-3 * lr).sum())
        total += diff.size
    assert apart <= STEP_SHARE * total, (apart, total)


def _one_device_step(inp, arch):
    """(loss, grad_norm, {name: parameter}) of the one-device step."""
    cfg = _f32(arch)
    model = convert.model_params_from_numpy(
        cfg, _tree(inp, f"{arch}/params"), "cpu")
    state = adamw.init(dict(model.named_parameters()))
    step = make_train_step(cfg, adamw.AdamWConfig(**OPT))
    batch = {k: torch.from_numpy(v)
             for k, v in _tree(inp, f"{arch}/batch").items()}
    model, state, m = step(model, state, batch)
    return float(m["loss"]), float(m["grad_norm"]), {
        n: p.detach().numpy() for n, p in model.named_parameters()}


def _zero1_local_shapes(cfg, sizes, coord) -> dict:
    """{port name: the moment's local shape} from ``zero1_pspecs`` on the
    stacked tree, computed apart from ``RankPlan``: a stacked leaf's
    local block, its layer rows split among the port's per-layer names
    ((0,) for a layer whose rows are on another rank)."""
    specs = adamw.zero1_pspecs(TM.specs(cfg), TM.pspecs(cfg),
                               data_size=sizes["data"])
    shapes = TM.specs(cfg)
    out = {}
    for name, _ in TM.Model(cfg, "meta").named_parameters():
        parts = name.split(".")
        path = [q for q in parts if not q.isdigit()]
        layer = [int(q) for q in parts if q.isdigit()]
        spec, shape = specs, shapes
        for q in path:
            spec, shape = spec[q], shape[q]
        local, first, count = [], 0, shape.shape[0]
        entries = tuple(spec) + (None,) * (len(shape.shape) - len(spec))
        for dim, (e, n) in enumerate(zip(entries, shape.shape)):
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            k, idx = 1, 0
            for a in axes:
                k, idx = k * sizes[a], idx * sizes[a] + coord[a]
            local.append(n // k)
            if dim == 0:
                first, count = idx * (n // k), n // k
        if not layer:
            out[name] = tuple(local)
        elif first <= layer[0] < first + count:
            out[name] = tuple(local[1:])
        else:
            out[name] = (0,)
    return out


def _numel_check(cfg, sizes, res, key):
    """The rank's moments of each stacked leaf hold its numel over the
    mesh axes that ``zero1_pspecs`` splits it over (``data`` among them
    wherever it divides)."""
    specs = adamw.zero1_pspecs(TM.specs(cfg), TM.pspecs(cfg),
                               data_size=sizes["data"])
    shapes = TM.specs(cfg)
    held = collections.Counter()
    for name, _ in TM.Model(cfg, "meta").named_parameters():
        path = tuple(q for q in name.split(".") if not q.isdigit())
        held[path] += int(np.prod(res[f"{key}/mu_shape/{name}"]))
    for path, n in held.items():
        spec, shape = specs, shapes
        for q in path:
            spec, shape = spec[q], shape[q]
        axes = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        assert n == shape.numel() // prod(sizes[a] for a in axes), path


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_one_step_matches_one_device(world, inputs, tag):
    _, inp = inputs
    loss, gnorm, params = _one_device_step(inp, ARCH)
    data, model = MESHES[tag]
    ranks = world[:data * model]
    for res in ranks:
        np.testing.assert_allclose(res[f"{tag}/{ARCH}/loss"], loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res[f"{tag}/{ARCH}/gnorm"], gnorm,
                                   rtol=GNORM_RTOL)
    _params_agree(ranks[0], params, f"{tag}/{ARCH}/p")


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_moments_hold_their_zero1_slices(world, tag):
    cfg = _f32(ARCH)
    data, model = MESHES[tag]
    sizes = {"data": data, "model": model}
    for rank, res in enumerate(world[:data * model]):
        coord = {"data": rank // model, "model": rank % model}
        want = _zero1_local_shapes(cfg, sizes, coord)
        for name, shape in want.items():
            got = tuple(res[f"{tag}/{ARCH}/mu_shape/{name}"])
            assert got == shape, (rank, name, got, shape)
        _numel_check(cfg, sizes, res, f"{tag}/{ARCH}")


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_data_parallel_step_of_other_families(world, inputs, arch):
    _, inp = inputs
    loss, gnorm, params = _one_device_step(inp, arch)
    for rank, res in enumerate(world[:2]):
        np.testing.assert_allclose(res[f"m21/{arch}/loss"], loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res[f"m21/{arch}/gnorm"], gnorm,
                                   rtol=GNORM_RTOL)
        want = _zero1_local_shapes(_f32(arch), {"data": 2, "model": 1},
                                   {"data": rank, "model": 0})
        for name, shape in want.items():
            assert tuple(res[f"m21/{arch}/mu_shape/{name}"]) == shape, name
    _params_agree(world[0], params, f"m21/{arch}/p")


def test_replicated_leaves_stay_bit_equal(world):
    cfg = _f32(ARCH)
    names = [k for k in world[0] if k.startswith("three/rep/")]
    assert any(k.endswith("final_norm") for k in names)
    assert sum(k.endswith(".ln1") for k in names) == cfg.n_layers
    for res in world[1:]:
        for k in names:
            assert np.array_equal(res[k], world[0][k]), k
    _, _, want = ttrain.train(cfg, device="cpu",
                              opt_cfg=adamw.AdamWConfig(**OPT),
                              log=lambda *a: None, **TRAIN3)
    for res in world:
        np.testing.assert_allclose(res["three/losses"], want, rtol=1e-5)


def _full_block(inp):
    cfg = _f32(ARCH)
    model = convert.model_params_from_numpy(
        cfg, _tree(inp, f"{ARCH}/params"), "cpu")
    p = model.layers[0]
    x = torch.from_numpy(inp["block/x"]).requires_grad_()
    gy = torch.from_numpy(inp["block/gy"])
    y, _ = attention_block(p.attn, x, torch.arange(S), cfg=cfg,
                           window=cfg.layer_windows(S)[0], remat=False)
    names = ("wq", "wk", "wv", "wo")
    g = torch.autograd.grad(y, [x] + [getattr(p.attn, n) for n in names], gy)
    out = {"attn/y": y.detach().numpy(), "attn/gx": g[0].numpy(),
           **{f"attn/g/{n}": t.numpy() for n, t in zip(names, g[1:])}}
    y, _ = ttf._dense_ffn(cfg)(p, x)
    g = torch.autograd.grad(y, [x, p.mlp.wi, p.mlp.wo], gy)
    out.update({"mlp/y": y.detach().numpy(), "mlp/gx": g[0].numpy(),
                "mlp/g/wi": g[1].numpy(), "mlp/g/wo": g[2].numpy(),
                "wi": p.mlp.wi.detach().numpy()})
    return out


@pytest.mark.parametrize("part", ["attn", "mlp"])
def test_tensor_parallel_block_matches_the_full_block(world, inputs, part):
    """``attn``: gemma-2b's one KV head, cut inside at ``model = 2``;
    ``mlp``: ``wi``'s gate/up cut (rank r holds gate and up columns of
    block r, and ``gated_mlp``'s ``chunk(2)`` splits them)."""
    _, inp = inputs
    cfg = _f32(ARCH)
    assert cfg.n_kv_heads == 1
    want = _full_block(inp)
    for res in world[:2]:
        for key in [k for k in want if k.startswith(part + "/")]:
            assert _share(res[key], want[key]) <= BLOCK_TOL, key
    if part == "mlp":
        f = cfg.d_ff // 2
        for rank, res in enumerate(world[:2]):
            gate = want["wi"][:, rank * f: (rank + 1) * f]
            up = want["wi"][:, cfg.d_ff + rank * f: cfg.d_ff + (rank + 1) * f]
            np.testing.assert_array_equal(res["mlp/wi_local"],
                                          np.concatenate([gate, up], 1))


@pytest.mark.parametrize("arch, ranks", [(ARCH, 4),
                                         ("falcon-mamba-7b", 2)])
def test_checkpoint_resumes_under_another_mesh(world, arch, ranks):
    """gemma-2b written under (2, 2), resumed under (4, 1); falcon-mamba
    under (2, 1) both ways (a layer's moments on one data rank)."""
    _, _, want = ttrain.train(
        _f32(arch), steps=4, global_batch=B, seq_len=S, device="cpu",
        opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup=2, total_steps=4),
        log=lambda *a: None)
    for res in world[:ranks]:
        assert int(res[f"resume/{arch}/step"]) == 4
        np.testing.assert_allclose(res[f"resume/{arch}/losses"], want[2:],
                                   rtol=RESUME_RTOL)


LINE = re.compile(r"^\[train\] step=(\d+) loss=(\d+\.\d{4}) "
                  r"gnorm=(\d+\.\d{3}) t=\d+\.\d{3}s$")


def test_cli_under_torchrun_prints_once(capsys):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port", str(port),
         "-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced",
         "--steps", "3", "--device", "cpu"], env=_env(),
        capture_output=True, text=True, timeout=WORLD_TIMEOUT, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    got = [ln for ln in r.stdout.splitlines() if ln.startswith("[train]")]
    ttrain.main(["--arch", ARCH, "--reduced", "--steps", "3", "--device",
                 "cpu"])
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2, (got, want)
    for g, w in zip(got, want):
        mg, mw = LINE.match(g), LINE.match(w)
        assert mg and mw, (g, w)
        assert mg.group(1) == mw.group(1)
        # bf16 on two ranks against one device: a looser rule than f32's
        np.testing.assert_allclose(float(mg.group(2)), float(mw.group(2)),
                                   rtol=1e-2)


@pytest.mark.parametrize("arch, sizes", [
    ("deepseek-moe-16b", {"data": 2}), ("deepseek-moe-16b", {"model": 2}),
    ("falcon-mamba-7b", {"model": 2}), ("zamba2-7b", {"data": 1, "model": 2}),
    ("internvl2-26b", {"model": 2}), ("seamless-m4t-large-v2", {"model": 4})])
def test_train_refuses_what_is_not_ported(arch, sizes):
    """What training across ranks still refuses: plain axis sizes above
    1 (they only describe a mesh; every family trains on a
    ``DeviceMesh``: test_torch_dist_train_moe.py, _tp.py), and a mesh
    that the arch does not cut evenly (each size above 1 made 3)."""
    cfg = get_reduced(arch)
    with pytest.raises(ValueError, match="DeviceMesh"):
        ttrain.train(cfg, steps=1, global_batch=2, seq_len=8, device="cpu",
                     mesh=sizes)
    uneven = {a: 3 if n > 1 else n for a, n in sizes.items()}
    with pytest.raises(ValueError, match="does not cut 3 ways"):
        ttrain.train(cfg, steps=1, global_batch=3, seq_len=8, device="cpu",
                     mesh=uneven)
