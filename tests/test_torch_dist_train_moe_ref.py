"""MoE training across ranks against the reference's ``jax.grad``.

Under a mesh whose ``model`` axis is above 1 the reference's MoE layer
takes its ``shard_map`` expert/tensor-parallel branch, which computes
another function than its single-device path (each data block routed
with its own capacity, the shared/dense MLPs cut by contiguous column
blocks, ROADMAP queue 3), and its gradient has a quirk of its own: the
``P()`` out-spec returns block 0's ``aux`` while the gradient is the
mean of the blocks' ``aux`` gradients.  So the port's branch
(``models.moe._moe_train_branch``) is held to the reference's own
``jax.value_and_grad(M.loss_fn)``, not to the one-device step.

``REF_GRADS`` (a subprocess on 4 forged host devices, ``XLA_FLAGS``
before its JAX import, ``Auto`` axes as ``test_torch_dist.py``'s
``REF_MOE``) takes, for reduced deepseek-moe-16b and arctic-480b (f32)
under (1, 2) and (2, 2) meshes, the loss and every gradient of
``M.loss_fn``, and ``aux`` (``M.forward_hidden``'s) with its gradient
alone.  The port's gloo world of 4 (``RANKS_SCRIPT``, one torch thread a
rank, ``subprocess.run`` with a time limit; ranks 2-3 idle on (1, 2))
computes the same through ``steps.loss_and_grads`` and ``RankPlan``
(its slices, its block of the batch), each gradient gathered to the
full leaf (``convert.rank_full``), the router's ``aux`` gradient summed
over the batch axes as the train step sums it.

The parameters: the port's ``init`` (carried to the reference as numpy)
with every matrix scaled by ``SCALE``.  At the raw init (fan-in = depth,
activations near 1e8) f32 alone parts the two packages' one-device
gradients by up to ~2e-4 of a leaf's largest (``test_torch_train_grads``),
so ``MOE_TOL`` (1e-5 of the largest) could not tell a wrong term from
rounding there; scaled, the activations stay O(1) and a wrong term
would part by a share near 1.  Tolerances: the loss to ``LOSS_RTOL``,
each gradient leaf within ``MOE_TOL`` of its largest |g| (a stacked
reference leaf row by row against the port's per-layer tensor), ``aux``
to ``LOSS_RTOL`` and its router gradient within ``MOE_TOL``.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.models import model as TM

from test_torch_dist_train import ROOT, _env, _flat, _share, _tree
from test_torch_ingest import one_torch_thread  # noqa: F401

ARCHS = ("deepseek-moe-16b", "arctic-480b")
MESHES = {"m12": (1, 2), "m22": (2, 2)}
B, S = 4, 16
SCALE = 0.15
LOSS_RTOL = 1e-6
MOE_TOL = 1e-5
WORLD_TIMEOUT = 300

# argv: inputs .npz, output .npz
REF_GRADS = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import mesh_context
from repro.configs.base import get_reduced
from repro.models import model as M


def tree(z, prefix):
    out = {}
    for key, v in z.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def flat(t, prefix, out):
    for k, v in t.items():
        if isinstance(v, dict):
            flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


inp = dict(np.load(sys.argv[1]))
out = {}
auto = (jax.sharding.AxisType.Auto,) * 2
for arch in ("deepseek-moe-16b", "arctic-480b"):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params, batch = tree(inp, f"{arch}/params"), tree(inp, f"{arch}/batch")
    for tag, shape in (("m12", (1, 2)), ("m22", (2, 2))):
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=auto)
        with mesh_context(mesh):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: M.loss_fn(cfg, p, b)))(params, batch)
            aux, g_aux = jax.jit(jax.value_and_grad(
                lambda p, b: M.forward_hidden(cfg, p, b)[1]))(params, batch)
        out[f"{tag}/{arch}/loss"] = np.asarray(loss)
        out[f"{tag}/{arch}/aux"] = np.asarray(aux)
        out[f"{tag}/{arch}/aux_router"] = np.asarray(
            g_aux["layers"]["moe"]["router"])
        flat(grads, f"{tag}/{arch}/g", out)
np.savez(sys.argv[2], **out)
"""

# argv: inputs .npz, the world's own directory (its store, rank<r>.npz)
RANKS_SCRIPT = r"""
import dataclasses, os, sys

import numpy as np
import torch
import torch.multiprocessing as mp

B, S = 4, 16


def tree(z, prefix):
    out = {}
    for key, v in z.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = v
    return out


def one(rank, res, z, mesh, tag, arch):
    from repro_torch import convert
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import local_batch
    from repro_torch.launch.train import RankPlan
    from repro_torch.models import model as M
    from repro_torch.models import parallel as par
    from repro_torch.models.steps import loss_and_grads
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    plan = RankPlan(cfg, mesh)
    if plan.groups is None:
        return
    model = plan.shard(convert.model_params_from_numpy(
        cfg, tree(z, f"{arch}/params"), "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in
             local_batch(tree(z, f"{arch}/batch"), mesh).items()}
    loss, grads = loss_and_grads(cfg, model, batch, groups=plan.groups)
    key = f"{tag}/{arch}"
    res[f"{key}/loss"] = float(loss)
    for name, g in grads.items():
        full = convert.rank_full(name, g, plan.param_specs[name], mesh,
                                 plan.shapes[name], cfg)
        if rank == 0:
            res[f"{key}/g/{name}"] = full.numpy()
    routers = [blk.moe.router for blk in model.layers]
    with par.parallel_context(plan.groups):
        _, aux = M.forward_hidden(cfg, model, batch)
        g_aux = torch.autograd.grad(aux, routers)
    res[f"{key}/aux"] = float(aux)
    for i, g in enumerate(g_aux):
        res[f"{key}/aux_router/{i}"] = par.all_reduce(
            g.contiguous(), plan.groups.batch).numpy()


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
                  "m22": tm.make_local_mesh(2, 2, "cpu")}
        for arch in ("deepseek-moe-16b", "arctic-480b"):
            for tag, mesh in meshes.items():
                one(rank, res, z, mesh, tag, arch)
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


def _batch(cfg, seed) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
            .astype(np.int32)}


def scaled_init(cfg, seed):
    """The port's init with every matrix scaled by ``SCALE``."""
    model = TM.init(cfg, torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.mul_(SCALE)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's world, side by side;
    (reference outputs, every rank's)."""
    d = tmp_path_factory.mktemp("dist_train_moe_ref")
    inp = {}
    for i, arch in enumerate(ARCHS):
        cfg = _f32(arch)
        inp.update(_flat(convert.model_params_to_numpy(
            scaled_init(cfg, 11 + i)), f"{arch}/params"))
        inp.update({f"{arch}/batch/{k}": v
                    for k, v in _batch(cfg, 3 + i).items()})
    np.savez(d / "inputs.npz", **inp)
    ref = subprocess.Popen([sys.executable, "-c", REF_GRADS,
                            str(d / "inputs.npz"), str(d / "ref.npz")],
                           env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
    try:
        own = d / "world"
        own.mkdir()
        (own / "ranks.py").write_text(RANKS_SCRIPT)
        r = subprocess.run([sys.executable, str(own / "ranks.py"),
                            str(d / "inputs.npz"), str(own)], env=_env(),
                           capture_output=True, text=True,
                           timeout=WORLD_TIMEOUT, cwd=str(ROOT))
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        out, err = ref.communicate(timeout=WORLD_TIMEOUT)
        assert ref.returncode == 0, out[-2000:] + err[-2000:]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    with np.load(d / "ref.npz") as z:
        want = dict(z)
    ranks = []
    for rank in range(4):
        with np.load(own / f"rank{rank}.npz") as z:
            ranks.append(dict(z))
    return want, ranks


def _ranks(ranks, tag):
    return ranks[:MESHES[tag][0] * MESHES[tag][1]]


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(runs, arch, tag):
    want, ranks = runs
    key = f"{tag}/{arch}"
    for res in _ranks(ranks, tag):
        np.testing.assert_allclose(res[f"{key}/loss"], want[f"{key}/loss"],
                                   rtol=LOSS_RTOL)
    got = convert.unstack_tree(_f32(arch), _tree(want, f"{key}/g"))
    assert sorted(got) == sorted(n[len(key) + 3:] for n in ranks[0]
                                 if n.startswith(f"{key}/g/"))
    worst = {name: _share(ranks[0][f"{key}/g/{name}"], w)
             for name, w in got.items()}
    assert max(worst.values()) <= MOE_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_aux_and_its_router_gradient_match_reference(runs, arch, tag):
    """Block 0's ``aux`` on every rank, and the mean of the blocks'
    ``aux`` gradients (the reference's ``P()`` out-spec)."""
    want, ranks = runs
    key = f"{tag}/{arch}"
    rows = want[f"{key}/aux_router"]
    for res in _ranks(ranks, tag):
        np.testing.assert_allclose(res[f"{key}/aux"], want[f"{key}/aux"],
                                   rtol=LOSS_RTOL)
        for i, row in enumerate(rows):
            assert _share(res[f"{key}/aux_router/{i}"], row) <= MOE_TOL, i
