"""MoE training under data parallelism: the mesh step against one device.

With ``model`` = 1 the reference's MoE layer runs its single-device
path over the global batch under GSPMD, so its mesh step is the
one-device step.  The port's rank holds its block of the batch and the
experts' FSDP slices over ``data`` (``wi``/``wo``, regathered in the
layer by ``parallel.gather_from_data``, whose backward reduce-scatters
their gradient), and routes through collectives: the capacity of the
global token count, a slot's global position (its rank-local one plus
an exclusive prefix over the batch ranks of the per-expert counts), the
aux's global means (``models.moe._moe_local``'s ``dp``).

One gloo world of 4 (``RANKS_SCRIPT``, one torch thread a rank, run by
``subprocess.run`` with a time limit) runs every case:

* one step of reduced deepseek-moe-16b and arctic-480b (f32, the port's
  init carried as numpy) on (2, 1) (``make_mesh_from_plan`` over ranks
  0-1, ranks 2-3 idle) and (4, 1), held to the one-device step at
  ``test_torch_dist_train.py``'s ``LOSS_RTOL``/``GNORM_RTOL``/
  ``STEP_TOL``; each rank's moments have ``zero1_pspecs``' local shapes,
  and the experts' parameters and moments are the rank's data slices
  (the parameter equal to its block of the gathered leaf after the
  step);
* the same on a (pod, data, model) = (2, 2, 1) mesh, whose experts'
  gradients are reduce-scattered over ``data``, then summed over
  ``pod``;
* the collectives of that step: the bucketed ``all_reduce`` over the
  batch axes takes exactly the gradients of the leaves that are not
  FSDP-split (their numel summed), and one reduce-scatter over ``data``
  a MoE layer and expert leaf reduces the experts' gradients, so no
  gradient is reduced twice;
* a deepseek-moe checkpoint written under (2, 2) at step 2 (the
  expert/tensor-parallel branch) and resumed under (4, 1) to step 4:
  the losses within ``RESUME_RTOL`` of a one-device run resumed from
  the same checkpoint (the branch computes another function than one
  device, so a straight one-device run is not the yardstick); and
  resumed under (2, 2): within ``RESUME_RTOL`` of a straight (2, 2)
  run.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.optim import adamw

from test_torch_dist_train import (GNORM_RTOL, LOSS_RTOL, RESUME_RTOL, ROOT,
                                   _batch, _env, _flat, _numel_check,
                                   _one_device_step, _params_agree,
                                   _zero1_local_shapes)
from test_torch_ingest import one_torch_thread  # noqa: F401

ARCHS = ("deepseek-moe-16b", "arctic-480b")
MESHES = {"m21": (2, 1), "m41": (4, 1)}
EXPERTS = ("moe.wi", "moe.wo")
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
    from repro_torch.models import parallel as par
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
    bucketed, podded = [], []
    real = par.all_reduce_buckets

    def spy(tensors, group, *a, **kw):
        if group is plan.groups.batch:
            bucketed.extend(t.numel() for t in tensors)
        elif group is plan.groups.pod:
            podded.extend(t.numel() for t in tensors)
        return real(tensors, group, *a, **kw)

    par.all_reduce_buckets = spy
    par.COUNTS.clear()
    try:
        model, state, m = step(model, state, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
    finally:
        par.all_reduce_buckets = real
    key = f"{tag}/{arch}"
    res[f"{key}/counts"] = np.asarray([par.COUNTS[k] for k in (
        "all_reduce", "all_gather", "reduce_scatter", "broadcast")])
    res[f"{key}/bucketed"] = np.asarray(bucketed, np.int64)
    res[f"{key}/podded"] = np.asarray(podded, np.int64)
    res[f"{key}/loss"], res[f"{key}/gnorm"] = float(m["loss"]), \
        float(m["grad_norm"])
    for name, t in state.mu.items():
        res[f"{key}/mu_shape/{name}"] = np.asarray(t.shape, np.int64)
    locals_ = {n: p.detach().clone() for n, p in model.named_parameters()}
    params, _, _ = plan.full_state(model, state)
    for name, p in locals_.items():
        if name.endswith(("moe.wi", "moe.wo")):
            res[f"{key}/local/{name}"] = p.numpy()
            res[f"{key}/full/{name}"] = params[name].numpy()
    if rank == 0:
        for name, p in params.items():
            res[f"{key}/p/{name}"] = p.numpy()


def resume(rank, res, meshes, ckpt):
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    cfg = f32("deepseek-moe-16b")
    kw = dict(global_batch=B, seq_len=S, device="cpu",
              opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup=2, total_steps=4),
              log=lambda *a: None)
    train(cfg, steps=2, ckpt_every=2, mesh=meshes["m22"], ckpt_dir=ckpt,
          **kw)
    for tag in ("m41", "m22"):
        _, state, losses = train(cfg, steps=4, resume=True, ckpt_dir=ckpt,
                                 mesh=meshes[tag], **kw)
        res[f"resume/{tag}/losses"] = np.asarray(losses)
        res[f"resume/{tag}/step"] = state.step
    _, _, losses = train(cfg, steps=4, mesh=meshes["m22"], **kw)
    res["straight/m22/losses"] = np.asarray(losses)


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
        from torch.distributed.device_mesh import init_device_mesh
        meshes = {"m21": make_mesh_from_plan(MeshPlan(2, 1, 2), "cpu"),
                  "m41": tm.make_local_mesh(4, 1, "cpu"),
                  "m22": tm.make_local_mesh(2, 2, "cpu"),
                  "p221": init_device_mesh("cpu", (2, 2, 1),
                                           mesh_dim_names=tm.POD_AXES)}
        for arch in ("deepseek-moe-16b", "arctic-480b"):
            for tag in ("m21", "m41", "p221"):
                one_step(rank, res, z, meshes[tag], tag, arch)
        resume(rank, res, meshes, os.path.join(own, "ckpt"))
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


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each arch's transplanted init and batch."""
    d = tmp_path_factory.mktemp("dist_train_moe")
    inp = {}
    for i, arch in enumerate(ARCHS):
        cfg = _f32(arch)
        model = TM.init(cfg, torch.Generator().manual_seed(21 + i), "cpu")
        inp.update(_flat(convert.model_params_to_numpy(model),
                         f"{arch}/params"))
        inp.update({f"{arch}/batch/{k}": v
                    for k, v in _batch(cfg, 9 + i).items()})
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
    return own, out


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_one_device(world, inputs, arch, tag):
    _, inp = inputs
    _, ranks = world
    loss, gnorm, params = _one_device_step(inp, arch)
    key = f"{tag}/{arch}"
    for res in ranks[:prod(MESHES[tag])]:
        np.testing.assert_allclose(res[f"{key}/loss"], loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res[f"{key}/gnorm"], gnorm,
                                   rtol=GNORM_RTOL)
    _params_agree(ranks[0], params, f"{key}/p")


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_experts_and_moments_hold_their_data_slices(world, arch, tag):
    """The moments' local shapes per ``zero1_pspecs``; each expert leaf
    the rank's block of ``wi``'s last dim (``[gate | up]`` cut as it
    lies) or ``wo``'s rows, over ``data``, after the step."""
    _, ranks = world
    cfg = _f32(arch)
    data = MESHES[tag][0]
    sizes = {"data": data, "model": 1}
    key = f"{tag}/{arch}"
    n_experts = 0
    for rank, res in enumerate(ranks[:data]):
        want = _zero1_local_shapes(cfg, sizes, {"data": rank, "model": 0})
        for name, shape in want.items():
            assert tuple(res[f"{key}/mu_shape/{name}"]) == shape, name
        _numel_check(cfg, sizes, res, key)
        for name in [k[len(key) + 7:] for k in res
                     if k.startswith(f"{key}/local/")]:
            local, full = res[f"{key}/local/{name}"], \
                res[f"{key}/full/{name}"]
            dim = 2 if name.endswith("wi") else 1
            c = full.shape[dim] // data
            assert local.shape[dim] == c
            np.testing.assert_array_equal(
                local, np.take(full, range(rank * c, (rank + 1) * c),
                               axis=dim))
            assert tuple(res[f"{key}/mu_shape/{name}"]) == local.shape
            n_experts += 1
    assert n_experts == data * 2 * (cfg.n_layers - cfg.first_dense_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_gradient_is_reduced_once(world, arch):
    """The bucketed ``all_reduce`` over the batch axes sums the
    gradients of every leaf but the experts', and a reduce-scatter a
    MoE layer and expert leaf sums theirs (on both meshes)."""
    _, ranks = world
    cfg = _f32(arch)
    meta = dict(TM.Model(cfg, "meta").named_parameters())
    n_moe = cfg.n_layers - cfg.first_dense_layers
    experts = [n for n in meta if n.endswith(EXPERTS)]
    assert len(experts) == 2 * n_moe
    plain = sum(p.numel() for n, p in meta.items() if n not in experts)
    for tag, (data, _) in MESHES.items():
        for res in ranks[:data]:
            assert int(res[f"{tag}/{arch}/bucketed"].sum()) == plain, tag
            all_reduce, all_gather, reduce_scatter, broadcast = \
                res[f"{tag}/{arch}/counts"]
            assert reduce_scatter == 2 * n_moe, tag
            assert broadcast == 0, tag


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_and_data_axes_step_matches_one_device(world, inputs, arch):
    """(pod, data, model) = (2, 2, 1): the batch splits over both, the
    experts over ``data`` alone, so their gradients are reduce-scattered
    over ``data`` and then summed over ``pod`` (the rest bucketed over
    the batch axes)."""
    _, inp = inputs
    _, ranks = world
    loss, gnorm, params = _one_device_step(inp, arch)
    key = f"p221/{arch}"
    cfg = _f32(arch)
    meta = dict(TM.Model(cfg, "meta").named_parameters())
    experts = sum(p.numel() for n, p in meta.items() if n.endswith(EXPERTS))
    plain = sum(p.numel() for p in meta.values()) - experts
    for res in ranks:
        np.testing.assert_allclose(res[f"{key}/loss"], loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res[f"{key}/gnorm"], gnorm,
                                   rtol=GNORM_RTOL)
        assert int(res[f"{key}/bucketed"].sum()) == plain
        assert int(res[f"{key}/podded"].sum()) == experts // 2
    _params_agree(ranks[0], params, f"{key}/p")


def test_checkpoint_written_under_the_branch_resumes_under_data(world):
    """deepseek-moe written under (2, 2) at step 2, resumed under
    (4, 1): the losses of steps 2-3 within ``RESUME_RTOL`` of a
    one-device run resumed from that checkpoint."""
    own, ranks = world
    _, _, want = ttrain.train(
        _f32("deepseek-moe-16b"), steps=4, resume=True, global_batch=4,
        seq_len=16, device="cpu", ckpt_dir=str(own / "ckpt"),
        opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup=2, total_steps=4),
        log=lambda *a: None)
    assert len(want) == 2
    for res in ranks:
        assert int(res["resume/m41/step"]) == 4
        np.testing.assert_allclose(res["resume/m41/losses"], want,
                                   rtol=RESUME_RTOL)


def test_checkpoint_written_under_the_branch_resumes_under_it(world):
    """The same checkpoint resumed under (2, 2) (the experts' slices
    over ``model`` and ``data`` restored): steps 2-3 within
    ``RESUME_RTOL`` of a straight (2, 2) run's."""
    _, ranks = world
    for res in ranks:
        assert int(res["resume/m22/step"]) == 4
        np.testing.assert_allclose(res["resume/m22/losses"],
                                   res["straight/m22/losses"][2:],
                                   rtol=RESUME_RTOL)
