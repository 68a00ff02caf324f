"""Training driver: data, the train step, checkpoints, straggler
monitoring and restart, on one device or across the ranks of a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        [--reduced] [--steps 20] [--global-batch 4] [--seq-len 64] \
        [--ckpt-dir D] [--ckpt-every N] [--resume] [--device cuda|cpu]

    python -m torch.distributed.run --nproc-per-node N \
        -m repro_torch.launch.train --arch gemma-2b ...

Port of ``repro/launch/train.py``: the same flags and printed lines
(``[train] step=... loss=... gnorm=... t=...`` every 10 steps and at the
last, ``[straggler] ...``), plus ``--device`` (the card by default;
``cpu`` runs the plain PyTorch path, over gloo across ranks).  A fresh
run draws the model from ``torch.Generator`` seed 0 (the reference's
leaf distributions, not its ``jax.random`` draws); ``--resume``
continues from the latest checkpoint under ``--ckpt-dir``, which may
have been written by either package, under any mesh.

The mesh: ``train(mesh=...)`` (a ``DeviceMesh``), else the active
``mesh_context``, else, when a world is up (``torchrun`` sets one up in
``main``), ``make_mesh_from_plan(choose_mesh_shape(world size))`` as
the reference does; else one device.  On a mesh the reference's GSPMD
run computes the one-device step (its ``maybe_shard`` and
``shard_residual`` only constrain layouts; MoE under ``model`` above 1
computes its ``shard_map`` branch), and so does this one, up to
reduction order (``RankPlan``), for every family: each rank holds its
slices of the parameters per ``build_shardings`` (a gated MLP's ``wi``
and the mamba blocks' ``in_proj``/``conv_w`` through ``convert``'s rank
layouts; the MoE experts' FSDP slices over ``data``) and of the AdamW
moments per ``zero1_pspecs``, takes its block of the global batch, and
the models run Megatron's collectives (``models.parallel``): data
parallelism over the batch axes, tensor parallelism over ``model``
(attention, the MLPs, the mamba blocks, the vlm/encdec projections),
and MoE routing over the global batch (``model`` = 1) or the
reference's expert/tensor-parallel branch with its backward (``model``
above 1).  A mesh that an arch does not cut evenly raises
``ValueError`` (``refuse``) instead of running replicated or padded.
Sequence parallelism is left out (it saves memory only).  Rank 0
prints; checkpoints hold the reference's full leaves (gathered, then
written by rank 0) and resume under another mesh.
"""
from __future__ import annotations

import argparse
import collections
import os

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.data.pipeline import Prefetcher, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.elastic import choose_mesh_shape, make_mesh_from_plan
from repro_torch.ft.straggler import StepMonitor
from repro_torch.launch.mesh import (NamedSharding, P, active_mesh,
                                     axis_sizes, init_world, local_batch,
                                     local_slice, tree_map)
from repro_torch.models import model as M
from repro_torch.models import parallel as par
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw

def build_shardings(cfg, mesh, pspecs=None):
    """(the parameters' shardings, the AdamW moments' ZeRO-1 shardings):
    trees of ``NamedSharding`` in the reference's stacked layout
    (``pspecs``: the parameters' spec tree, ``M.pspecs(cfg)`` if None)."""
    pspec = M.pspecs(cfg) if pspecs is None else pspecs
    param_sh = tree_map(lambda spec: NamedSharding(mesh, spec), pspec)
    dspec = adamw.zero1_pspecs(M.specs(cfg), pspec,
                               data_size=axis_sizes(mesh).get("data", 1))
    opt_sh = tree_map(lambda spec: NamedSharding(mesh, spec), dspec)
    return param_sh, opt_sh


def refuse(cfg, sizes: dict) -> None:
    """Raise ``ValueError`` where ``cfg`` does not cut evenly over a mesh
    of ``sizes``: under ``model`` = m, whole query heads sharing whole
    KV heads (or one KV head cut inside), and every dim that a spec
    splits over ``model`` (the MLPs' widths, ``d_inner``, mamba2's
    heads and state, the experts, the vlm/encdec projections' columns);
    the experts' widths over ``data`` (their FSDP slices).  Such a mesh
    never runs replicated or padded."""
    m, data = sizes.get("model", 1), sizes.get("data", 1)
    cuts = {}
    if m > 1:
        if cfg.family != "ssm" and (
                cfg.n_heads % m or (cfg.n_kv_heads * cfg.head_dim) % m
                or (cfg.n_kv_heads % m and (cfg.n_heads // cfg.n_kv_heads)
                    % (cfg.n_heads // m))):
            raise ValueError(
                f"{cfg.name} does not cut {m} ways over model: its "
                f"{cfg.n_heads} heads and {cfg.n_kv_heads} KV heads of "
                f"{cfg.head_dim} must give each rank whole query heads "
                f"sharing whole KV heads, or one KV head cut inside")
        if cfg.family in ("dense", "vlm", "hybrid", "encdec") or \
                cfg.dense_residual:
            cuts["d_ff"] = cfg.d_ff
        if cfg.family == "moe":
            cuts["n_experts"] = cfg.n_experts
            if cfg.n_shared_experts:
                cuts["the shared experts' d_ff"] = (cfg.moe_d_ff
                                                    * cfg.n_shared_experts)
            if cfg.first_dense_layers:
                cuts["first_dense_d_ff"] = cfg.first_dense_d_ff or cfg.d_ff
        if cfg.family in ("ssm", "hybrid"):
            cuts["d_inner"] = cfg.d_inner
        if cfg.family == "hybrid":
            cuts.update(ssm_heads=cfg.ssm_heads, ssm_state=cfg.ssm_state)
        if cfg.family in ("vlm", "encdec"):
            cuts["d_model"] = cfg.d_model
    uneven = {k: v for k, v in cuts.items() if v % m}
    if uneven:
        raise ValueError(f"{cfg.name} does not cut {m} ways over model: "
                         + ", ".join(f"{k} {v}" for k, v in uneven.items()))
    if cfg.family == "moe" and cfg.moe_d_ff % data:
        raise ValueError(f"{cfg.name}: the experts' moe_d_ff "
                         f"{cfg.moe_d_ff} does not cut {data} ways over data "
                         f"(their FSDP slices)")


def _layer(name: str):
    """(the stacked path, the layer index or None) of a port name."""
    parts = name.split(".")
    layer = [int(q) for q in parts if q.isdigit()]
    return (tuple(q for q in parts if not q.isdigit()),
            layer[0] if layer else None)


def _per_layer(cfg, tree) -> dict:
    """{port name: (one layer's spec, the mesh axis that the stacked
    leaf's layer axis splits over, or None)} from a stacked tree of
    shardings."""
    out = {}
    for name, _ in M.Model(cfg, "meta").named_parameters():
        path, layer = _layer(name)
        node = tree
        for q in path:
            node = node[q]
        spec, axis = tuple(node.spec), None
        if layer is not None:
            axis, spec = (spec[0] if spec else None), spec[1:]
        out[name] = (P(*spec), axis)
    return out


class RankPlan:
    """How this rank holds the training state of ``cfg`` on ``mesh``: the
    groups (``parallel.groups_of``; None on a rank the mesh leaves
    idle), and per parameter name (one layer's) the spec of its slice
    (``build_shardings``) and of its AdamW moments' (``zero1_pspecs``).
    Where ZeRO-1 splits a stacked leaf's layer axis over ``data`` (the
    largest replicated dim, as falcon-mamba's ``d_skip``), a layer's
    moments live whole on one data rank (``owners``) and the others
    hold an empty tensor for them.  Every rank of the world builds one
    (it makes process groups).  ``pspecs``: the parameters' spec tree
    (``M.pspecs(cfg)`` if None)."""

    def __init__(self, cfg, mesh, pspecs=None):
        self.cfg, self.mesh = cfg, mesh
        self.sizes = axis_sizes(mesh)
        refuse(cfg, self.sizes)
        self.groups = par.groups_of(mesh)
        if self.groups is None:               # an idle rank
            return
        param_sh, opt_sh = build_shardings(cfg, mesh, pspecs)
        params = _per_layer(cfg, param_sh)
        moments = _per_layer(cfg, opt_sh)
        if any(axis is not None for _, axis in params.values()) or any(
                axis not in (None, "data") for _, axis in moments.values()):
            raise NotImplementedError(
                f"{cfg.name}: a spec splits the layer axis over another "
                f"axis than ZeRO-1's data")
        self.param_specs = {n: spec for n, (spec, _) in params.items()}
        self.moment_specs = {n: spec for n, (spec, _) in moments.items()}
        meta = dict(M.Model(cfg, "meta").named_parameters())
        self.shapes = {name: tuple(p.shape) for name, p in meta.items()}
        depth = collections.Counter(_layer(n)[0] for n in meta)
        # layers a data rank holds of each layer-split leaf
        self.rows = {n: depth[_layer(n)[0]] // self.sizes["data"]
                     for n, (_, axis) in moments.items() if axis == "data"}
        self.owners = {n: _layer(n)[1] // k for n, k in self.rows.items()}
        self.moment_shapes = {
            n: tuple(local_slice(torch.empty(self.shapes[n], device="meta"),
                                 spec, mesh).shape)
            for n, spec in self.moment_specs.items()}

    def zero1(self) -> adamw.Zero1:
        coord = dict(zip(self.sizes, self.mesh.get_coordinate()))
        dims, counted = {}, {}
        for name, mspec in self.moment_specs.items():
            pspec = tuple(self.param_specs[name])
            pspec = pspec + (None,) * (len(mspec) - len(pspec))
            dims[name] = next((d for d, (a, b) in enumerate(zip(mspec, pspec))
                               if a == "data" and b is None), None)
            used = {a for e in mspec if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            if name in self.owners:
                used.add("data")
            counted[name] = all(coord[a] == 0 for a in self.sizes
                                if a not in used) and \
                self.owners.get(name, coord["data"]) == coord["data"]
        g = self.groups
        return adamw.Zero1(dims=dims, counted=counted, owners=self.owners,
                           index=g.data_rank, parts=g.data_size,
                           group=g.data, norm_group=g.mesh)

    def shard(self, model):
        """Keep this rank's slices of a full ``model`` (in place)."""
        return convert.shard_model(model, self.param_specs, self.mesh)

    def full_state(self, model, opt_state):
        """The full parameters and moments, {port name: tensor} each
        (collectives: every rank of the mesh calls it, every rank gets
        them)."""
        def full(name, t, specs):
            return convert.rank_full(name, t, specs[name], self.mesh,
                                     self.shapes[name], self.cfg)

        def moment(name, t):
            if name in self.owners:
                if self.owners[name] != self.groups.data_rank:
                    t = torch.empty(self.moment_shapes[name], dtype=t.dtype,
                                    device=t.device)
                t = par.broadcast(t, self.owners[name], self.groups.data)
            return full(name, t, self.moment_specs)
        return ({n: full(n, p.detach(), self.param_specs)
                 for n, p in model.named_parameters()},
                {n: moment(n, t) for n, t in opt_state.mu.items()},
                {n: moment(n, t) for n, t in opt_state.nu.items()})

    def moments_from_stacked(self, tree) -> dict:
        """{port name: this rank's moment slice} from the stacked tree of
        this rank's local blocks (``restore(shardings=...)``)."""
        rows = convert.unstack_tree(self.cfg, tree)
        out = {}
        for name in self.shapes:
            if name not in self.owners:
                out[name] = rows[name]
                continue
            if self.owners[name] != self.groups.data_rank:
                out[name] = torch.zeros(0)
                continue
            layer = _layer(name)[1]          # row layer % n of the block
            out[name] = rows[name.replace(f".{layer}.",
                                          f".{layer % self.rows[name]}.", 1)]
        return out

    def shardings(self):
        """``build_shardings``' trees with each leaf's rank layout
        (``convert.rank_layout``), for ``ft.checkpoint.restore(
        shardings=...)``."""
        m = self.sizes.get("model", 1)
        param_sh, opt_sh = build_shardings(self.cfg, self.mesh)

        def with_layout(sh_tree, path=()):
            if isinstance(sh_tree, dict):
                return {k: with_layout(v, path + (k,))
                        for k, v in sh_tree.items()}
            layout = convert.rank_layout(".".join(path), m, self.cfg)
            return NamedSharding(self.mesh, sh_tree.spec,
                                 layout and layout[0])
        return with_layout(param_sh), with_layout(opt_sh)


def _state_tree(model, opt_state, plan: RankPlan | None = None):
    """The training state in the reference's checkpoint tree (stacked
    tensors, which the checkpoint copies to the host; the step an int32
    scalar, as the reference's).  Across ranks every rank gathers the
    full leaves; the ranks that do not write get None."""
    if plan is None:
        params, mu, nu = (dict(model.named_parameters()), opt_state.mu,
                          opt_state.nu)
    else:
        params, mu, nu = plan.full_state(model, opt_state)
        import torch.distributed as dist
        if dist.get_rank(plan.groups.mesh) != 0:
            return None
    return {"params": convert.stack_tree(params),
            "opt": adamw.AdamWState(mu=convert.stack_tree(mu),
                                    nu=convert.stack_tree(nu),
                                    step=np.int32(opt_state.step))}


def _resume(cfg, ckpt_dir: str, device, plan: RankPlan | None = None):
    """The latest checkpoint (either package's, written under any mesh)
    as a model and an AdamW state on ``device`` (this rank's slices
    with ``plan``, placed through ``restore(shardings=...)``); returns
    (model, opt_state, step)."""
    # the tree's structure, from placeholders (no stacked copies)
    layout = convert.stack_tree({name: torch.empty(0) for name, _ in
                                 M.Model(cfg, "meta").named_parameters()})
    example = {"params": layout,
               "opt": adamw.AdamWState(mu=layout, nu=layout, step=0)}
    if plan is None:
        state, step = ckpt.restore(ckpt_dir, example)
        model = convert.load_model_params(M.Model(cfg, device),
                                          state["params"])
        return model, convert.adamw_state_from_numpy(cfg, state["opt"],
                                                     device), step
    param_sh, opt_sh = plan.shardings()
    state, step = ckpt.restore(ckpt_dir, example, shardings={
        "params": param_sh,
        "opt": adamw.AdamWState(mu=opt_sh, nu=opt_sh,
                                step=NamedSharding(plan.mesh, P()))})
    local = tree_map(lambda t: t.to_local(), state)
    model = convert.model_from_local(
        cfg, convert.unstack_tree(cfg, local["params"]), device)
    opt = local["opt"]
    return model, adamw.AdamWState(
        mu={k: convert._tensor(v, device) for k, v in
            plan.moments_from_stacked(opt.mu).items()},
        nu={k: convert._tensor(v, device) for k, v in
            plan.moments_from_stacked(opt.nu).items()},
        step=int(opt.step)), step


def _world_mesh(device):
    """The reference's default mesh when a world is up, else None."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return make_mesh_from_plan(choose_mesh_shape(dist.get_world_size()),
                               device)


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: str | None = None, ckpt_every: int = 0,
          resume: bool = False, opt_cfg: adamw.AdamWConfig | None = None,
          device="cuda", mesh=None, log=print):
    """Train ``cfg`` for ``steps`` steps (from the latest checkpoint
    under ``ckpt_dir`` with ``resume``) on ``device``, across the ranks
    of ``mesh`` (see the module's docstring for the default).  Returns
    (model, opt_state, losses of the steps this call ran): this rank's
    slices on a mesh, (None, None, []) on a rank the mesh leaves idle.
    ``mesh`` may also be plain axis sizes (``{"data": 2}``): the
    divisibility is checked, and only sizes of 1 train (on one
    device)."""
    device = resolve_device(device)
    if mesh is None:
        mesh = active_mesh()
    if mesh is None:
        mesh = _world_mesh(device)
    plan = None
    if mesh is not None:
        if hasattr(mesh, "mesh_dim_names"):
            plan = RankPlan(cfg, mesh)
            if plan.groups is None:
                return None, None, []
        else:
            refuse(cfg, axis_sizes(mesh))
            if any(n > 1 for n in axis_sizes(mesh).values()):
                raise ValueError(
                    f"training across ranks needs a DeviceMesh "
                    f"(launch.mesh.make_local_mesh); {axis_sizes(mesh)} "
                    f"only describes one")
    groups = zero1 = None
    if plan is not None:
        import torch.distributed as dist
        groups, zero1 = plan.groups, plan.zero1()
        if dist.get_rank() != 0:
            log = lambda *a: None             # noqa: E731 (rank 0 prints)
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=steps)
    extras = {}
    if cfg.family == "vlm":
        extras["patches"] = ((cfg.n_frontend_tokens, cfg.frontend_dim),
                             np.float32)
    if cfg.family == "encdec":
        extras["frames"] = ((seq_len, cfg.frontend_dim), np.float32)
    pipe = TokenPipeline(cfg.vocab_size, seq_len, global_batch,
                         extras=extras)

    start_step = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        model, opt_state, start_step = _resume(cfg, ckpt_dir, device, plan)
        log(f"[train] resumed from step {start_step}")
    else:
        model = M.init(cfg, torch.Generator(device=device).manual_seed(0),
                       device)
        if plan is not None:
            plan.shard(model)
        opt_state = adamw.init(dict(model.named_parameters()), zero1=zero1)

    step_fn = make_train_step(cfg, opt_cfg, groups=groups, zero1=zero1)
    checkpointer = (ckpt.AsyncCheckpointer(
        ckpt_dir, group=groups and groups.mesh) if ckpt_dir else None)
    monitor = StepMonitor()
    prefetch = Prefetcher(pipe.batch_at, start_step=start_step)
    losses = []
    try:
        for step in range(start_step, steps):
            batch = prefetch.next()
            if plan is not None:
                batch = local_batch(batch, plan.mesh)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in batch.items()}
            with monitor:
                model, opt_state, metrics = step_fn(model, opt_state, batch)
                loss = float(metrics["loss"])
            losses.append(loss)
            if step % 10 == 0 or step == steps - 1:
                log(f"[train] step={step} loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"t={monitor.median:.3f}s")
            for a in monitor.actions:
                log(f"[straggler] {a}")
            monitor.actions.clear()
            if (checkpointer and ckpt_every
                    and (step + 1) % ckpt_every == 0):
                checkpointer.save_async(_state_tree(model, opt_state, plan),
                                        step + 1)
    finally:
        prefetch.close()
        if checkpointer:
            checkpointer.wait()
    return model, opt_state, losses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--global-batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    run = lambda: train(                      # noqa: E731
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume, device=args.device)
    if "WORLD_SIZE" not in os.environ:
        return run()
    # under torchrun: one rank of its world, on the reference's mesh
    import torch.distributed as dist
    init_world(args.device)
    try:
        return run()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
