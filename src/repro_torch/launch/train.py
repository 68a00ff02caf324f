"""Training driver: data, the train step, checkpoints, straggler
monitoring and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        [--reduced] [--steps 20] [--global-batch 4] [--seq-len 64] \
        [--ckpt-dir D] [--ckpt-every N] [--resume] [--device cuda|cpu]

Port of ``repro/launch/train.py`` on one card: the same flags and
printed lines (``[train] step=... loss=... gnorm=... t=...`` every 10
steps and at the last, ``[straggler] ...``), plus ``--device`` (the
card by default; ``cpu`` runs the plain PyTorch path).  A fresh run
draws the model from ``torch.Generator`` seed 0 (the reference's leaf
distributions, not its ``jax.random`` draws); ``--resume`` continues
from the latest checkpoint under ``--ckpt-dir``, which may have been
written by either package.  ``build_shardings(cfg, mesh)`` gives the
parameters' and the ZeRO-1 moments' shardings on a ``DeviceMesh`` (the
reference's stacked tree), which ``ft.checkpoint.restore(shardings=...)``
and ``ft.elastic.reshard`` place as DTensors.  Training itself runs on
one device: under a mesh with a ``data`` or ``model`` axis above 1,
``train`` raises ``NotImplementedError`` (ROADMAP: training across
ranks) rather than run replicated.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import get_config, get_reduced
from repro_torch.data.pipeline import Prefetcher, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.straggler import StepMonitor
from repro_torch.launch.mesh import (NamedSharding, active_mesh, axis_sizes,
                                     tree_map)
from repro_torch.models import model as M
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw


def build_shardings(cfg, mesh):
    """(the parameters' shardings, the AdamW moments' ZeRO-1 shardings):
    trees of ``NamedSharding`` in the reference's stacked layout."""
    pspec = M.pspecs(cfg)
    param_sh = tree_map(lambda spec: NamedSharding(mesh, spec), pspec)
    dspec = adamw.zero1_pspecs(M.specs(cfg), pspec,
                               data_size=axis_sizes(mesh).get("data", 1))
    opt_sh = tree_map(lambda spec: NamedSharding(mesh, spec), dspec)
    return param_sh, opt_sh


def _state_tree(model, opt_state) -> dict:
    """The training state in the reference's checkpoint tree (stacked
    tensors, which the checkpoint copies to the host; the step an int32
    scalar, as the reference's)."""
    return {"params": convert.stack_tree(dict(model.named_parameters())),
            "opt": adamw.AdamWState(mu=convert.stack_tree(opt_state.mu),
                                    nu=convert.stack_tree(opt_state.nu),
                                    step=np.int32(opt_state.step))}


def _resume(cfg, ckpt_dir: str, device):
    """The latest checkpoint (either package's) as a model and an AdamW
    state on ``device``; returns (model, opt_state, step)."""
    model = M.Model(cfg, device)
    # the tree's structure, from placeholders (no stacked copies)
    layout = convert.stack_tree({name: torch.empty(0) for name, _ in
                                 model.named_parameters()})
    state, step = ckpt.restore(ckpt_dir, {
        "params": layout,
        "opt": adamw.AdamWState(mu=layout, nu=layout, step=0)})
    convert.load_model_params(model, state["params"])
    return model, convert.adamw_state_from_numpy(cfg, state["opt"],
                                                 device), step


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: str | None = None, ckpt_every: int = 0,
          resume: bool = False, opt_cfg: adamw.AdamWConfig | None = None,
          device="cuda", mesh=None, log=print):
    """Train ``cfg`` for ``steps`` steps (from the latest checkpoint
    under ``ckpt_dir`` with ``resume``) on ``device``.  Returns (model,
    opt_state, losses of the steps this call ran).  ``mesh`` (or the
    active ``mesh_context``) may only be a one-device mesh."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is not None and any(axis_sizes(mesh).get(a, 1) > 1
                                for a in ("data", "model")):
        raise NotImplementedError(
            f"training across ranks (mesh {axis_sizes(mesh)}) is not "
            f"ported yet (ROADMAP: training across ranks); train on one "
            f"device")
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=steps)
    device = resolve_device(device)
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
        model, opt_state, start_step = _resume(cfg, ckpt_dir, device)
        log(f"[train] resumed from step {start_step}")
    else:
        model = M.init(cfg, torch.Generator(device=device).manual_seed(0),
                       device)
        opt_state = adamw.init(dict(model.named_parameters()))

    step_fn = make_train_step(cfg, opt_cfg)
    checkpointer = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    monitor = StepMonitor()
    prefetch = Prefetcher(pipe.batch_at, start_step=start_step)
    losses = []
    try:
        for step in range(start_step, steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in prefetch.next().items()}
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
                checkpointer.save_async(_state_tree(model, opt_state),
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
    return train(cfg, steps=args.steps, global_batch=args.global_batch,
                 seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, resume=args.resume,
                 device=args.device)


if __name__ == "__main__":
    main()
