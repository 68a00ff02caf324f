"""AdamW with f32 moments and a cosine schedule.

Port of ``repro/optim/adamw.py``.  Functional, as the reference is:
``init(params)`` makes the state and ``update(cfg, grads, state,
params)`` applies one step, with the reference's arithmetic: the clip by
the global gradient norm, the bias corrections in f32 (``b1 ** step``
with ``step`` as f32) and a per-leaf f32 ``core`` whose every operation
rounds where the reference's does.  ``params`` and ``grads`` map the
port's parameter names (``model.named_parameters()``: ``layers.3.attn.
wq``, ...) to tensors; the moments are keyed the same way, one tensor a
layer, so ``convert.adamw_state_to_numpy`` can stack them into the
reference's tree.  Parameters are updated IN PLACE (under ``no_grad``)
and returned.

The reference updates a layer-stacked leaf one layer at a time so that
its f32 staging copies are a layer's size; the port's weights are one
tensor a layer already, so its per-leaf ``core`` stages a layer at a
time with no loop.  ``zero1_pspecs`` gives the moments' partition specs
sharded over the data axis (ZeRO-1), as the reference's does.

Across ranks (``launch.train`` on a mesh) ``params`` and ``grads`` are
the rank's slices (its gradients already summed over the batch axes)
and ``Zero1`` says how its moments are held: each rank keeps and
updates only its ``zero1_pspecs`` slice of each leaf, with the same
arithmetic, then ``all_gather``s the parameter slices over ``data``;
the clip's norm is global (each rank's squares of its slices, each
element counted on one rank, summed over the mesh).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch

from repro_torch.launch.mesh import P, tree_map
from repro_torch.models import parallel as par


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    step: int


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0
    # memory-reduced moments: bfloat16 halves the optimizer's memory
    moment_dtype: str = "float32"


def _dtype(d) -> torch.dtype:
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup, then cosine decay to ``min_lr_frac``: the learning
    rate of step ``step``, computed in f32 as the reference computes it."""
    s = torch.tensor(step, dtype=torch.float32)
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return float(cfg.lr * warm * frac)


@dataclasses.dataclass(frozen=True)
class Zero1:
    """ZeRO-1 on a mesh, for one rank.  Per parameter name: ``dims``, the
    dim of the rank's parameter slice that its moments split over
    ``data`` (None: not split, the whole slice updated on every data
    rank); ``counted``, whether this rank's moment slice counts toward
    the gradient norm (each element on exactly one rank of the mesh).
    ``owners``: where ZeRO-1 splits a stacked leaf's layer axis, the
    data rank that holds and updates a layer's moments whole (the
    others hold an empty tensor and take the layer by broadcast).
    ``index``/``parts``: this rank's block along ``data`` and their
    number; ``group`` the ``data`` group, ``norm_group`` the mesh's."""
    dims: dict
    counted: dict
    owners: dict
    index: int
    parts: int
    group: object
    norm_group: object

    def slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 block of ``t`` (a view)."""
        d = self.dims[name]
        if d is None:
            return t
        n = t.shape[d] // self.parts
        return t.narrow(d, self.index * n, n)


def init(params: Mapping[str, torch.Tensor], moment_dtype=torch.float32,
         zero1: Zero1 | None = None) -> AdamWState:
    """Zero moments shaped as ``params`` (as their ZeRO-1 slices with
    ``zero1``), on their devices; step 0."""
    mdt = _dtype(moment_dtype)

    def shape(k, p):
        if zero1 is None:
            return p.shape
        if zero1.owners.get(k, zero1.index) != zero1.index:
            return (0,)
        return zero1.slice(k, p).shape
    return AdamWState(
        mu={k: torch.zeros(shape(k, p), dtype=mdt, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(shape(k, p), dtype=mdt, device=p.device)
            for k, p in params.items()},
        step=0)


def global_norm(grads: Mapping[str, torch.Tensor], zero1: Zero1):
    """The gradient norm over every rank's slices: the squares of this
    rank's counted ZeRO-1 slices, summed over the mesh."""
    sq = torch.zeros((), dtype=torch.float32,
                     device=next(iter(grads.values())).device)
    for name, g in grads.items():
        if zero1.counted[name]:
            sq = sq + torch.sum(torch.square(zero1.slice(name, g).float()))
    return torch.sqrt(par.all_reduce(sq, zero1.norm_group))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
           state: AdamWState, params: Mapping[str, torch.Tensor],
           zero1: Zero1 | None = None):
    """One AdamW step.  Returns (params, new state, {"grad_norm", "lr"}):
    ``params`` written in place, the moments replaced in ``state``'s
    dicts, ``grad_norm`` a 0-d f32 tensor on the gradients' device (no
    host sync) and ``lr`` a float.  With ``zero1`` the rank updates its
    ZeRO-1 slice of each leaf, then gathers the leaf over ``data``."""
    if zero1 is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads.values()))
    else:
        gnorm = global_norm(grads, zero1)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    f32 = torch.tensor(float(step), dtype=torch.float32)
    b1c = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** f32)
    b2c = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** f32)
    mdt = _dtype(cfg.moment_dtype)
    for name, whole in params.items():
        owner = None if zero1 is None else zero1.owners.get(name)
        if owner is not None and owner != zero1.index:
            par.broadcast(whole, owner, zero1.group)   # another's layer
            continue
        # the rank's block (a view: written in place), or the whole leaf
        p = whole if zero1 is None else zero1.slice(name, whole)
        # the reference's core, op for op (in-place where that rounds
        # the same: a * b == b * a, x += y == x + y), so the f32 staging
        # of a large leaf holds few copies at once
        g = (grads[name] if zero1 is None
             else zero1.slice(name, grads[name])).float() * scale
        m = state.mu[name].float() * cfg.b1
        m += g * (1 - cfg.b1)
        v = state.nu[name].float() * cfg.b2
        v += torch.square(g).mul_(1 - cfg.b2)
        del g
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        delta += p.float() * cfg.weight_decay
        p.copy_(p.float() - delta.mul_(lr))
        del delta
        state.mu[name] = m.to(mdt)
        state.nu[name] = v.to(mdt)
        if owner is not None:
            par.broadcast(whole, owner, zero1.group)
        elif zero1 is not None and zero1.dims[name] is not None:
            whole.copy_(par.all_gather_dim(p, zero1.dims[name], zero1.group,
                                           zero1.parts))
    return params, AdamWState(state.mu, state.nu, step), \
        {"grad_norm": gnorm, "lr": lr}


def zero1_pspecs(param_specs, param_pspecs, data_axis="data",
                 data_size: int = 1):
    """Optimizer-state pspecs: shard the largest replicated axis of each
    moment over the data axis (ZeRO-1).  ``param_specs``: a tree of
    leaves with a ``shape`` (``models.model.specs``); ``param_pspecs``
    the same tree of ``P``."""

    def one(sds, spec):
        if spec is None:
            spec = P()
        flat = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else tuple(e))}
        if data_axis in flat:      # already FSDP-sharded over data
            return spec
        axes = list(spec) + [None] * (len(sds.shape) - len(spec))
        best, best_dim = -1, 0
        for i, (ax, dim) in enumerate(zip(axes, sds.shape)):
            if ax is None and dim % max(data_size, 1) == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best >= 0 and data_size > 1:
            axes[best] = data_axis
        return P(*axes)

    return tree_map(one, param_specs, param_pspecs)
