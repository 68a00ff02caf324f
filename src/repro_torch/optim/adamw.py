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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch

from repro_torch.launch.mesh import P, tree_map


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


def init(params: Mapping[str, torch.Tensor],
         moment_dtype=torch.float32) -> AdamWState:
    """Zero moments shaped as ``params``, on their devices; step 0."""
    mdt = _dtype(moment_dtype)
    return AdamWState(
        mu={k: torch.zeros(p.shape, dtype=mdt, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=mdt, device=p.device)
            for k, p in params.items()},
        step=0)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
           state: AdamWState, params: Mapping[str, torch.Tensor]):
    """One AdamW step.  Returns (params, new state, {"grad_norm", "lr"}):
    ``params`` written in place, the moments replaced in ``state``'s
    dicts, ``grad_norm`` a 0-d f32 tensor on the gradients' device (no
    host sync) and ``lr`` a float."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads.values()))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    f32 = torch.tensor(float(step), dtype=torch.float32)
    b1c = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** f32)
    b2c = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** f32)
    mdt = _dtype(cfg.moment_dtype)
    for name, p in params.items():
        # the reference's core, op for op (in-place where that rounds
        # the same: a * b == b * a, x += y == x + y), so the f32 staging
        # of a large leaf holds few copies at once
        g = grads[name].float() * scale
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
