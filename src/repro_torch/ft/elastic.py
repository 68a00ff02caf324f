"""Elastic scaling: re-mesh and reshard on a change of device count.

Port of ``repro/ft/elastic.py``.  On restart after losing (or gaining)
devices the launcher picks the largest usable (data, model) grid
(``choose_mesh_shape``), with `model` capped at ``max_model`` and kept
as large as the divisor structure allows, the remaining devices on
`data`, and devices that do not factor cleanly left idle; it then builds
the mesh over the first ``plan.used`` ranks (``make_mesh_from_plan``) and
re-places the checkpoint on it (``reshard``, or
``ft.checkpoint.restore(shardings=...)``) as DTensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import AXES, NamedSharding, tree_map


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    idle: int

    @property
    def used(self) -> int:
        return self.data * self.model


def choose_mesh_shape(n_devices: int, *, max_model: int = 16,
                      prefer_model: int = 16) -> MeshPlan:
    """Largest (data, model) grid with model | prefer_model, maximizing
    used devices then model size."""
    best = MeshPlan(data=1, model=1, idle=n_devices - 1)
    for model in range(min(max_model, n_devices), 0, -1):
        if prefer_model % model != 0:
            continue
        data = n_devices // model
        plan = MeshPlan(data=data, model=model,
                        idle=n_devices - data * model)
        if (plan.used, plan.model) > (best.used, best.model):
            best = plan
    return best


def make_mesh_from_plan(plan: MeshPlan, device="cuda"):
    """A ``("data", "model")`` ``DeviceMesh`` over ranks ``0 …
    plan.used - 1`` (rank ``i * model + j`` at ``(i, j)``); every rank of
    the world must call it, and the idle ones are in no coordinate."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(plan.used).reshape(plan.data, plan.model)
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=AXES)


def reshard(tree, pspecs, mesh):
    """Re-place a tree of full tensors (the same on every rank) onto
    ``mesh``: each leaf a DTensor placed by its spec in ``pspecs``."""
    return tree_map(lambda leaf, spec: NamedSharding(mesh, spec).distribute(
        torch.as_tensor(leaf)), tree, pspecs)
