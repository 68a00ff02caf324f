"""Elastic scaling: the (data, model) mesh plan for a device count.

A copy of ``repro/ft/elastic.py``'s plan (``MeshPlan``,
``choose_mesh_shape``): on restart after losing (or gaining) devices the
launcher picks the largest usable (data, model) grid, with `model`
capped at ``max_model`` and kept as large as the divisor structure
allows, the remaining devices on `data`, and devices that do not factor
cleanly left idle.  Building a mesh from the plan and re-placing a
checkpoint on it (``make_mesh_from_plan``, ``reshard``) wait for a
multi-card mesh.
"""
from __future__ import annotations

import dataclasses


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
