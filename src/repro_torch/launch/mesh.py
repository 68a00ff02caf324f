"""The device mesh over ``torch.distributed``: one process (rank) per device.

Port of ``repro/launch/mesh.py`` and of the mesh half of
``repro/compat.py``.  The reference's mesh is a grid of the devices one
JAX program sees; here it is a ``DeviceMesh`` over ranks, each rank a
process that owns one device: ``cuda:{LOCAL_RANK}`` over NCCL, or the
CPU over gloo when the caller asks for it (the tests).  A rank never
falls back from NCCL or from the card: a failure raises.

* ``init_world`` starts the process group, from the variables
  ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or from
  an explicit ``init_method`` (a ``file://`` store, a ``tcp://`` address).
* ``make_local_mesh`` / ``make_production_mesh`` build the
  ``("data", "model")`` mesh (``("pod", "data", "model")`` multi-pod)
  over the whole world; ``batch_axes`` names the axes a batch splits
  over.
* ``mesh_context`` / ``active_mesh`` are ``jax.set_mesh`` /
  ``get_abstract_mesh``: the mesh the models' MoE layer shards over.
* ``P`` is ``jax.sharding.PartitionSpec`` (a mesh axis, a tuple of axes
  or ``None`` per tensor dim), and ``placements`` maps it onto DTensor
  ``Shard``/``Replicate`` placements, one per mesh dim, refusing what
  JAX refuses (a dim that does not divide) instead of padding as DTensor
  would.  ``local_slice`` is a rank's block of a tensor under a spec —
  what ``distribute_tensor`` keeps on the rank, taken without any
  communication.
* ``axis_group`` is the process group of a rank's block along some
  axes, ``local_batch`` a rank's rows of the global batch (training
  across ranks: ``models.parallel.groups_of``, ``launch.train``).

``torch.distributed`` is imported where it is used, so importing this
module starts nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from math import prod

import torch

from repro_torch.device import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")

_ACTIVE = contextvars.ContextVar("repro_torch_active_mesh", default=None)


class P(tuple):
    """A partition spec: per tensor dim, ``None`` (replicated), a mesh
    axis name, or a tuple of them (that dim split over their product,
    the first axis major).  Normalized as ``PartitionSpec`` is: a
    one-axis tuple is its name, an empty tuple ``None``; trailing dims
    left out are replicated."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding:
    """``spec`` on ``mesh`` (``jax.sharding.NamedSharding``).  ``layout``
    (optional) maps the full value to the layout whose blocks the ranks
    hold (a gated MLP's ``wi``, the mamba blocks' ``in_proj`` in
    training across ranks: ``convert.rank_layout``); the reference's
    layout when None."""

    def __init__(self, mesh, spec, layout=None):
        self.mesh, self.spec, self.layout = mesh, spec, layout

    def distribute(self, tensor: torch.Tensor):
        """``tensor`` (the full value, the same on every rank) as a
        DTensor placed by the spec (``jax.device_put``), in ``layout``."""
        from torch.distributed.tensor import distribute_tensor
        if self.layout is not None:
            tensor = self.layout(tensor).contiguous()
        return distribute_tensor(tensor, self.mesh, placements(
            self.spec, self.mesh, tensor.shape))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and (named) tuples,
    ``rest`` trees of the same structure beside them (``P`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        vals = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree, *rest)


def init_world(device="cuda", *, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None
               ) -> torch.device:
    """Join the process group and return this rank's device.

    ``device``: ``"cuda"`` (NCCL, ``cuda:{LOCAL_RANK}``, set as the
    current device before the group starts) or ``"cpu"`` (gloo).  Without
    ``rank``/``world_size`` they come from ``RANK``/``WORLD_SIZE`` as
    ``torchrun`` sets them, and ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``)."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return dev


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ``("data", "model")`` mesh of ``data x model`` ranks: the whole
    world, rank ``i * model + j`` at ``(i, j)``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=AXES)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh: 16 x 16 = 256 ranks a pod, x 2
    pods multi-pod.  Any other world size raises."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != prod(shape):
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{prod(shape)} ranks; this one has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=POD_AXES if multi_pod else AXES)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, in mesh order; a mapping
    of axis sizes (a mesh described before any process starts) is
    returned as a dict."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes a global batch shards over."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


@contextlib.contextmanager
def mesh_context(mesh):
    """``with mesh_context(mesh):`` makes ``mesh`` the active mesh."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The mesh of the innermost ``mesh_context``, or None."""
    return _ACTIVE.get()


def _spec_axes(spec, ndim: int, sizes: dict):
    """Per tensor dim, the tuple of mesh axes it splits over (checked)."""
    entries = tuple(spec)
    if len(entries) > ndim:
        raise ValueError(f"the spec {spec} has more entries than the "
                         f"tensor's {ndim} dims")
    names, seen, out = list(sizes), set(), []
    for e in entries + (None,) * (ndim - len(entries)):
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        for a in axes:
            if a not in sizes:
                raise ValueError(f"the spec {spec} names {a!r}, which is "
                                 f"not an axis of the mesh {names}")
            if a in seen:
                raise ValueError(f"the spec {spec} uses {a!r} twice")
            seen.add(a)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"the spec {spec} splits a dim over {axes}, "
                             f"not in the mesh's axis order {names}")
        out.append(tuple(axes))
    return out


def placements(spec, mesh, shape) -> tuple:
    """``spec`` as DTensor placements on ``mesh``, one per mesh dim, for
    a tensor of ``shape``: ``Shard(d)`` on each mesh axis that splits
    dim ``d``, ``Replicate()`` elsewhere.  A dim split over two axes is
    split over the first, then within that over the second (data-major,
    as JAX lays it out).  Raises ``ValueError`` where JAX would: a dim
    that does not divide by its axes' product, an axis not in the mesh
    or used twice."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(sizes)
    names = list(sizes)
    for dim, axes in enumerate(_spec_axes(spec, len(shape), sizes)):
        n = prod(sizes[a] for a in axes)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(shape)} does not "
                             f"split evenly over {axes} ({n} ways), as the "
                             f"spec {spec} asks")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def local_slice(tensor: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full ``tensor`` under ``spec`` (a view):
    what ``distribute_tensor(tensor, mesh, placements(...)).to_local()``
    holds, without communication."""
    placements(spec, mesh, tensor.shape)          # the checks
    sizes = axis_sizes(mesh)
    out = tensor
    for dim, axes in enumerate(_spec_axes(spec, tensor.ndim, sizes)):
        if axes:
            n = tensor.shape[dim] // prod(sizes[a] for a in axes)
            out = out.narrow(dim, group_index(mesh, axes) * n, n)
    return out


def group_index(mesh, axes) -> int:
    """This rank's index along ``axes`` of ``mesh`` (the first axis
    major): its query block over the batch axes, for instance."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def axis_group(mesh, axes):
    """The process group over ``axes`` of ``mesh`` that holds this rank
    (its ranks ascending, which is data-major on a mesh laid out row by
    row, as ``make_local_mesh`` and ``make_mesh_from_plan`` lay it
    out).  One axis: the mesh's own group.  Several: one ``new_group``
    for each block, made on every rank of the world in the same order
    (so every rank calls this with the same axes) and cached on the
    mesh; None on a rank outside the mesh."""
    axes = tuple(axes)
    if len(axes) == 1:
        return (None if mesh.get_coordinate() is None
                else mesh.get_group(axes[0]))
    cache = mesh.__dict__.setdefault("_repro_axis_groups", {})
    if axes not in cache:
        import torch.distributed as dist
        names = list(mesh.mesh_dim_names)
        order = [names.index(a) for a in names if a not in axes] + \
            [names.index(a) for a in axes]
        n = prod(axis_sizes(mesh)[a] for a in axes)
        me, mine = dist.get_rank(), None
        for row in mesh.mesh.permute(order).reshape(-1, n).tolist():
            group = dist.new_group(row)
            if me in row:
                mine = group
        cache[axes] = mine
    return cache[axes]


def local_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch (a dict of arrays or tensors
    with the batch first): block ``i`` of the batch axes takes rows
    ``i*b/n:(i+1)*b/n``, data-major, as the reference's ``P(ba)``
    places them."""
    axes = batch_axes(mesh)
    n = prod(axis_sizes(mesh)[a] for a in axes)
    i = group_index(mesh, axes)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split "
                             f"evenly over the batch axes {axes} ({n} ways)")
        rows = v.shape[0] // n
        out[k] = v[i * rows: (i + 1) * rows]
    return out
