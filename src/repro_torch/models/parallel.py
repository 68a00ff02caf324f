"""Training across the ranks of a mesh: the collectives by hand.

The reference trains under any mesh through GSPMD: ``build_shardings``
places the parameters, ``maybe_shard``/``shard_residual`` constrain
layouts, and XLA inserts the collectives, so the mesh step computes the
one-device loss, gradients and update (and, for MoE under ``model``
above 1, its ``shard_map`` branch's).  Here each rank holds its slices
(``launch.train``'s ``RankPlan``) and the models call the collectives
themselves, Megatron-style, while a ``parallel_context(groups)`` is
active:

* ``copy_to_model``: identity forward, ``all_reduce`` over ``model``
  backward (a column-parallel layer's input, a replicated leaf that a
  rank uses only in part, as mamba2's ``a_log``);
* ``reduce_from_model``: ``all_reduce`` forward, identity backward (a
  row-parallel layer's output); ``reduce_from`` is the same over any
  group (the loss's local sums over the batch axes, MoE routing
  statistics); ``reduce_from_model`` then ``copy_to_model`` reduces both
  ways (mamba1's ``x_proj`` partial, mamba2's sum of squares);
* ``gather_from_model``: ``all_gather`` of the last dim forward, a
  reduce-scatter (the sum, then this rank's block) backward, for a
  value that rank-local work consumes (K/V cut inside a head, mamba2's
  ``B``/``C``); ``gather_from_data`` is the same over ``data`` along
  any dim (the MoE experts' FSDP slices, regathered in the layer);
* ``join_from_model``: ``all_gather`` of the last dim forward, this
  rank's block of the gradient backward, for a column-parallel output
  that joins the replicated stream (the vlm ``projector``, the encdec
  ``enc_proj``), whose gradient every rank holds whole;
* ``embed_lookup`` and ``cross_entropy_sum``: the vocab-parallel lookup
  (masked local rows, then ``reduce_from_model``) and cross entropy (an
  ``all_reduce`` MAX of the logit max, an ``all_reduce`` SUM of the
  exp-sums, whose backward is ``logsumexp``'s own on the rank's
  columns, and the true logit from the rank that owns it), in f32.

Each pair is an ``autograd.Function`` whose backward is the forward's
adjoint; on a group of one rank every collective still runs (and is an
identity).  Without an active context every function here is the
one-device code, op for op.  ``all_reduce_buckets`` sums the gradients
over the batch axes in place (all but the FSDP leaves, whose
``gather_from_data`` backward already reduced them over ``data``).
``COUNTS`` counts every collective called (``chip_smoke.py`` reads it),
and ``BYTES`` the bytes of their results by kind, as the reference's
``roofline.collective_bytes`` counts an HLO collective's output shape
(``launch.op_walk`` reads it; ``tally`` adds a collective made outside
these wrappers, as the search's ``all_gather``s).

``torch.distributed`` is imported where it is used, so importing this
module starts nothing.
"""
from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple

import torch

# every collective called, by kind
COUNTS: collections.Counter = collections.Counter()
# the bytes of every collective's result, by kind
BYTES: collections.Counter = collections.Counter()
# gradients below this many bytes share a flat buffer for their all_reduce
BUCKET_BYTES = 64 << 20


class Groups(NamedTuple):
    """A rank's process groups in a mesh, with its index and the group's
    size along each: ``model``; the batch axes (``pod``, ``data``);
    ``data`` alone (ZeRO-1, the experts' FSDP); every rank of the mesh;
    ``pod`` alone (None without a ``pod`` axis).  ``fsdp``/``fsdp_size``:
    the group that the FSDP leaves are sliced over, where it is not
    ``data`` (the dry run's multi-pod mesh widens it to the batch axes).
    ``kv_split``: a decode cache whose positions split over the batch
    axes (a global batch of 1, replicated over them)."""
    model: object
    model_size: int
    model_rank: int
    batch: object
    batch_size: int
    batch_rank: int
    data: object
    data_size: int
    data_rank: int
    mesh: object
    pod: object = None
    fsdp: object = None
    fsdp_size: int = 1
    kv_split: bool = False


# a process-wide setting, not a context variable: on the card the
# autograd engine runs the backward pass (and remat's recomputation of
# the forward inside it) on a thread of its own, which sees no context
# variable of the caller's
_ACTIVE: list = [None]


@contextlib.contextmanager
def parallel_context(groups: Groups | None):
    """``with parallel_context(groups):`` makes the models run their
    tensor-parallel collectives over ``groups`` (None: one device),
    in the forward and the backward pass alike."""
    before = _ACTIVE[0]
    _ACTIVE[0] = groups
    try:
        yield groups
    finally:
        _ACTIVE[0] = before


def active() -> Groups | None:
    """The groups of the innermost ``parallel_context``, or None."""
    return _ACTIVE[0]


def groups_of(mesh) -> Groups | None:
    """This rank's ``Groups`` in the ``DeviceMesh`` ``mesh``, or None on
    a rank the mesh leaves idle.  Every rank of the world calls it (the
    groups over several axes are made here, on every rank)."""
    from math import prod

    from repro_torch.launch import mesh as tm
    sizes = tm.axis_sizes(mesh)
    ba = tm.batch_axes(mesh)
    made = [tm.axis_group(mesh, axes)
            for axes in (("model",), ba, ("data",), tuple(sizes))]
    pod = tm.axis_group(mesh, ("pod",)) if "pod" in sizes else None
    if mesh.get_coordinate() is None:
        return None
    return Groups(made[0], sizes["model"], tm.group_index(mesh, ("model",)),
                  made[1], prod(sizes[a] for a in ba),
                  tm.group_index(mesh, ba), made[2], sizes["data"],
                  tm.group_index(mesh, ("data",)), made[3], pod)


def _dist():
    import torch.distributed as dist
    return dist


def tally(kind: str, result: torch.Tensor, copies: int = 1) -> None:
    """Add ``copies`` x ``result``'s bytes to ``BYTES[kind]``."""
    BYTES[kind] += copies * result.numel() * result.element_size()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce the contiguous ``t`` over ``group`` in place; returns it."""
    dist = _dist()
    COUNTS["all_reduce"] += 1
    tally("all_reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of ``group``'s rank ``src`` on every rank of it, in place."""
    dist = _dist()
    COUNTS["broadcast"] += 1
    tally("broadcast", t)
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def all_gather_dim(t: torch.Tensor, dim: int, group,
                   size: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order."""
    return torch.cat(gather_stack(t, group, size).unbind(0), dim=dim)


def gather_stack(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """(size, *t.shape): rank r's ``t`` at index r (no autograd)."""
    COUNTS["all_gather"] += 1
    out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    tally("all_gather", out)
    _dist().all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.view((size,) + tuple(t.shape))


def reduce_scatter_dim(t: torch.Tensor, dim: int, group,
                       size: int) -> torch.Tensor:
    """The sum of the ranks' ``t``, and of it this rank's block of
    ``dim`` (the adjoint of ``all_gather_dim`` along it)."""
    COUNTS["reduce_scatter"] += 1
    dim = dim % t.ndim
    c = t.shape[dim] // size
    blocks = t.unflatten(dim, (size, c)).movedim(dim, 0).contiguous()
    out = torch.empty(blocks.shape[1:], dtype=t.dtype, device=t.device)
    tally("reduce_scatter", out)
    _dist().reduce_scatter_tensor(out, blocks.flatten(0, 1), group=group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return all_gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.size), None,
                None, None)


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.size, ctx.rank = size, rank
        return all_gather_dim(x, -1, group, size)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None, None,
                None)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    g = active()
    return x if g is None else _Copy.apply(x, g.model)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    g = active()
    return x if g is None else _Reduce.apply(x, g.model)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (forward), identity backward."""
    return _Reduce.apply(x, group)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    g = active()
    return x if g is None else _Gather.apply(x, -1, g.model, g.model_size)


def gather_from_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' FSDP slices along ``dim``, concatenated over ``data``
    (a reduce-scatter into this rank's slice backward)."""
    g = active()
    if g is None:
        return x
    if g.fsdp is not None:
        return _Gather.apply(x, dim, g.fsdp, g.fsdp_size)
    return _Gather.apply(x, dim, g.data, g.data_size)


def join_from_model(x: torch.Tensor) -> torch.Tensor:
    """A column-parallel output joined into the replicated stream: the
    ranks' blocks of the last dim concatenated; backward, this rank's
    block of the (replicated) gradient."""
    g = active()
    return x if g is None else _Join.apply(x, g.model, g.model_size,
                                           g.model_rank)


def model_size() -> int:
    g = active()
    return 1 if g is None else g.model_size


def vocab_offset(local_rows: int) -> int:
    """The global index of this rank's first vocab row (0 off a mesh)."""
    g = active()
    return 0 if g is None else g.model_rank * local_rows


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the (vocab-parallel) table by token id: this rank's rows
    where it owns the token, zeros elsewhere, summed over ``model``."""
    g = active()
    if g is None:
        return table[tokens.long()]
    rows = table.shape[0]
    local = tokens.long() - vocab_offset(rows)
    mine = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)]
    out = torch.where(mine[..., None], out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))
    return reduce_from_model(out)


def cross_entropy_sum(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp(logits) - logits[target]) over every position, in
    f32.  ``logits``: this rank's vocab columns (all of them off a
    mesh); ``targets``: global token ids."""
    g = active()
    if g is None:
        lse = torch.logsumexp(logits, dim=-1)
        true = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return torch.sum(lse - true)
    cols = logits.shape[-1]
    lse = _LogSumExp.apply(logits, g.model)
    local = targets.long() - vocab_offset(cols)
    mine = (local >= 0) & (local < cols)
    true = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])
    true = torch.where(mine, true[..., 0], torch.zeros(
        (), dtype=logits.dtype, device=logits.device))
    true = reduce_from_model(true)
    return torch.sum(lse - true)


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` of the last dim over the vocab columns of every
    rank of ``group``: forward ``torch.logsumexp``'s own ops (the max,
    the sum of ``exp(x - max)``, its log plus the max), the max and the
    sum each ``all_reduce``d; backward its adjoint on the rank's columns,
    ``g * exp(x - lse)`` (no collective), as ``logsumexp``'s backward
    computes it, so a group of one repeats the one-device gradient."""

    @staticmethod
    def forward(ctx, logits, group):
        top = all_reduce(logits.amax(dim=-1), group, op="max")
        sums = all_reduce(torch.exp(logits - top[..., None]).sum(dim=-1),
                          group)
        lse = torch.log(sums) + top
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(logits - lse[..., None]), None


def all_reduce_buckets(tensors, group, cap: int = BUCKET_BYTES) -> None:
    """Sum each tensor over ``group``, in place: one ``all_reduce`` for
    each run of same-dtype tensors below ``cap`` bytes together (through
    a flat buffer), one for each larger tensor alone."""
    bucket: list = []

    def flush():
        if not bucket:
            return
        if len(bucket) == 1 and bucket[0].is_contiguous():
            all_reduce(bucket[0], group)
        else:
            flat = all_reduce(torch.cat([t.reshape(-1) for t in bucket]),
                              group)
            for t, part in zip(bucket, flat.split([t.numel()
                                                   for t in bucket])):
                t.copy_(part.view_as(t))
        bucket.clear()

    size = 0
    for t in tensors:
        n = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or size + n > cap):
            flush()
            size = 0
        bucket.append(t)
        size += n
    flush()
