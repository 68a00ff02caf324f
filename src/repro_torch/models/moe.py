"""Mixture-of-Experts layer: top-k routing, sort-based dispatch, EP sharding.

Port of ``repro/models/moe.py``, which covers both MoE archs:
  * arctic-480b      — 128 experts, top-2, dense residual MLP in parallel
  * deepseek-moe-16b — 64 routed experts top-6 + 2 shared experts,
                       leading dense layer(s)

Dispatch is sort-based (stable argsort by expert id + capacity cutoff);
tokens beyond an expert's capacity are dropped, and the combine weights
are the renormalised top-k gates.  Every sort is stable and top-k breaks
ties toward the lower expert id, as ``jnp.argsort``/``lax.top_k`` do, so
the routing integers equal the reference's.

Under ``launch.mesh.mesh_context(mesh)`` with a ``model`` axis above 1
that divides the expert count, ``moe_layer`` takes the reference's
``shard_map`` branch over ``torch.distributed`` for serving (forward
only): every rank holds the layer's full weights and the whole batch;
it takes its block of the batch over the batch axes, routes it
(capacity from the local token count), dispatches only its
``E / model`` experts, adds its tensor-parallel slices of the shared
and dense MLPs (``wi`` by columns, ``wo`` by rows, as the reference's
specs cut them), and one ``all_reduce`` over ``model`` sums the parts;
the blocks are then gathered over the batch axes, so every rank returns
the whole (B, S, D) output, and ``aux`` is the first block's, as the
reference's ``P()`` out-spec returns it.

Under a ``models.parallel.parallel_context`` (training across ranks)
every rank holds its slices and its block of the batch: the experts'
FSDP slices over ``data`` are regathered in the layer
(``gather_from_data``, a reduce-scatter backward); ``model`` = 1 runs
the single-device path over the global batch (global capacity, slot
positions and aux statistics through collectives), ``model`` above 1
the branch with its backward (``_moe_train_branch``).
"""
from __future__ import annotations

from math import prod
from types import SimpleNamespace

import torch

from repro_torch.launch.mesh import P, active_mesh, axis_sizes, group_index
from repro_torch.models import parallel as par
from repro_torch.models.layers import GatedMLP, Leaves, activation, gated_mlp


class MoE(Leaves):
    def __init__(self, cfg, dtype, device, stack=None):
        super().__init__(dtype, device, stack)
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        # experts over `model` (EP) and `data` (the reference's FSDP)
        self.leaf("router", (d, e), P(None, None), 1.0)
        self.leaf("wi", (e, d, 2 * f), P("model", None, "data"), 1.0)
        self.leaf("wo", (e, f, d), P("model", "data", None), 1.0)
        self.shared = (GatedMLP(d, f * cfg.n_shared_experts, dtype, device,
                                stack) if cfg.n_shared_experts else None)
        self.dense = (GatedMLP(d, cfg.d_ff, dtype, device, stack)
                      if cfg.dense_residual else None)


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    mult = 512 if c >= 512 else 8
    return max(8, -(-c // mult) * mult)


def _route(xt, router, e, k, cap, *, expert_lo=0, expert_hi=None):
    """Top-k routing + capacity positions for experts in [lo, hi).

    Returns (flat_e, pos, keep, tok_idx, gate_vals, probs) with ``keep``
    false for slots outside [lo, hi) or beyond capacity.
    """
    t = xt.shape[0]
    expert_hi = e if expert_hi is None else expert_hi
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]   # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_e = gate_idx.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=xt.device), side="left")
    pos_sorted = (torch.arange(t * k, device=xt.device)
                  - seg_start[sorted_e])
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    keep = (pos < cap) & (flat_e >= expert_lo) & (flat_e < expert_hi)
    tok_idx = torch.arange(t * k, device=xt.device) // k
    return flat_e, pos, keep, tok_idx, gate_vals, probs


def _expert_ffn(buf, wi, wo, mlp_kind):
    h = torch.einsum("ecd,edf->ecf", buf, wi.to(buf.dtype))
    gate, up = h.chunk(2, dim=-1)
    return torch.einsum("ecf,efd->ecd", activation(gate, mlp_kind) * up,
                        wo.to(buf.dtype))


def _moe_local(params, xt, cfg, mlp_kind, e_lo, e_local, cap, dp=None):
    """Dispatch/compute/combine for experts [e_lo, e_lo + e_local).

    Slot-compacted as in the reference: routed slots are keyed by
    (expert * cap + position); a stable argsort brings the kept slots to
    the front, so every gather and scatter is (e_local * cap, D)-sized.
    Returns (partial y, Switch load-balance aux).

    ``dp``: the ``parallel.Groups`` of a rank whose tokens are its block
    of a global batch routed as one (training under data parallelism:
    the reference's single-device path over the whole batch).  A slot's
    global position is its rank-local one plus the slots that lower
    batch ranks route to its expert (the batch splits data-major, so the
    reference's stable sort puts their tokens first; one ``all_gather``
    of the per-expert counts); ``keep`` tests it against the global
    ``cap``; the rank fills and computes only its own kept slots (the
    expert FFN is row-independent, so no all-to-all).  The aux takes the
    global means: the counts kept per expert are min(total, cap), and
    the probabilities' sum goes through ``reduce_from`` over the batch
    axes (each rank's backward its own tokens' share).
    """
    e, k = cfg.n_experts, cfg.top_k
    t, d = xt.shape
    flat_e, pos, keep, tok_idx, gate_vals, probs = _route(
        xt, params.router, e, k, cap, expert_lo=e_lo,
        expert_hi=e_lo + e_local)
    if dp is not None:
        every = par.gather_stack(torch.bincount(flat_e, minlength=e),
                                 dp.batch, dp.batch_size)      # (n, E)
        ahead = every[:dp.batch_rank].sum(dim=0)
        keep = ((pos + ahead[flat_e] < cap) & (flat_e >= e_lo)
                & (flat_e < e_lo + e_local))
    n_slots = e_local * cap
    big = 2 ** 30
    keys = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, big))
    order = torch.argsort(keys, stable=True)[:n_slots]
    k_sel = keys[order]
    valid = k_sel < big
    slot = torch.where(valid, k_sel - e_lo * cap,
                       torch.full_like(k_sel, n_slots))   # row n_slots: drop
    src_tok = tok_idx[order]
    buf = xt.new_zeros((n_slots + 1, d))
    # xt[src_tok] as a gather by the unique flat (token, choice) rows, so
    # its backward scatters unique rows and sums over k in a fixed order
    buf[slot] = xt[:, None].expand(t, k, d).reshape(t * k, d)[order]
    out = _expert_ffn(buf[:n_slots].reshape(e_local, cap, d), params.wi,
                      params.wo, mlp_kind).reshape(n_slots, d)
    # combine: each slot's output back to its token, weighted
    w_slot = gate_vals.reshape(t * k)[order].to(xt.dtype)
    contrib = out[torch.where(valid, slot, torch.zeros_like(slot))] \
        * w_slot[:, None]
    contrib = torch.where(valid[:, None], contrib, torch.zeros_like(contrib))
    y = _combine(contrib, src_tok, valid, t, k)
    # Switch-style load-balance aux over the global routing statistics
    if dp is None:
        # the mean as a sum over t (jnp.mean's division), as the data-
        # parallel path takes it: a world of one runs the same ops
        me = probs.sum(dim=0) / t
        ce = torch.zeros(e, dtype=torch.float32, device=xt.device)
        ce.index_add_(0, flat_e, (pos < cap).float())
        ce = ce / t
    else:
        t_all = t * dp.batch_size
        me = par.reduce_from(probs.sum(dim=0), dp.batch) / t_all
        ce = torch.clamp(every.sum(dim=0), max=cap).float() / t_all
    aux = e * torch.sum(me * ce) / k
    return y, aux


def _combine(contrib, src_tok, valid, t: int, k: int) -> torch.Tensor:
    """(t, D): each token's valid ``contrib`` rows added in their slot
    order, from zeros, in f32, rounded once to ``contrib``'s dtype: what
    the CPU's sequential ``index_add_`` computes (in bf16 too: it
    accumulates in f32), in that fixed order on every device (CUDA's
    ``index_add_`` adds in atomic order).  Entry j's rank among its
    token's entries places it at ``[token, rank]`` of a (t + 1, k, D)
    tensor (unique indices for the valid entries: no add, and the
    backward is a gather); a left fold over ``k`` sums it."""
    n, d = contrib.shape
    tok = torch.where(valid, src_tok, torch.full_like(src_tok, t))
    by_tok = torch.argsort(tok, stable=True)
    seg = torch.searchsorted(tok[by_tok], tok[by_tok], side="left")
    rank = torch.empty_like(tok)
    rank[by_tok] = torch.arange(n, device=tok.device) - seg
    c = contrib.new_zeros((t + 1, k, d))
    c[tok, rank.clamp(max=k - 1)] = contrib
    y = torch.zeros((t, d), dtype=torch.float32, device=contrib.device)
    for j in range(k):
        y = y + c[:t, j].float()
    return y.to(contrib.dtype)


def moe_layer(params, x, cfg, *, mlp_kind="swiglu"):
    """x: (B, S, D) -> (y (B, S, D), load-balance aux loss).

    Single-device dispatch, or the expert/tensor-parallel branch under an
    active mesh whose ``model`` axis (above 1) divides the experts.
    Under a ``parallel_context`` (training across ranks) ``x`` is the
    rank's block of the batch and the experts' ``wi``/``wo`` are its
    FSDP slices over ``data`` (regathered here): ``model`` above 1 takes
    the branch (``_moe_train_branch``), else the single-device path runs
    over the global batch (``_moe_local``'s ``dp``), its routing
    collectives running on groups of one too."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    groups = par.active()
    if groups is not None:
        return _moe_train(params, x, cfg, mlp_kind, groups)
    mesh = active_mesh()
    sizes = {} if mesh is None else axis_sizes(mesh)
    n_ep = sizes.get("model", 1)
    if n_ep > 1 and e % n_ep == 0:
        return _moe_parallel(params, x, cfg, mlp_kind, mesh, sizes)
    xt = x.reshape(b * s, d)
    cap = _capacity(b * s, e, k, cfg.capacity_factor)
    y, aux = _moe_local(params, xt, cfg, mlp_kind, 0, e, cap)
    if params.shared is not None:
        y = y + gated_mlp(params.shared, xt, mlp_kind)
    if params.dense is not None:
        y = y + gated_mlp(params.dense, xt, mlp_kind)
    return y.reshape(b, s, d), aux


def _moe_train(params, x, cfg, mlp_kind, groups):
    """The layer on one rank of a training mesh (``moe_layer``)."""
    b, s, d = x.shape
    e, k, m = cfg.n_experts, cfg.top_k, groups.model_size
    if e % m:
        raise ValueError(
            f"{cfg.name}: its {e} experts do not cut {m} ways over model "
            f"(the reference runs such a mesh through GSPMD's "
            f"single-device path, which is not ported)")
    experts = SimpleNamespace(router=params.router,
                              wi=par.gather_from_data(params.wi, -1),
                              wo=par.gather_from_data(params.wo, 1))
    if m == 1:
        xt = x.reshape(b * s, d)
        cap = _capacity(b * s * groups.batch_size, e, k,
                        cfg.capacity_factor)
        y, aux = _moe_local(experts, xt, cfg, mlp_kind, 0, e, cap,
                            dp=groups)
        for mlp in (params.shared, params.dense):
            if mlp is not None:
                y = y + gated_mlp(mlp, xt, mlp_kind)
        return y.reshape(b, s, d), aux
    return _moe_train_branch(experts, params, x, cfg, mlp_kind, groups)


def _moe_train_branch(experts, params, x, cfg, mlp_kind, groups):
    """The reference's ``shard_map`` EP+TP branch with its backward, on
    a rank of a training mesh with ``model`` above 1: ``x`` is its block
    of the batch (routed with the block's own capacity, as the
    reference's ``t_loc``), the rank runs its ``E / model`` experts and
    the contiguous column blocks of the shared/dense MLPs that it holds
    (the reference's gate/up cut, ROADMAP queue 3), and
    ``reduce_from_model`` behind ``copy_to_model`` (on ``x`` and the
    router, which the rank uses for its own experts' gates only) sums
    the parts.  The aux is the reference's ``P()`` out-spec's: block 0's
    value in every rank's loss (a ``broadcast`` over the batch axes), and
    in the backward pass the mean of the blocks' aux gradients, taken on
    model rank 0 alone (the copies' all-reduces would count it ``model``
    times)."""
    b, s, d = x.shape
    e, m = cfg.n_experts, groups.model_size
    e_loc = e // m
    me = groups.model_rank
    cap = _capacity(b * s, e, cfg.top_k, cfg.capacity_factor)
    xt = par.copy_to_model(x.reshape(b * s, d))
    local = SimpleNamespace(router=par.copy_to_model(experts.router),
                            wi=experts.wi, wo=experts.wo)
    y, aux = _moe_local(local, xt, cfg, mlp_kind, me * e_loc, e_loc, cap)
    for mlp in (params.shared, params.dense):
        if mlp is not None:
            y = y + gated_mlp(mlp, xt, mlp_kind)
    y = par.reduce_from_model(y)
    with torch.no_grad():
        first = par.broadcast(aux.detach().clone(), 0, groups.batch)
    share = (aux - aux.detach()) * (1.0 / groups.batch_size if me == 0
                                    else 0.0)
    return y.reshape(b, s, d), first + share


def _tp_slice(mlp, me: int, n: int):
    """Rank ``me``'s tensor-parallel slice of a gated MLP: ``wi``'s
    columns and ``wo``'s rows, in ``n`` contiguous blocks."""
    ci, rw = mlp.wi.shape[1] // n, mlp.wo.shape[0] // n
    return SimpleNamespace(wi=mlp.wi[:, me * ci:(me + 1) * ci],
                           wo=mlp.wo[me * rw:(me + 1) * rw])


def _gather(t, mesh, axes):
    """``t`` concatenated along dim 0 over the mesh axes ``axes`` (the
    first axis major), every rank receiving the whole."""
    import torch.distributed as dist
    for a in reversed(axes):
        n = axis_sizes(mesh)[a]
        if n == 1:
            continue
        parts = [torch.empty_like(t) for _ in range(n)]
        par.tally("all_gather", t, n)
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(a))
        t = torch.cat(parts)
    return t


def _moe_parallel(params, x, cfg, mlp_kind, mesh, sizes):
    """The reference's ``shard_map`` EP+TP branch on one rank, for
    serving (forward only): every rank holds the layer's full weights
    and the whole batch; it takes its block of the batch, and the blocks
    of the output are gathered over the batch axes."""
    import torch.distributed as dist
    b, s, d = x.shape
    e, n_ep = cfg.n_experts, sizes["model"]
    ba = tuple(a for a in ("pod", "data") if a in sizes)
    n_blocks = prod(sizes[a] for a in ba)
    if b % n_blocks:
        raise ValueError(f"a batch of {b} does not split over the "
                         f"{n_blocks} blocks of the batch axes {ba}")
    if torch.is_grad_enabled() and (x.requires_grad
                                    or params.wi.requires_grad):
        raise NotImplementedError(
            "the MoE expert-parallel branch under mesh_context is forward "
            "only (training across ranks runs it under parallel_context); "
            "run it under torch.no_grad()")
    bl = b // n_blocks
    blk = group_index(mesh, ba)
    cap = _capacity(bl * s, e, cfg.top_k, cfg.capacity_factor)
    me, e_loc = group_index(mesh, ("model",)), e // n_ep
    xt = x[blk * bl:(blk + 1) * bl].reshape(bl * s, d)
    local = SimpleNamespace(router=params.router,
                            wi=params.wi[me * e_loc:(me + 1) * e_loc],
                            wo=params.wo[me * e_loc:(me + 1) * e_loc])
    y, aux = _moe_local(local, xt, cfg, mlp_kind, me * e_loc, e_loc, cap)
    for mlp in (params.shared, params.dense):
        if mlp is not None:
            y = y + gated_mlp(_tp_slice(mlp, me, n_ep), xt, mlp_kind)
    y = y.contiguous()
    par.tally("all_reduce", y)
    dist.all_reduce(y, group=mesh.get_group("model"))
    y = _gather(y.reshape(bl, s, d), mesh, ba)
    aux = _gather(aux.reshape(1), mesh, ba)[0]
    return y, aux
