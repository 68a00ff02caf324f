"""Mixture-of-Experts layer: top-k routing and sort-based dispatch.

Port of ``repro/models/moe.py``'s single-device branch, which covers
both MoE archs:
  * arctic-480b      — 128 experts, top-2, dense residual MLP in parallel
  * deepseek-moe-16b — 64 routed experts top-6 + 2 shared experts,
                       leading dense layer(s)

Dispatch is sort-based (stable argsort by expert id + capacity cutoff);
tokens beyond an expert's capacity are dropped, and the combine weights
are the renormalised top-k gates.  Every sort is stable and top-k breaks
ties toward the lower expert id, as ``jnp.argsort``/``lax.top_k`` do, so
the routing integers equal the reference's.  The reference's
``shard_map`` expert/tensor-parallel branch waits for a multi-card mesh.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import GatedMLP, Leaves, activation, gated_mlp


class MoE(Leaves):
    def __init__(self, cfg, dtype, device, stack=None):
        super().__init__(dtype, device, stack)
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.leaf("router", (d, e), 1.0)
        self.leaf("wi", (e, d, 2 * f), 1.0)
        self.leaf("wo", (e, f, d), 1.0)
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


def _moe_local(params, xt, cfg, mlp_kind, e_lo, e_local, cap):
    """Dispatch/compute/combine for experts [e_lo, e_lo + e_local).

    Slot-compacted as in the reference: routed slots are keyed by
    (expert * cap + position); a stable argsort brings the kept slots to
    the front, so every gather and scatter is (e_local * cap, D)-sized.
    Returns (partial y, Switch load-balance aux).
    """
    e, k = cfg.n_experts, cfg.top_k
    t, d = xt.shape
    flat_e, pos, keep, tok_idx, gate_vals, probs = _route(
        xt, params.router, e, k, cap, expert_lo=e_lo,
        expert_hi=e_lo + e_local)
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
    buf[slot] = xt[src_tok]
    out = _expert_ffn(buf[:n_slots].reshape(e_local, cap, d), params.wi,
                      params.wo, mlp_kind).reshape(n_slots, d)
    # combine: scatter each slot's output back to its token, weighted
    w_slot = gate_vals.reshape(t * k)[order].to(xt.dtype)
    contrib = out[torch.where(valid, slot, torch.zeros_like(slot))] \
        * w_slot[:, None]
    contrib = torch.where(valid[:, None], contrib, torch.zeros_like(contrib))
    y = xt.new_zeros((t + 1, d))
    y.index_add_(0, torch.where(valid, src_tok, torch.full_like(src_tok, t)),
                 contrib)
    # Switch-style load-balance aux over the global routing statistics
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=xt.device)
    ce.index_add_(0, flat_e, (pos < cap).float())
    ce = ce / t
    aux = e * torch.sum(me * ce) / k
    return y[:t], aux


def moe_layer(params, x, cfg, *, mlp_kind="swiglu"):
    """x: (B, S, D) -> (y (B, S, D), load-balance aux loss)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    cap = _capacity(b * s, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    y, aux = _moe_local(params, xt, cfg, mlp_kind, 0, cfg.n_experts, cap)
    if params.shared is not None:
        y = y + gated_mlp(params.shared, xt, mlp_kind)
    if params.dense is not None:
        y = y + gated_mlp(params.dense, xt, mlp_kind)
    return y.reshape(b, s, d), aux
