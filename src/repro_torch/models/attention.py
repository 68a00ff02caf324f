"""Attention: GQA + sliding-window + softcap, in dense and flash forms.

Port of ``repro/models/attention.py``.  The per-layer *window* is data
(an int per layer; see ``ArchConfig.layer_windows``), so local and
global layers share one block.  ``flash_attention`` is the reference's
blockwise online softmax written as a plain PyTorch loop over query and
KV blocks; ``dense_attention`` is the direct form (decode steps,
cross-attention, short sequences).  Numerics as in the reference: scores
in f32, softcap before the additive mask (``NEG_INF = -2**30``), GQA by
head-group reshape (no KV repetition).  ``scaled_dot_product_attention``
is not used: it has no softcap, and its masking differs.  The KV-cache
write (``write_at``) is in place and serves decoding only: the training
path passes no cache.

Under a ``parallel_context`` (training across ranks) ``attention_block``
is Megatron's: ``wq``/``wk``/``wv`` column-parallel (a block of
``wq``'s head-major columns is a block of whole heads), ``wo``
row-parallel, ``copy_to_model`` on the input and ``reduce_from_model``
on the output.  With ``n_kv % model == 0`` the rank's KV heads are the
ones its query groups use; otherwise its ``wk``/``wv`` columns cut
inside a head, so K and V are rebuilt whole (``gather_from_model``,
whose backward reduce-scatters their gradient) and the rank keeps the
one KV head its queries share (``kv_heads``).  Serving across ranks
runs the same block on the rank's block of the decode cache; a cache
whose positions split over the batch axes (a global batch of 1) takes
``split_cache_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import P
from repro_torch.models import parallel as par
from repro_torch.models.layers import Leaves, checkpointed, rope, softcap

NEG_INF = -2.0 ** 30


class Attention(Leaves):
    def __init__(self, d_model, n_heads, n_kv, head_dim, dtype, device,
                 stack=None):
        super().__init__(dtype, device, stack)
        cols, rows = P(None, "model"), P("model", None)
        self.leaf("wq", (d_model, n_heads * head_dim), cols, 1.0)
        self.leaf("wk", (d_model, n_kv * head_dim), cols, 1.0)
        self.leaf("wv", (d_model, n_kv * head_dim), cols, 1.0)
        self.leaf("wo", (n_heads * head_dim, d_model), rows, 1.0)


def _mask(q_pos, k_pos, window, causal):
    """(Sq, Sk) additive f32 mask: causal + sliding window."""
    dq = q_pos[:, None] - k_pos[None, :]
    ok = (dq >= 0) if causal else torch.ones_like(dq, dtype=torch.bool)
    ok = ok & (dq < window)          # window >= seq_len means global
    return torch.where(ok, 0.0, NEG_INF).float()


def dense_attention(q, k, v, q_pos, k_pos, *, window, causal=True,
                    attn_softcap=None):
    """q: (B, Sq, H, Dh); k/v: (B, Sk, KV, Dh)."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores / (dh ** 0.5)
    scores = softcap(scores, attn_softcap)
    scores = scores + _mask(q_pos, k_pos, window, causal)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h, dh)


def flash_attention(q, k, v, q_pos, k_pos, *, window, causal=True,
                    attn_softcap=None, block_q=512, block_k=512, remat=True):
    """Blockwise online-softmax attention: peak memory per step is
    (B, KV, G, block_q, block_k), independent of S.  Both S_q and S_k
    must divide their block sizes (callers pad).

    With ``remat`` each q-block step and each kv-block step is
    checkpointed, as the reference's are: the backward pass recomputes a
    q-block's score tiles instead of keeping one (block_q, S_k) panel per
    q-block, and keeps only the (m, l, acc) carries of each kv step."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    kv = k.shape[2]
    g = h // kv
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"sequence lengths {sq}, {sk} must divide the "
                         f"blocks {block_q}, {block_k}")
    # (B, S, ...) -> (B, KV, G, S, Dh) for q, (B, KV, S, Dh) for k/v
    qh = q.reshape(b, sq, kv, g, dh).permute(0, 2, 3, 1, 4)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)

    def kv_step(qblk, qp, m, l, acc, kblk, vblk, kp):
        s = torch.einsum("bkgqd,bksd->bkgqs", qblk, kblk)
        s = s.float() / (dh ** 0.5)
        s = softcap(s, attn_softcap)
        s = s + _mask(qp, kp, window, causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bksd->bkgqd", p.to(vblk.dtype), vblk).float()
        return m_new, l, acc

    def q_step(qblk, qp):
        m = torch.full((b, kv, g, block_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kv, g, block_q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, kv, g, block_q, dh), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, block_k):
            m, l, acc = checkpointed(
                kv_step, remat, qblk, qp, m, l, acc,
                kh[:, :, k0: k0 + block_k], vh[:, :, k0: k0 + block_k],
                k_pos[k0: k0 + block_k])
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)

    outs = [checkpointed(q_step, remat, qh[:, :, :, q0: q0 + block_q],
                         q_pos[q0: q0 + block_q])
            for q0 in range(0, sq, block_q)]
    out = torch.cat(outs, dim=3)                  # (B, KV, G, Sq, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def best_attention(q, k, v, q_pos, k_pos, *, window, causal=True,
                   attn_softcap=None, remat=True):
    """Dense below 1,024 positions (or off the 512 grid), flash above:
    the score matrix must never materialize at prefill/train scale."""
    sq, sk = q.shape[1], k.shape[1]
    if sq >= 1024 and sk >= 1024 and sq % 512 == 0 and sk % 512 == 0:
        return flash_attention(q, k, v, q_pos, k_pos, window=window,
                               causal=causal, attn_softcap=attn_softcap,
                               remat=remat)
    return dense_attention(q, k, v, q_pos, k_pos, window=window,
                           causal=causal, attn_softcap=attn_softcap)


def write_at(buf, new, pos: int, offset: int = 0, total: int | None = None):
    """``lax.dynamic_update_slice_in_dim(buf, new, pos, 1)`` in place:
    the start clamps so the write fits, as XLA clamps it.  ``buf`` may
    be the block of positions [offset, offset + len) of a buffer of
    ``total`` positions: only the rows of ``new`` that land in it are
    written."""
    s = new.shape[1]
    total = buf.shape[1] if total is None else total
    start = min(max(int(pos), 0), total - s)
    lo, hi = max(start, offset), min(start + s, offset + buf.shape[1])
    if lo < hi:
        buf[:, lo - offset: hi - offset] = new[:, lo - start: hi - start]


def split_cache_attention(q, k, v, cache, positions, cache_pos, groups, *,
                          window, attn_softcap=None):
    """Decode attention over a cache whose positions split over the batch
    axes (``groups.kv_split``: a global batch of 1, replicated over them;
    the rank holds block ``batch_rank`` of the positions): the rank writes
    the new K/V rows that land in its block, scores its block, and the
    softmax's max, its sum and the weighted values are reduced over the
    batch axes (flash decoding's combine)."""
    ck, cv = cache["k"], cache["v"]
    n = ck.shape[1]
    lo = groups.batch_rank * n
    write_at(ck, k, cache_pos, lo, n * groups.batch_size)
    write_at(cv, v, cache_pos, lo, n * groups.batch_size)
    k_pos = lo + torch.arange(n, device=q.device)
    b, sq, h, dh = q.shape
    kv = ck.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, ck).float() / (dh ** 0.5)
    scores = softcap(scores, attn_softcap)
    scores = scores + _mask(positions, k_pos, window, True)
    top = par.all_reduce(scores.amax(dim=-1), groups.batch, op="max")
    p = torch.exp(scores - top[..., None])
    total = par.all_reduce(p.sum(dim=-1), groups.batch)
    out = torch.einsum("bkgqs,bskd->bqkgd",
                       (p / total[..., None]).to(q.dtype), cv).float()
    out = par.all_reduce(out.contiguous(), groups.batch).to(q.dtype)
    return out.reshape(b, sq, h, dh)


def attention_block(params, x, positions, *, cfg, window, kv_cache=None,
                    cache_pos=None, remat=True):
    """Full projection + RoPE + attention (+ the KV-cache update).

    kv_cache: dict(k=(B, Smax, KV, Dh), v=...) or None; written IN PLACE
    at ``cache_pos`` for every batch row (the reference writes all rows
    at one offset too).  Returns (out, cache).
    """
    b, s, _ = x.shape
    dh = cfg.head_dim
    x = par.copy_to_model(x)
    q = x @ params.wq
    h = q.shape[-1] // dh
    q = q.reshape(b, s, h, dh)
    k, v = kv_heads(cfg, x @ params.wk, x @ params.wv)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    groups = par.active()
    if kv_cache is not None and groups is not None and groups.kv_split:
        out = split_cache_attention(q, k, v, kv_cache, positions, cache_pos,
                                    groups, window=window,
                                    attn_softcap=cfg.attn_softcap)
    elif kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        write_at(ck, k, cache_pos)
        write_at(cv, v, cache_pos)
        k_pos = torch.arange(ck.shape[1], device=x.device)
        # unwritten slots all have k_pos > max(q positions): the causal
        # term of the mask hides them
        out = dense_attention(q, ck, cv, positions, k_pos, window=window,
                              causal=True, attn_softcap=cfg.attn_softcap)
    elif s > 1:
        out = flash_attention(q, k, v, positions, positions, window=window,
                              causal=True, attn_softcap=cfg.attn_softcap,
                              remat=remat)
    else:
        out = dense_attention(q, k, v, positions, positions, window=window,
                              causal=True, attn_softcap=cfg.attn_softcap)
    out = out.reshape(b, s, h * dh)
    return par.reduce_from_model(out @ params.wo), kv_cache


def kv_heads(cfg, k, v):
    """(B, S, cols) K and V projections -> (B, S, KV, Dh): all of them off
    a mesh; under ``model = m`` the rank's KV heads, whole, for its
    ``n_heads / m`` query heads."""
    m, kv, dh = par.model_size(), cfg.n_kv_heads, cfg.head_dim
    b, s, _ = k.shape
    if kv % m == 0:
        return k.reshape(b, s, kv // m, dh), v.reshape(b, s, kv // m, dh)
    g = par.active()
    first = g.model_rank * (cfg.n_heads // m) // (cfg.n_heads // kv)
    k = par.gather_from_model(k).reshape(b, s, kv, dh)
    v = par.gather_from_model(v).reshape(b, s, kv, dh)
    return k[:, :, first: first + 1], v[:, :, first: first + 1]
