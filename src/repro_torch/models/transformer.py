"""Layer stacks: dense / MoE / SSM / hybrid decoders and the enc-dec pair.

Port of ``repro/models/transformer.py``.  The reference scans over
layer-stacked params; here a stack is an ``nn.ModuleList`` of blocks
and the scan is a Python loop.  Heterogeneity stays data, as there:

  * local/global attention alternation -> a per-layer window list
    (gemma2 1:1, gemma3 5:1),
  * MoE leading dense layers -> a second, separate stack,
  * zamba2's *shared* attention block -> one unstacked block applied
    after every ``hybrid_attn_every`` mamba blocks.

KV / SSM caches keep the reference's stacked layout (a leading layer
axis); each layer reads and writes its slice IN PLACE, so a stack
returns the cache it was given.  Remat is the reference's: with
``remat`` every block body (the attn, ssm, hybrid mamba and encoder
stacks, and the decoder's cross-attention stack) is checkpointed, so
the backward pass keeps only each block's input.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.launch.mesh import P
from repro_torch.models import parallel as par
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (Attention, attention_block,
                                          best_attention, kv_heads)
from repro_torch.models.layers import (GatedMLP, Leaves, checkpointed,
                                       gated_mlp, rms_norm, rope)
from repro_torch.models.moe import MoE, moe_layer

BIG_WINDOW = 2 ** 30


# --------------------------------------------------------------------------
# per-layer blocks
# --------------------------------------------------------------------------

class DenseBlock(Leaves):
    def __init__(self, cfg, dtype, device, stack=None):
        super().__init__(dtype, device, stack)
        self.leaf("ln1", (cfg.d_model,), P(None))
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, dtype, device, stack)
        self.leaf("ln2", (cfg.d_model,), P(None))
        self.mlp = GatedMLP(cfg.d_model, cfg.d_ff, dtype, device, stack)


class MoEBlock(Leaves):
    def __init__(self, cfg, dtype, device, stack=None):
        super().__init__(dtype, device, stack)
        self.leaf("ln1", (cfg.d_model,), P(None))
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, dtype, device, stack)
        self.leaf("ln2", (cfg.d_model,), P(None))
        self.moe = MoE(cfg, dtype, device, stack)


class SSMBlock(Leaves):
    def __init__(self, cfg, dtype, device, stack=None):
        super().__init__(dtype, device, stack)
        self.leaf("ln", (cfg.d_model,), P(None))
        mixer = (ssm_mod.Mamba1 if cfg.ssm_variant == "mamba1"
                 else ssm_mod.Mamba2)
        self.mixer = mixer(cfg, dtype, device, stack)


class DecBlock(DenseBlock):
    def __init__(self, cfg, dtype, device, stack=None):
        super().__init__(cfg, dtype, device, stack)
        self.leaf("ln_x", (cfg.d_model,), P(None))
        self.xattn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, dtype, device, stack)


def stack(block, cfg, n, dtype, device) -> nn.ModuleList:
    """``n`` layers of ``block``, each drawing with the stacked fan-in."""
    return nn.ModuleList(block(cfg, dtype, device, stack=n)
                         for _ in range(n))


# --------------------------------------------------------------------------
# block applications
# --------------------------------------------------------------------------

def _apply_attn_block(p, x, positions, cfg, window, cache, cache_pos,
                      ffn_fn, remat=True):
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    a, cache = attention_block(p.attn, h, positions, cfg=cfg, window=window,
                               kv_cache=cache, cache_pos=cache_pos,
                               remat=remat)
    x = x + a
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    y, aux = ffn_fn(p, h)
    return x + y, cache, aux


def _dense_ffn(cfg):
    """The gated MLP; under a ``parallel_context`` ``wi`` column-parallel
    (the rank's gate and up columns, ``convert.rank_layout``)
    and ``wo`` row-parallel."""
    def fn(p, h):
        y = gated_mlp(p.mlp, par.copy_to_model(h), cfg.mlp)
        return par.reduce_from_model(y), 0.0
    return fn


def _moe_ffn(cfg):
    def fn(p, h):
        return moe_layer(p.moe, h, cfg, mlp_kind=cfg.mlp)
    return fn


def _layer(cache, i):
    """Layer ``i``'s views of a stacked cache dict (writes go through)."""
    return None if cache is None else {k: v[i] for k, v in cache.items()}


# --------------------------------------------------------------------------
# decoder stacks
# --------------------------------------------------------------------------

def attn_stack(cfg, blocks, x, positions, windows, *, kind, cache=None,
               cache_pos=None, remat=True):
    """A dense or MoE decoder.  Returns (x, cache, aux).

    windows: per-layer attention window (ints).
    cache: dict(k=(L,B,Smax,KV,Dh), v=...) or None.
    """
    ffn = _dense_ffn(cfg) if kind == "dense" else _moe_ffn(cfg)

    def body(x, p, w, c):
        x, _, a = _apply_attn_block(p, x, positions, cfg, w, c, cache_pos,
                                    ffn, remat)
        return x, a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (p, w) in enumerate(zip(blocks, windows)):
        x, a = checkpointed(body, remat, x, p, w, _layer(cache, i))
        aux = aux + a
    return x, cache, aux


def _ssm_layer(cfg, p, x, states, i, block, remat):
    st = _layer(states, i)

    def body(x):
        h = rms_norm(x, p.ln, cfg.norm_eps)
        y, s_out, c_out = block(p.mixer, h, cfg,
                                None if st is None else st["ssm"],
                                None if st is None else st["conv"], remat)
        return x + y, s_out, c_out

    x, s_out, c_out = checkpointed(body, remat, x)
    if st is not None:
        st["ssm"].copy_(s_out)
        st["conv"].copy_(c_out)
    return x


def ssm_stack(cfg, blocks, x, *, states=None, remat=True):
    """A mamba decoder.  states: dict(ssm=(L,B,...), conv=(L,B,W-1,Dc))
    or None, advanced in place.  Returns (x, states)."""
    block = (ssm_mod.mamba1_block if cfg.ssm_variant == "mamba1"
             else ssm_mod.mamba2_block)
    for i, p in enumerate(blocks):
        x = _ssm_layer(cfg, p, x, states, i, block, remat)
    return x, states


class Hybrid(nn.Module):
    """zamba2's layers: the mamba2 stack and the one shared block."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.mamba = stack(SSMBlock, cfg, cfg.n_layers, dtype, device)
        self.shared_attn = DenseBlock(cfg, dtype, device)


def hybrid_stack(cfg, params, x, positions, *, states=None, cache=None,
                 cache_pos=None, remat=True):
    """zamba2: groups of ``hybrid_attn_every`` mamba2 blocks, each group
    followed by the ONE shared attention block (same weights every
    group), leftover mamba blocks last.

    states: dict(ssm=, conv=) over all n_layers; cache: the shared
    block's per-group KV cache dict(k=(G,B,Smax,KV,Dh), v=).  Both are
    advanced in place.  Returns x.  As in the reference, each mamba
    block is checkpointed and the shared block is not (its flash
    attention steps are).
    """
    k = cfg.hybrid_attn_every
    n_groups = cfg.n_layers // k
    ffn = _dense_ffn(cfg)
    window = positions.shape[-1] if cache is None else BIG_WINDOW
    for g in range(n_groups):
        for i in range(g * k, (g + 1) * k):
            x = _ssm_layer(cfg, params.mamba[i], x, states, i,
                           ssm_mod.mamba2_block, remat)
        x, _, _ = _apply_attn_block(params.shared_attn, x, positions, cfg,
                                    window, _layer(cache, g), cache_pos, ffn,
                                    remat)
    for i in range(n_groups * k, cfg.n_layers):
        x = _ssm_layer(cfg, params.mamba[i], x, states, i,
                       ssm_mod.mamba2_block, remat)
    return x


def encoder_stack(cfg, blocks, x, positions, remat=True):
    """Bidirectional encoder (full window, no mask)."""
    ffn = _dense_ffn(cfg)

    def body(x, p):
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        x = x + _noncausal_self_attn(p.attn, h, positions, cfg, remat)
        h = rms_norm(x, p.ln2, cfg.norm_eps)
        y, _ = ffn(p, h)
        return x + y

    for p in blocks:
        x = checkpointed(body, remat, x, p)
    return x


def _noncausal_self_attn(p, x, positions, cfg, remat=True):
    """Under a ``parallel_context`` Megatron's, as ``attention_block``."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    x = par.copy_to_model(x)
    q = x @ p.wq
    h = q.shape[-1] // dh                  # the rank's heads
    q = rope(q.reshape(b, s, h, dh), positions, cfg.rope_theta)
    k, v = kv_heads(cfg, x @ p.wk, x @ p.wv)
    k = rope(k, positions, cfg.rope_theta)
    o = best_attention(q, k, v, positions, positions, window=BIG_WINDOW,
                       causal=False, attn_softcap=cfg.attn_softcap,
                       remat=remat)
    return par.reduce_from_model(o.reshape(b, s, h * dh) @ p.wo)


def decoder_xattn_stack(cfg, blocks, x, positions, enc_out, enc_positions,
                        *, cache=None, cache_pos=None, remat=True):
    """Enc-dec decoder: causal self-attn + cross-attn + MLP per layer.

    cache: dict(k=, v= (self), xk=, xv= (cross)) stacked.  With
    ``enc_out`` (forward / prefill) the cross K/V are computed fresh and,
    given a cache, stored as its new ``xk``/``xv`` (the encoder's length,
    as the reference's returned cache has them); at decode they are read
    back.  Returns (x, cache).  Under a ``parallel_context`` the
    cross-attention is Megatron's (``wq``/``wk``/``wv`` column-parallel,
    ``wo`` row-parallel), ``enc_out`` passing ``copy_to_model`` once.
    """
    ffn = _dense_ffn(cfg)
    dh = cfg.head_dim
    if enc_out is not None:
        enc_out = par.copy_to_model(enc_out)

    def body(x, p, c, enc_out):
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        a, _ = attention_block(
            p.attn, h, positions, cfg=cfg, window=BIG_WINDOW,
            kv_cache=None if c is None else {"k": c["k"], "v": c["v"]},
            cache_pos=cache_pos, remat=remat)
        x = x + a
        # cross attention: no rope, the encoder output as K/V
        h = rms_norm(x, p.ln_x, cfg.norm_eps)
        b, s, _ = h.shape
        q = par.copy_to_model(h) @ p.xattn.wq
        heads = q.shape[-1] // dh          # the rank's heads
        q = q.reshape(b, s, heads, dh)
        if enc_out is not None:
            ck, cv = kv_heads(cfg, enc_out @ p.xattn.wk,
                              enc_out @ p.xattn.wv)
        else:
            ck, cv = c["xk"], c["xv"]
        o = best_attention(q, ck, cv, positions, enc_positions,
                           window=BIG_WINDOW, causal=False,
                           attn_softcap=cfg.attn_softcap, remat=remat)
        x = x + par.reduce_from_model(o.reshape(b, s, heads * dh)
                                      @ p.xattn.wo)
        h = rms_norm(x, p.ln2, cfg.norm_eps)
        y, _ = ffn(p, h)
        return x + y, ck, cv

    cross = []
    for i, p in enumerate(blocks):
        x, ck, cv = checkpointed(body, remat, x, p, _layer(cache, i),
                                 enc_out)
        if cache is not None:
            cross.append((ck, cv))
    if cache is not None and enc_out is not None:
        cache = dict(cache, xk=torch.stack([c[0] for c in cross]),
                     xv=torch.stack([c[1] for c in cross]))
    return x, cache
