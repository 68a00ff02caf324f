"""Model dispatcher: one init/forward/cache API over all families.

Port of ``repro/models/model.py``.  Everything is driven by
``ArchConfig.family``:

  dense | moe | vlm  -> attn_stack decoder (per-layer window list)
  ssm                -> mamba1 stack (attention-free)
  hybrid             -> zamba2 mamba2 stack + shared attention block
  encdec             -> encoder_stack + decoder_xattn_stack

``Model(cfg)`` holds the parameters under the reference's tree names
(``embed.table``, ``layers.3.attn.wq``, ...; a stacked reference leaf
is a ``ModuleList`` here), ``init`` fills them from a
``torch.Generator`` as the reference's ``init_from_decl`` draws, and
``convert.model_params_from_numpy`` fills them from the reference's own
``M.init`` tree.  The entry points take the model where the reference
takes ``params``: ``forward``, ``loss_fn``, ``prefill`` and
``decode_step``.  ``pspecs``/``specs`` are the reference's partition
specs and shapes (meta tensors) of the parameter tree, ``cache_pspecs``
its decode cache's specs; ``tree_of`` groups the port's per-layer
names into that stacked tree.  Caches are dicts of stacked tensors with the
reference's names and shapes (``init_cache``; on a mesh the rank's
block, which ``prefill``/``decode_step`` fill under a
``parallel.parallel_context``, as the training path runs); ``prefill`` and
``decode_step`` write them in place, without autograd, and return them,
so the reference's ``_merge_hybrid_cache`` (which reassembles scanned
outputs) has no counterpart.  ``forward``, ``forward_hidden`` and
``loss_fn`` take no cache and are differentiable in every parameter,
with the reference's remat points (``remat=True``).
"""
from __future__ import annotations

import dataclasses
from math import prod

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import P, axis_sizes, batch_axes
from repro_torch.models import parallel as par
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (DTYPES, Embed, Leaves, checkpointed,
                                       embed_lookup,
                                       init_leaves, pspecs_from_decl,
                                       rms_norm, scale_embedding, unembed)


class Model(Leaves):
    """Every parameter of one architecture, on one device (``"meta"``:
    shapes only, nothing allocated)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        dtype = DTYPES[cfg.dtype]
        device = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        super().__init__(dtype, device, None)
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype, device)
        self.leaf("final_norm", (cfg.d_model,), P(None))
        if cfg.family in ("dense", "vlm"):
            self.layers = tf.stack(tf.DenseBlock, cfg, cfg.n_layers, dtype,
                                   device)
        elif cfg.family == "moe":
            self.layers = tf.stack(tf.MoEBlock, cfg,
                                   cfg.n_layers - cfg.first_dense_layers,
                                   dtype, device)
            if cfg.first_dense_layers:
                self.dense_layers = tf.stack(
                    tf.DenseBlock, _with_ff(cfg, cfg.first_dense_d_ff
                                            or cfg.d_ff),
                    cfg.first_dense_layers, dtype, device)
        elif cfg.family == "ssm":
            self.layers = tf.stack(tf.SSMBlock, cfg, cfg.n_layers, dtype,
                                   device)
        elif cfg.family == "hybrid":
            self.layers = tf.Hybrid(cfg, dtype, device)
        elif cfg.family == "encdec":
            self.enc_layers = tf.stack(tf.DenseBlock, cfg, cfg.n_enc_layers,
                                       dtype, device)
            self.leaf("enc_norm", (cfg.d_model,), P(None))
            self.leaf("enc_proj", (cfg.frontend_dim, cfg.d_model),
                      P(None, "model"), 1.0)
            self.layers = tf.stack(tf.DecBlock, cfg, cfg.n_layers, dtype,
                                   device)
        else:
            raise ValueError(cfg.family)
        if cfg.family == "vlm":
            self.leaf("projector", (cfg.frontend_dim, cfg.d_model),
                      P(None, "model"), 1.0)

    @property
    def device(self) -> torch.device:
        return self._device


def _with_ff(cfg, ff):
    return dataclasses.replace(cfg, d_ff=ff)


def tree_of(named: dict, stack) -> dict:
    """{port name: leaf} (``named_parameters()``, moments or specs keyed
    the same way) -> the reference's tree: ``layers.3.attn.wq`` is row 3
    of the stacked leaf ``["layers"]["attn"]["wq"]``, which is
    ``stack([row 0, row 1, ...])``; every other name is a path of its
    own, its leaf unchanged."""
    rows: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        path = tuple(q for q in parts if not q.isdigit())
        layer = [int(q) for q in parts if q.isdigit()]
        if layer:
            rows.setdefault(path, {})[layer[0]] = t
        else:
            rows[path] = t
    tree: dict = {}
    for path, v in rows.items():
        node = tree
        for q in path[:-1]:
            node = node.setdefault(q, {})
        node[path[-1]] = (stack([v[i] for i in range(len(v))])
                          if isinstance(v, dict) else v)
    return tree


def specs(cfg: ArchConfig) -> dict:
    """The reference's parameter tree as meta tensors (shapes and dtypes,
    stacked leaves with their layer axis; nothing allocated)."""
    return tree_of({k: p.detach() for k, p in
                    Model(cfg, "meta").named_parameters()}, torch.stack)


def pspecs(cfg: ArchConfig) -> dict:
    """The reference's partition-spec tree (``M.pspecs``): a stacked
    leaf's spec with a leading ``None`` for its layer axis."""
    return tree_of(pspecs_from_decl(Model(cfg, "meta")),
                   lambda rows: P(None, *rows[0]))


def init(cfg: ArchConfig, generator: torch.Generator | None = None,
         device="cuda") -> Model:
    """A ``Model`` drawn from ``generator`` (seed 0 on ``device`` when
    none is given): the reference's leaf distributions, not its draws."""
    model = Model(cfg, device)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    init_leaves(model, generator)
    return model


# --------------------------------------------------------------------------
# caches (decode state)
# --------------------------------------------------------------------------

def cache_decl(cfg: ArchConfig, batch: int, max_len: int,
               batch_axes=("data",), model_size: int = 1) -> dict:
    """The decode cache's leaves as {name: (shape, dtype or None, pspec)},
    the reference's ``cache_decl`` tree (None: the config's dtype; SSM
    states are f32).  ``model_size`` drives divisibility-aware KV
    sharding: kv-heads split over ``model`` when they divide, else
    head_dim does; a batch of 1 splits the sequence over the batch axes
    instead (distributed-KV decode)."""
    ba = tuple(batch_axes) if batch > 1 else None
    seq_ax = None if batch > 1 else tuple(batch_axes)
    m = max(model_size, 1)
    kv_ax, hd_ax = (("model", None) if cfg.n_kv_heads % m == 0 else
                    (None, "model") if cfg.head_dim % m == 0 else
                    (None, None))
    kvshape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv = P(None, ba, seq_ax, kv_ax, hd_ax)
    if cfg.family in ("dense", "vlm"):
        return {"k": (kvshape, None, kv), "v": (kvshape, None, kv)}
    if cfg.family == "moe":
        n_moe = cfg.n_layers - cfg.first_dense_layers
        mk = (n_moe,) + kvshape[1:]
        dk = (cfg.first_dense_layers,) + kvshape[1:]
        out = {"k": (mk, None, kv), "v": (mk, None, kv)}
        if cfg.first_dense_layers:
            out = {"moe": out,
                   "dense": {"k": (dk, None, kv), "v": (dk, None, kv)}}
        return out
    if cfg.family == "ssm":
        di = cfg.d_inner
        return {"ssm": ((cfg.n_layers, batch, di, cfg.ssm_state),
                        torch.float32, P(None, ba, "model", None)),
                "conv": ((cfg.n_layers, batch, cfg.conv_width - 1, di),
                         None, P(None, ba, None, "model"))}
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.hybrid_attn_every
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        gk = (g, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"ssm": ((cfg.n_layers, batch, nh, di // nh, n),
                        torch.float32, P(None, ba, "model", None, None)),
                "conv": ((cfg.n_layers, batch, cfg.conv_width - 1,
                          di + 2 * n), None, P(None, ba, None, "model")),
                "attn_k": (gk, None, kv), "attn_v": (gk, None, kv)}
    if cfg.family == "encdec":
        xk = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (kvshape, None, kv), "v": (kvshape, None, kv),
                "xk": (xk, None, kv), "xv": (xk, None, kv)}
    raise ValueError(cfg.family)


def cache_pspecs(cfg: ArchConfig, batch: int, max_len: int,
                 batch_axes=("data",), model_size: int = 1) -> dict:
    """The decode cache's partition-spec tree (the reference's
    ``cache_pspecs``)."""
    def specs_of(d):
        if isinstance(d, dict):
            return {k: specs_of(v) for k, v in d.items()}
        return d[2]
    return specs_of(cache_decl(cfg, batch, max_len, batch_axes, model_size))


_KV_LEAVES = ("k", "v", "xk", "xv", "attn_k", "attn_v")


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                 mesh=None) -> dict:
    """The decode cache's leaves as {name: (shape, dtype)}: whole off a
    mesh; on ``mesh`` (a ``DeviceMesh`` or plain axis sizes) this rank's
    block under ``cache_pspecs(cfg, batch, max_len, batch_axes(mesh),
    model)``, the reference's ``cache_specs`` cut per rank.  Where the
    KV heads do not cut over ``model`` (``n_kv_heads % model``), a K/V
    leaf holds the one whole KV head that the rank's query heads share
    (``attention.kv_heads``), not the reference's cut of ``head_dim``."""
    sizes = {} if mesh is None else axis_sizes(mesh)
    m = sizes.get("model", 1)
    decl = cache_decl(cfg, batch, max_len,
                      batch_axes(sizes) if sizes else ("data",), m)

    def cut(name, d):
        if isinstance(d, dict):
            return {k: cut(k, v) for k, v in d.items()}
        shape, dtype, spec = d
        shape = list(shape)
        for dim, e in enumerate(spec):
            n = prod(sizes.get(a, 1) for a in
                     (() if e is None else (e,) if isinstance(e, str) else e))
            if shape[dim] % n:
                raise ValueError(f"the cache leaf {name} {tuple(d[0])} does "
                                 f"not cut {n} ways along dim {dim} ({spec})")
            shape[dim] //= n
        if name in _KV_LEAVES and cfg.n_kv_heads % m:
            shape[3:] = [1, cfg.head_dim]
        return tuple(shape), dtype or DTYPES[cfg.dtype]
    return cut("", decl)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device="cuda", mesh=None) -> dict:
    """Zeros in the reference's cache layout, on ``device``: the whole
    cache, or on ``mesh`` this rank's block of it (``cache_shapes``)."""
    device = resolve_device(device)

    def make(d):
        if isinstance(d, dict):
            return {k: make(v) for k, v in d.items()}
        shape, dtype = d
        return torch.zeros(shape, dtype=dtype, device=device)
    return make(cache_shapes(cfg, batch, max_len, mesh))


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def _embed_inputs(cfg, params, batch):
    """tokens (+ stub frontend embeddings) -> (B, S, D) activations."""
    x = scale_embedding(embed_lookup(params.embed, batch["tokens"]),
                        cfg.d_model)
    if cfg.family == "vlm":   # column-parallel over d_model on a mesh
        patches = par.join_from_model(batch["patches"].to(x.dtype)
                                      @ params.projector)
        x = torch.cat([patches, x], dim=1)
    return x


def _encode(cfg, params, batch, dtype, remat=True):
    enc_x = par.join_from_model(batch["frames"].to(dtype) @ params.enc_proj)
    enc_pos = torch.arange(enc_x.shape[1], device=enc_x.device)
    enc_out = tf.encoder_stack(cfg, params.enc_layers, enc_x, enc_pos,
                               remat)
    return rms_norm(enc_out, params.enc_norm, cfg.norm_eps), enc_pos


def _attn_families(cfg, params, x, positions, windows, cache, cache_pos,
                   remat=True):
    """dense / vlm / moe: the (leading dense and) main attention stacks."""
    if cfg.family == "moe" and cfg.first_dense_layers:
        nd = cfg.first_dense_layers
        dcfg = _with_ff(cfg, cfg.first_dense_d_ff or cfg.d_ff)
        x, _, _ = tf.attn_stack(dcfg, params.dense_layers, x, positions,
                                windows[:nd], kind="dense",
                                cache=None if cache is None
                                else cache["dense"], cache_pos=cache_pos,
                                remat=remat)
        x, _, aux = tf.attn_stack(cfg, params.layers, x, positions,
                                  windows[nd:], kind="moe",
                                  cache=None if cache is None
                                  else cache["moe"], cache_pos=cache_pos,
                                  remat=remat)
        return x, cache, aux
    kind = "moe" if cfg.family == "moe" else "dense"
    return tf.attn_stack(cfg, params.layers, x, positions, windows,
                         kind=kind, cache=cache, cache_pos=cache_pos,
                         remat=remat)


def forward(cfg: ArchConfig, params, batch, *, remat=True):
    """Full-sequence forward -> (logits (B, S, V_padded), aux)."""
    x, aux = forward_hidden(cfg, params, batch, remat=remat)
    logits = unembed(params.embed, x, cap=cfg.logit_softcap,
                     vocab=cfg.vocab_size)
    return logits, aux


def forward_hidden(cfg: ArchConfig, params, batch, *, remat=True):
    """Full-sequence forward -> (final-norm hidden states (B, S, D), aux).

    batch: {"tokens": (B, S)} + family extras
    ("patches": (B, P, frontend_dim) for vlm;
     "frames": (B, S_enc, frontend_dim) for encdec).
    remat: checkpoint at the reference's remat points (every block body,
    flash attention's q- and kv-block steps, the SSM scan's chunk step);
    with False nothing is recomputed in the backward pass.
    """
    x = _embed_inputs(cfg, params, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm", "moe"):
        x, _, aux = _attn_families(cfg, params, x, positions,
                                   cfg.layer_windows(s), None, None, remat)
    elif cfg.family == "ssm":
        x, _ = tf.ssm_stack(cfg, params.layers, x, remat=remat)
    elif cfg.family == "hybrid":
        x = tf.hybrid_stack(cfg, params.layers, x, positions, remat=remat)
    elif cfg.family == "encdec":
        enc_out, enc_pos = _encode(cfg, params, batch, x.dtype, remat)
        x, _ = tf.decoder_xattn_stack(cfg, params.layers, x, positions,
                                      enc_out, enc_pos, remat=remat)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, aux


def _chunked_ce(cfg, params, h, tgt, remat=True):
    """Mean next-token cross entropy, the batch in chunks (as the
    reference chunks it, so no (T, V) f32 logits for the whole batch);
    with ``remat`` each chunk is checkpointed, so its logits are
    recomputed in the backward pass instead of kept.  Under a
    ``parallel_context`` the cross entropy is vocab-parallel
    (``parallel.cross_entropy_sum``) and the rank's sum is reduced over
    the batch axes: the global mean, whose backward gives each rank the
    gradient of its own rows' share (the train step sums them)."""
    b, s, d = h.shape
    nb = 1
    for cand in (16, 8, 4, 2):
        if b % cand == 0 and b // cand >= cand:
            nb = cand
            break
    # the reference's chunks stride across the batch: chunk j holds rows
    # j, j + nb, j + 2 nb, ...
    hb = h.reshape(b // nb, nb, s, d).transpose(0, 1)
    tb = tgt.reshape(b // nb, nb, s).transpose(0, 1)

    def chunk(hc, tc):
        lg = unembed(params.embed, hc, cap=cfg.logit_softcap,
                     vocab=cfg.vocab_size).float()
        return par.cross_entropy_sum(lg, tc)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for hc, tc in zip(hb, tb):
        total = total + checkpointed(chunk, remat, hc, tc)
    groups = par.active()
    if groups is None:
        return total / (b * s)
    # the rank's rows are its block of the global batch: the mean is
    # over every rank's positions
    return par.reduce_from(total, groups.batch) / (b * groups.batch_size * s)


def loss_fn(cfg: ArchConfig, params, batch, *, aux_weight=0.01, remat=True):
    """Next-token cross entropy (f32 logsumexp, chunked) + MoE aux loss,
    differentiable in every parameter (``remat`` as in
    ``forward_hidden``, and for each chunk of the cross entropy).  Under
    a ``parallel_context`` (training across ranks) ``params`` are the
    rank's slices, ``batch`` its rows, and the loss is the global mean
    (``_chunked_ce``)."""
    hidden, aux = forward_hidden(cfg, params, batch, remat=remat)
    tokens = batch["tokens"]
    if cfg.family == "vlm":   # text tail only
        hidden = hidden[:, -tokens.shape[1]:]
    loss = _chunked_ce(cfg, params, hidden[:, :-1], tokens[:, 1:], remat)
    return loss + aux_weight * aux


@torch.no_grad()
def prefill(cfg: ArchConfig, params, batch, cache):
    """Populate the decode cache from a full prompt (written at offset 0,
    in place, without autograd); returns (last-token logits (B, 1, V),
    cache)."""
    x = _embed_inputs(cfg, params, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if cfg.family in ("dense", "vlm", "moe"):
        x, cache, _ = _attn_families(cfg, params, x, positions,
                                     cfg.layer_windows(s), cache, 0)
    elif cfg.family == "ssm":
        x, cache = tf.ssm_stack(cfg, params.layers, x, states=cache)
    elif cfg.family == "hybrid":
        x = _hybrid(cfg, params, x, positions, cache, 0)
    elif cfg.family == "encdec":
        enc_out, enc_pos = _encode(cfg, params, batch, x.dtype)
        x, cache = tf.decoder_xattn_stack(cfg, params.layers, x, positions,
                                          enc_out, enc_pos, cache=cache,
                                          cache_pos=0)
    x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = unembed(params.embed, x, cap=cfg.logit_softcap,
                     vocab=cfg.vocab_size)
    return logits, cache


def _hybrid(cfg, params, x, positions, cache, pos):
    return tf.hybrid_stack(
        cfg, params.layers, x, positions,
        states={"ssm": cache["ssm"], "conv": cache["conv"]},
        cache={"k": cache["attn_k"], "v": cache["attn_v"]}, cache_pos=pos)


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, tokens, cache, pos: int):
    """One-token decode, without autograd (the cache is written in
    place).  tokens: (B, 1); pos: the write offset, one for every row.
    Returns (logits (B, 1, V), cache)."""
    x = scale_embedding(embed_lookup(params.embed, tokens), cfg.d_model)
    positions = int(pos) + torch.arange(1, device=x.device)
    if cfg.family in ("dense", "vlm", "moe"):
        kv = cache["dense"]["k"] if "dense" in cache else cache["k"]
        groups = par.active()
        length = kv.shape[2] * (groups.batch_size if groups is not None
                                and groups.kv_split else 1)
        x, cache, _ = _attn_families(cfg, params, x, positions,
                                     cfg.layer_windows(length), cache, pos)
    elif cfg.family == "ssm":
        x, cache = tf.ssm_stack(cfg, params.layers, x, states=cache)
    elif cfg.family == "hybrid":
        x = _hybrid(cfg, params, x, positions, cache, pos)
    elif cfg.family == "encdec":
        enc_pos = torch.arange(cache["xk"].shape[2], device=x.device)
        x, cache = tf.decoder_xattn_stack(cfg, params.layers, x, positions,
                                          None, enc_pos, cache=cache,
                                          cache_pos=pos)
    else:
        raise ValueError(cfg.family)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = unembed(params.embed, x, cap=cfg.logit_softcap,
                     vocab=cfg.vocab_size)
    return logits, cache

