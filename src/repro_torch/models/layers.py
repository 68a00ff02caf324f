"""Shared building blocks: norms, embeddings, rotary, gated MLPs.

Port of ``repro/models/layers.py``.  The reference keeps parameters as a
pytree with a leading layer axis (scan over layers); here each block is
an ``nn.Module`` (``Leaves``) holding one layer's weights, and a stack is
an ``nn.ModuleList`` of them.  Weights keep the reference's ``x @ W``
layout: stored ``(d_in, d_out)``, so ``convert.model_params_from_numpy``
only unstacks, never transposes.

The init draws what the reference's ``init_from_decl`` draws, leaf by
leaf: ``normal * scale / sqrt(fan_in)``, ones for norm gammas (and the
SSM's ``a_log``/``d_skip``), zeros for caches.  ``fan_in`` is
``shape[0]`` of the reference's leaf, which for every weight of a
stacked layer is the STACK DEPTH (``stack_decl`` prepends the layer
axis), not ``d_in`` — a quirk kept for parity, so a block built with
``stack=n`` draws with ``fan_in = n``.  Each leaf carries the
reference's partition spec (``launch.mesh.P``) for one layer's weight;
``pspecs_from_decl`` collects them, and ``models.model.pspecs`` gives
the reference's stacked tree (a stacked leaf's spec gains a leading
``None``, as ``stack_decl`` gives it).  The reference's ``maybe_shard``
and ``shard_residual`` (GSPMD layout constraints) have no counterpart:
training across ranks holds each rank's slices and calls the
collectives of ``models.parallel`` instead (the embedding table is
vocab-parallel there: ``embed_lookup`` sums the owning rank's rows and
``unembed`` gives the rank's vocab columns); sequence parallelism is
left out (it saves memory only).

Every weight is a trainable ``nn.Parameter``.  ``checkpointed`` is the
reference's ``jax.checkpoint``: the models call it at the reference's
remat points, and it recomputes only where autograd records the call.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import P
from repro_torch.models import parallel as par

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Leaves(nn.Module):
    """A module whose weights are declared like the reference's leaves.

    ``stack`` is the depth of the reference's stacked leaf this block is
    one layer of (None: an unstacked leaf, e.g. the embedding table or
    zamba2's shared block).  ``leaf(name, shape, pspec, scale)`` registers an
    uninitialized parameter and records how ``init_leaves`` fills it and
    its partition spec ``pspec``.
    """

    def __init__(self, dtype: torch.dtype, device, stack: Optional[int]):
        super().__init__()
        self._dtype, self._device, self._stack = dtype, device, stack
        self._init: dict[str, tuple[Optional[float], int]] = {}
        self._pspec: dict[str, P] = {}

    def leaf(self, name: str, shape, pspec: P,
             scale: Optional[float] = None) -> None:
        shape = tuple(shape)
        if self._stack is not None:
            fan_in = self._stack               # shape[0] of (n,) + shape
        else:
            fan_in = shape[0] if len(shape) >= 2 else 1
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=self._dtype, device=self._device)))
        self._init[name] = (scale, fan_in)
        self._pspec[name] = pspec


def pspecs_from_decl(module: nn.Module) -> dict:
    """{parameter name: partition spec} of every ``Leaves`` parameter
    under ``module``, each for its own (one layer's) shape."""
    return {f"{prefix}{'.' if prefix else ''}{name}": spec
            for prefix, sub in module.named_modules()
            if isinstance(sub, Leaves)
            for name, spec in sub._pspec.items()}


def init_leaves(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every ``Leaves`` parameter under ``module``: ones where the
    reference declares no scale, else a normal draw (float32, then cast)
    times ``scale / sqrt(fan_in)``."""
    with torch.no_grad():
        for sub in module.modules():
            if not isinstance(sub, Leaves):
                continue
            for name, (scale, fan_in) in sub._init.items():
                p = getattr(sub, name)
                if scale is None:
                    p.fill_(1)
                    continue
                draw = torch.randn(p.shape, generator=generator,
                                   dtype=torch.float32, device=p.device)
                p.copy_(draw * (scale / fan_in ** 0.5))


def checkpointed(fn, remat: bool, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept (``jax.checkpoint``) when ``remat`` is set and
    autograd records the call."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------------
# Ops
# --------------------------------------------------------------------------

def rms_norm(x, gamma, eps):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap else x


def rope(x, positions, theta):
    """Rotary embedding.  x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    # a Python base: no host-to-device copy (one would wait for the card)
    freq = torch.pow(float(theta), -torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq      # (..., S, half)
    ang = ang[..., None, :]                        # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(gate, kind):
    """GeGLU's tanh-approximate GELU, or SwiGLU's SiLU."""
    return (F.gelu(gate, approximate="tanh") if kind == "geglu"
            else F.silu(gate))


class GatedMLP(Leaves):
    def __init__(self, d_model, d_ff, dtype, device, stack=None):
        super().__init__(dtype, device, stack)
        self.leaf("wi", (d_model, 2 * d_ff), P(None, "model"), 1.0)
        self.leaf("wo", (d_ff, d_model), P("model", None), 1.0)


def gated_mlp(params, x, kind="swiglu"):
    h = x @ params.wi
    gate, up = h.chunk(2, dim=-1)
    return (activation(gate, kind) * up) @ params.wo


def padded_vocab(vocab: int) -> int:
    """Pad the vocab to a multiple of 256, as the reference does (its
    embedding table shards over any TP degree up to 256)."""
    return -(-vocab // 256) * 256


class Embed(Leaves):
    def __init__(self, vocab, d_model, dtype, device):
        super().__init__(dtype, device, None)
        self.leaf("table", (padded_vocab(vocab), d_model), P("model", None),
                  1.0)


def embed_lookup(params, tokens):
    return par.embed_lookup(params.table, tokens)


def unembed(params, x, *, cap=None, vocab=None):
    """x @ E^T with softcap; padded vocab columns masked to -1e9 (after the
    cap — they must stay out of every softmax/argmax/logsumexp).  Under
    a ``parallel_context`` the table is this rank's vocab rows, and so
    are the logits' columns: the mask lands on the padded ones among
    them."""
    logits = softcap(par.copy_to_model(x) @ params.table.T, cap)
    rows = params.table.shape[0]
    first = par.vocab_offset(rows)
    if vocab is not None and vocab < first + rows:
        logits[..., max(vocab - first, 0):] = -1e9
    return logits


def scale_embedding(x, d_model: int):
    """Gemma-style sqrt(d) scaling, the factor rounded to ``x.dtype``
    first (on the host) as the reference's ``jnp.asarray(d ** 0.5,
    x.dtype)`` is."""
    return x * float(torch.tensor(math.sqrt(d_model), dtype=x.dtype))
