"""Gradient compression hooks: bf16 or int8 casts, error feedback.

Port of ``repro/optim/grad_compress.py``.  ``compress_bf16``/
``compress_int8`` cast a gradient tree (nested dicts of tensors) between
backward and optimizer; ``decompress`` brings it back to f32; error
feedback carries each step's quantization error into the next step
(1-bit-Adam style).  Rounding is half to even, as ``jnp.round``'s.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


def _map(fn, *trees):
    """``fn`` over the leaves of one or more same-shaped dict trees."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def compress_bf16(grads):
    return _map(lambda g: g.to(torch.bfloat16), grads)


class Int8Grad(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor


def compress_int8(grads):
    def one(g):
        g = g.float()
        scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
        return Int8Grad(q=torch.clamp(torch.round(g / scale), -127, 127)
                        .to(torch.int8), scale=scale)
    return _map(one, grads)


def decompress(grads):
    def one(g):
        if isinstance(g, Int8Grad):
            return g.q.float() * g.scale
        return g.float()
    return _map(one, grads)


class ErrorFeedback(NamedTuple):
    residual: Any


def ef_init(params):
    return ErrorFeedback(residual=_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params))


def ef_compress(grads, ef: ErrorFeedback, kind="int8"):
    """Add the residual, compress, store the new residual."""
    corrected = _map(lambda g, r: g.float() + r, grads, ef.residual)
    comp = compress_int8(corrected) if kind == "int8" \
        else compress_bf16(corrected)
    recon = decompress(comp)
    new_res = _map(lambda c, r: c - r, corrected, recon)
    return comp, ErrorFeedback(residual=new_res)
