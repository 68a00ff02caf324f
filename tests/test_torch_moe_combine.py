"""The MoE combine's fixed-order fold (``models.moe._combine``) against
the sequential ``index_add_`` that it replaces, on the CPU.

A seeded routing of (token, slot) entries, in f32 and bf16, with
duplicate tokens (a token's k choices), dropped slots (``valid`` false,
their rows zeroed) and k = 1, 2 and 6: the output and the gradient of
``contrib`` are bit for bit those of ``index_add_`` into a (t + 1, D)
buffer whose last row takes the dropped slots (in bf16 the CPU's
``index_add_`` accumulates in f32 and rounds once, which the fold
does too).  A -0.0 contribution comes out as +0.0 from both.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.models.moe import _combine

from test_torch_ingest import one_torch_thread  # noqa: F401


def _routing(k: int, t: int = 24, d: int = 16, seed: int = 0):
    """(contrib (n, d) f32, src_tok (n,), valid (n,)): each token's k
    choices in a shuffled slot order, about a third of them dropped."""
    rng = np.random.default_rng(seed + k)
    src = rng.permutation(np.repeat(np.arange(t), k))
    valid = rng.random(src.size) > 0.35
    contrib = rng.normal(size=(src.size, d)).astype(np.float32)
    contrib[~valid] = 0.0
    contrib[np.flatnonzero(valid)[0], 0] = -0.0
    return (torch.from_numpy(contrib), torch.from_numpy(src),
            torch.from_numpy(valid))


def _index_add(contrib, src, valid, t):
    tok = torch.where(valid, src, torch.full_like(src, t))
    return contrib.new_zeros((t + 1, contrib.shape[1])).index_add(
        0, tok, contrib)[:t]


def _bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_fold_equals_index_add_bit_for_bit(dtype, k):
    t = 24
    contrib, src, valid = _routing(k, t)
    contrib = contrib.to(dtype)
    gy = torch.from_numpy(np.random.default_rng(k).normal(
        size=(t, contrib.shape[1])).astype(np.float32)).to(dtype)
    a = contrib.clone().requires_grad_()
    b = contrib.clone().requires_grad_()
    got = _combine(a, src, valid, t, k)
    want = _index_add(b, src, valid, t)
    assert torch.equal(_bits(got), _bits(want))
    (ga,) = torch.autograd.grad(got, a, gy)
    (gb,) = torch.autograd.grad(want, b, gy)
    assert torch.equal(_bits(ga), _bits(gb))
