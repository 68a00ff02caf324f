"""Selective state-space blocks: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2).

Port of ``repro/models/ssm.py``.  The recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t        (diagonal A)
    y_t = <C_t, h_t>

runs as the reference runs it: a sequential loop over chunks carries
only the (B, ..., N) boundary state, and inside each chunk a log-depth
associative scan materializes h for `chunk` positions, contracts it with
C at once and frees it.  ``associative_scan`` is the reference's
``lax.associative_scan`` algorithm (pairwise reduce, recurse on the odd
elements, fix up the even ones) in plain PyTorch ops, so the products
and sums happen in the same order; only XLA's fused multiply-adds and
the C contraction's summation order can part the two, which the parity
tests bound (``tests/test_torch_model_parts.py``).

Mamba-2 uses the same recurrence with a scalar A per head and B/C
shared across heads.  Decode is the single-step update through the same
code (S=1, chunk=1).

Under a ``parallel_context`` (training across ranks) both blocks are
tensor-parallel over ``model`` as the reference's specs cut them: the
input through ``copy_to_model``, ``in_proj`` column-parallel in its rank
layout (``convert.rank_layout``: rank r holds its blocks of each part,
``[x_r | z_r]`` for mamba1, ``[z_r | x_r | B_r | C_r | dt_r]`` for
mamba2, and mamba2's ``conv_w`` rows follow ``[x_r | B_r | C_r]``), the
depthwise conv, the scan and ``d_skip`` on the rank's ``d_inner``
channels (mamba2: its whole heads), ``out_proj`` row-parallel
(``reduce_from_model``).  Mamba1's ``x_proj`` is row-parallel, and its
(dt, B, C) partial is reduced both ways (every rank's channels consume
it).  Mamba2 gathers ``B``/``C`` over ``model`` (``gather_from_model``:
rank-local heads consume them), takes its heads of the replicated
``a_log``/``d_skip`` behind ``copy_to_model`` (their gradients summed
over ``model``, so the leaves stay equal on every rank), and its gated
RMSNorm's sum of squares over the full ``d_inner`` is reduced both
ways.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import P
from repro_torch.models import parallel as par
from repro_torch.models.layers import Leaves, checkpointed


def _assoc(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, b1 * a2 + b2


def _interleave(even, odd, axis):
    """Elements of ``even`` at positions 0, 2, ..., ``odd`` at 1, 3, ..."""
    n = even.shape[axis] + odd.shape[axis]
    shape = list(even.shape)
    shape[axis] = n
    out = even.new_empty(shape)
    idx = [slice(None)] * even.ndim
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = even
    idx[axis] = slice(1, None, 2)
    out[tuple(idx)] = odd
    return out


def associative_scan(fn, elems, axis):
    """Inclusive scan of the tuple ``elems`` along ``axis`` under the
    associative ``fn``, in ``lax.associative_scan``'s order of combines."""
    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                     tuple(sl(e, 1, None, 2) for e in elems))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(sl(e, 0, -1) for e in odd),
                      tuple(sl(e, 2, None, 2) for e in elems))
        else:
            even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
        even = tuple(torch.cat([sl(e, 0, 1), r], dim=axis)
                     for e, r in zip(elems, even))
        return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))

    return scan(tuple(elems))


def fused_ssm_scan(dt, a, bmat, cmat, x, h0, chunk, variant, remat=True):
    """Chunked selective scan with fused output contraction.

    mamba1: dt (B,S,Di), a (Di,N), bmat/cmat (B,S,N), x (B,S,Di),
            h (B,Di,N)  -> y (B,S,Di)
    mamba2: dt (B,S,nh), a (nh,), bmat/cmat (B,S,N), x (B,S,nh,hd),
            h (B,nh,hd,N) -> y (B,S,nh,hd)
    Returns (y in f32, last state).  With ``remat`` each chunk's step is
    checkpointed, as the reference's is: the backward pass recomputes the
    chunk's (B, chunk, ..., N) expanded state instead of keeping it for
    every chunk.
    """
    s = dt.shape[1]
    chunk = min(chunk, s)
    while s % chunk:          # ragged prompts: largest divisor <= requested
        chunk -= 1

    def step(h, dtc, bc, cc, xc):
        dtc, bc, cc, xc = dtc.float(), bc.float(), cc.float(), xc.float()
        if variant == "mamba1":
            da = torch.exp(dtc[..., None] * a)                  # (B,c,Di,N)
            db = (dtc * xc)[..., None] * bc[:, :, None, :]       # (B,c,Di,N)
        else:  # mamba2
            db = (dtc[..., None, None] * xc[..., None]
                  * bc[:, :, None, None, :])                     # (B,c,nh,hd,N)
            da = torch.exp(dtc * a)[..., None, None].expand(db.shape)
        aa, bb = associative_scan(_assoc, (da, db), axis=1)
        h_all = aa * h[:, None] + bb        # (B, chunk, ..., N)
        if variant == "mamba1":
            y = torch.einsum("bcdn,bcn->bcd", h_all, cc)
        else:
            y = torch.einsum("bchdn,bcn->bchd", h_all, cc)
        return h_all[:, -1].clone(), y      # a copy: h_all is freed

    h = h0
    ys = []
    for c0 in range(0, s, chunk):
        h, y = checkpointed(step, remat, h, dt[:, c0: c0 + chunk],
                            bmat[:, c0: c0 + chunk], cmat[:, c0: c0 + chunk],
                            x[:, c0: c0 + chunk])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv as W shifted multiply-adds.

    x: (B, S, D); w: (D, W); state: (B, W-1, D) decode carry.
    Returns (y, new_state).
    """
    bsz, s, d = x.shape
    width = w.shape[1]
    pad = (x.new_zeros((bsz, width - 1, d)) if state is None else state)
    xp = torch.cat([pad.to(x.dtype), x], dim=1)   # (B, S+W-1, D)
    w = w.to(x.dtype)
    y = xp[:, width - 1: width - 1 + s, :] * w[:, width - 1]
    for j in range(width - 1):
        y = y + xp[:, j: j + s, :] * w[:, j]
    new_state = xp[:, -(width - 1):, :] if width > 1 else pad
    return y, new_state


# --------------------------------------------------------------------------
# Mamba-1 block (falcon-mamba)
# --------------------------------------------------------------------------

class Mamba1(Leaves):
    def __init__(self, cfg, dtype, device, stack=None):
        super().__init__(dtype, device, stack)
        d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        dt_rank = max(d // 16, 1)
        self.leaf("in_proj", (d, 2 * di), P(None, "model"), 1.0)
        self.leaf("conv_w", (di, cfg.conv_width), P("model", None), 1.0)
        self.leaf("x_proj", (di, dt_rank + 2 * n), P("model", None), 1.0)
        self.leaf("dt_proj", (dt_rank, di), P(None, "model"), 1.0)
        self.leaf("a_log", (di, n), P("model", None))
        self.leaf("d_skip", (di,), P("model"))
        self.leaf("out_proj", (di, d), P("model", None), 1.0)


def mamba1_block(params, x, cfg, ssm_state=None, conv_state=None,
                 remat=True):
    """x: (B, S, D).  ssm_state: (B, Di, N) f32 decode carry.

    Returns (y, new_ssm_state, new_conv_state).
    """
    bsz, s, d = x.shape
    n = cfg.ssm_state
    dt_rank = max(d // 16, 1)
    xz = par.copy_to_model(x) @ params.in_proj
    xi, z = xz.chunk(2, dim=-1)                         # (B, S, Di)
    di = xi.shape[-1]                                   # the rank's channels
    xi, new_conv = causal_conv1d(xi, params.conv_w, conv_state)
    xi = F.silu(xi)
    proj = par.copy_to_model(par.reduce_from_model(
        xi @ params.x_proj.to(xi.dtype)))               # (B, S, dt_rank+2N)
    dt, bmat, cmat = proj.split([dt_rank, n, n], dim=-1)
    dt = F.softplus(dt @ params.dt_proj)                # (B, S, Di)
    a = -torch.exp(params.a_log.float())                # (Di, N)
    h0 = (ssm_state if ssm_state is not None
          else torch.zeros((bsz, di, n), dtype=torch.float32,
                           device=x.device))
    y, h_last = fused_ssm_scan(dt, a, bmat, cmat, xi, h0, cfg.ssm_chunk,
                               "mamba1", remat)
    y = y.to(x.dtype) + params.d_skip * xi
    y = y * F.silu(z)
    return par.reduce_from_model(y @ params.out_proj), h_last, new_conv


# --------------------------------------------------------------------------
# Mamba-2 block (zamba2): scalar-per-head A, head-shared B/C
# --------------------------------------------------------------------------

class Mamba2(Leaves):
    def __init__(self, cfg, dtype, device, stack=None):
        super().__init__(dtype, device, stack)
        d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh = cfg.ssm_heads
        self.leaf("in_proj", (d, 2 * di + 2 * n + nh), P(None, "model"),
                  1.0)
        self.leaf("conv_w", (di + 2 * n, cfg.conv_width), P("model", None),
                  1.0)
        self.leaf("a_log", (nh,), P(None))
        self.leaf("d_skip", (nh,), P(None))
        self.leaf("norm_g", (di,), P("model"))
        self.leaf("out_proj", (di, d), P("model", None), 1.0)


def mamba2_block(params, x, cfg, ssm_state=None, conv_state=None,
                 remat=True):
    """x: (B, S, D).  ssm_state: (B, nh, hd, N) f32."""
    bsz, s, d = x.shape
    groups = par.active()
    m = 1 if groups is None else groups.model_size
    hd = cfg.d_inner // cfg.ssm_heads
    # the rank's channels, state columns and heads (all of them off a mesh)
    di, n, nh = cfg.d_inner // m, cfg.ssm_state // m, cfg.ssm_heads // m
    zxbcdt = par.copy_to_model(x) @ params.in_proj
    z, xbc, dt = zxbcdt.split([di, di + 2 * n, nh], dim=-1)
    xbc, new_conv = causal_conv1d(xbc, params.conv_w, conv_state)
    xbc = F.silu(xbc)
    xi, bmat, cmat = xbc.split([di, n, n], dim=-1)
    bmat, cmat = par.gather_from_model(bmat), par.gather_from_model(cmat)
    dt = F.softplus(dt)                                  # (B, S, nh)
    a_log, d_skip = params.a_log, params.d_skip
    if groups is not None:       # the rank's heads of the replicated leaves
        heads = slice(groups.model_rank * nh, (groups.model_rank + 1) * nh)
        a_log = par.copy_to_model(a_log)[heads]
        d_skip = par.copy_to_model(d_skip)[heads]
    a = -torch.exp(a_log.float())                        # (nh,)
    xh = xi.reshape(bsz, s, nh, hd)
    h0 = (ssm_state if ssm_state is not None
          else torch.zeros((bsz, nh, hd, cfg.ssm_state), dtype=torch.float32,
                           device=x.device))
    y, h_last = fused_ssm_scan(dt, a, bmat, cmat, xh, h0, cfg.ssm_chunk,
                               "mamba2", remat)
    y = y.to(x.dtype) + d_skip[None, None, :, None] * xh
    y = y.reshape(bsz, s, di)
    # gated RMSNorm (mamba2's norm-before-out): the mean over the full
    # d_inner as a sum (over model) divided by it, the same ops on one
    # device as on a world of one
    yf = y.float()
    var = par.copy_to_model(par.reduce_from_model(
        yf.square().sum(-1, keepdim=True))) / cfg.d_inner
    y = ((yf * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype) * params.norm_g
         * F.silu(z))
    return par.reduce_from_model(y @ params.out_proj), h_last, new_conv
