"""Public wrappers of the port's hand-written kernels.

One wrapper per kernel.  Each checks device, dtype (float32 vectors,
int32 ids), shape and contiguity, then picks its path by the device of
the tensors it was given:

* all on the CPU  -> the plain PyTorch version in ``ref.py``,
* all on the card -> the CUDA kernel (``csrc/*.cu``, built and loaded by
  ``_build``), launched on ``torch.cuda.current_stream()`` into outputs
  allocated here with ``torch.empty``; a launch that returns a non-zero
  ``cudaError_t`` raises.  There is no fallback from the card to the
  plain version.

``LAUNCHES`` counts kernel launches, one per wrapper call that launched
(plain-version calls never count), so a run can show that its main path
went through the kernels; callers reset it by assigning 0.  The count
takes a lock: the sharded and tiered tiers launch from pool threads.

Each wrapper runs inside ``obs.profiler.annotate("repro_torch.kernels.
<name>")``: a named ``torch.profiler`` range when profiling is on, a
shared no-op context otherwise; it first calls every hook in
``CALL_HOOKS`` with its name and arguments.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import library
from repro_torch.obs.profiler import annotate

LAUNCHES = {"gather_distance": 0, "lsh_hash": 0, "fused_hop_l2": 0,
            "fused_hop_pq": 0, "pq_adc": 0, "l2_distance": 0}
_LAUNCHES_LOCK = threading.Lock()
# hook(name, args, kwargs), called at every wrapper call on either path
# (``launch.op_walk`` counts the kernels' operations through it)
CALL_HOOKS: list = []

# bucket tables hold 2**L rows and codes are non-negative int32
MAX_LSH_BITS = 30
# the fused hops keep a lane's [beam | candidates] in shared memory
# without the opt-in
MAX_SMEM_BYTES = 48 * 1024
# l2_distance tiles B in 128-row blocks along the grid's y dimension
MAX_L2_ROWS = 65535 * 128


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_smem(nbytes: int, what: str) -> None:
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory, "
                         f"more than the kernel's {MAX_SMEM_BYTES}")


def _on_card(device: torch.device) -> bool:
    """True for CUDA tensors; False for CPU tensors; raises otherwise."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t "
                           f"{rc}")


def _count(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _annotated(fn):
    """Run the wrapper ``fn`` inside its profiler range, after telling
    every hook in ``CALL_HOOKS`` of the call."""
    label = f"repro_torch.kernels.{fn.__name__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        for hook in CALL_HOOKS:
            hook(fn.__name__, args, kwargs)
        with annotate(label):
            return fn(*args, **kwargs)
    return wrapper


@_annotated
def gather_distance(vectors: torch.Tensor, ids: torch.Tensor,
                    queries: torch.Tensor) -> torch.Tensor:
    """(N, d) f32 table, (B, C) int32 ids, (B, d) f32 queries -> (B, C)
    f32 squared L2; ids < 0 give +inf."""
    dev = vectors.device
    _check("vectors", vectors, torch.float32, 2, dev)
    _check("ids", ids, torch.int32, 2, dev)
    _check("queries", queries, torch.float32, 2, dev)
    n, d = vectors.shape
    b, c = ids.shape
    if queries.shape != (b, d):
        raise ValueError(f"queries shape {tuple(queries.shape)} != {(b, d)}")
    if not _on_card(dev):
        return ref.gather_distance_ref(vectors, ids, queries)
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = library("gather_distance").launch_gather_distance(
        _ptr(vectors), _ptr(ids), _ptr(queries), _ptr(out), n, b, c, d,
        _stream(dev))
    _raise_on(rc, "gather_distance")
    _count("gather_distance")
    return out


@_annotated
def lsh_hash(queries: torch.Tensor, hyperplanes: torch.Tensor) -> torch.Tensor:
    """(B, d) f32 queries, (L, d) f32 hyperplanes -> (B,) int32 codes."""
    dev = queries.device
    _check("queries", queries, torch.float32, 2, dev)
    _check("hyperplanes", hyperplanes, torch.float32, 2, dev)
    b, d = queries.shape
    l = hyperplanes.shape[0]
    if hyperplanes.shape[1] != d:
        raise ValueError(f"hyperplanes have dim {hyperplanes.shape[1]}, "
                         f"queries {d}")
    if l > MAX_LSH_BITS:
        raise ValueError(f"{l} hyperplanes > {MAX_LSH_BITS}: a 2^L bucket "
                         f"table would not fit")
    if not _on_card(dev):
        return ref.lsh_hash_ref(queries, hyperplanes)
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    rc = library("lsh_hash").launch_lsh_hash(
        _ptr(queries), _ptr(hyperplanes), _ptr(out), b, l, d, _stream(dev))
    _raise_on(rc, "lsh_hash")
    _count("lsh_hash")
    return out


@_annotated
def fused_hop_l2(vectors, cand_ids, queries, beam_ids, beam_dists, beam_exp):
    """One fused L2 hop (gather + distance + beam merge) for a batch.

    (N, d) f32 table, (B, C) int32 candidate ids, (B, d) f32 queries,
    (B, L) int32/f32/bool beam -> (new_ids, new_dists, new_exp, n_fresh).
    """
    dev = vectors.device
    _check("vectors", vectors, torch.float32, 2, dev)
    _check("cand_ids", cand_ids, torch.int32, 2, dev)
    _check("queries", queries, torch.float32, 2, dev)
    _check("beam_ids", beam_ids, torch.int32, 2, dev)
    _check("beam_dists", beam_dists, torch.float32, 2, dev)
    _check("beam_exp", beam_exp, torch.bool, 2, dev)
    n, d = vectors.shape
    b, c = cand_ids.shape
    l = beam_ids.shape[1]
    if queries.shape != (b, d):
        raise ValueError(f"queries shape {tuple(queries.shape)} != {(b, d)}")
    if beam_ids.shape != (b, l) or beam_dists.shape != (b, l) \
            or beam_exp.shape != (b, l):
        raise ValueError("beam_ids/beam_dists/beam_exp must all be (B, L)")
    if not _on_card(dev):
        return ref.fused_hop_ref(vectors, cand_ids, queries, beam_ids,
                                 beam_dists, beam_exp)
    lib = library("fused_hop")
    _check_smem(lib.fused_hop_l2_smem_bytes(c, l),
                f"C + L = {c + l} entries")
    out_ids = torch.empty((b, l), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, l), dtype=torch.float32, device=dev)
    out_exp = torch.empty((b, l), dtype=torch.bool, device=dev)
    out_nf = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0 or l == 0:
        return out_ids, out_d, out_exp, out_nf.zero_()
    rc = lib.launch_fused_hop_l2(
        _ptr(vectors), _ptr(cand_ids), _ptr(queries), _ptr(beam_ids),
        _ptr(beam_dists), _ptr(beam_exp), _ptr(out_ids), _ptr(out_d),
        _ptr(out_exp), _ptr(out_nf), n, b, c, l, d, _stream(dev))
    _raise_on(rc, "fused_hop_l2")
    _count("fused_hop_l2")
    return out_ids, out_d, out_exp, out_nf


@_annotated
def pq_adc(luts: torch.Tensor, codes: torch.Tensor,
           ids: torch.Tensor | None = None) -> torch.Tensor:
    """ADC sums ``Σ_m luts[b, m, row[m]]`` of (B, M, K) f32 LUTs over
    candidate code rows, in one of two forms:

    * ``pq_adc(luts, codes)``: (B, C, M) int32 code rows -> (B, C), the
      reference's contract batched over lanes;
    * ``pq_adc(luts, table, ids)``: an (N, M) int32 code table and (B, C)
      int32 ids -> (B, C), each row read by id inside the kernel; ids < 0
      give +inf.  This is ``core.pq.ADCDist``'s whole call.

    Codes lie in [0, K) by construction (``core.pq.encode`` is an argmin
    over K centroids) and ids below N; the kernel checks neither (an id
    >= N reads row N-1)."""
    dev = luts.device
    _check("luts", luts, torch.float32, 3, dev)
    b, m, k = luts.shape
    if ids is None:
        _check("codes", codes, torch.int32, 3, dev)
        c = codes.shape[1]
        if codes.shape != (b, c, m):
            raise ValueError(f"codes shape {tuple(codes.shape)} != (B, C, M) "
                             f"with B={b}, M={m}")
    else:
        _check("codes", codes, torch.int32, 2, dev)
        _check("ids", ids, torch.int32, 2, dev)
        c = ids.shape[1]
        if codes.shape[1] != m:
            raise ValueError(f"codes have {codes.shape[1]} subspaces, LUTs "
                             f"{m}")
        if ids.shape[0] != b:
            raise ValueError(f"ids has {ids.shape[0]} lanes, LUTs {b}")
        if codes.shape[0] == 0:
            raise ValueError("the code table is empty")
    if not _on_card(dev):
        return ref.pq_adc_ref(luts, codes, ids)
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = library("pq_adc").launch_pq_adc(
        _ptr(luts), _ptr(codes), None if ids is None else _ptr(ids),
        _ptr(out), codes.shape[0], b, c, m, k, _stream(dev))
    _raise_on(rc, "pq_adc")
    _count("pq_adc")
    return out


@_annotated
def fused_hop_pq(luts, codes, cand_ids, beam_ids, beam_dists, beam_exp):
    """One fused PQ-ADC hop (code gather + ADC + beam merge) for a batch.

    (B, M, K) f32 LUTs, (N, M) int32 code table, (B, C) int32 candidate
    ids, (B, L) int32/f32/bool beam -> (new_ids, new_dists, new_exp,
    n_fresh).  Codes lie in [0, K) by construction; not checked.
    """
    dev = luts.device
    _check("luts", luts, torch.float32, 3, dev)
    _check("codes", codes, torch.int32, 2, dev)
    _check("cand_ids", cand_ids, torch.int32, 2, dev)
    _check("beam_ids", beam_ids, torch.int32, 2, dev)
    _check("beam_dists", beam_dists, torch.float32, 2, dev)
    _check("beam_exp", beam_exp, torch.bool, 2, dev)
    b, m, k = luts.shape
    n = codes.shape[0]
    c = cand_ids.shape[1]
    l = beam_ids.shape[1]
    if codes.shape[1] != m:
        raise ValueError(f"codes have {codes.shape[1]} subspaces, LUTs {m}")
    if cand_ids.shape[0] != b:
        raise ValueError(f"cand_ids has {cand_ids.shape[0]} lanes, LUTs {b}")
    if beam_ids.shape != (b, l) or beam_dists.shape != (b, l) \
            or beam_exp.shape != (b, l):
        raise ValueError("beam_ids/beam_dists/beam_exp must all be (B, L)")
    if not _on_card(dev):
        return ref.fused_hop_pq_ref(luts, codes, cand_ids, beam_ids,
                                    beam_dists, beam_exp)
    lib = library("fused_hop_pq")
    _check_smem(lib.fused_hop_pq_smem_bytes(c, l),
                f"C + L = {c + l} entries")
    out_ids = torch.empty((b, l), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, l), dtype=torch.float32, device=dev)
    out_exp = torch.empty((b, l), dtype=torch.bool, device=dev)
    out_nf = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0 or l == 0:
        return out_ids, out_d, out_exp, out_nf.zero_()
    rc = lib.launch_fused_hop_pq(
        _ptr(luts), _ptr(codes), _ptr(cand_ids), _ptr(beam_ids),
        _ptr(beam_dists), _ptr(beam_exp), _ptr(out_ids), _ptr(out_d),
        _ptr(out_exp), _ptr(out_nf), n, b, c, l, m, k, _stream(dev))
    _raise_on(rc, "fused_hop_pq")
    _count("fused_hop_pq")
    return out_ids, out_d, out_exp, out_nf


@_annotated
def l2_distance(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(B, d) f32 queries, (C, d) f32 points -> (B, C) f32 squared L2.

    The kernel computes the expanded form ``‖q‖² + ‖x‖² − 2q·x`` (as the
    reference's Pallas kernel does), the plain version the direct form;
    they agree to about 1e-4.  No search path calls it."""
    dev = queries.device
    _check("queries", queries, torch.float32, 2, dev)
    _check("points", points, torch.float32, 2, dev)
    b, d = queries.shape
    c = points.shape[0]
    if points.shape[1] != d:
        raise ValueError(f"points have dim {points.shape[1]}, queries {d}")
    if b > MAX_L2_ROWS:
        raise ValueError(f"{b} queries > {MAX_L2_ROWS}, the kernel's grid")
    if not _on_card(dev):
        return ref.l2_distance_ref(queries, points)
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = library("l2_distance").launch_l2_distance(
        _ptr(queries), _ptr(points), _ptr(out), b, c, d, _stream(dev))
    _raise_on(rc, "l2_distance")
    _count("l2_distance")
    return out
