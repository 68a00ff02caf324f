"""Per-rank operation counts of one step, taken while it runs.

Port of ``repro/launch/hlo_walk.py``.  The reference parses the
compiled SPMD module's HLO text (one device's program) and walks it
from ENTRY, multiplying the trip counts of its loops in.  Here the step
runs eagerly (on real tensors, or on fake ones that allocate nothing)
as one rank of its world, so every loop has run its trips by the time
the counts are read:

    with op_walk(live=[...]) as walked:
        step(...)
    walked == {"dot_flops", "kernel_flops", "collectives", "peak_bytes"}

* ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
  aten's matrix products (``mm``, ``bmm``, ``addmm``, convolutions,
  attention), as the walker counts HLO dots and convolutions;
* ``kernel_flops``: the port's hand-written kernels, which no aten op
  counts, each wrapper call by its own formula (``KERNEL_FLOPS``, told
  of the call through ``kernels.ops.CALL_HOOKS``);
* ``collectives``: the bytes of the collectives' results by kind, from
  ``models.parallel.BYTES`` (the reference's ``collective_bytes``);
* ``peak_bytes``: the most bytes live at once on the rank, from a
  ``TorchDispatchMode`` that adds each new output storage's bytes and
  takes them off when the storage dies, plus the storages of ``live``
  (parameters, moments, batch, cache), live when the walk begins.

Counts are per rank: every rank of the world runs the same program, so
``launch.roofline.analyze`` multiplies them by the chips.
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import ops
from repro_torch.models import parallel as par


def _lsh_hash(queries, hyperplanes):
    return 2 * queries.shape[0] * hyperplanes.shape[0] * queries.shape[1]


def _l2_distance(queries, points):
    return 2 * queries.shape[0] * points.shape[0] * queries.shape[1]


def _gather_distance(vectors, ids, queries):
    return 3 * ids.shape[0] * ids.shape[1] * vectors.shape[1]


def _fused_hop_l2(vectors, cand_ids, queries, *beam):
    return 3 * cand_ids.shape[0] * cand_ids.shape[1] * vectors.shape[1]


def _pq_adc(luts, codes, ids=None):
    b, m, _ = luts.shape
    return m * b * (codes.shape[1] if ids is None else ids.shape[1])


def _fused_hop_pq(luts, codes, cand_ids, *beam):
    return luts.shape[1] * luts.shape[0] * cand_ids.shape[1]


# a kernel's operations a wrapper call: a subtract, a multiply and an add
# per element of an L2 distance; a multiply-add per dot-product term; a
# table read, counted as an add, per ADC term
KERNEL_FLOPS = {"lsh_hash": _lsh_hash, "l2_distance": _l2_distance,
                "gather_distance": _gather_distance,
                "fused_hop_l2": _fused_hop_l2, "pq_adc": _pq_adc,
                "fused_hop_pq": _fused_hop_pq}


class PeakBytes(TorchDispatchMode):
    """The most bytes of tensor storage live at once while the mode is
    on: ``live``'s storages, and every storage an op's outputs bring,
    each counted from its first output until it dies."""

    def __init__(self, live=()):
        super().__init__()
        self._seen = WeakIdKeyDictionary()
        self._refs = set()
        self.now = 0
        for t in live:
            self._track(t)
        self.peak = self.now

    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.now += n
        self._refs.add(weakref.ref(st, self._make_release(n)))

    def _make_release(self, n: int):
        def release(ref):
            self.now -= n
            self._refs.discard(ref)
        return release

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            self._track(t)
        self.peak = max(self.peak, self.now)
        return out


@contextlib.contextmanager
def op_walk(live=()):
    """Count the step run inside the block (see the module docstring);
    yields the dict, which is filled when the block ends.  ``live``: the
    tensors that stay live through the step (their storages count toward
    ``peak_bytes``)."""
    walked: dict = {}
    kernels: collections.Counter = collections.Counter()
    before = collections.Counter(par.BYTES)
    flops = FlopCounterMode(display=False)
    peak = PeakBytes(live)

    def hook(name, args, kwargs):
        kernels[name] += KERNEL_FLOPS[name](*args, **kwargs)

    ops.CALL_HOOKS.append(hook)
    try:
        with flops, peak:
            yield walked
    finally:
        ops.CALL_HOOKS.remove(hook)
    walked.update(
        dot_flops=float(flops.get_total_flops()),
        kernel_flops=float(sum(kernels.values())),
        kernel_breakdown=dict(kernels),
        collectives={k: float(v - before[k]) for k, v in par.BYTES.items()
                     if v - before[k]},
        peak_bytes=int(peak.peak))
