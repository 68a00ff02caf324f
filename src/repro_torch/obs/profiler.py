"""Opt-in ``torch.profiler`` annotation hooks for the port's kernels.

Counterpart of ``repro/obs/profiler.py``.  When profiling is enabled
(``REPRO_PROFILE=1`` in the environment, or ``enable_profiling()`` at
runtime), the kernel wrappers in ``repro_torch.kernels.ops`` wrap each
launch in a ``torch.profiler.record_function`` range, so a trace shows
named host spans (``repro_torch.kernels.fused_hop_l2``, ...) around the
CUDA kernels they enqueue.

Disabled (the default), ``annotate`` returns one shared no-op context
manager: the hot path pays a single truthiness check and no allocation.
"""
from __future__ import annotations

import os
from contextlib import contextmanager


class _NullContext:
    """Shared reusable no-op context."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CONTEXT = _NullContext()
_enabled = os.environ.get("REPRO_PROFILE", "") not in ("", "0")


def profiling_enabled() -> bool:
    return _enabled


def enable_profiling(flag: bool = True) -> None:
    """Runtime switch (the env var ``REPRO_PROFILE=1`` sets the initial
    state); affects every subsequent ``annotate`` call."""
    global _enabled
    _enabled = bool(flag)


def annotate(name: str):
    """Context manager: a ``torch.profiler.record_function(name)`` when
    profiling is on, the shared no-op otherwise."""
    if not _enabled:
        return _NULL_CONTEXT
    import torch.profiler
    return torch.profiler.record_function(name)


@contextmanager
def profile_trace(log_dir: str):
    """A whole capture: everything inside the ``with`` block runs under a
    ``torch.profiler.profile`` of the CPU and (where present) the card,
    with kernel annotations on, and the trace is written to
    ``log_dir/trace.json`` (Chrome trace format, viewable in Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = _enabled
    enable_profiling(True)
    try:
        with profile(activities=activities) as prof:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        enable_profiling(was)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
