"""Device resolution for the port's entry points.

Every public entry point takes ``device="cuda"`` by default and resolves
it here.  Asking for the card where ``torch.cuda.is_available()`` is
False raises: the port never continues on the CPU behind the caller's
back — the CPU path is something a caller (the tests) asks for.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or ``torch.device``) -> a usable ``torch.device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but "
            f"torch.cuda.is_available() is False; pass device='cpu' to "
            f"run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: "
                         f"expected 'cuda' or 'cpu'")
    return dev
