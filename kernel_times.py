#!/usr/bin/env python3
"""Phase 1 of a checkout's ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 kernel_times.py [--root DIR] [--seed 0] [--out results.json]

Loads ``DIR/chip_smoke.py`` (default: this checkout) with ``DIR/src``
first on the import path, builds that checkout's kernels, and runs its
phase-1 functions on the inputs ``chip_smoke.py`` makes from the same
seed: every kernel against its plain version, timed on the card.  Prints
the card's name and power limit, then one JSON line ``{"root": ...,
"ms": {kernel: device ms}}``; ``--out`` keeps every number.

Two checkouts run in turns in one machine (A, B, B, A) compare two
versions of the kernels on one card, e.g. a parent commit unpacked with
``git archive`` into ``build/parent`` against this tree.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if not (root / "chip_smoke.py").is_file():
        print(f"kernel_times.py: no chip_smoke.py in {root}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_times.py: torch.cuda.is_available() is False; this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]

    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import _build
    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {_build.__file__}, not {root}'s port")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    vectors = torch.randn((smoke.N, smoke.D), generator=gen, device=dev)
    kernels = smoke.phase_kernels(vectors, gen, dev)
    kernels.update(smoke.phase_pq_kernels(gen, dev))
    kernels["l2_distance"] = smoke.phase_l2_distance(vectors, dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "root": str(root), "kernels": kernels}, indent=1,
            default=str))
    print(card)
    print(json.dumps({"root": str(root),
                      "ms": {k: r["ms"] for k, r in kernels.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
