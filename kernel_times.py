#!/usr/bin/env python3
"""Phase 1 of a checkout's ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 kernel_times.py [--root DIR] [--seed 0] [--out results.json]

Loads ``DIR/chip_smoke.py`` (default: this checkout) with ``DIR/src``
first on the import path, builds that checkout's kernels, and runs its
phase-1 functions on the inputs ``chip_smoke.py`` makes from the same
seed: every kernel against its plain version, timed on the card.  Then
it times calls whose interface every checkout of the port has, so that
two checkouts compare like with like where their phase 1 differ:
``core.pq.ADCDist``'s call (the distance of an unfused PQ hop, its LUTs
built beforehand) at M=8 and M=96 over a (1,000,000, M) code table and
4,096 lanes of 64 ids, and ``ops.lsh_hash`` at the main path's tripclick
shape (B=256, d=24, L=8).  Prints the card's name and power limit, then
one JSON line ``{"root": ..., "ms": {kernel: device ms}, "shared": {call:
device ms}}``; ``--out`` keeps every number.

Two checkouts run in turns in one machine (A, B, B, A) compare two
versions of the kernels on one card, e.g. a parent commit unpacked with
``git archive`` into ``build/parent`` against this tree.

    python3 kernel_times.py --builds [256,1024]

times, instead of phase 1, what sizes the streaming-ingest phases: a
Vamana build on the card of the first N rows of ``make_medrag_zipf(
d=768)`` at ``IndexSpec(degree=64)``'s parameters for each N (the
searches on the card, RobustPrune on the host), then an upsert of 64
rows into a database over the largest build, on the card and on the
CPU.  Prints one JSON line ``{"builds_s": {N: s}, "upsert64_s": {...}}``.

    python3 kernel_times.py --decode [--root DIR]

times, instead of phase 1 (and without building the kernels), the LM
serve phase's decode step: gemma-2b at its published config, a batch of
2 over a 16-slot cache, 64 steps after 5 warm ones, host clock to a
device sync.  Prints one JSON line ``{"root": ..., "decode_ms": {"median":
..., "min": ..., "p90": ...}}``; checkouts in turns compare serving
across a change to ``models/``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch


def shared_interface_ms(smoke, dev, seed: int) -> dict:
    """Device ms of the calls named in the module docstring, on inputs
    from a generator of their own."""
    from repro_torch.core import pq
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    q = torch.randn((256, 24), generator=gen, device=dev)
    planes = torch.randn((8, 24), generator=gen, device=dev)
    out = {"lsh_hash_b256_d24_l8": smoke.cuda_ms(
        lambda: ops.lsh_hash(q, planes))}
    for m in (8, 96):
        cb = pq.PQCodebook(torch.randn((m, 256, smoke.D // m), generator=gen,
                                       device=dev))
        codes = torch.randint(0, 256, (smoke.N, m), generator=gen,
                              device=dev, dtype=torch.int32)
        queries = torch.randn((smoke.B, smoke.D), generator=gen, device=dev)
        ids = smoke.hop_ids(gen, smoke.N, smoke.B, smoke.C, smoke.L, dev)[0]
        dist = pq.adc_dist_fn(cb, codes)
        dist.luts(queries)                        # built once, then cached
        out[f"adc_dist_m{m}"] = smoke.cuda_ms(lambda: dist(queries, ids))
    return out


def build_times(sizes, dev) -> dict:
    """Wall seconds of the builds and upserts named in the docstring."""
    import time
    from repro_torch import db
    from repro_torch.core.vamana import build_vamana
    from repro_torch.data import make_medrag_zipf
    n_max = max(sizes)
    rows = make_medrag_zipf(n=n_max + 64, d=768).corpus
    params = db.IndexSpec(degree=64).vamana()
    out = {"builds_s": {}, "upsert64_s": {}}
    for n in sizes:
        t0 = time.perf_counter()
        graph = build_vamana(rows[:n], params, device=dev)
        torch.cuda.synchronize()
        out["builds_s"][n] = time.perf_counter() - t0
    spec = db.IndexSpec(degree=64, spare_capacity=64)
    for where in (dev, "cpu"):
        d = db.create(spec, rows[:n_max], prebuilt=graph, device=where)
        t0 = time.perf_counter()
        d.upsert(rows[n_max:])
        out["upsert64_s"][str(where)] = time.perf_counter() - t0
    return out


def decode_times(dev, steps: int = 64) -> dict:
    """Wall ms of the decode steps named in the docstring."""
    import time
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("gemma-2b")
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    walls = []
    with torch.no_grad():
        cache = M.init_cache(cfg, 2, 16, dev)
        toks = torch.full((2, 1), 7, dtype=torch.int32, device=dev)
        for i in range(5 + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.decode_step(cfg, model, toks, cache, 6 + i % 8)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    walls = walls[5:]
    return {"median": float(np.median(walls)), "min": float(np.min(walls)),
            "p90": float(np.percentile(walls, 90))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--builds", default=None, metavar="N,N,...",
                    help="time d=768 Vamana builds of these sizes instead")
    ap.add_argument("--decode", action="store_true",
                    help="time gemma-2b's decode step instead")
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
    if args.decode:
        print(card)
        print(json.dumps({"root": str(root),
                          "decode_ms": decode_times(dev)}))
        return 0
    _build.build_all()
    if args.builds:
        print(card)
        print(json.dumps(build_times(
            [int(n) for n in args.builds.split(",")], dev)))
        return 0

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    vectors = torch.randn((smoke.N, smoke.D), generator=gen, device=dev)
    kernels = smoke.phase_kernels(vectors, gen, dev)
    kernels.update(smoke.phase_pq_kernels(gen, dev))
    kernels["l2_distance"] = smoke.phase_l2_distance(vectors, dev)
    shared = shared_interface_ms(smoke, dev, args.seed)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "root": str(root), "kernels": kernels,
             "shared": shared}, indent=1, default=str))
    print(card)
    print(json.dumps({"root": str(root),
                      "ms": {k: r["ms"] for k, r in kernels.items()},
                      "shared": shared}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
