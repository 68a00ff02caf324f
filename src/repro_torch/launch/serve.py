"""Serving driver: batched generation (continuous batching) with optional
catapult-RAG retrieval in front.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        [--reduced] [--requests 6] [--max-new 8] [--rag] [--device cpu]

Port of ``repro/launch/serve.py``: the same flags and printed lines,
plus ``--device`` (the card by default; ``cpu`` runs the plain PyTorch
path).  The model is drawn from ``torch.Generator`` seed 0 (the
reference's leaf distributions, not its ``jax.random`` draws) and the
prompts from numpy seed 0, as the reference draws them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=6)
    p.add_argument("--rag", action="store_true",
                   help="retrieve context via CatapultDB before decoding")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, args.prompt_len)
               for _ in range(args.requests)]

    if args.rag:
        from repro_torch.serving.rag import RagPipeline
        corpus = np.stack([rng.integers(2, cfg.vocab_size, 8)
                           for _ in range(256)]).astype(np.int32)
        pipe = RagPipeline.build(cfg, params, corpus, mode="catapult")
        out, docs, stats = pipe.answer(
            np.stack(prompts).astype(np.int32), k=2,
            max_new_tokens=args.max_new)
        for i, (o, d) in enumerate(zip(out.tolist(), docs.tolist())):
            print(f"[serve] req {i}: docs={d} tokens={o}")
        print(f"[serve] retrieval catapult usage={stats.used.mean():.2f}")
        return

    eng = ServingEngine(cfg, params, slots=args.slots,
                        max_len=args.prompt_len + args.max_new + 2)
    reqs = [Request(prompt=pr, max_new_tokens=args.max_new)
            for pr in prompts]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in done)
    for i, r in enumerate(done):
        print(f"[serve] req {i}: {r.out.tolist()}")
    print(f"[serve] {len(done)} requests, {total} tokens, "
          f"{total / dt:.1f} tok/s ({args.slots} slots)")


if __name__ == "__main__":
    main()
