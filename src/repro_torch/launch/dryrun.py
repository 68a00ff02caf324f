"""The production mesh's dry run: one rank's step of every cell, counted.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each (arch x shape x mesh) cell's step for the 256-chip (16, 16) mesh,
or (2, 16, 16) multi-pod, on forged devices, and reads the compiled
module's memory, FLOPs and collectives.  Here the process is rank 0 of
a world of 256 or 512 ranks over a fake process group (``fake_pg``:
every collective returns at once and moves nothing) on
``launch.mesh.make_production_mesh``; the rank's parameters, AdamW
moments (ZeRO-1, ``adamw.zero1_pspecs``), batch and decode cache are
fake tensors of its local shapes (``FakeTensorMode``: nothing is
allocated), and it runs the train, prefill or decode step of
``models/steps.py`` once inside ``launch.op_walk``.  Every rank runs
the same program, so rank 0's counts stand for all.  Per cell:

  * ``op_walk``'s peak bytes on the rank (parameters, moments, batch
    and cache, plus the live intermediates) against the card's memory
    (``roofline.HBM_PER_CARD``: ``fits_hbm``);
  * ``roofline.analyze``: FLOPs (aten's matrix products and the
    kernels'), the analytic HBM bytes, the collectives' bytes by kind,
    the dominant term.

A cell whose arch the port cannot cut on the mesh (``launch.train.
refuse``) reports ``"status": "refused"`` with the reason, as a shape
the arch skips reports ``"skipped"``.  ``catapultdb x search`` cannot
run on fake tensors (the search reads the medoid and the step as ints,
syncs a flag each hop and publishes on the host), so it runs one rank's
step (``core.sharded.make_sharded_search``) on real tensors: a
``configs/catapultdb`` shard of random vectors with a seeded random
degree-R adjacency and the rank's block of the query batch, through
the ``lsh_hash`` and ``gather_distance`` kernels on the card.

CLI:
    python -m repro_torch.launch.dryrun --arch gemma2-27b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch catapultdb --shape search
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
        [--out DIR] [--jobs N] [--device cuda|cpu] [--layers N]
  ``--all`` runs every cell in a subprocess of its own, ``--jobs`` of
  them at once (the fake runs are host work).  ``--device``:
  the card by default (the fakes are CUDA tensors; the search cell's
  shard lives on the card), ``cpu`` for fakes on the CPU and the search
  at ``catapultdb.reduced()`` size.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from math import prod

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (P, axis_sizes, batch_axes,
                                     local_slice, make_production_mesh,
                                     tree_map)
from repro_torch.launch.op_walk import op_walk
from repro_torch.launch.train import RankPlan
from repro_torch.models import model as M
from repro_torch.models.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.optim import adamw

GiB = 2 ** 30


def opt_config(cfg) -> adamw.AdamWConfig:
    """arctic-480b: bf16 moments (f32 moments alone would not fit)."""
    if cfg.name == "arctic-480b":
        return adamw.AdamWConfig(moment_dtype="bfloat16")
    return adamw.AdamWConfig()


def _extend_fsdp(pspecs, mesh):
    """The FSDP leaves' ``data`` entries widened to ``("pod", "data")``
    on the multi-pod mesh, so the experts' weights shard over every
    data-parallel rank (the reference's tuple ``("data",)``; ``P``
    normalizes it to ``"data"``, the only use of that axis in a
    parameter's spec)."""
    if "pod" not in axis_sizes(mesh):
        return pspecs
    return tree_map(lambda spec: P(*(("pod", "data") if e == "data" else e
                                     for e in spec)), pspecs)


def fake_world(world: int) -> None:
    """Rank 0 of a ``world``-rank process group whose collectives move
    nothing (``torch.testing._internal.distributed.fake_pg``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake_model(cfg, plan, device):
    """A ``Model`` whose parameters are fakes of the rank's slices."""
    model = M.Model(cfg, "meta")
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        shape = local_slice(p.detach(), plan.param_specs[name],
                            plan.mesh).shape
        setattr(model.get_submodule(owner) if owner else model, leaf,
                torch.nn.Parameter(torch.empty(shape, dtype=p.dtype,
                                               device=device)))
    model._device = device
    return model


def _batch(cfg, b: int, s: int, device) -> dict:
    """A batch of ``b`` rows of ``s`` positions (fakes when called under
    ``FakeTensorMode``), with the family's stub frontend inputs."""
    tok = lambda n: torch.zeros((b, n), dtype=torch.int32,  # noqa: E731
                                device=device)
    out = {"tokens": tok(s)}
    if cfg.family == "vlm":
        out["tokens"] = tok(s - cfg.n_frontend_tokens)
        out["patches"] = torch.zeros((b, cfg.n_frontend_tokens,
                                      cfg.frontend_dim), device=device)
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((b, s, cfg.frontend_dim), device=device)
    return out


def _leaves(tree) -> list:
    out = []
    tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor)
             else None, tree)
    return out


def input_specs(cfg, shape_name: str, mesh, device, fake_mode):
    """One cell's step on this rank, over fakes of its local shapes made
    in ``fake_mode`` (a ``FakeTensorMode``, under which the step must
    run).  Returns (fn, args, the tensors live through the step,
    model_flops, hbm_bytes): ``fn(*args)`` runs it.  Raises
    ``ValueError`` where the arch does not cut on ``mesh``
    (``launch.train.refuse``)."""
    seq_len, global_batch, kind = SHAPES[shape_name]
    sizes = axis_sizes(mesh)
    n_blocks = prod(sizes[a] for a in batch_axes(mesh))
    plan = RankPlan(cfg, mesh, _extend_fsdp(M.pspecs(cfg), mesh))
    groups = plan.groups
    if "pod" in sizes:                   # the FSDP leaves span pod x data
        groups = groups._replace(fsdp=groups.batch,
                                 fsdp_size=groups.batch_size)
    with fake_mode:
        return _step_on_fakes(cfg, plan, groups, seq_len, global_batch,
                              kind, n_blocks, mesh, device)


def _step_on_fakes(cfg, plan, groups, seq_len, global_batch, kind,
                   n_blocks, mesh, device):
    model = _fake_model(cfg, plan, device)
    params = list(model.parameters())
    # a global batch of 1 is replicated over the batch axes (P())
    local = global_batch // n_blocks if global_batch > 1 else 1
    mf = rl.model_flops(cfg, kind, seq_len, global_batch)
    hbm = rl.analytic_hbm_bytes(cfg, kind, seq_len, global_batch)

    if kind == "train":
        ocfg = opt_config(cfg)
        zero1 = plan.zero1()
        opt = adamw.init(dict(model.named_parameters()), ocfg.moment_dtype,
                         zero1=zero1)
        batch = _batch(cfg, local, seq_len, device)
        fn = make_train_step(cfg, ocfg, groups=groups, zero1=zero1)
        live = params + _leaves(opt.mu) + _leaves(opt.nu) + _leaves(batch)
        return fn, (model, opt, batch), live, mf, hbm

    groups = groups._replace(kv_split=global_batch == 1 and n_blocks > 1)
    cache = M.init_cache(cfg, global_batch, seq_len, device, mesh=mesh)
    live = params + _leaves(cache)
    if kind == "prefill":
        batch = _batch(cfg, local, seq_len, device)
        return (make_prefill_step(cfg, groups=groups), (model, batch, cache),
                live + _leaves(batch), mf, hbm)
    # decode: one new token against a seq_len cache, at its last slot
    tokens = torch.zeros((local, 1), dtype=torch.int32, device=device)
    return (make_decode_step(cfg, groups=groups),
            (model, tokens, cache, seq_len - 1), live + [tokens], mf, hbm)


def catapultdb_specs(mesh, device, engine=None, seed: int = 0):
    """The paper's own cell: one rank's catapulted search step on real
    tensors (its shard of ``engine``'s corpus, random vectors and a
    random degree-R adjacency from ``seed``, an empty bucket table).
    Returns (fn, args, live tensors, model_flops, hbm_bytes) as
    ``input_specs``."""
    from repro_torch.configs.catapultdb import CONFIG
    from repro_torch.core.beam_search import SearchSpec
    from repro_torch.core.sharded import (ShardedEngineState,
                                          make_sharded_search)
    e = engine or CONFIG
    g = torch.Generator(device=device).manual_seed(seed)
    n, r = e.n_vectors, e.max_degree
    rows = 2 ** e.lsh_bits
    empty = lambda: torch.full((rows, e.bucket_capacity), -1,  # noqa: E731
                               dtype=torch.int32, device=device)
    state = ShardedEngineState(
        vectors=torch.randn((n, e.dim), generator=g, device=device),
        adjacency=torch.randint(0, n, (n, r), generator=g, device=device,
                                dtype=torch.int32),
        medoids=torch.zeros(1, dtype=torch.int32, device=device),
        hyperplanes=torch.randn((e.lsh_bits, e.dim), generator=g,
                                device=device),
        bucket_ids=empty(), bucket_stamp=empty(),
        bucket_step=torch.zeros(1, dtype=torch.int32, device=device))
    queries = torch.randn((e.query_batch, e.dim), generator=g, device=device)
    spec = SearchSpec(beam_width=e.beam_width, k=e.k, max_iters=e.max_iters)
    step = make_sharded_search(mesh, spec, n, e.lsh_bits)
    # FLOPs of useful work: beam hops x degree x dim MACs per query
    mf = 2.0 * e.query_batch * e.max_iters * e.max_degree * e.dim
    # HBM: per hop gather R x (d vector + adjacency row) + beam state churn
    hbm = (e.query_batch * e.max_iters
           * (e.max_degree * (e.dim * 4 + 4) + e.beam_width * 16)
           + e.query_batch * e.bucket_capacity * 8)
    return step, (state, queries), list(state) + [queries], mf, hbm


def _mesh_name(multi_pod: bool) -> str:
    return "multi_pod" if multi_pod else "single_pod"


def run_cell(arch: str, shape: str, multi_pod: bool, device="cuda",
             layers: int | None = None) -> dict:
    """One cell on this process, which must not have a world yet (it
    starts the fake one).  ``device``: the card (fakes need no card, the
    search cell's tensors do) or the CPU (the search at ``reduced()``
    size).  ``layers``: the arch's depth cut to that many layers (its
    widths kept; the result's ``n_layers`` says so)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = resolve_device(device)
    head = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod)}
    if arch != "catapultdb":
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
            head["n_layers"] = layers
        if shape in cfg.skip_shapes:
            return dict(head, status="skipped",
                        reason="inapplicable shape (DESIGN.md "
                               "§Arch-applicability)")
    fake_world(512 if multi_pod else 256)
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        if arch == "catapultdb":
            from repro_torch.configs import catapultdb
            engine = catapultdb.CONFIG if dev.type == "cuda" \
                else catapultdb.reduced()
            fn, args, live, mf, hbm = catapultdb_specs(mesh, dev, engine)
            with op_walk(live=live) as walked:
                fn(*args)
        else:
            fake = FakeTensorMode()
            try:
                fn, args, live, mf, hbm = input_specs(cfg, shape, mesh, dev,
                                                      fake)
            except ValueError as err:       # launch.train.refuse
                return dict(head, status="refused", reason=str(err))
            with fake, op_walk(live=live) as walked:
                fn(*args)
        terms = rl.analyze(walked, mesh.size(), model_flops=mf,
                           hbm_bytes=hbm)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    argument = sum(t.untyped_storage().nbytes() for t in
                   {id(t.untyped_storage()): t for t in live}.values())
    peak = walked["peak_bytes"]
    return dict(
        head, chips=mesh.size(), status="ok",
        compile_s=round(time.time() - t0, 1),
        memory={"argument_bytes": argument, "output_bytes": None,
                "temp_bytes": peak - argument, "alias_bytes": None,
                "code_bytes": None, "peak_bytes_per_chip": peak,
                "fits_hbm": bool(peak <= rl.HBM_PER_CARD)},
        walk={k: walked[k] for k in ("dot_flops", "kernel_flops",
                                     "kernel_breakdown")},
        roofline=terms.as_dict())


def all_cells():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape
    yield "catapultdb", "search"


def summary(res: dict) -> str:
    cut = f" ({res['n_layers']} layers)" if "n_layers" in res else ""
    line = (f"[dryrun] {res['arch']}{cut}×{res['shape']}×{res['mesh']}: "
            f"{res['status']}")
    if res["status"] == "ok":
        peak = res["memory"]["peak_bytes_per_chip"]
        line += (f" peak={peak / GiB:.2f}GiB/chip "
                 f"fits={res['memory']['fits_hbm']} "
                 f"dominant={res['roofline']['dominant']} "
                 f"compile={res['compile_s']}s")
    elif res["status"] == "refused":
        line += f" ({res['reason']})"
    return line


def _slow_first(cell) -> bool:
    """Sort key: the mamba stacks' train and prefill cells first (their
    chunked scans run hundreds of thousands of ops on fakes, minutes of
    host time each), so ``--jobs`` workers start them at once."""
    arch, shape, _ = cell
    return not (arch in ARCH_IDS and get_config(arch).family in
                ("ssm", "hybrid") and SHAPES[shape][2] != "decode")


def _run_subprocess(arch: str, shape: str, mp: bool, args):
    """(tag, the line to print, whether it ran) of one cell run in a
    subprocess of its own (``--all``); a cell whose JSON is under
    ``args.out`` is cached."""
    tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
    dest = os.path.join(args.out, tag + ".json")
    if os.path.exists(dest):
        return tag, f"[dryrun] {tag}: cached", True
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", dest, "--device", args.device]
    if mp:
        cmd.append("--multi-pod")
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        return tag, (f"[dryrun] {tag}: FAILED\n{r.stdout[-2000:]}"
                     f"\n{r.stderr[-2000:]}"), False
    return tag, r.stdout.strip().splitlines()[-1], True


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--out", default="build/dryrun")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--jobs", type=int, default=1,
                   help="--all: cells run at once, each in its process")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the arch's depth to this many layers")
    args = p.parse_args(argv)
    resolve_device(args.device)          # raises without a card

    if args.all:
        os.makedirs(args.out, exist_ok=True)
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        cells = sorted(((arch, shape, mp) for arch, shape in all_cells()
                        for mp in meshes), key=_slow_first)
        failures = []
        with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
            for done in as_completed([pool.submit(_run_subprocess, *c, args)
                                      for c in cells]):
                tag, line, ok = done.result()
                print(line, flush=True)
                if not ok:
                    failures.append(tag)
        print(f"[dryrun] done; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    res = run_cell(args.arch, args.shape, args.multi_pod, args.device,
                   args.layers)
    print(summary(res))
    if args.out and args.out.endswith(".json"):
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    elif args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = (f"{args.arch}__{args.shape}__"
               f"{'mp' if args.multi_pod else 'sp'}")
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
