"""Prefill and decode across ranks: the port's mesh serve steps against
its one-device steps, on the CPU.

The reference serves under any mesh through GSPMD, so its mesh prefill
and decode compute the one-device functions.  The port holds each
rank's slices (``launch.train.RankPlan``), its rows of the batch and its
block of the decode cache (``models.model.init_cache(..., mesh=)``),
and runs the models' collectives under ``parallel_context`` (the serve
steps' ``groups``); the logits it returns are its vocab columns.

One gloo world of 4 ranks (``RANKS_SCRIPT``, one torch thread a rank,
run by ``subprocess.run`` with a time limit) runs every case on a
(2, 2) mesh: prefill of a batch of 4 prompts of 8 positions, then 3
decode steps, into a cache of 16 positions, for reduced f32 gemma-2b
(its one KV head cut inside at ``model`` = 2), falcon-mamba-7b,
zamba2-7b, internvl2-26b and seamless-m4t-large-v2, and gemma2-27b with
a global batch of 1 (replicated over ``data``; the cache's positions
split over it: ``attention.split_cache_attention``).  The MoE family:
deepseek-moe-16b on a (4, 1) mesh (the routing over the global batch),
and on (2, 2) without its shared experts: under ``model`` above 1 the
reference's expert-parallel branch cuts a shared MLP's ``[gate | up]``
into contiguous blocks (ROADMAP's quirks), which is not the one-device
function, and the port keeps that cut.  This process computes the
one-device twins from the same seed-0 init.  The gathered logits agree
within ``LOGIT_TOL`` of their largest magnitude (PR 21-22's forward
tolerance), and every cache leaf, each rank's block gathered into the
one-device layout, within the same share.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.models import model as TM
from repro_torch.models.steps import make_decode_step, make_prefill_step

from test_torch_ingest import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, MAXLEN, STEPS = 4, 8, 16, 3
LOGIT_TOL = 5e-5
WORLD_TIMEOUT = 300
# (case, arch, global batch, mesh, config changes)
CASES = (("dense", "gemma-2b", B, (2, 2), {}),
         ("moe", "deepseek-moe-16b", B, (2, 2), {"n_shared_experts": 0}),
         ("moe_dp", "deepseek-moe-16b", B, (4, 1), {}),
         ("ssm", "falcon-mamba-7b", B, (2, 2), {}),
         ("hybrid", "zamba2-7b", B, (2, 2), {}),
         ("vlm", "internvl2-26b", B, (2, 2), {}),
         ("encdec", "seamless-m4t-large-v2", B, (2, 2), {}),
         ("split_kv", "gemma2-27b", 1, (2, 2), {}))

# argv: the world's own directory (its store, rank<r>.npz written there)
RANKS_SCRIPT = r"""
import os, sys

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.environ["SERVE_TESTS"])
from test_torch_dist_serve import CASES, MAXLEN, case_config, inputs, serve


def rank_main(rank, world, own):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch import mesh as tm
    from repro_torch.launch.train import RankPlan
    from repro_torch.models import model as M
    tm.init_world("cpu", init_method=f"file://{own}/store", rank=rank,
                  world_size=world)
    res = {}
    try:
        meshes = {shape: tm.make_local_mesh(*shape, "cpu")
                  for shape in sorted({c[3] for c in CASES})}
        for case, arch, b, shape, cut in CASES:
            cfg = case_config(arch, cut)
            mesh = meshes[shape]
            plan = RankPlan(cfg, mesh)
            model = plan.shard(M.init(cfg, torch.Generator().manual_seed(0),
                                      "cpu"))
            batch, toks = inputs(cfg, b)
            if b > 1:
                batch = tm.local_batch(batch, mesh)
                toks = np.stack([tm.local_batch({"t": t}, mesh)["t"]
                                 for t in toks])
            groups = plan.groups._replace(
                kv_split=b == 1 and plan.groups.batch_size > 1)
            cache = M.init_cache(cfg, b, MAXLEN, "cpu", mesh=mesh)
            logits, cache = serve(cfg, model, batch, toks, cache, groups)
            res[f"{case}/logits"] = logits.numpy()
            for name, t in flat(cache).items():
                res[f"{case}/cache/{name}"] = t.numpy()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(own, f"rank{rank}.npz"), **res)


def flat(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


if __name__ == "__main__":
    mp.spawn(rank_main, args=(4, sys.argv[1]), nprocs=4)
"""


def case_config(arch, cut):
    return dataclasses.replace(get_reduced(arch), dtype="float32", **cut)


def inputs(cfg, b):
    """(the prompt batch of ``b`` rows, the (STEPS, b, 1) decode tokens)
    from numpy seed 0: S positions in all (the vlm's patches first)."""
    rng = np.random.default_rng(0)
    text = S - (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, text))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(b, cfg.n_frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, S, cfg.frontend_dim)) \
            .astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (STEPS, b, 1)).astype(np.int32)
    return out, toks


def serve(cfg, model, batch, toks, cache, groups):
    """Prefill, then a decode step for each row of ``toks``: (the logits
    of every step (b, 1 + STEPS, V), the cache)."""
    prefill = make_prefill_step(cfg, groups=groups)
    decode = make_decode_step(cfg, groups=groups)
    logits, cache = prefill(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, cache)
    out = [logits.clone()]
    for i, t in enumerate(toks):
        logits, cache = decode(model, torch.from_numpy(t), cache, S + i)
        out.append(logits.clone())
    return torch.cat(out, dim=1), cache


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    own = tmp_path_factory.mktemp("dist_serve")
    script = own / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               SERVE_TESTS=str(ROOT / "tests"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(own)], env=env,
                       capture_output=True, text=True, timeout=WORLD_TIMEOUT,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = []
    for rank in range(4):
        with np.load(own / f"rank{rank}.npz") as z:
            out.append(dict(z))
    return out


def _share(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rank_of(shape, d, m):
    return d * shape[1] + m


def _gather(world, key, shape, spec, full_shape):
    """The full leaf from the ranks' blocks of ``key`` (block (d, m) at
    rank d * model + m): each spec entry's axes cut its dim; a batch of 1
    is the same on every data rank."""
    n_data, n_model = shape
    blocks = {}
    for d in range(n_data):
        for m in range(n_model):
            blocks[d, m] = world[_rank_of(shape, d, m)][key]
    dims = {"data": None, "model": None}
    for dim, e in enumerate(spec):
        if e in dims:
            dims[e] = dim
    rows = []
    for d in range(n_data):
        parts = [blocks[d, m] for m in range(n_model)]
        row = (np.concatenate(parts, dims["model"])
               if dims["model"] is not None else parts[0])
        rows.append(row)
    full = (np.concatenate(rows, dims["data"]) if dims["data"] is not None
            else rows[0])
    assert full.shape == tuple(full_shape), (key, full.shape, full_shape)
    return full


@pytest.fixture(scope="module")
def one_device():
    """{case: (logits, {cache leaf: array})} of the one-device steps."""
    torch.set_num_threads(1)
    out = {}
    for case, arch, b, _, cut in CASES:
        cfg = case_config(arch, cut)
        model = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
        batch, toks = inputs(cfg, b)
        logits, cache = serve(cfg, model, batch, toks,
                              TM.init_cache(cfg, b, MAXLEN, "cpu"), None)
        flat = {}
        _flatten(cache, "", flat)
        out[case] = (logits.numpy(), flat)
    return out


def _flatten(cache, prefix, out):
    for k, v in cache.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = v.numpy()


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_logits_across_ranks_equal_one_device(world, one_device, case):
    _, arch, b, shape, cut = next(c for c in CASES if c[0] == case)
    want, _ = one_device[case]
    spec = ("data" if b > 1 else None, None, "model")
    got = _gather(world, f"{case}/logits", shape, spec, want.shape)
    vocab = case_config(arch, cut).vocab_size
    assert _share(got[..., :vocab], want[..., :vocab]) <= LOGIT_TOL
    if b == 1:                   # replicated over data: the same rows
        for m in range(shape[1]):
            np.testing.assert_array_equal(
                world[_rank_of(shape, 0, m)][f"{case}/logits"],
                world[_rank_of(shape, 1, m)][f"{case}/logits"])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_caches_across_ranks_equal_one_device(world, one_device, case):
    _, arch, b, shape, cut = next(c for c in CASES if c[0] == case)
    cfg = case_config(arch, cut)
    _, want = one_device[case]
    sizes = {"data": shape[0], "model": shape[1]}
    specs = TM.cache_pspecs(cfg, b, MAXLEN, ("data",), shape[1])
    flat_specs = {}
    _flatten_specs(specs, "", flat_specs)
    for name, full in want.items():
        key = f"{case}/cache/{name}"
        leaf = name.split("/")[-1]
        spec = tuple(flat_specs.get(name, ()))
        if leaf in ("xk", "xv"):       # the encoder's K/V, set by prefill
            spec = (None, "data" if b > 1 else None, None, "model")
        if leaf in TM._KV_LEAVES and cfg.n_kv_heads % shape[1]:
            # the rank's one whole KV head, the same on every model rank
            spec = tuple(e if e != "model" else None for e in spec)
        got = _gather(world, key, shape, spec, full.shape)
        if leaf == "conv" and cfg.family == "hybrid":
            di, n = cfg.d_inner, cfg.ssm_state
            got = convert.sections_from_rank_layout(
                torch.from_numpy(got), (di, n, n), sizes["model"]).numpy()
        assert _share(got, full) <= LOGIT_TOL, (name, _share(got, full))


def _flatten_specs(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten_specs(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = tuple(v)
