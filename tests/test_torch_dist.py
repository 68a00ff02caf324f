"""The mesh over ``torch.distributed`` against the reference on the CPU.

The reference's multi-device runs forge 8 host devices in subprocesses
(``XLA_FLAGS`` must precede their JAX import, as in
``tests/test_sharded_engine.py``), started by an autouse module fixture
so they run beside the checks below:

* ``REF_SEARCH``: the (2, 4) mesh search over ``test_sharded_engine``'s
  corpus and queries, three steps from one state (the port's
  ``build_sharded_state``: the reference's own four Vamana builds would
  take most of a minute; the two packages' builds agree on >= 99% of
  rows, ``test_torch_sharded.py``);
* ``REF_MOE``: ``moe_layer`` under a (1, 2) and a (2, 2) mesh on
  reduced deepseek-moe-16b and arctic-480b (f32; the port's ``init``
  carried to the reference's tree by ``convert.model_params_to_numpy``),
  and a reduced deepseek-moe prefill plus two decode steps under each.

The port's worlds are gloo process groups, one rank per process on one
torch thread (``RANKS_SCRIPT``, run by ``subprocess.run`` with a time
limit, so a hang fails one test): a world of 8 on a (2, 4) mesh runs the
search, each rank on its ``shard_state``; its ids, distances and every
rank's bucket block and step must be bit-equal to the port's one-card
tuple step on the same state, and its ids equal to the reference's; a
world of 4 checks ``placements`` (a dim over two axes is data-major),
``reshard`` then ``full_tensor()`` bit for bit, ``restore(shardings=
build_shardings(...))`` of a checkpoint the reference's
``ft/checkpoint.save`` wrote (each rank's local shard the matching slice
of the leaf, ZeRO-1 moments split over ``data``), and the MoE branch on
a (2, 2) mesh of all four ranks and a (1, 2) mesh from
``make_mesh_from_plan`` over the first two: within ``MOE_TOL`` of the
largest magnitude of the reference's branch.

Without processes: ``model.pspecs``, ``zero1_pspecs`` and the cache
pspecs leaf for leaf with the reference's for all ten reduced archs
(specs compared as tuples), ``engine_state_specs`` (shapes and specs),
``placements``' refusals, ``make_production_mesh`` in a small world, and
``train`` refusing plain axis sizes and meshes an arch does not cut.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys
from math import prod

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ARCH_IDS, get_reduced
from repro.core import sharded as jsh
from repro.ft import checkpoint as jckpt
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.core import sharded as tsh
from repro_torch.core.beam_search import SearchSpec
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import P
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw

from test_torch_ingest import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_ARCHS = ("deepseek-moe-16b", "arctic-480b")
MESHES = {"m12": (1, 2), "m22": (2, 2)}
MOE_X = (4, 8)                 # (B, S) of the moe_layer input
LM_B, LM_S, LM_STEPS = 2, 8, 2
MOE_TOL = 1e-5
CKPT_ARCH = "gemma-2b"
WORLD_TIMEOUT = 300

# argv: inputs .npz (the state, queries), output .npz
REF_SEARCH = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.beam_search import SearchSpec
from repro.core.sharded import (ShardedEngineState, make_sharded_search,
                                mesh_context)

inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((2, 4), ("data", "model"))
st = ShardedEngineState(*[jnp.asarray(inp[f"state/{n}"])
                          for n in ShardedEngineState._fields])
# jitted, so that it compiles once (an eager call traces and compiles
# again on every step)
step = jax.jit(make_sharded_search(mesh, SearchSpec(beam_width=12, k=5,
                                                    max_iters=64), 400, 4))
out = {}
with mesh_context(mesh):
    jq = jax.device_put(jnp.asarray(inp["queries"]),
                        NamedSharding(mesh, P("data", None)))
    for rep in range(3):
        st, ids, dists = step(st, jq)
        out[f"ids{rep}"] = np.asarray(ids)
        out[f"dists{rep}"] = np.asarray(dists)
np.savez(sys.argv[2], **out)
"""

# argv: inputs .npz (x, tokens), output .npz
REF_MOE = r"""
import contextlib, dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import mesh_context
from repro.configs.base import get_reduced
from repro.models import model as M
from repro.models.moe import moe_layer

inp = dict(np.load(sys.argv[1]))
out = {}
# Auto axes: the model's best-effort sharding constraints (maybe_shard)
# are hints there, as the reference's model code expects them to be
auto = (jax.sharding.AxisType.Auto,) * 2
for arch in ("deepseek-moe-16b", "arctic-480b"):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = {}
    for key, v in inp.items():
        if key.startswith(f"{arch}/params/"):
            node = params
            parts = key.split("/")[2:]
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = jnp.asarray(v)
    moe = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["moe"])
    x = jnp.asarray(inp[f"{arch}/x"])
    f = jax.jit(lambda p, x: moe_layer(p, x, cfg, mlp_kind=cfg.mlp))
    y, aux = f(moe, x)
    out[f"none/{arch}/y"], out[f"none/{arch}/aux"] = y, aux
    for tag, shape in (("m12", (1, 2)), ("m22", (2, 2))):
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=auto)
        with mesh_context(mesh):
            f = jax.jit(lambda p, x: moe_layer(p, x, cfg, mlp_kind=cfg.mlp))
            y, aux = f(moe, x)
        out[f"{tag}/{arch}/y"], out[f"{tag}/{arch}/aux"] = y, aux
    if arch != "deepseek-moe-16b":
        continue
    b, s = inp["tokens"].shape
    steps = inp["steps"]
    for tag, shape in (("none", None), ("m12", (1, 2)), ("m22", (2, 2))):
        mesh = (jax.make_mesh(shape, ("data", "model"), axis_types=auto)
                if shape else None)
        with (mesh_context(mesh) if mesh else contextlib.nullcontext()):
            cache = M.init_cache(cfg, b, s + len(steps))
            logits, cache = jax.jit(lambda p, t, c: M.prefill(
                cfg, p, {"tokens": t}, c, remat=False))(
                params, jnp.asarray(inp["tokens"]), cache)
            out[f"{tag}/prefill"] = logits
            dec = jax.jit(lambda p, t, c, pos: M.decode_step(cfg, p, t, c,
                                                             pos))
            for i, t in enumerate(steps):
                logits, cache = dec(params, jnp.asarray(t), cache,
                                    jnp.int32(s + i))
                out[f"{tag}/decode{i}"] = logits
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""

# argv: world size, the directory of inputs.npz and ckpt/, the world's
# own directory (its store, rank<r>.npz written there)
RANKS_SCRIPT = r"""
import dataclasses, os, sys
from math import prod

import numpy as np
import torch
import torch.multiprocessing as mp


def flat_to_tree(z, prefix):
    tree = {}
    for key, v in z.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = tree
        for q in parts[:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = v
    return tree


def expected_slice(full, spec, coord, sizes):
    # the rank's block, computed apart from the port's local_slice
    idx = []
    entries = tuple(spec) + (None,) * (full.ndim - len(spec))
    for dim, e in enumerate(entries):
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        n, k = 1, 0
        for a in axes:
            n, k = n * sizes[a], k * sizes[a] + coord[a]
        c = full.shape[dim] // n
        idx.append(slice(k * c, (k + 1) * c))
    return full[tuple(idx)]


def world8(rank, res, z, mesh):
    from repro_torch.core import sharded as sh
    from repro_torch.core.beam_search import SearchSpec
    state = sh.ShardedEngineState(*[torch.from_numpy(z[f"state/{n}"])
                                    for n in sh.ShardedEngineState._fields])
    local = sh.shard_state(state, mesh)
    step = sh.make_sharded_search(
        mesh, SearchSpec(beam_width=12, k=5, max_iters=64), 400, 4)
    q = torch.from_numpy(z["queries"])
    for rep in range(3):
        local, ids, d = step(local, q)
        res[f"ids{rep}"], res[f"dists{rep}"] = ids.numpy(), d.numpy()
        for name in ("bucket_ids", "bucket_stamp", "bucket_step"):
            res[f"{name}{rep}"] = getattr(local, name).numpy()


def moe_and_lm(res, z, mesh, tag):
    from repro_torch import convert
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import model as M
    from repro_torch.models.moe import moe_layer
    for arch in ("deepseek-moe-16b", "arctic-480b"):
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        model = convert.model_params_from_numpy(
            cfg, flat_to_tree(z, f"{arch}/params"), "cpu")
        with torch.no_grad(), mesh_context(mesh):
            y, aux = moe_layer(model.layers[0].moe,
                               torch.from_numpy(z[f"{arch}/x"]), cfg,
                               mlp_kind=cfg.mlp)
        res[f"{tag}/{arch}/y"], res[f"{tag}/{arch}/aux"] = y.numpy(), \
            aux.numpy()
        if arch != "deepseek-moe-16b":
            continue
        tokens, steps = z["tokens"], z["steps"]
        cache = M.init_cache(cfg, tokens.shape[0],
                             tokens.shape[1] + len(steps), "cpu")
        with mesh_context(mesh):
            logits, cache = M.prefill(cfg, model, {
                "tokens": torch.from_numpy(tokens)}, cache)
            res[f"{tag}/prefill"] = logits.numpy()
            for i, t in enumerate(steps):
                logits, cache = M.decode_step(cfg, model,
                                              torch.from_numpy(t), cache,
                                              tokens.shape[1] + i)
                res[f"{tag}/decode{i}"] = logits.numpy()


def world4(rank, res, z, mesh, plan_mesh, ckpt_dir):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import convert
    from repro_torch.configs import get_reduced
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.ft.elastic import reshard
    from repro_torch.launch import mesh as tm
    from repro_torch.launch.train import build_shardings
    from repro_torch.launch.mesh import NamedSharding, P
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWState
    sizes = tm.axis_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    # a dim over two axes: data-major, as JAX lays it out
    t = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    spec = P(("data", "model"), None)
    res["data_major"] = distribute_tensor(
        t, mesh, tm.placements(spec, mesh, t.shape)).to_local().numpy()
    res["data_major_slice"] = tm.local_slice(t, spec, mesh).numpy()
    # restore(shardings=...) of the reference's checkpoint
    cfg = get_reduced("gemma-2b")
    layout = convert.stack_tree({n: torch.empty(0) for n, _ in
                                 M.Model(cfg, "meta").named_parameters()})
    example = {"params": layout,
               "opt": AdamWState(mu=layout, nu=layout, step=0)}
    full, step = ckpt.restore(ckpt_dir, example)
    param_sh, opt_sh = build_shardings(cfg, mesh)
    shards = {"params": param_sh,
              "opt": AdamWState(mu=opt_sh, nu=opt_sh,
                                step=NamedSharding(mesh, P()))}
    placed, step2 = ckpt.restore(ckpt_dir, example, shardings=shards)
    bad, n = [], 0
    pairs = ckpt._flatten(full), ckpt._flatten(placed), \
        ckpt._flatten(shards)
    for f, dt, sh in zip(*pairs):
        n += 1
        want = expected_slice(f, sh.spec, coord, sizes)
        if not torch.equal(dt.to_local(), want):
            bad.append(n)
        if not torch.equal(dt.full_tensor(), f):
            bad.append(-n)
    res["restore_bad"] = np.asarray(bad, np.int64)
    res["restore_leaves"] = n
    res["restore_step"] = step2
    res["opt_sharded_over_data"] = sum(
        any(e == "data" or (isinstance(e, tuple) and "data" in e)
            for e in s.spec) for s in ckpt._flatten(opt_sh))
    # reshard, then full_tensor(), bit for bit
    tree = full["params"]
    placed = reshard(tree, M.pspecs(cfg), mesh)
    res["reshard_equal"] = all(
        torch.equal(d.full_tensor(), f) for d, f in
        zip(ckpt._flatten(placed), ckpt._flatten(tree)))
    moe_and_lm(res, z, mesh, "m22")
    if plan_mesh.get_coordinate() is not None:
        moe_and_lm(res, z, plan_mesh, "m12")


def rank_main(rank, world, inputs, own):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.ft.elastic import MeshPlan, make_mesh_from_plan
    from repro_torch.launch import mesh as tm
    tm.init_world("cpu", init_method=f"file://{own}/store",
                  rank=rank, world_size=world)
    res = {}
    try:
        z = dict(np.load(os.path.join(inputs, "inputs.npz")))
        if world == 8:
            world8(rank, res, z, tm.make_local_mesh(2, 4, "cpu"))
        else:
            mesh = tm.make_local_mesh(2, 2, "cpu")
            plan_mesh = make_mesh_from_plan(MeshPlan(1, 2, world - 2),
                                            "cpu")
            world4(rank, res, z, mesh, plan_mesh,
                   os.path.join(inputs, "ckpt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(own, f"rank{rank}.npz"), **res)


if __name__ == "__main__":
    world, inputs, own = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mp.spawn(rank_main, args=(world, inputs, own), nprocs=world)
"""


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _flat(tree, prefix) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _share(got, want) -> float:
    """max |got - want| as a share of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tuples(tree):
    """A spec tree with every spec as a plain tuple (None stays None)."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return None if tree is None else tuple(tree)


def _start(script, *args):
    return subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=str(ROOT))


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("dist")


@pytest.fixture(scope="module", autouse=True)
def ref_runs(scratch):
    """The inputs that the reference's two forged-device runs and the
    port's worlds share, and the reference's runs, started when the
    module's first test sets up (the tests that need them come last):
    the MoE archs' parameters (f32), inputs and tokens, and a checkpoint
    the reference's ``save`` wrote, then ``REF_MOE`` starts; the sharded
    state and queries, then ``REF_SEARCH`` starts."""
    rng = np.random.default_rng(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    procs = {}
    try:
        inp = {}
        for arch in MOE_ARCHS:
            cfg = _f32(t_get_reduced(arch))
            model = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
            inp.update(_flat(convert.model_params_to_numpy(model),
                             f"{arch}/params"))
            inp[f"{arch}/x"] = rng.normal(size=MOE_X + (cfg.d_model,)) \
                .astype(np.float32)
        vocab = get_reduced("deepseek-moe-16b").vocab_size
        inp["tokens"] = rng.integers(0, vocab, (LM_B, LM_S)).astype(np.int32)
        inp["steps"] = rng.integers(0, vocab, (LM_STEPS, LM_B, 1)) \
            .astype(np.int32)
        np.savez(scratch / "moe_inputs.npz", **inp)
        procs["moe"] = _start(REF_MOE, scratch / "moe_inputs.npz",
                              scratch / "ref_moe.npz")
        # the checkpoint: gemma-2b's reduced parameters (bf16) and random
        # f32 moments, so that every slice is distinct
        model = TM.init(t_get_reduced(CKPT_ARCH),
                        torch.Generator().manual_seed(1), "cpu")
        params = convert.model_params_to_numpy(model)
        draw = lambda a: rng.normal(size=a.shape).astype(np.float32)
        jckpt.save(str(scratch / "ckpt"), {
            "params": params,
            "opt": jadamw.AdamWState(mu=jax.tree_util.tree_map(draw, params),
                                     nu=jax.tree_util.tree_map(draw, params),
                                     step=np.int32(7))}, step=7)
        centers = rng.normal(size=(16, 24)).astype(np.float32) * 2
        vecs = (centers[rng.integers(0, 16, 1600)]
                + rng.normal(size=(1600, 24))).astype(np.float32)
        state = tsh.build_sharded_state(vecs, n_shards=4, n_devices=8,
                                        max_degree=12, lsh_bits=4,
                                        bucket_cap=8, device="cpu")
        inp.update({f"state/{n}": getattr(state, n).numpy()
                    for n in tsh.ShardedEngineState._fields})
        inp["queries"] = (centers[rng.integers(0, 16, 64)]
                          + 0.3 * rng.normal(size=(64, 24))
                          ).astype(np.float32)
        np.savez(scratch / "inputs.npz", **inp)
        procs["search"] = _start(REF_SEARCH, scratch / "inputs.npz",
                                 scratch / "ref_search.npz")
        torch.set_num_threads(threads)
        yield procs
    finally:
        torch.set_num_threads(threads)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


def _ref(ref_runs, scratch, name) -> dict:
    proc = ref_runs[name]
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
    with np.load(scratch / f"ref_{name}.npz") as z:
        return dict(z)


def _world(scratch, size: int) -> list:
    """Run a gloo world of ``size`` ranks; every rank's results."""
    d = scratch / f"world{size}"
    d.mkdir()
    script = d / "ranks.py"
    script.write_text(RANKS_SCRIPT)
    r = subprocess.run([sys.executable, str(script), str(size), str(scratch),
                        str(d)],
                       env=_env(), capture_output=True, text=True,
                       timeout=WORLD_TIMEOUT, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = []
    for rank in range(size):
        with np.load(d / f"rank{rank}.npz") as z:
            out.append(dict(z))
    return out


# ------------------------------------------------------- without processes

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_zero1_pspecs_match_reference(arch):
    """``model.pspecs``, ``model.specs`` and ``zero1_pspecs`` (data sizes
    1, 2 and 16) leaf for leaf against the reference's."""
    jcfg, tcfg = get_reduced(arch), t_get_reduced(arch)
    want = JM.pspecs(jcfg)
    got = TM.pspecs(tcfg)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    assert _tuples(got) == jax.tree_util.tree_map(
        tuple, want, is_leaf=is_p)
    jspecs, tspecs = JM.specs(jcfg), TM.specs(tcfg)
    assert jax.tree_util.tree_map(lambda s: tuple(s.shape), jspecs) == \
        jax.tree_util.tree_map(lambda t: tuple(t.shape), tspecs)
    assert all(t.is_meta for t in jax.tree_util.tree_leaves(tspecs))
    for n in (1, 2, 16):
        w = jadamw.zero1_pspecs(jspecs, want, data_size=n)
        g = tadamw.zero1_pspecs(tspecs, got, data_size=n)
        assert _tuples(g) == jax.tree_util.tree_map(tuple, w,
                                                    is_leaf=is_p), n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_reference(arch):
    """The decode cache's specs for batches of 1 and 4, model sizes 1,
    2 and 16, one and two batch axes."""
    jcfg, tcfg = get_reduced(arch), t_get_reduced(arch)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    for batch in (1, 4):
        for model_size in (1, 2, 16):
            for axes in (("data",), ("pod", "data")):
                want = JM.cache_pspecs(jcfg, batch, 16, axes, model_size)
                got = TM.cache_pspecs(tcfg, batch, 16, axes, model_size)
                assert _tuples(got) == jax.tree_util.tree_map(
                    tuple, want, is_leaf=is_p), (batch, model_size, axes)
    jshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape),
                                     JM.cache_specs(jcfg, 4, 16))
    tshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                     TM.init_cache(tcfg, 4, 16, "cpu"))
    assert tshapes == jshapes


@pytest.mark.parametrize("shape", [(2, 4), (1, 1), (16, 16)])
def test_engine_state_specs_match_reference(shape):
    want_sds, want = jsh.engine_state_specs(
        AbstractMesh(shape, ("data", "model")), 400, 24, 12, 4, 8)
    got_sds, got = tsh.engine_state_specs(
        dict(zip(("data", "model"), shape)), 400, 24, 12, 4, 8)
    for w, g, ws, gs in zip(want_sds, got_sds, want, got):
        assert tuple(g.shape) == w.shape and g.is_meta
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert tuple(gs) == tuple(ws)


def test_placements_refuse_what_jax_refuses():
    """A dim that does not divide (DTensor would pad it), an axis not in
    the mesh, an axis used twice, a dim split over axes out of mesh
    order, and more entries than dims all raise; a dim over two axes
    maps to ``Shard`` on both."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"data": 2, "model": 2}
    for spec, shape in ((P("data"), (5,)), (P(None, "model"), (4, 3)),
                        (P(("data", "model")), (6,)), (P("pod"), (4,)),
                        (P("data", "data"), (4, 4)),
                        (P(("model", "data")), (8,)),
                        (P(None, None, "model"), (4, 4))):
        with pytest.raises(ValueError):
            tmesh.placements(spec, mesh, shape)
    assert tmesh.placements(P(("data", "model"), None), mesh, (8, 3)) == \
        (Shard(0), Shard(0))
    assert tmesh.placements(P(None, "model"), mesh, (3, 4)) == \
        (Replicate(), Shard(1))
    assert tuple(P("a", ("b",), ())) == ("a", "b", None)


def test_production_mesh_refuses_a_small_world():
    with pytest.raises(ValueError, match="256"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert tmesh.batch_axes({"pod": 2, "data": 16, "model": 16}) == \
        ("pod", "data")
    assert tmesh.batch_axes({"data": 2, "model": 2}) == ("data",)


def test_train_refuses_a_mesh_it_would_run_replicated():
    """What training across ranks refuses rather than run replicated or
    padded: plain axis sizes above 1, given or active (every family
    trains on a ``DeviceMesh``: test_torch_dist_train*.py), an arch
    that does not cut ``model`` ways, and experts that do not (the
    reference's GSPMD fallback for them is not ported)."""
    for arch, sizes in (("deepseek-moe-16b", {"data": 2, "model": 1}),
                        ("deepseek-moe-16b", {"data": 1, "model": 2}),
                        ("falcon-mamba-7b", {"data": 1, "model": 2})):
        cfg = t_get_reduced(arch)
        with pytest.raises(ValueError, match="DeviceMesh"):
            ttrain.train(cfg, steps=1, global_batch=2, seq_len=8,
                         device="cpu", mesh=sizes)
        with tmesh.mesh_context(sizes), \
                pytest.raises(ValueError, match="DeviceMesh"):
            ttrain.train(cfg, steps=1, global_batch=2, seq_len=8,
                         device="cpu")
    with pytest.raises(ValueError, match="d_inner 128"):
        ttrain.refuse(t_get_reduced("falcon-mamba-7b"), {"model": 3})
    uneven = dataclasses.replace(t_get_reduced("deepseek-moe-16b"),
                                 n_experts=6)
    with pytest.raises(ValueError, match="n_experts 6"):
        ttrain.train(uneven, steps=1, global_batch=2, seq_len=8,
                     device="cpu", mesh={"data": 1, "model": 4})


# ------------------------------------------------------ a world of 4 ranks

@pytest.fixture(scope="module")
def world4(scratch):
    return _world(scratch, 4)


def test_placements_split_a_dim_data_major(world4):
    """``P(("data", "model"), None)`` on rows 0..7: rank (i, j) holds
    rows 2(2i + j) .. 2(2i + j) + 1, through DTensor and ``local_slice``."""
    full = np.arange(24, dtype=np.float32).reshape(8, 3)
    for rank, res in enumerate(world4):
        np.testing.assert_array_equal(res["data_major"],
                                      full[2 * rank: 2 * rank + 2])
        np.testing.assert_array_equal(res["data_major_slice"],
                                      res["data_major"])


def test_restore_places_a_reference_checkpoint(world4):
    for res in world4:
        assert res["restore_bad"].size == 0, res["restore_bad"]
        assert int(res["restore_step"]) == 7
        assert int(res["restore_leaves"]) > 20
        assert int(res["opt_sharded_over_data"]) > 0


def test_reshard_full_tensor_is_bit_equal(world4):
    assert all(bool(res["reshard_equal"]) for res in world4)


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_branch_matches_reference(world4, ref_runs, scratch, tag, arch):
    ref = _ref(ref_runs, scratch, "moe")
    ranks = world4 if tag == "m22" else world4[:prod(MESHES[tag])]
    want_y, want_aux = ref[f"{tag}/{arch}/y"], ref[f"{tag}/{arch}/aux"]
    # the branch was taken: its tensor-parallel cut of the gated MLPs
    # gives another result than the single-device path
    assert _share(ref[f"none/{arch}/y"], want_y) > 1e-3
    for res in ranks:
        assert _share(res[f"{tag}/{arch}/y"], want_y) <= MOE_TOL
        assert abs(float(res[f"{tag}/{arch}/aux"]) - float(want_aux)) <= \
            MOE_TOL * abs(float(want_aux))


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_moe_prefill_and_decode_match_reference(world4, ref_runs, scratch,
                                                tag):
    ref = _ref(ref_runs, scratch, "moe")
    ranks = world4 if tag == "m22" else world4[:prod(MESHES[tag])]
    for key in ["prefill"] + [f"decode{i}" for i in range(LM_STEPS)]:
        assert _share(ref[f"none/{key}"], ref[f"{tag}/{key}"]) > 1e-4
        for res in ranks:
            assert _share(res[f"{tag}/{key}"], ref[f"{tag}/{key}"]) <= \
                MOE_TOL, key


# ------------------------------------------------------ a world of 8 ranks

@pytest.fixture(scope="module")
def search(ref_runs, scratch):
    ranks = _world(scratch, 8)
    with np.load(scratch / "inputs.npz") as z:
        inp = dict(z)
    return inp, _ref(ref_runs, scratch, "search"), ranks


def test_rank_search_equals_the_tuple_step(search, one_torch_thread):
    """Every rank's ids and distances are its query block of the tuple
    (2, 4) step's, bit for bit, and the ranks' bucket blocks and steps,
    in rank order, are its tables."""
    inp, _, ranks = search
    state = tsh.ShardedEngineState(*[torch.from_numpy(inp[f"state/{n}"])
                                     for n in tsh.ShardedEngineState._fields])
    step = tsh.make_sharded_search((2, 4), SearchSpec(
        beam_width=12, k=5, max_iters=64), 400, 4)
    q = torch.from_numpy(inp["queries"])
    ql = q.shape[0] // 2
    for rep in range(3):
        state, ids, dists = step(state, q)
        for rank, res in enumerate(ranks):
            blk = slice((rank // 4) * ql, (rank // 4 + 1) * ql)
            np.testing.assert_array_equal(res[f"ids{rep}"],
                                          ids[blk].numpy())
            np.testing.assert_array_equal(res[f"dists{rep}"],
                                          dists[blk].numpy())
        for name in ("bucket_ids", "bucket_stamp", "bucket_step"):
            np.testing.assert_array_equal(
                np.concatenate([r[f"{name}{rep}"] for r in ranks]),
                getattr(state, name).numpy(), err_msg=f"{name} {rep}")
    assert int(state.bucket_step.sum()) > 0


def test_rank_search_ids_equal_the_reference(search):
    """The ids of the forged 8-device run, step by step; distances within
    rtol 1e-6 (``test_torch_sharded.py``'s standard)."""
    _, ref, ranks = search
    for rep in range(3):
        ids = np.concatenate([ranks[0][f"ids{rep}"], ranks[4][f"ids{rep}"]])
        d = np.concatenate([ranks[0][f"dists{rep}"],
                            ranks[4][f"dists{rep}"]])
        np.testing.assert_array_equal(ids, ref[f"ids{rep}"])
        np.testing.assert_allclose(d, ref[f"dists{rep}"], rtol=1e-6)
