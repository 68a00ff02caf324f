"""The production mesh's dry run (``repro_torch.launch.dryrun``), its
operation walk (``launch.op_walk``) and the roofline's collective half
(``launch.roofline``), on the CPU: the counterparts of
``tests/test_dryrun_cell.py``.

The reference's own dry run fails under the installed JAX, so the cells
are held to their own invariants: one cheap cell in a subprocess
(256 ranks, 512 multi-pod; it fits, FLOPs and collective bytes above 0,
a dominant term), a refused arch, the walker's trip counts (12 and 3 x 5
matrix products), the collectives' tally, the terms' dominance with the
H100 constants, data parallelism's FLOPs (a (4, 1) fake world's per-rank
count times 4 is one device's), and the search cell at ``reduced()``
size with its two ``all_gather``s.  The in-process cases start and end
their fake world themselves.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.op_walk import op_walk
from repro_torch.models import parallel as par

from test_torch_ingest import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("multi_pod,chips", [(False, 256), (True, 512)])
def test_dryrun_cell_subprocess(tmp_path, multi_pod, chips):
    out = tmp_path / "cell.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "gemma2-27b", "--shape", "decode_32k", "--device", "cpu",
           "--out", str(out)] + (["--multi-pod"] if multi_pod else [])
    r = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                       timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    assert "ok" in r.stdout and "fits=True" in r.stdout
    d = json.loads(out.read_text())
    assert d["chips"] == chips and d["status"] == "ok"
    assert d["memory"]["fits_hbm"]
    rf = d["roofline"]
    assert rf["flops"] > 0 and rf["coll_bytes"] > 0
    assert rf["dominant"] in ("compute", "memory", "collective")


def test_uncut_arch_is_refused():
    res = dryrun.run_cell("gemma-2b", "decode_32k", False, "cpu")
    assert res["status"] == "refused"
    assert "heads" in res["reason"] and "16" in res["reason"]
    assert "refused" in dryrun.summary(res)


def test_walker_multiplies_trip_counts():
    x = torch.randn(128, 128)
    with op_walk() as walked:
        y = x
        for _ in range(12):
            y = y @ y
    want = 12 * 2 * 128 ** 3
    assert abs(walked["dot_flops"] - want) / want < 0.01


def test_walker_nested_loops():
    x = torch.randn(64, 64)
    with op_walk() as walked:
        for _ in range(5):
            for _ in range(3):
                x = x @ x
    want = 15 * 2 * 64 ** 3
    assert abs(walked["dot_flops"] - want) / want < 0.01


def test_walker_peak_bytes_counts_live_and_freed_storage():
    x = torch.zeros(1024)                       # 4 KiB, live throughout
    with op_walk(live=[x]) as walked:
        for _ in range(8):
            y = x + 1                           # one more 4 KiB at a time
            del y
    assert walked["peak_bytes"] == 2 * 4096


def test_collective_tally():
    import torch.distributed as dist
    dryrun.fake_world(2)
    try:
        before = dict(par.BYTES)
        par.gather_stack(torch.zeros(64, 256), dist.group.WORLD, 2)
        par.all_reduce(torch.zeros(64, dtype=torch.bfloat16),
                       dist.group.WORLD)
        got = {k: v - before.get(k, 0) for k, v in par.BYTES.items()}
    finally:
        dist.destroy_process_group()
    assert got["all_gather"] == 128 * 256 * 4 == 131_072
    assert got["all_reduce"] == 64 * 2 == 128
    out = rl.collective_bytes(got)
    assert out["all-gather"] == 131_072 and out["all-reduce"] == 128
    assert out["all-to-all"] == 0


def test_roofline_terms_and_dominance():
    t = rl.RooflineTerms(flops=1e15, hbm_bytes=1e12, coll_bytes=1e12,
                         coll_breakdown={}, chips=256, model_flops=5e14)
    assert t.t_compute > 0 and t.t_memory > 0 and t.t_collective > 0
    assert t.dominant == "collective"   # 1e12 / (256 x 450e9) is largest
    assert abs(t.useful_ratio - 0.5) < 1e-9
    walked = {"dot_flops": 2.0, "kernel_flops": 1.0,
              "collectives": {"all_reduce": 8, "broadcast": 4}}
    a = rl.analyze(walked, 4, model_flops=6.0, hbm_bytes=10.0)
    assert a.flops == 12.0 and a.coll_bytes == 48.0 and a.hbm_bytes == 10.0
    assert a.coll_breakdown["all-reduce"] == 32.0


def _walk_step(cfg, shape, mesh_shape):
    """op_walk's counts of one train step of ``cfg`` on rank 0 of a fake
    world over ``mesh_shape`` (``shape`` a key of ``dryrun.SHAPES``), or
    on one device without a world (``mesh_shape`` None, ``shape`` its
    (seq_len, batch))."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import mesh as tm
    from repro_torch.models import model as M
    from repro_torch.models.steps import make_train_step
    fake = FakeTensorMode()
    if mesh_shape is None:
        with fake:
            model = M.Model(cfg, "meta")
            for name, p in list(model.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(owner) if owner else model,
                        leaf, torch.nn.Parameter(torch.empty(
                            p.shape, dtype=p.dtype, device="cpu")))
            model._device = torch.device("cpu")
            from repro_torch.optim import adamw
            opt = adamw.init(dict(model.named_parameters()))
            batch = dryrun._batch(cfg, shape[1], shape[0], "cpu")
            with op_walk() as walked:
                make_train_step(cfg)(model, opt, batch)
        return walked
    dryrun.fake_world(4)
    try:
        mesh = tm.make_local_mesh(*mesh_shape, "cpu")
        fn, args, live, _, _ = dryrun.input_specs(cfg, shape, mesh, "cpu",
                                                  fake)
        with fake, op_walk(live=live) as walked:
            fn(*args)
    finally:
        dist.destroy_process_group()
    return walked


def test_data_parallel_flops_split_exactly(monkeypatch):
    cfg = dataclasses.replace(get_reduced("gemma2-27b"), dtype="float32")
    monkeypatch.setitem(dryrun.SHAPES, "train_32", (32, 8, "train"))
    one = _walk_step(cfg, (32, 8), None)
    ranked = _walk_step(cfg, "train_32", (4, 1))
    assert one["dot_flops"] > 0
    assert ranked["dot_flops"] * 4 == one["dot_flops"]
    assert ranked["collectives"]["all_reduce"] > 0


def test_search_cell_on_a_fake_world():
    import torch.distributed as dist
    from repro_torch.configs import catapultdb
    from repro_torch.launch import mesh as tm
    e = catapultdb.reduced()
    dryrun.fake_world(4)
    try:
        mesh = tm.make_local_mesh(2, 2, "cpu")
        fn, args, live, mf, _ = dryrun.catapultdb_specs(
            mesh, torch.device("cpu"), e)
        with op_walk(live=live) as walked:
            _, ids, dists = fn(*args)
    finally:
        dist.destroy_process_group()
    ql = e.query_batch // 2
    assert ids.shape == dists.shape == (ql, e.k)
    # two all_gathers over the 2 corpus shards: int32 ids, f32 distances
    assert walked["collectives"] == {"all_gather": 2 * 2 * ql * e.k * 4}
    kernels = walked["kernel_breakdown"]
    assert kernels["lsh_hash"] == 2 * ql * e.lsh_bits * e.dim
    assert kernels["gather_distance"] > 0 and mf > 0
    assert walked["peak_bytes"] >= sum(t.numel() * t.element_size()
                                       for t in live)
