"""Training across ranks against the reference's GSPMD run, on the CPU.

The reference trains reduced gemma-2b (f32, global batch 4, sequence
16) for 8 steps under a forged 4-device (2, 2) mesh, checkpointing at
steps 4 and 8 (``REF_TRAIN``, a subprocess: ``XLA_FLAGS`` must precede
its JAX import).  Two things of jax 0.9 are worked around there, each
in layout only: the mesh has ``Auto`` axes (``make_local_mesh``'s
default Explicit axes turn the models' ``maybe_shard`` into an assert
that the embedding gather fails), and the step's outputs are pinned to
``build_shardings``' layouts with ``with_sharding_constraint`` (without
it the step's parameters come out laid out like their ZeRO-1 moments
and the driver's second call refuses them against its
``in_shardings``, whenever ``data`` is above 1).  A ``debug.callback``
records each step's ``grad_norm``.

The port's gloo world of 4 ranks (``RANKS_SCRIPT``, run by
``subprocess.run`` with a time limit) resumes on a (2, 2) mesh from the
reference's step-4 checkpoint (copied alone into its own directory) to
step 8, writing its own checkpoint there.  Its losses and ``grad_norm``s
of steps 4-7 hold to the reference's within ``test_torch_train_loop``'s
``RESUME_RTOL`` and ``GNORM_RTOL``, and its step-8 checkpoint to the
reference's under that file's ``PARAM_TOL``/``PARAM_SHARE`` rule (in
units of the summed learning rates of steps 5-8), each AdamW moment
within ``MOMENT_TOL`` of its leaf's largest, the step equal.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.optim import adamw

from test_torch_ingest import one_torch_thread  # noqa: F401
from test_torch_train_loop import GNORM_RTOL, PARAM_SHARE, PARAM_TOL, \
    RESUME_RTOL

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPT = dict(lr=3e-3, warmup=2, total_steps=8)
STEPS, RESUME_AT = 8, 4
MOMENT_TOL = 1e-3      # of a leaf's largest moment (5.1e-5 measured)
WORLD_TIMEOUT = 300

# argv: the checkpoint directory, the output .npz
REF_TRAIN = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs.base import get_reduced
from repro.launch import train as jtrain
from repro.optim import adamw

cfg = dataclasses.replace(get_reduced("gemma-2b"), dtype="float32")
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
param_sh, opt_sh = jtrain.build_shardings(cfg, mesh)
gnorms = {}
real = jtrain.make_train_step


def make(*a, **kw):
    step = real(*a, **kw)

    def pinned(params, opt_state, batch):
        p, o, m = step(params, opt_state, batch)
        wsc = jax.lax.with_sharding_constraint
        p = wsc(p, param_sh)
        o = adamw.AdamWState(mu=wsc(o.mu, opt_sh), nu=wsc(o.nu, opt_sh),
                             step=o.step)
        jax.debug.callback(
            lambda s, g: gnorms.__setitem__(int(s), float(g)), o.step,
            m["grad_norm"])
        return p, o, m
    return pinned


jtrain.make_train_step = make
_, _, losses = jtrain.train(
    cfg, steps=8, global_batch=4, seq_len=16, ckpt_dir=sys.argv[1],
    ckpt_every=4, opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup=2,
                                            total_steps=8),
    mesh=mesh, log=lambda *a: None)
np.savez(sys.argv[2], losses=np.asarray(losses),
         gnorms=np.asarray([gnorms[s + 1] for s in range(8)]))
"""

# argv: the checkpoint directory to resume from, the world's own
# directory (its store, rank<r>.npz written there)
RANKS_SCRIPT = r"""
import dataclasses, os, sys

import numpy as np
import torch
import torch.multiprocessing as mp


def rank_main(rank, world, ckpt, own):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as tm
    from repro_torch.launch import train as tt
    from repro_torch.optim import adamw
    tm.init_world("cpu", init_method=f"file://{own}/store", rank=rank,
                  world_size=world)
    gnorms = []
    real = tt.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def recorded(model, state, batch):
            out = step(model, state, batch)
            gnorms.append(float(out[2]["grad_norm"]))
            return out
        return recorded

    tt.make_train_step = make
    try:
        cfg = dataclasses.replace(get_reduced("gemma-2b"), dtype="float32")
        _, state, losses = tt.train(
            cfg, steps=8, global_batch=4, seq_len=16, ckpt_dir=ckpt,
            ckpt_every=4, resume=True, device="cpu",
            opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup=2, total_steps=8),
            mesh=tm.make_local_mesh(2, 2, "cpu"), log=lambda *a: None)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(own, f"rank{rank}.npz"), losses=np.asarray(losses),
             gnorms=np.asarray(gnorms), step=state.step)


if __name__ == "__main__":
    ckpt, own = sys.argv[1], sys.argv[2]
    mp.spawn(rank_main, args=(4, ckpt, own), nprocs=4)
"""


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run, then the port's world resuming from its
    step-4 checkpoint; (reference outputs, every rank's, directories)."""
    d = tmp_path_factory.mktemp("dist_train_ref")
    ref_dir, port_dir = d / "ref_ckpt", d / "port_ckpt"
    r = subprocess.run([sys.executable, "-c", REF_TRAIN, str(ref_dir),
                        str(d / "ref.npz")], env=_env(), capture_output=True,
                       text=True, timeout=WORLD_TIMEOUT, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    port_dir.mkdir()
    name = f"step_{RESUME_AT:09d}"
    shutil.copytree(ref_dir / name, port_dir / name)
    (port_dir / "LATEST").write_text(name)
    own = d / "world"
    own.mkdir()
    (own / "ranks.py").write_text(RANKS_SCRIPT)
    r = subprocess.run([sys.executable, str(own / "ranks.py"), str(port_dir),
                        str(own)], env=_env(), capture_output=True,
                       text=True, timeout=WORLD_TIMEOUT, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with np.load(d / "ref.npz") as z:
        ref = dict(z)
    ranks = []
    for rank in range(4):
        with np.load(own / f"rank{rank}.npz") as z:
            ranks.append(dict(z))
    return ref, ranks, ref_dir, port_dir


def test_resumed_losses_and_norms_match_reference(runs):
    ref, ranks, _, _ = runs
    for res in ranks:
        assert int(res["step"]) == STEPS
        np.testing.assert_allclose(res["losses"], ref["losses"][RESUME_AT:],
                                   rtol=RESUME_RTOL)
        np.testing.assert_allclose(res["gnorms"], ref["gnorms"][RESUME_AT:],
                                   rtol=GNORM_RTOL)


def _leaves(path):
    """The step-8 directory's manifest and leaves (numpy, as stored)."""
    d = pathlib.Path(path) / f"step_{STEPS:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return manifest, [np.load(d / m["file"]) for m in manifest["leaves"]]


def test_final_checkpoint_matches_reference(runs):
    _, _, ref_dir, port_dir = runs
    (want_m, want), (got_m, got) = _leaves(ref_dir), _leaves(port_dir)
    assert got_m["step"] == want_m["step"] == STEPS
    assert [(m["shape"], m["dtype"]) for m in got_m["leaves"]] == \
        [(m["shape"], m["dtype"]) for m in want_m["leaves"]]
    lr_sum = sum(adamw.schedule(adamw.AdamWConfig(**OPT), s)
                 for s in range(RESUME_AT + 1, STEPS + 1))
    n_params = (len(want) - 1) // 3    # opt's mu, nu and step come first
    params = slice(len(want) - n_params, len(want))
    apart = total = 0
    for g, w in zip(got[params], want[params]):
        diff = np.abs(g.astype(np.float64) - w)
        assert diff.max() <= PARAM_TOL * lr_sum
        apart += int((diff > 1e-3 * lr_sum).sum())
        total += diff.size
    assert apart <= PARAM_SHARE * total, (apart, total)
    # the moments: the same leaves, f32, within the f32 drift of a step
    worst = 0.0
    for g, w in zip(got[:2 * n_params], want[:2 * n_params]):
        assert g.dtype == w.dtype == np.float32
        worst = max(worst, np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    assert worst <= MOMENT_TOL, worst
    assert int(got[2 * n_params]) == int(want[2 * n_params]) == STEPS
