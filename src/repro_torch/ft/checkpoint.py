"""Atomic, async checkpoints in the reference's on-disk format.

Port of ``repro/ft/checkpoint.py``.  Layout (one directory per step):

    <dir>/step_000123/
        manifest.json     — step, tree structure, each leaf's shape/dtype
        leaf_00000.npy …  — one file per leaf
    <dir>/LATEST          — atomically-renamed pointer file

The files are the reference's, so a checkpoint crosses between the two
packages in both directions: leaves in jax's flatten order (dict keys
sorted, tuples and NamedTuples in field order, ``None`` no leaf), so a
training state ``{"params": tree, "opt": AdamWState(mu, nu, step)}``
writes ``opt``'s ``mu``, ``nu`` and ``step`` before ``params``; bfloat16
stored as a ``uint16`` view with the dtype named in the manifest.  The
manifest's ``treedef`` is the port's own description of the structure
(the reference's ``restore`` never reads it).  Leaves may be numpy
arrays, torch tensors (any device) or scalars; ``restore`` returns CPU
torch tensors, bfloat16 decoded through a torch view (no ``ml_dtypes``).

Guarantees, as the reference's: an atomic publish (the step directory
is written under a temporary name and renamed, then LATEST is swapped),
and an async save (``AsyncCheckpointer`` copies the tensors to the host
on the caller's thread, then writes in a background thread).  From a
world (``AsyncCheckpointer(path, group=...)``, training across ranks)
every rank calls ``save_async`` with the full tree (``launch.train``
gathers it); the group's rank 0 writes, the same files, and every rank
waits at a barrier over the group in ``wait`` (the next save, or the end
of the run), so no rank goes on before the step is published.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

# numpy cannot hold bfloat16: such leaves are stored as raw uint views,
# their logical dtype in the manifest.  name -> (stored dtype, the torch
# integer dtype of that width and its numpy twin, the torch dtype)
_VIEW = {"bfloat16": (np.uint16, torch.int16, np.int16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.uint8, np.uint8,
                           torch.float8_e4m3fn)}


def _flatten(tree) -> list:
    """Leaves in jax's ``tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _unflatten(example, leaves):
    """``example``'s structure with ``leaves`` (an iterator) in it."""
    if example is None:
        return None
    if isinstance(example, dict):
        return {k: _unflatten(example[k], leaves) for k in sorted(example)}
    if isinstance(example, tuple) and hasattr(example, "_fields"):
        return type(example)(*(_unflatten(t, leaves) for t in example))
    if isinstance(example, (tuple, list)):
        return type(example)(_unflatten(t, leaves) for t in example)
    return next(leaves)


def _treedef(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return name + "(" + ", ".join(_treedef(t) for t in tree) + ")"
    return "*"


def _host(leaf):
    """A leaf as a host copy: a CPU tensor (never a view of one that
    training goes on writing) or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _encode(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        name = str(leaf.dtype).split(".")[-1]
        if name in _VIEW:
            stored, as_int, _, _ = _VIEW[name]
            return leaf.view(as_int).numpy().view(stored), name
        return leaf.numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _VIEW:
        return arr.view(_VIEW[name][0]), name
    return arr, name


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _VIEW:
        _, _, np_int, dtype = _VIEW[name]
        return torch.from_numpy(arr.view(np_int)).view(dtype)
    return torch.from_numpy(arr)


def save(path: str, tree: Any, step: int) -> str:
    """Blocking atomic save.  Returns the step directory."""
    encoded = [_encode(l) for l in _flatten(tree)]
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(dir=path, prefix=".tmp_save_")
    try:
        manifest = {
            "step": step,
            "treedef": _treedef(tree),
            "leaves": [{"file": f"leaf_{i:05d}.npy",
                        "shape": list(l.shape), "dtype": name}
                       for i, (l, name) in enumerate(encoded)],
        }
        for i, (l, _) in enumerate(encoded):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), l)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _swap_latest(path, os.path.basename(final))
    return final


def _swap_latest(path: str, name: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".tmp_latest_")
    with os.fdopen(fd, "w") as f:
        f.write(name)
    os.replace(tmp, os.path.join(path, "LATEST"))


class AsyncCheckpointer:
    """One in-flight save at a time; the device-to-host copy happens on
    the caller's thread, serialization on the worker.  With ``group`` (a
    process group every rank of which makes the same calls) only its
    rank 0 writes, and ``wait`` ends with a barrier over the group."""

    def __init__(self, path: str, group=None):
        self.path = path
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None
        self.group, self._issued = group, False
        if group is None:
            self.writer = True
        else:
            import torch.distributed as dist
            self.writer = dist.get_rank(group) == 0

    def save_async(self, tree: Any, step: int) -> None:
        self.wait()
        self._issued = True
        if not self.writer:
            self.last_saved = step
            return
        leaves = [_host(l) for l in _flatten(tree)]
        host = _unflatten(tree, iter(leaves))

        def work():
            save(self.path, host, step)
            self.last_saved = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.group is not None and self._issued:
            import torch.distributed as dist
            dist.barrier(group=self.group)
            self._issued = False


def latest_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, "LATEST")) as f:
            return int(f.read().strip().split("_")[-1])
    except (FileNotFoundError, ValueError):
        return None


def restore(path: str, example_tree: Any, step: Optional[int] = None,
            shardings: Any = None) -> tuple[Any, int]:
    """Restore ``step`` (the latest when None) into ``example_tree``'s
    structure (its leaves are placeholders): CPU torch tensors, in the
    saved dtypes; the caller places them (``convert``).  With
    ``shardings`` (a tree of ``launch.mesh.NamedSharding`` of the same
    structure, ``launch.train.build_shardings``) each leaf is re-placed
    on the live mesh as a DTensor instead — the elastic restore path."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    n = len(_flatten(example_tree))
    if n != len(manifest["leaves"]):
        raise ValueError(f"the example tree has {n} leaves, the checkpoint "
                         f"{len(manifest['leaves'])}")
    loaded = [_decode(np.load(os.path.join(d, m["file"])), m["dtype"])
              for m in manifest["leaves"]]
    if shardings is not None:
        loaded = [s.distribute(l) for l, s in zip(loaded,
                                                  _flatten(shardings))]
    return _unflatten(example_tree, iter(loaded)), step
