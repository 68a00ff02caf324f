"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` becomes its own shared library with a plain
``extern "C"`` launcher, compiled for ``sm_90a`` (Hopper).  The build
happens at first use, never at import, into ``build/repro_torch/<key>/``
at the root of the checkout, where ``<key>`` hashes the sources and the
flags — an edited source rebuilds, an unchanged one loads what is there.
All sources compile in parallel (one ``nvcc`` each, started together).
A failed build raises with nvcc's stderr.  ``ptxas -v`` reports
(registers, shared memory, spills) are kept beside each library as
``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("gather_distance", "lsh_hash", "fused_hop", "fused_hop_pq",
           "pq_adc", "l2_distance")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# launcher name -> argtypes (pointers and the stream as void*, ints as int)
SIGNATURES = {
    "gather_distance": {
        "launch_gather_distance": [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "lsh_hash": {"launch_lsh_hash": [_P, _P, _P, _I, _I, _I, _P]},
    "fused_hop": {
        "launch_fused_hop_l2": [_P] * 10 + [_I] * 5 + [_P],
        "fused_hop_l2_smem_bytes": [_I, _I]},
    "fused_hop_pq": {
        "launch_fused_hop_pq": [_P] * 10 + [_I] * 6 + [_P],
        "fused_hop_pq_smem_bytes": [_I, _I]},
    "pq_adc": {"launch_pq_adc": [_P] * 4 + [_I] * 5 + [_P]},
    "l2_distance": {"launch_l2_distance": [_P, _P, _P, _I, _I, _I, _P]},
}
RESTYPES = {"fused_hop_l2_smem_bytes": ctypes.c_size_t,
            "fused_hop_pq_smem_bytes": ctypes.c_size_t}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA "
                           "kernels cannot be built")
    return found


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every kernel that is not built yet; returns the build dir."""
    out_dir = BUILD_ROOT / _build_key()
    todo = [k for k in KERNELS if not (out_dir / f"lib{k}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        (out_dir / f"{name}.log").write_text(stdout + stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out_dir


_LOAD_LOCK = threading.Lock()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use (one
    build and one load, whichever thread asks first)."""
    with _LOAD_LOCK:
        return _load(name)


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = RESTYPES.get(fn, ctypes.c_int)
    return lib
