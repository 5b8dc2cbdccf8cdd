"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded through ``ctypes`` (no PyTorch headers, so a build takes
seconds). The libraries go to ``ddpm3d_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. All sources are compiled at once, in
parallel, on first use. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading
from typing import Dict

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
SRC_DIR = osp.join(_PKG, "csrc")
BUILD_DIR = osp.join(_PKG, "_build")
SOURCES = ("conv3d", "groupnorm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (library, argtypes); every one returns cudaError_t
_SIGNATURES = {
    "conv3d_ndhwc_launch": (
        "conv3d", [_P, _P, _P, _P] + [_I] * 10 + [_P]),
    "gn_stats_launch": ("groupnorm", [_P, _P, _P] + [_I] * 5 + [_P]),
    "gn_apply_launch": ("groupnorm", [_P, _P, _P, _P] + [_I] * 5 + [_P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        osp.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and osp.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of ddpm3d_tpu_torch "
        "are built from csrc/ on first use"
    )


def _lib_path(name: str) -> str:
    with open(osp.join(SRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return osp.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source that has no up-to-date library, all in parallel.
    Returns {source name: library path}. Raises with nvcc's output on a
    failed build. ``ptxas`` register/spill reports land in ``<lib>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = {}
    for name, path in paths.items():
        if osp.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, osp.join(SRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu ---\n{out}")
            continue
        with open(paths[name] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def fn(name: str):
    """The ctypes function ``name`` with its argtypes set (builds on first
    use)."""
    lib_name, argtypes = _SIGNATURES[name]
    with _lock:
        if lib_name not in _libs:
            paths = build_all()
            for n, p in paths.items():
                _libs[n] = ctypes.CDLL(p)
        f = getattr(_libs[lib_name], name)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
