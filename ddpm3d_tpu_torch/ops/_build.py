"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded through ``ctypes`` (no PyTorch headers, so a build takes
seconds). The libraries go to ``ddpm3d_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. All sources are compiled at once, in
parallel, on first use. :func:`build_variants` compiles other versions of a
source (study builds with extra defines, another revision of a file) the
same way. Nothing here runs at import time.
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
SOURCES = ("conv3d_f32", "conv3d_head", "conv3d_narrow", "conv3d_s8",
           "conv3d_sm90", "groupnorm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (library, argtypes); every one returns cudaError_t
_SIGNATURES = {
    "conv3d_f32_launch": (
        "conv3d_f32", [_P, _P, _P, _P] + [_I] * 8 + [_P]),
    "conv3d_f32_fused_launch": (
        "conv3d_f32", [_P] * 5 + [_I] + [_P] * 5 + [_I] * 8 + [_P]),
    "conv3d_sm90_launch": (
        "conv3d_sm90", [_P, _P, _P, _P] + [_I] * 9 + [_P]),
    "conv3d_sm90_fused_launch": (
        "conv3d_sm90", [_P] * 5 + [_I] + [_P] * 4 + [_I] * 9 + [_P]),
    "conv3d_head_launch": (
        "conv3d_head", [_P, _P, _P, _P] + [_I] * 7 + [_P]),
    "conv3d_f32_narrow_launch": (
        "conv3d_head", [_P, _P, _P, _P] + [_I] * 5 + [_P]),
    "conv3d_narrow_launch": (
        "conv3d_narrow", [_P, _P, _P, _P] + [_I] * 6 + [_P]),
    "conv3d_gather_launch": (
        "conv3d_narrow", [_P, _P, _P, _P] + [_I] * 6 + [_P]),
    "conv3d_s8_launch": (
        "conv3d_s8", [_P] * 6 + [_I] * 12 + [_P]),
    "gn_stats_launch": ("groupnorm", [_P] * 4 + [_I] * 5 + [_P]),
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


def _lib_path(name: str, source: str = None, flags=()) -> str:
    """The library of ``source`` (default ``csrc/<name>.cu``) built with
    ``flags``, named by a hash of the source, of every header in ``csrc/``
    (``*.cuh``: a source may include any of them) and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    files = [source or osp.join(SRC_DIR, f"{name}.cu")]
    for path in files + [osp.join(SRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(osp.basename(path).encode() + b"\0" + f.read())
    return osp.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(variants: Dict[str, tuple] = None) -> Dict[str, str]:
    """Compile every source that has no up-to-date library, all in parallel,
    with ``variants`` {name: (source path, extra nvcc flags)} beside them.
    Returns {name: library path}. Raises with nvcc's output on a failed
    build. ``ptxas`` register/spill reports land in ``<lib>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {name: (osp.join(SRC_DIR, f"{name}.cu"), ()) for name in SOURCES}
    jobs.update(variants or {})
    paths = {name: _lib_path(name, src, tuple(flags))
             for name, (src, flags) in jobs.items()}
    procs = {}
    for name, path in paths.items():
        if osp.exists(path):
            continue
        src, flags = jobs[name]
        tmp = f"{path}.{os.getpid()}.tmp"
        # -I: a source outside csrc/ (another revision) finds the headers
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-I", SRC_DIR, "-o", tmp, src]
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


def build_variants(variants: Dict[str, tuple]) -> Dict[str, ctypes.CDLL]:
    """Build and load other versions of a source, {name: (source path, extra
    nvcc flags)}, for studies: their C entry points are called like the
    package's own (``_SIGNATURES``). Names must differ from SOURCES."""
    if set(variants) & set(SOURCES):
        raise ValueError("a variant may not take a source's name")
    paths = build_all(variants)
    return {name: ctypes.CDLL(paths[name]) for name in variants}


def variant_fn(lib: ctypes.CDLL, name: str):
    """The entry point ``name`` of a variant library, typed as the
    package's own."""
    f = getattr(lib, name)
    f.argtypes = _SIGNATURES[name][1]
    f.restype = ctypes.c_int
    return f


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
