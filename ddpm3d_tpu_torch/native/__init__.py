"""Native C++ host tier: TIFF decode, patch extraction, Hann blending.

Own copy of the JAX package's host tier (``ddpm3d_native.cpp`` beside this
file, the same C ABI), bound through ctypes. The library is built with g++
on first use, never at import, into ``ddpm3d_tpu_torch/_build/``
(git-ignored), named by a hash of the source, the compiler, its flags and
the CPU features ``-march=native`` resolves to, so an edited source or
another host rebuilds. Each process writes its own temporary file and
renames it into place, so concurrent first uses do not race.

There is no quiet fallback: a failed build or load raises with the
compiler's output. ``DDPM3D_NATIVE=0`` (or ``off`` / ``false``) is the one
way to choose the numpy paths of :mod:`..data`; :func:`available` says
which is in force. A TIFF that the reader declines (compressed, tiled,
colour) goes to the Python reader: :func:`tiff_read` returns ``None``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = osp.dirname(osp.abspath(__file__))
SRC = osp.join(_DIR, "ddpm3d_native.cpp")
BUILD_DIR = osp.join(osp.dirname(_DIR), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def enabled() -> bool:
    """False when ``$DDPM3D_NATIVE`` is 0, off or false."""
    return os.environ.get("DDPM3D_NATIVE", "auto").lower() not in (
        "0", "off", "false")


def _run(cmd) -> subprocess.CompletedProcess:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"native tier: cannot run {cmd[0]!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native tier: {' '.join(cmd)} failed ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    return proc


def lib_path() -> str:
    """The library's path for this source, compiler, flags and host CPU."""
    target = _run([CXX, *CXX_FLAGS[:2], "-Q", "--help=target"]).stdout
    digest = hashlib.sha256("\0".join((CXX,) + CXX_FLAGS).encode())
    digest.update(target.encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return osp.join(BUILD_DIR, f"ddpm3d_native-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is there; returns its path. Raises
    with the compiler's output on a failed build."""
    path = lib_path()
    if osp.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    _run([CXX, *CXX_FLAGS, SRC, "-o", tmp])
    os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None when
    ``$DDPM3D_NATIVE`` turns the tier off."""
    global _lib
    if not enabled():
        return None
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(path)
            lib.ddpm3d_tiff_shape.argtypes = [ctypes.c_char_p, _i64p]
            lib.ddpm3d_tiff_shape.restype = ctypes.c_int
            lib.ddpm3d_tiff_read_f32.argtypes = [ctypes.c_char_p, _f32p, _i64]
            lib.ddpm3d_tiff_read_f32.restype = ctypes.c_int
            lib.ddpm3d_extract_patches.argtypes = [
                _f32p, _i64, _i64, _i64, _i64p, _i64, _i64, _f32p,
                ctypes.c_float,
            ]
            lib.ddpm3d_extract_patches.restype = ctypes.c_int
            lib.ddpm3d_blend_accumulate.argtypes = [
                _f32p, _i64p, _i64, _i64, _f32p, _f32p, _f32p, _i64, _i64,
                _i64,
            ]
            lib.ddpm3d_blend_accumulate.restype = ctypes.c_int
            lib.ddpm3d_blend_finalize.argtypes = [_f32p, _f32p, _f32p, _i64]
            lib.ddpm3d_blend_finalize.restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    """True unless ``$DDPM3D_NATIVE`` turns the tier off; builds and loads
    the library on first use and raises when that fails."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native tier is off ($DDPM3D_NATIVE)")
    return lib


def tiff_read(path: str) -> Optional[np.ndarray]:
    """Read a TIFF as float32, shaped (H, W), (D, H, W) or (C, D, H, W);
    ``None`` when the file is one the reader declines (compressed, tiled,
    colour, or not a classic TIFF), which the Python reader then takes."""
    lib = _require()
    shape = np.zeros(4, np.int64)
    nd = lib.ddpm3d_tiff_shape(path.encode(), shape)
    if nd < 2:
        return None
    C, D, H, W = (int(x) for x in shape)
    out = np.empty(C * D * H * W, np.float32)
    if lib.ddpm3d_tiff_read_f32(path.encode(), out, out.size) != 0:
        return None
    if nd == 4:
        return out.reshape(C, D, H, W)
    if nd == 3:
        return out.reshape(D, H, W)
    return out.reshape(H, W)


def _grid(grid) -> np.ndarray:
    """[P, 3] int64 starts; negative ones would index before the buffers."""
    g = np.ascontiguousarray(np.asarray(grid, np.int64).reshape(-1, 3))
    if (g < 0).any():
        raise ValueError("patch grid starts must be >= 0")
    return g


def extract_patches(
    vol_zxy: np.ndarray, grid, patch_size: int, inv_div: float = 1.0
) -> np.ndarray:
    """Patches [P, Z, X, Y] of ``vol_zxy`` at the grid's (x, y, z) starts,
    times ``inv_div``, zero-padded at the high ends."""
    lib = _require()
    vol = np.ascontiguousarray(vol_zxy, np.float32)
    g = _grid(grid)
    n = g.shape[0]
    out = np.empty((n, patch_size, patch_size, patch_size), np.float32)
    Z, X, Y = vol.shape
    rc = lib.ddpm3d_extract_patches(
        vol, Z, X, Y, g.reshape(-1), n, patch_size, out.reshape(-1),
        np.float32(inv_div),
    )
    if rc != 0:
        raise RuntimeError(f"ddpm3d_extract_patches returned {rc}")
    return out


def blend_hann(
    patches_xyz: np.ndarray, grid, out_shape_xyz: Tuple[int, int, int],
    patch_size: int, window: np.ndarray,
) -> np.ndarray:
    """Window-weighted overlap-add of [P, X, Y, Z] patches into the
    (X, Y, Z) volume; voxels of zero weight stay 0."""
    lib = _require()
    p = np.ascontiguousarray(patches_xyz, np.float32)
    g = _grid(grid)
    if p.shape != (g.shape[0],) + (patch_size,) * 3:
        raise ValueError(f"patches {p.shape} for {g.shape[0]} starts of "
                         f"{patch_size}^3")
    w = np.ascontiguousarray(window, np.float32)
    X, Y, Z = out_shape_xyz
    acc = np.zeros(out_shape_xyz, np.float32)
    wgt = np.zeros(out_shape_xyz, np.float32)
    rc = lib.ddpm3d_blend_accumulate(
        p.reshape(-1), g.reshape(-1), g.shape[0], patch_size, w.reshape(-1),
        acc.reshape(-1), wgt.reshape(-1), X, Y, Z,
    )
    if rc != 0:
        raise RuntimeError(f"ddpm3d_blend_accumulate returned {rc}")
    out = np.empty_like(acc)
    lib.ddpm3d_blend_finalize(
        acc.reshape(-1), wgt.reshape(-1), out.reshape(-1), out.size
    )
    return out
