"""The port's host data tier against the JAX package's.

* the native library (``ddpm3d_tpu_torch/native``): the patch cut and the
  Hann blend bit-equal to ``ddpm3d_tpu.native`` (the same source and g++
  flags on this machine) at the production grid and at a grid smaller than
  a patch; the cut bit-equal and the blend within ``BLEND_REL`` of the
  port's numpy versions;
* ``tiff_io.imread`` equal to JAX's in dtype and values over u8 / u16 /
  i16 / u32 / i32 / f32 / f64, 2-D / 3-D / 4-D, little- and big-endian,
  with both packages' tiers on (float32 for every file) and both off (the
  file's dtype);
* a failed native build raises; ``DDPM3D_NATIVE=0`` is the one way to the
  numpy paths; files the reader declines go to the Python reader;
* ``WholeVolumeDataset`` and the 2-D PIL crops against JAX's on the same
  files, images and numpy generators.
"""

import os
import os.path as osp
import stat
import struct

import numpy as np
import pytest
import torch

from ddpm3d_tpu import native as jnative
from ddpm3d_tpu.data import dataset as jdataset
from ddpm3d_tpu.data import patches as jpatches
from ddpm3d_tpu.data import tiff_io as jtiff
from ddpm3d_tpu_torch import native
from ddpm3d_tpu_torch.data import dataset as tdataset
from ddpm3d_tpu_torch.data import patches as tpatches
from ddpm3d_tpu_torch.data import tiff_io as ttiff


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads for this file's tests and fixtures (the suite's
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# the numpy blend sums window x patch in another order than the C++ loop:
# measured 2.4e-7 absolute on [0, 1] data
BLEND_REL = 1e-6

PROD_SHAPE = (130, 200, 200)  # (Z, X, Y): 18 patches of 96^3
SMALL_SHAPE = (10, 12, 14)    # every side below the 16^3 patch


def _grid(shape, ps, n_xy):
    Z, X, Y = shape
    if min(shape) < ps:  # overlapping patches that all run off the volume
        return tpatches.patch_grid([0, 4], [0, 6], [0])
    return tpatches.patch_grid(tpatches.test_xy_starts(X, ps, n_xy),
                               tpatches.test_xy_starts(Y, ps, n_xy),
                               tpatches.test_z_starts(Z, ps))


@pytest.fixture
def jax_tier(monkeypatch):
    """Switch the JAX package's tier on or off (its module state, as its
    own loader leaves it; nothing of it is edited)."""
    def set_on(on: bool):
        if on:
            monkeypatch.setattr(jnative, "_tried", False)
            monkeypatch.setattr(jnative, "_lib", None)
            monkeypatch.delenv("DDPM3D_NATIVE", raising=False)
            assert jnative.available()
        else:
            monkeypatch.setattr(jnative, "_tried", True)
            monkeypatch.setattr(jnative, "_lib", None)
    return set_on


@pytest.fixture
def port_tier(monkeypatch):
    def set_on(on: bool):
        if on:
            monkeypatch.delenv("DDPM3D_NATIVE", raising=False)
            assert native.available()
        else:
            monkeypatch.setenv("DDPM3D_NATIVE", "0")
            assert not native.available()
    return set_on


@pytest.mark.parametrize("shape,ps,n_xy", [(PROD_SHAPE, 96, 3),
                                           (SMALL_SHAPE, 16, 2)])
def test_native_cut_and_blend_bit_equal_to_jax(shape, ps, n_xy, jax_tier,
                                               port_tier):
    jax_tier(True)
    port_tier(True)
    rng = np.random.default_rng(7)
    vol = rng.uniform(0, 1, shape).astype(np.float32)
    grid = _grid(shape, ps, n_xy)
    if shape == PROD_SHAPE:
        assert len(grid) == 18
    got = native.extract_patches(vol, grid, ps, inv_div=0.25)
    ref = jnative.extract_patches(vol, grid, ps, inv_div=0.25)
    np.testing.assert_array_equal(got, ref)
    got = native.extract_patches(vol, grid, ps)
    np.testing.assert_array_equal(got, jnative.extract_patches(vol, grid, ps))
    Z, X, Y = shape
    pxyz = np.ascontiguousarray(np.transpose(got, (0, 2, 3, 1)))
    window = tpatches.hann_window_3d(ps)
    blended = native.blend_hann(pxyz, grid, (X, Y, Z), ps, window)
    np.testing.assert_array_equal(
        blended, jnative.blend_hann(pxyz, grid, (X, Y, Z), ps, window))
    # the public functions route through the tier in both packages
    np.testing.assert_array_equal(tpatches.extract_patches_zxy(vol, grid, ps),
                                  jpatches.extract_patches_zxy(vol, grid, ps))
    np.testing.assert_array_equal(
        tpatches.blend_patches_hann(pxyz, grid, (X, Y, Z), ps),
        jpatches.blend_patches_hann(pxyz, grid, (X, Y, Z), ps))


def test_native_refuses_negative_starts():
    with pytest.raises(ValueError, match=">= 0"):
        native.extract_patches(np.zeros((4, 4, 4), np.float32),
                               [(0, -2, 0)], 4)


@pytest.mark.parametrize("shape,ps,n_xy", [(PROD_SHAPE, 96, 3),
                                           (SMALL_SHAPE, 16, 2)])
def test_native_against_numpy(shape, ps, n_xy, port_tier):
    port_tier(True)
    rng = np.random.default_rng(8)
    vol = rng.uniform(0, 1, shape).astype(np.float32)
    grid = _grid(shape, ps, n_xy)
    cut = tpatches.extract_patches_zxy(vol, grid, ps)
    np.testing.assert_array_equal(
        cut, tpatches.extract_patches_zxy_plain(vol, grid, ps))
    Z, X, Y = shape
    pxyz = np.transpose(cut, (0, 2, 3, 1))
    got = tpatches.blend_patches_hann(pxyz, grid, (X, Y, Z), ps)
    plain = tpatches.blend_patches_hann_plain(pxyz, grid, (X, Y, Z), ps)
    assert np.abs(got - plain).max() <= BLEND_REL * np.abs(plain).max()
    assert ((got == 0) == (plain == 0)).all()  # zero-weight voxels stay 0
    port_tier(False)  # DDPM3D_NATIVE=0: the plain versions themselves
    np.testing.assert_array_equal(
        tpatches.blend_patches_hann(pxyz, grid, (X, Y, Z), ps), plain)


# --- TIFF files: little-endian from imwrite, big-endian written here ------

_BITS = {np.dtype(np.float32): (32, 3), np.dtype(np.float64): (64, 3),
         np.dtype(np.uint8): (8, 1), np.dtype(np.uint16): (16, 1),
         np.dtype(np.int16): (16, 2), np.dtype(np.uint32): (32, 1),
         np.dtype(np.int32): (32, 2)}


def write_tiff(path, vol, endian=">", strips=2, extra_tags=()):
    """A classic TIFF of ``vol`` (2-D, 3-D, or 4-D with the CDHW
    description) in byte order ``endian``, each page in ``strips`` strips;
    ``extra_tags`` are (tag, type, value) SHORT entries added to page 0."""
    vol = np.ascontiguousarray(vol)
    desc = b""
    if vol.ndim == 2:
        pages = vol[None]
    elif vol.ndim == 3:
        pages = vol
    else:
        C, D = vol.shape[:2]
        desc = f"axes=CDHW channels={C} slices={D}".encode() + b"\0"
        pages = vol.reshape(C * D, *vol.shape[2:])
    bits, fmt = _BITS[pages.dtype]
    n, H, W = pages.shape
    rows = -(-H // strips)
    data = pages.astype(pages.dtype.newbyteorder(endian)).tobytes()
    blob = bytearray(b"MM\0*" if endian == ">" else b"II*\0")
    blob += b"\0\0\0\0"
    data_off = len(blob)
    blob += data
    desc_off = len(blob)
    blob += desc
    if len(blob) % 2:
        blob += b"\0"
    page_bytes = H * W * bits // 8
    row_bytes = W * bits // 8
    ifds = []
    for i in range(n):
        offs, cnts = [], []
        for s in range(strips):
            r0, r1 = s * rows, min(H, (s + 1) * rows)
            offs.append(data_off + i * page_bytes + r0 * row_bytes)
            cnts.append((r1 - r0) * row_bytes)
        arrays_off = len(blob)
        blob += struct.pack(f"{endian}{strips}I", *offs)
        blob += struct.pack(f"{endian}{strips}I", *cnts)
        short = lambda tag, v: (tag, 3, 1, struct.pack(f"{endian}HH", v, 0))
        tags = [short(256, W), short(257, H), short(258, bits), short(259, 1),
                short(262, 1), short(278, rows), short(339, fmt)]
        if strips == 1:  # one value fits in the entry itself
            tags += [(273, 4, 1, struct.pack(f"{endian}I", offs[0])),
                     (279, 4, 1, struct.pack(f"{endian}I", cnts[0]))]
        else:
            tags += [(273, 4, strips, struct.pack(f"{endian}I", arrays_off)),
                     (279, 4, strips,
                      struct.pack(f"{endian}I", arrays_off + 4 * strips))]
        if i == 0:
            tags += [short(t, v) for t, v in extra_tags]
            if desc:
                tags.append((270, 2, len(desc),
                             struct.pack(f"{endian}I", desc_off)))
        ifds.append(sorted(tags))
    first = len(blob)
    pos = first
    starts = []
    for tags in ifds:
        starts.append(pos)
        pos += 2 + 12 * len(tags) + 4
    for i, tags in enumerate(ifds):
        blob += struct.pack(f"{endian}H", len(tags))
        for tag, typ, count, value in tags:
            blob += struct.pack(f"{endian}HHI", tag, typ, count) + value
        blob += struct.pack(f"{endian}I",
                            starts[i + 1] if i + 1 < len(ifds) else 0)
    blob[4:8] = struct.pack(f"{endian}I", first)
    with open(path, "wb") as f:
        f.write(bytes(blob))


def _volume(dtype, rank, rng):
    shape = {2: (9, 7), 3: (3, 9, 7), 4: (2, 3, 9, 7)}[rank]
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.standard_normal(shape) * 100).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=np.int64).astype(dt)


DTYPES = ["uint8", "uint16", "int16", "uint32", "int32", "float32", "float64"]


@pytest.mark.parametrize("writer", ["imwrite", "<1", ">1", ">2"])
@pytest.mark.parametrize("rank", [2, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
def test_imread_matches_jax(tmp_path, dtype, rank, writer, jax_tier,
                            port_tier):
    """``writer``: the port's imwrite, or this file's writer in that byte
    order with that many strips a page."""
    vol = _volume(dtype, rank, np.random.default_rng(rank * 31 + len(dtype)))
    path = str(tmp_path / "v.tif")
    if writer == "imwrite":
        ttiff.imwrite(path, vol)
    else:
        write_tiff(path, vol, writer[0], strips=int(writer[1]))
    for on in (True, False):
        jax_tier(on)
        port_tier(on)
        got, ref = ttiff.imread(path), jtiff.imread(path)
        assert got.dtype == ref.dtype, (on, got.dtype, ref.dtype)
        assert got.shape == ref.shape == vol.shape
        np.testing.assert_array_equal(got, ref)
        if on:  # both tiers: float32 for every file
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, vol.astype(np.float32))
        else:  # both Python readers: the file's own values
            assert got.dtype.newbyteorder("=") == vol.dtype
            np.testing.assert_array_equal(got, vol)


@pytest.mark.parametrize("tag,value", [(259, 5),   # LZW compression
                                       (277, 3),   # three samples a pixel
                                       (322, 16)])  # tiled
def test_declined_files_go_to_the_python_reader(tmp_path, tag, value,
                                                port_tier, monkeypatch):
    port_tier(True)
    vol = np.arange(2 * 16 * 16, dtype=np.uint16).reshape(2, 16, 16)
    path = str(tmp_path / "odd.tif")
    write_tiff(path, vol, "<", strips=1, extra_tags=[(tag, value)])
    assert native.tiff_read(path) is None
    monkeypatch.setattr(ttiff, "_tifffile", None)
    seen = []
    monkeypatch.setattr(ttiff, "_imread_builtin",
                        lambda p: seen.append(p) or np.zeros(1))
    ttiff.imread(path)
    assert seen == [path]


def _fake_compiler(tmp_path):
    cxx = tmp_path / "broken-g++"
    cxx.write_text("#!/bin/sh\necho 'broken compiler: no' >&2\nexit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    return str(cxx)


def test_failed_build_raises(tmp_path, monkeypatch, rng):
    monkeypatch.delenv("DDPM3D_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", _fake_compiler(tmp_path))
    with pytest.raises(RuntimeError, match="broken compiler"):
        native.available()
    vol = rng.uniform(0, 1, (10, 12, 14)).astype(np.float32)
    grid = _grid(vol.shape, 16, 2)
    with pytest.raises(RuntimeError, match="broken compiler"):
        tpatches.extract_patches_zxy(vol, grid, 16)
    with pytest.raises(RuntimeError, match="broken compiler"):
        tpatches.blend_patches_hann(np.zeros((len(grid), 16, 16, 16),
                                             np.float32), grid, (12, 14, 10),
                                    16)
    ttiff.imwrite(str(tmp_path / "v.tif"), vol)
    with pytest.raises(RuntimeError, match="broken compiler"):
        ttiff.imread(str(tmp_path / "v.tif"))
    # the one way to the numpy paths
    monkeypatch.setenv("DDPM3D_NATIVE", "off")
    assert not native.available()
    np.testing.assert_array_equal(
        tpatches.extract_patches_zxy(vol, grid, 16),
        tpatches.extract_patches_zxy_plain(vol, grid, 16))
    assert ttiff.imread(str(tmp_path / "v.tif")).dtype == np.float32
    with pytest.raises(RuntimeError, match="native tier is off"):
        native.extract_patches(vol, grid, 16)


def test_failed_load_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("DDPM3D_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    os.makedirs(native.BUILD_DIR)
    with open(native.lib_path(), "wb") as f:
        f.write(b"not a shared library")
    with pytest.raises(OSError):
        native.available()


def test_build_lands_under_build_dir(tmp_path, monkeypatch):
    """A fresh build: the library is named by the source/flags/CPU hash
    under BUILD_DIR, no temporary file is left, and a second load reuses
    it."""
    monkeypatch.delenv("DDPM3D_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    assert native.available()
    names = os.listdir(native.BUILD_DIR)
    assert names == [osp.basename(native.lib_path())]
    assert names[0].startswith("ddpm3d_native-") and names[0].endswith(".so")
    mtime = os.path.getmtime(native.lib_path())
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    assert os.path.getmtime(native.lib_path()) == mtime


# --- the whole-volume dataset and the 2-D crops ----------------------------

def test_whole_volume_dataset_matches_jax(tmp_path, rng, port_tier,
                                          jax_tier):
    paths = []
    for i in range(3):
        p = str(tmp_path / f"v{i}.tif")
        shape = (2, 6, 10, 12) if i % 2 else (6, 10, 12)
        ttiff.imwrite(p, rng.uniform(0, 4, shape).astype(np.float32))
        paths.append(p)
    np.save(str(tmp_path / "v3.npy"), rng.uniform(0, 4, (2, 5, 8, 8)))
    paths.append(str(tmp_path / "v3.npy"))
    for on in (True, False):
        port_tier(on)
        jax_tier(on)
        for shard, n in ((0, 1), (1, 2)):
            got = tdataset.WholeVolumeDataset(paths, shard, n, 4.0)
            ref = jdataset.WholeVolumeDataset(paths, shard, n, 4.0)
            assert got.local_paths == ref.local_paths and len(got) == len(ref)
            for i in range(len(ref)):
                (gh, gkw), (rh, rkw) = got[i], ref[i]
                np.testing.assert_array_equal(gh, rh)
                np.testing.assert_array_equal(gkw["low_res"], rkw["low_res"])
                assert gh.dtype == rh.dtype == np.float32
                assert gh.shape[-1] == 1


def _images():
    from PIL import Image

    rng = np.random.default_rng(5)
    rgb = Image.fromarray(rng.integers(0, 256, (300, 170, 3), np.uint8))
    gray = Image.fromarray(rng.integers(0, 256, (64, 97), np.uint8))
    return [rgb, gray]


@pytest.mark.parametrize("size", [32, 64])
def test_center_crop_matches_jax(size):
    for img in _images():
        got = tdataset.center_crop_arr(img, size)
        np.testing.assert_array_equal(got, jdataset.center_crop_arr(img, size))
        assert got.shape[:2] == (size, size)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crop_matches_jax(seed):
    for img in _images():
        got = tdataset.random_crop_arr(img, 40,
                                       rng=np.random.default_rng(seed))
        ref = jdataset.random_crop_arr(img, 40,
                                       rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, ref)
        assert got.shape[:2] == (40, 40)
