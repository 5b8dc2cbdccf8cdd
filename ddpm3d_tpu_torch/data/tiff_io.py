"""Volume IO: TIFF read/write without external dependencies.

Own copy of ``ddpm3d_tpu/data/tiff_io.py``. :func:`imwrite` writes classic
little-endian TIFF, uncompressed, one strip per page, grayscale
float32/float64/uint8/uint16/int16/uint32/int32; 4-D (C, D, H, W) volumes
are stored as C*D pages with an ImageDescription tag recording the axes.
:func:`imread` reads through the native tier (:mod:`..native`, float32 for
every file, as the JAX package's reader) unless ``$DDPM3D_NATIVE`` turns it
off or the file is one the tier declines; then through ``tifffile`` where
installed, else the built-in parser, which keep the file's dtype.
"""

from __future__ import annotations

import struct

import numpy as np

try:  # pragma: no cover - environment-dependent
    import tifffile as _tifffile
except ImportError:  # pragma: no cover
    _tifffile = None

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_IMAGE_DESCRIPTION = 270
_STRIP_OFFSETS = 273
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_SAMPLE_FORMAT = 339

_DTYPE_TO_FORMAT = {
    np.dtype(np.float32): (32, 3),
    np.dtype(np.float64): (64, 3),
    np.dtype(np.uint8): (8, 1),
    np.dtype(np.uint16): (16, 1),
    np.dtype(np.int16): (16, 2),
    np.dtype(np.uint32): (32, 1),
    np.dtype(np.int32): (32, 2),
}
_FORMAT_TO_DTYPE = {v: k for k, v in _DTYPE_TO_FORMAT.items()}


def imwrite(path: str, volume: np.ndarray) -> None:
    """Write a (H,W), (D,H,W) or (C,D,H,W) array as a multi-page TIFF."""
    _imwrite_builtin(path, volume)


def imread(path: str) -> np.ndarray:
    """Read a TIFF written by :func:`imwrite` (or any simple uncompressed
    grayscale TIFF). Returns (H,W), (D,H,W) or (C,D,H,W): float32 from the
    native tier, else the file's dtype (see the module docstring)."""
    from .. import native

    out = native.tiff_read(path) if native.available() else None
    if out is not None:
        return out
    if _tifffile is not None:
        return np.asarray(_tifffile.imread(path))
    return _imread_builtin(path)


def _imwrite_builtin(path: str, volume: np.ndarray) -> None:
    volume = np.ascontiguousarray(volume)
    description = b""
    if volume.ndim == 2:
        pages = volume[None]
    elif volume.ndim == 3:
        pages = volume
    elif volume.ndim == 4:
        C, D = volume.shape[:2]
        description = f"axes=CDHW channels={C} slices={D}".encode() + b"\x00"
        pages = volume.reshape(C * D, *volume.shape[2:])
    else:
        raise ValueError(f"unsupported volume rank {volume.ndim}")

    dt = pages.dtype
    if dt not in _DTYPE_TO_FORMAT:
        pages = pages.astype(np.float32)
        dt = pages.dtype
    bits, sample_format = _DTYPE_TO_FORMAT[dt]
    n_pages, H, W = pages.shape
    page_bytes = H * W * (bits // 8)

    with open(path, "wb") as f:
        f.write(b"II*\x00")
        # layout: header(8) | page data blocks | description | IFDs
        data_start = 8
        desc_off = data_start + n_pages * page_bytes
        ifd_start = desc_off + len(description)
        # pad IFD start to word boundary
        ifd_start += ifd_start % 2

        f.write(struct.pack("<I", ifd_start))
        pages_le = pages.astype(dt.newbyteorder("<"), copy=False)
        for i in range(n_pages):
            f.write(pages_le[i].tobytes())
        f.write(description)
        if (desc_off + len(description)) % 2:
            f.write(b"\x00")

        def entry(tag, typ, count, value):
            return struct.pack("<HHI4s", tag, typ, count, value)

        # Build all IFDs first: page 0 may carry an extra description tag,
        # so IFD sizes differ and next-IFD offsets must be prefix sums.
        page_tags = []
        for i in range(n_pages):
            tags = []
            tags.append(entry(_IMAGE_WIDTH, 3, 1, struct.pack("<HH", W, 0)))
            tags.append(entry(_IMAGE_LENGTH, 3, 1, struct.pack("<HH", H, 0)))
            tags.append(entry(_BITS_PER_SAMPLE, 3, 1, struct.pack("<HH", bits, 0)))
            tags.append(entry(_COMPRESSION, 3, 1, struct.pack("<HH", 1, 0)))
            tags.append(entry(_PHOTOMETRIC, 3, 1, struct.pack("<HH", 1, 0)))
            if description and i == 0:
                tags.append(
                    entry(
                        _IMAGE_DESCRIPTION, 2, len(description),
                        struct.pack("<I", desc_off),
                    )
                )
            tags.append(
                entry(
                    _STRIP_OFFSETS, 4, 1,
                    struct.pack("<I", data_start + i * page_bytes),
                )
            )
            tags.append(entry(_ROWS_PER_STRIP, 3, 1, struct.pack("<HH", H, 0)))
            tags.append(entry(_STRIP_BYTE_COUNTS, 4, 1, struct.pack("<I", page_bytes)))
            tags.append(
                entry(_SAMPLE_FORMAT, 3, 1, struct.pack("<HH", sample_format, 0))
            )
            page_tags.append(tags)

        ifd_offsets = []
        pos = ifd_start
        for tags in page_tags:
            ifd_offsets.append(pos)
            pos += 2 + len(tags) * 12 + 4

        for i, tags in enumerate(page_tags):
            next_ifd = 0 if i == n_pages - 1 else ifd_offsets[i + 1]
            f.write(struct.pack("<H", len(tags)))
            for t in tags:
                f.write(t)
            f.write(struct.pack("<I", next_ifd))


def _read_tag_value(f, typ, count, raw, endian):
    type_sizes = {1: 1, 2: 1, 3: 2, 4: 4, 16: 8, 17: 8}
    size = type_sizes.get(typ, 1) * count
    if size <= 4:
        data = raw[:size]
    else:
        (off,) = struct.unpack(endian + "I", raw)
        pos = f.tell()
        f.seek(off)
        data = f.read(size)
        f.seek(pos)
    if typ == 2:
        return data.rstrip(b"\x00").decode(errors="replace")
    fmt = {1: "B", 3: "H", 4: "I", 16: "Q"}.get(typ)
    if fmt is None:
        return data
    return list(struct.unpack(endian + fmt * count, data))


def _imread_builtin(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.read(8)
        if header[:2] == b"II":
            endian = "<"
        elif header[:2] == b"MM":
            endian = ">"
        else:
            raise ValueError(f"{path}: not a TIFF file")
        magic = struct.unpack(endian + "H", header[2:4])[0]
        if magic != 42:
            raise ValueError(f"{path}: unsupported TIFF variant (magic={magic})")
        (ifd_off,) = struct.unpack(endian + "I", header[4:8])

        pages = []
        description = ""
        while ifd_off:
            f.seek(ifd_off)
            (n_tags,) = struct.unpack(endian + "H", f.read(2))
            tags = {}
            for _ in range(n_tags):
                raw = f.read(12)
                tag, typ, count = struct.unpack(endian + "HHI", raw[:8])
                tags[tag] = _read_tag_value(f, typ, count, raw[8:], endian)
            (ifd_off,) = struct.unpack(endian + "I", f.read(4))

            W = tags[_IMAGE_WIDTH][0]
            H = tags[_IMAGE_LENGTH][0]
            bits = tags.get(_BITS_PER_SAMPLE, [8])[0]
            comp = tags.get(_COMPRESSION, [1])[0]
            if comp != 1:
                raise ValueError(
                    f"{path}: compression {comp} unsupported by builtin reader"
                )
            fmt = tags.get(_SAMPLE_FORMAT, [1])[0]
            dt = _FORMAT_TO_DTYPE.get((bits, fmt))
            if dt is None:
                raise ValueError(f"{path}: unsupported sample format {(bits, fmt)}")
            if isinstance(tags.get(_IMAGE_DESCRIPTION), str):
                description = description or tags[_IMAGE_DESCRIPTION]
            offsets = tags[_STRIP_OFFSETS]
            counts = tags[_STRIP_BYTE_COUNTS]
            buf = b""
            for off, cnt in zip(offsets, counts):
                f.seek(off)
                buf += f.read(cnt)
            page = np.frombuffer(buf, dtype=np.dtype(dt).newbyteorder(endian))
            pages.append(page.reshape(H, W))

    vol = np.stack(pages) if len(pages) > 1 else pages[0][None]
    if "axes=CDHW" in description:
        fields = dict(
            kv.split("=") for kv in description.split() if "=" in kv
        )
        C = int(fields.get("channels", 1))
        D = int(fields.get("slices", vol.shape[0] // max(C, 1)))
        vol = vol.reshape(C, D, *vol.shape[1:])
    elif len(pages) == 1:
        vol = vol[0]
    return np.ascontiguousarray(vol)
