"""Pluggable blob-storage IO for checkpoints.

Own copy of ``ddpm3d_tpu/utils/blobio.py``: a small scheme registry so the
checkpoint layer works the same on

  - local filesystem paths, plain or ``file://`` (default; a write goes to
    a temporary file that is renamed into place),
  - ``mem://`` in-memory storage (hermetic tests, no disk),
  - ``gs://`` Google Cloud Storage, resolved at first use through
    ``etils.epath`` or ``google.cloud.storage`` when one is installed
    (else a clear error says which to install).

Registering a custom scheme is one call:
``register_scheme("s3", MyS3Backend())``.
"""

from __future__ import annotations

import os
import os.path as osp
import re
import threading
from typing import Dict, List


class _Backend:
    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError


class _LocalBackend(_Backend):
    @staticmethod
    def _fs(path: str) -> str:
        # file:///abs/path -> /abs/path (plain paths pass through)
        return path[len("file://"):] if path.startswith("file://") else path

    def read(self, path: str) -> bytes:
        with open(self._fs(path), "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        path = self._fs(path)
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic on POSIX

    def exists(self, path: str) -> bool:
        return osp.exists(self._fs(path))

    def listdir(self, path: str) -> List[str]:
        path = self._fs(path)
        return os.listdir(path) if osp.isdir(path) else []


class _MemBackend(_Backend):
    """In-memory blob store (scheme ``mem://``): hermetic tests and a live
    stand-in for remote stores."""

    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def read(self, path: str) -> bytes:
        with self._lock:
            if path not in self._store:
                raise FileNotFoundError(path)
            return self._store[path]

    def write(self, path: str, data: bytes) -> None:
        with self._lock:
            self._store[path] = bytes(data)

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._store

    def listdir(self, path: str) -> List[str]:
        prefix = path.rstrip("/") + "/"
        with self._lock:
            names = {
                k[len(prefix):].split("/")[0]
                for k in self._store if k.startswith(prefix)
            }
        return sorted(names)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()


class _GCSBackend(_Backend):
    """gs:// via etils.epath (Orbax's path layer), falling back to
    google.cloud.storage; resolved at first use."""

    @staticmethod
    def _split_bucket(path: str):
        rest = path[len("gs://"):]
        bucket, _, key = rest.partition("/")
        return bucket, key

    def _impl(self):
        try:
            from etils import epath  # type: ignore

            return ("epath", epath)
        except ImportError:
            pass
        try:
            from google.cloud import storage  # type: ignore

            return ("gcs", storage.Client())
        except ImportError:
            raise RuntimeError(
                "gs:// paths need `etils[epath]` or `google-cloud-storage` "
                "installed; neither is available in this environment"
            )

    def _blob(self, client, path: str):
        bucket, key = self._split_bucket(path)
        return client.bucket(bucket).blob(key)

    def read(self, path: str) -> bytes:
        kind, impl = self._impl()
        if kind == "epath":
            return impl.Path(path).read_bytes()
        return self._blob(impl, path).download_as_bytes()

    def write(self, path: str, data: bytes) -> None:
        kind, impl = self._impl()
        if kind == "epath":
            impl.Path(path).write_bytes(data)
        else:
            self._blob(impl, path).upload_from_string(bytes(data))

    def exists(self, path: str) -> bool:
        kind, impl = self._impl()
        if kind == "epath":
            return impl.Path(path).exists()
        return self._blob(impl, path).exists()

    def listdir(self, path: str) -> List[str]:
        kind, impl = self._impl()
        if kind == "epath":
            return [p.name for p in impl.Path(path).iterdir()]
        bucket, key = self._split_bucket(path)
        prefix = key.rstrip("/") + "/" if key else ""
        names = set()
        for b in impl.list_blobs(bucket, prefix=prefix):
            names.add(b.name[len(prefix):].split("/")[0])
        return sorted(n for n in names if n)


_SCHEMES: Dict[str, _Backend] = {
    "": _LocalBackend(),
    "file": _LocalBackend(),
    "mem": _MemBackend(),
    "gs": _GCSBackend(),
}


def register_scheme(scheme: str, backend: _Backend) -> None:
    _SCHEMES[scheme] = backend


def _split(path: str):
    m = re.match(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://", path)
    scheme = m.group(1) if m else ""
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown blob scheme {scheme!r} in {path!r}")
    return _SCHEMES[scheme]


def read_bytes(path: str) -> bytes:
    return _split(path).read(path)


def write_bytes(path: str, data: bytes) -> None:
    _split(path).write(path, data)


def exists(path: str) -> bool:
    return _split(path).exists(path)


def listdir(path: str) -> List[str]:
    return _split(path).listdir(path)


def join(base: str, *parts: str) -> str:
    if "://" in base:
        return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])
    return osp.join(base, *parts)


def dirname(path: str) -> str:
    if "://" in path:
        scheme, rest = path.split("://", 1)
        return scheme + "://" + rest.rsplit("/", 1)[0]
    return osp.dirname(path)


def isdir(path: str) -> bool:
    if "://" in path:
        return bool(listdir(path))
    return osp.isdir(path)
