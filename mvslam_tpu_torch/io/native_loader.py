"""ctypes bindings for the native (C++/libjpeg) data loader (port of
``mvslam_tpu.io.native_loader``).

JPEG decode in ``csrc/loader.cpp`` (the port's copy of the JAX package's
``native/loader.cpp``) plus a threaded prefetch queue so frame t+1 decodes
while frame t computes on the device. This is host IO: frames come out as
(H, W) float32 numpy arrays in [0, 1], which the caller moves to its
device.

The shared library is built on first use with g++ into ``build/native/``
beside the checkout (never next to the source), named by the source's
hash so an edit rebuilds it. :func:`available` is False when the toolchain
or libjpeg is missing; callers then read frames with PIL, as the JAX
package does. :func:`load_library` raises instead, with the compiler's
message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "loader.cpp"
#: build products live beside the checkout, in a directory git ignores
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_error: str | None = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mvslam_decode_jpeg_gray.restype = ctypes.c_int
    lib.mvslam_decode_jpeg_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mvslam_loader_create.restype = ctypes.c_void_p
    lib.mvslam_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mvslam_loader_next.restype = ctypes.c_int
    lib.mvslam_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mvslam_loader_destroy.restype = None
    lib.mvslam_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def load_library() -> ctypes.CDLL:
    """Build the loader with g++ (once per source: the library in
    ``BUILD_DIR`` is named by the source's hash) and load it; idempotent.
    Raises ``RuntimeError`` with the compiler's message if the build or the
    load fails."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"libmvslam_loader-{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                   "-o", tmp, str(_SOURCE), "-ljpeg", "-lpthread"]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=120)
            except (OSError, subprocess.SubprocessError) as e:
                os.unlink(tmp)
                _load_error = f"g++ did not run: {e}"
                raise RuntimeError(_load_error) from e
            if proc.returncode != 0:
                os.unlink(tmp)
                _load_error = f"g++ failed ({proc.returncode}):\n{proc.stderr}"
                raise RuntimeError(_load_error)
            os.replace(tmp, so)
        try:
            _lib = _bind(ctypes.CDLL(str(so)))
        except OSError as e:
            _load_error = f"cannot load {so}: {e}"
            raise RuntimeError(_load_error) from e
        return _lib


def available() -> bool:
    """Whether the loader builds and loads here (one attempt per process:
    a failed build is not retried)."""
    if _lib is None and _load_error is None:
        try:
            load_library()
        except RuntimeError:
            pass
    return _lib is not None


_MAX_PIXELS = 64 * 1024 * 1024


def _get_lib() -> ctypes.CDLL:
    if not available():
        raise RuntimeError(f"native loader unavailable: {_load_error}")
    return _lib


def decode_jpeg_gray(path: str) -> np.ndarray:
    """(H, W) float32 grayscale in [0, 1] via the native decoder."""
    lib = _get_lib()
    buf = np.empty(_MAX_PIXELS, np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.mvslam_decode_jpeg_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _MAX_PIXELS, ctypes.byref(h), ctypes.byref(w),
    )
    if rc != 0:
        raise IOError(f"native jpeg decode failed ({rc}): {path}")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


class PrefetchLoader:
    """Iterate decoded frames with background decode-ahead.

    with PrefetchLoader(paths, queue_depth=4, threads=2) as it:
        for index, image in it: ...

    ``PrefetchLoader.delivered`` counts the frames every loader has handed
    out since import (or since a caller reset it).
    """

    delivered = 0

    def __init__(self, paths: Sequence[str], queue_depth: int = 4,
                 threads: int = 2) -> None:
        lib = _get_lib()
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.mvslam_loader_create(
            arr, len(self._paths), queue_depth, threads
        )
        self._buf = np.empty(_MAX_PIXELS, np.float32)

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._handle:
            self._lib.mvslam_loader_destroy(self._handle)
            self._handle = None

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        h = ctypes.c_int()
        w = ctypes.c_int()
        idx = ctypes.c_int()
        while True:
            rc = self._lib.mvslam_loader_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                _MAX_PIXELS, ctypes.byref(h), ctypes.byref(w),
                ctypes.byref(idx),
            )
            if rc == 1:
                return
            if rc != 0:
                raise IOError(f"decode failed ({rc}) for frame {idx.value}")
            PrefetchLoader.delivered += 1
            yield idx.value, (
                self._buf[: h.value * w.value]
                .reshape(h.value, w.value)
                .copy()
            )
