"""Native (C) host components, built on demand with a NumPy fallback.

``load_fastraw()`` returns the fastraw reader (``fastraw.c``), building it
with the system C compiler on first use into ``ptyrad_tpu_torch/_build/``,
or None when that fails: callers then take the NumPy path, which reads the
same bytes. ``fastraw.c`` has a plain C interface, loaded through ctypes, so
the build needs no Python headers.

The port's counterpart of ptyrad_tpu/native/__init__.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_CACHED = None
_TRIED = False
BUILD_ERROR: Optional[str] = None  # why the last build or load failed, if it did


def _build_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


class FastRaw:
    """The loaded reader: ``read_frames`` as the JAX package's extension
    offers it, on top of the C function ``ptyrad_read_frames``."""

    def __init__(self, handle: ctypes.CDLL):
        fn = handle.ptyrad_read_frames
        fn.argtypes = [ctypes.c_char_p] + [ctypes.c_int64] * 7 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        fn.restype = ctypes.c_int
        self._fn = fn

    def read_frames(self, path: str, n: int, h: int, w: int, itemsize: int, offset: int,
                    gap: int, nthreads: int) -> np.ndarray:
        """The n frames of (h, w) values of ``itemsize`` bytes, without
        their gaps, as a writable flat uint8 array (``np.frombuffer`` or
        ``.view`` it as the values' dtype). Raises ValueError for an invalid
        geometry or a file too small for it, OSError when the file cannot
        be read."""
        # np.empty, not bytearray: no zero-fill pass over a multi-GB stack
        out = np.empty(max(int(n) * int(h) * int(w) * int(itemsize), 0), np.uint8)
        need = ctypes.c_int64(0)
        err = self._fn(os.fsencode(path), int(n), int(h), int(w), int(itemsize), int(offset),
                       int(gap), int(nthreads), out.ctypes.data, ctypes.byref(need))
        if err == -1:
            raise ValueError("invalid raw geometry")
        if err == -2:
            raise ValueError(f"raw file too small: need {need.value} bytes "
                             f"(offset={offset}, {n} frames), have {os.path.getsize(path)}")
        if err != 0:
            raise OSError(err, os.strerror(err), path)
        return out


def load_fastraw() -> Optional[FastRaw]:
    """The fastraw reader, building it if needed, or None."""
    global _CACHED, _TRIED, BUILD_ERROR
    if _TRIED:
        return _CACHED
    _TRIED = True
    try:
        build = _build_dir()
        so_path = os.path.join(build, "libptyrad_fastraw.so")
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastraw.c")
        if not os.path.exists(so_path) or os.path.getmtime(so_path) < os.path.getmtime(src):
            os.makedirs(build, exist_ok=True)
            cc = os.environ.get("CC", "cc")
            # compile to a per-process temp name, then os.replace (atomic): an
            # interrupted or concurrent build never leaves a corrupt library
            # at the final path
            tmp_path = f"{so_path}.{os.getpid()}.tmp"
            try:
                subprocess.run([cc, "-O3", "-shared", "-fPIC", "-pthread", src, "-o", tmp_path],
                               check=True, capture_output=True)
                os.replace(tmp_path, so_path)
            finally:
                if os.path.exists(tmp_path):
                    os.remove(tmp_path)
        _CACHED = FastRaw(ctypes.CDLL(so_path))
        BUILD_ERROR = None
    except Exception as e:  # noqa: BLE001 — any failure means "use the NumPy path"
        stderr = getattr(e, "stderr", b"") or b""
        BUILD_ERROR = f"{type(e).__name__}: {e} {stderr.decode(errors='replace')}".strip()
        _CACHED = None
    return _CACHED

