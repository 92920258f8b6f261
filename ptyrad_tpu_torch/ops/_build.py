"""Build the package's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface (``extern "C"`` launchers
that take raw device pointers and the CUDA stream, and return
``cudaGetLastError()``), so no PyTorch header is compiled: every source is
built by its own ``nvcc`` process, all started together, and linked into one
shared library under ``ptyrad_tpu_torch/_build/``. The library's name carries
a hash of every file under ``csrc/`` (sources and the headers they
include) and the flags, so an edit rebuilds and an unchanged tree reuses it.

The build happens at first CUDA use (``lib()``), never at import: importing
the package needs no nvcc. A failed build raises. Every launch goes through
``launch``, which makes the operand's device current around the call (a
ctypes launch runs in the current device's context, whatever stream it is
handed) and costs one device query when it already is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("patches.cu", "multislice.cu", "chain.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every launcher: pointers and the stream are c_void_p (a
# default ctypes int would cut a 64-bit pointer), sizes c_int, strides
# c_longlong, scalars c_float
SIGNATURES = {
    "ptyrad_chain_segment_fwd": (_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_chain_segment_bwd": (_P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_chain_stack_fwd": (_P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_chain_stack_bwd": (_P, _P, _P, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_chain_prepare": (_I,),
    "ptyrad_chain_plan": (_I, _I, _P),
    "ptyrad_fused_prepare": (_I,),
    "ptyrad_fused_plan": (_I, _P),
    "ptyrad_gather_patches": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_scatter_add_patches": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_dp_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_dp_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_loss_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "ptyrad_loss_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
}

_LIB = None
BUILD_SECONDS = None  # wall time of the build this process ran (None: cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def _key() -> str:
    """Hash of the flags and every file under csrc/, so an edited header
    rebuilds as an edited source does."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (one nvcc per file, in parallel) and link the
    shared library; returns its path. Reuses a library built from the same
    sources."""
    global BUILD_SECONDS
    out = BUILD_DIR / f"libptyrad_kernels_{_key()}.so"
    if out.exists():
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed to compile\n" + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_so)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, out)  # atomic: a concurrent loader never sees half a file
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        handle.ptyrad_error_string.argtypes = [ctypes.c_int]
        handle.ptyrad_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def ptr(t) -> int | None:
    """A tensor's device pointer for a launcher, or None (NULL) for an
    absent optional operand."""
    return None if t is None else t.data_ptr()


def launch(name: str, t: torch.Tensor, *args, stream: bool = True) -> None:
    """Call launcher ``name`` with ``args`` and (unless ``stream`` is False)
    the current stream of ``t``'s device last, with that device current:
    under ``torch.cuda.device`` when another one is current. Raise if it
    returns a CUDA error code."""
    fn = getattr(lib(), name)
    index = t.device.index
    guard = nullcontext() if index == torch.cuda.current_device() else torch.cuda.device(index)
    with guard:
        err = fn(*args, torch.cuda.current_stream(index).cuda_stream) if stream else fn(*args)
    check(err, name)


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        name = lib().ptyrad_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name}) at launch")
