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

At N that is not a power of two the chain kernels come from libraries of
their own for each such N (``mixed_lib``): up to 128 the fused kernels
(B3/B4), ``multislice.cu`` compiled with the plan of
``ops/fused_plan.py``; in (128, 512] the segmented chain (B5/B6),
``chain.cu`` with the plan of ``ops/chain_plan.py``. A generated source
defines the plan and includes the kernel file; the float32 kernels and
their ``_bf16`` twins are two libraries, each built by its own nvcc at its
first use (``launch(..., n=N)``, or ``prepare`` of ``fused_multislice`` or
``chain`` ahead of it), so a run that never rounds operands at N never
compiles the twin. A library's name carries the same hash plus its
generated source's; ``build(extra_n=..., bf16_n=...)`` starts those builds
beside the main library's.
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

from ptyrad_tpu_torch.ops import chain_plan
from ptyrad_tpu_torch.ops.fused_plan import is_pow2, plan_source
from ptyrad_tpu_torch.utils.tracing import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("patches.cu", "multislice.cu", "chain.cu", "multislice_bf16.cu", "chain_bf16.cu")
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
    "ptyrad_gather_patches": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_scatter_add_patches": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_dp_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_dp_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _P),
    "ptyrad_loss_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "ptyrad_loss_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
}

# Launchers with a bfloat16-operand twin of the same signature, name + "_bf16"
# (multislice_bf16.cu and chain_bf16.cu: the chain sources compiled with
# every transform pass rounding its operand; launch(..., bf16_operands=True))
BF16_VARIANTS = ("ptyrad_chain_segment_fwd", "ptyrad_chain_segment_bwd",
                 "ptyrad_chain_stack_fwd", "ptyrad_chain_stack_bwd", "ptyrad_chain_prepare",
                 "ptyrad_fused_prepare", "ptyrad_dp_fwd", "ptyrad_dp_bwd", "ptyrad_loss_fwd",
                 "ptyrad_loss_bwd")

# the entry points of a mixed-radix library (mixed_lib): the fused kernels'
# at N <= 128, the segmented chain's above
FUSED_ENTRIES = ("ptyrad_dp_fwd", "ptyrad_dp_bwd", "ptyrad_loss_fwd", "ptyrad_loss_bwd",
                 "ptyrad_fused_prepare", "ptyrad_fused_plan")
CHAIN_ENTRIES = ("ptyrad_chain_segment_fwd", "ptyrad_chain_segment_bwd",
                 "ptyrad_chain_stack_fwd", "ptyrad_chain_stack_bwd", "ptyrad_chain_prepare",
                 "ptyrad_chain_plan")
PLAN_ENTRIES = ("ptyrad_fused_plan", "ptyrad_chain_plan")  # no _bf16 twin

_LIB = None
_MIXED = {}  # (N, bf16) -> the loaded mixed-radix library
BUILD_SECONDS = None  # wall time of the build this process ran (None: cached)
MIXED_BUILD_SECONDS = {}  # N, or "N_bf16" -> seconds of that mixed-radix build this process ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def _key(extra=()) -> str:
    """Hash of the flags (and ``extra`` ones) and every file under csrc/, so
    an edited header rebuilds as an edited source does."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra)).encode())
    for path in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


class _Job:
    """One library's build: its nvcc processes, started at once, then the
    link (finish)."""

    def __init__(self, out: Path, sources=SOURCES, generated=None, nice: int = 0):
        """sources: files of csrc/; generated: {file name: text} of
        sources written into the build's directory (they include csrc/);
        nice: the compiles' niceness increment."""
        self.out, self.t0, self.compiled_at = out, time.perf_counter(), None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        self.tmp = tempfile.TemporaryDirectory(dir=BUILD_DIR)
        paths = [CSRC / name for name in sources]
        for name, text in (generated or {}).items():
            paths.append(Path(self.tmp.name) / name)
            paths[-1].write_text(text)
        self.objs, self.procs = [], []
        for path in paths:
            obj = Path(self.tmp.name) / (path.stem + ".o")
            self.objs.append(str(obj))
            self.procs.append((path.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(path), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                preexec_fn=(lambda: os.nice(nice)) if nice else None)))

    def compiled(self) -> bool:
        """Whether every compile has ended (the first time: when)."""
        if self.compiled_at is None and all(proc.poll() is not None for _, proc in self.procs):
            self.compiled_at = time.perf_counter()
        return self.compiled_at is not None

    def finish(self) -> float:
        """Wait for the compiles, link, and return the build's own seconds
        (to the compiles' end, then the link)."""
        with self.tmp:
            failed = []
            for name, proc in self.procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{name}:\n{log}")
            if failed:
                raise RuntimeError("nvcc failed to compile\n" + "\n".join(failed))
            self.compiled()
            t_link = time.perf_counter()
            tmp_so = Path(self.tmp.name) / self.out.name
            link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", *self.objs, "-o", str(tmp_so)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc failed to link:\n{link.stdout}{link.stderr}")
            os.replace(tmp_so, self.out)  # atomic: a concurrent loader never sees half a file
        return self.compiled_at - self.t0 + time.perf_counter() - t_link


def _mixed_kind(n: int) -> str:
    """Which kernels N's mixed-radix library holds: "fused" (B3/B4, N <=
    128) or "chain" (B5/B6, N in (128, 512])."""
    if chain_plan.takes(n):
        return "chain"
    if 2 <= n <= 128 and not is_pow2(n):
        return "fused"
    raise ValueError(f"no mixed-radix library for N = {n}: N <= 512 and not a power of two")


def _mixed_sources(n: int, variants=(False, True)) -> dict:
    """The generated sources of N's mixed-radix libraries: the float32
    kernels' (False in variants) and the _bf16 twins' (True)."""
    stem, source = ((f"chain_n{n}", chain_plan.plan_source) if _mixed_kind(n) == "chain"
                    else (f"multislice_n{n}", plan_source))
    return {f"{stem}{'_bf16' if bf16 else ''}.cu": source(n, bf16_operands=bf16)
            for bf16 in variants}


def _mixed_path(n: int, bf16: bool = False) -> Path:
    key = _key(tuple(_mixed_sources(n, (bf16,)).values()))
    return BUILD_DIR / f"libptyrad_{_mixed_kind(n)}_n{n}{'_bf16' if bf16 else ''}_{key}.so"


def _mixed_job(n: int, bf16: bool, nice: int = 0) -> _Job:
    return _Job(_mixed_path(n, bf16), (), _mixed_sources(n, (bf16,)), nice=nice)


def build(extra_n=(), bf16_n=()) -> Path:
    """Compile the sources (one nvcc per file, in parallel) and link the
    shared library; returns its path. Reuses a library built from the same
    sources. ``extra_n``, ``bf16_n``: N that are not powers of two whose
    mixed-radix libraries (mixed_lib: the float32 kernels', the _bf16
    twins') build at the same time, beside it."""
    global BUILD_SECONDS
    out = BUILD_DIR / f"libptyrad_kernels_{_key()}.so"
    main = None if out.exists() else _Job(out)
    # beside the main build the mixed-radix ones yield the cores to it: its
    # unrolled multislice.cu compiles are the longest (about 110 s alone on
    # an H100 host's CPU)
    wanted = [(n, False) for n in extra_n] + [(n, True) for n in bf16_n]
    extra = {key: _mixed_job(*key, nice=10 if main else 0)
             for key in dict.fromkeys(wanted) if not _mixed_path(*key).exists()}
    jobs = [job for job in (main, *extra.values()) if job is not None]
    while not all([job.compiled() for job in jobs]):  # each build's own end
        time.sleep(0.1)
    if main is not None:
        BUILD_SECONDS = main.finish()
    for (n, bf16), job in extra.items():
        MIXED_BUILD_SECONDS[f"{n}_bf16" if bf16 else n] = job.finish()
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (the call that loads
    it runs under the ``ptyrad.setup.kernels`` span: the sources' hash, any
    build, the load and the argtypes)."""
    global _LIB
    if _LIB is None:
        with span("ptyrad.setup.kernels"):
            handle = ctypes.CDLL(str(build()))
            entries = {**SIGNATURES, **{n + "_bf16": SIGNATURES[n] for n in BF16_VARIANTS}}
            for name, argtypes in entries.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.ptyrad_error_string.argtypes = [ctypes.c_int]
            handle.ptyrad_error_string.restype = ctypes.c_char_p
            _LIB = handle
    return _LIB


def mixed_lib(n: int, bf16: bool = False) -> ctypes.CDLL:
    """The loaded mixed-radix library at N (not a power of two, at most
    512): B3/B4's up to 128, B5/B6's above; with bf16 the _bf16 twins' (no
    plan entry point); built on first call. Its entry points take that N
    alone. The call that loads it runs under the ``ptyrad.setup.kernels``
    span, as lib()'s does."""
    key = (n, bf16)
    if key not in _MIXED:
        with span("ptyrad.setup.kernels"):
            path = _mixed_path(n, bf16)
            if not path.exists():
                MIXED_BUILD_SECONDS[f"{n}_bf16" if bf16 else n] = _mixed_job(n, bf16).finish()
            handle = ctypes.CDLL(str(path))
            for name in CHAIN_ENTRIES if _mixed_kind(n) == "chain" else FUSED_ENTRIES:
                if bf16 and name in PLAN_ENTRIES:
                    continue
                fn = getattr(handle, name + ("_bf16" if bf16 else ""))
                fn.argtypes = list(SIGNATURES[name])
                fn.restype = ctypes.c_int
            _MIXED[key] = handle
    return _MIXED[key]


def ptr(t) -> int | None:
    """A tensor's device pointer for a launcher, or None (NULL) for an
    absent optional operand."""
    return None if t is None else t.data_ptr()


def launch(name: str, t: torch.Tensor, *args, stream: bool = True,
           bf16_operands: bool = False, n: int | None = None) -> None:
    """Call launcher ``name`` (its bfloat16-operand twin with
    ``bf16_operands``, BF16_VARIANTS) with ``args`` and (unless ``stream``
    is False) the current stream of ``t``'s device last, with that device
    current: under ``torch.cuda.device`` when another one is current. Raise
    if it returns a CUDA error code. ``n``: the kernels' N, whose launcher
    comes from mixed_lib(n, bf16_operands) when N is not a power of two."""
    handle = lib() if n is None or is_pow2(n) else mixed_lib(n, bf16_operands)
    fn = getattr(handle, name + "_bf16" if bf16_operands else name)
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
