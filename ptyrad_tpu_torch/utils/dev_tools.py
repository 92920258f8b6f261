"""Developer tools: structure printers, NaN checks, smoke helpers, profiling
(counterpart of ptyrad_tpu/utils/dev_tools.py, name by name).

Every function works on the tensors it is given where they lie: a check on
CUDA tensors reduces on the card and reads back scalars; nothing moves to
the CPU unless the caller passes CPU tensors. A "tree" is a PtychoParams, a
Buffers, or any nesting of dataclasses, dicts, lists and tuples whose
leaves are tensors or NumPy arrays; a leaf is named as the JAX package's
``keystr`` names it (``.obja``, ``['a']``, ``[0]``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ptyrad_tpu_torch.utils.logging import vprint


def print_package_tree(package=None, max_depth: int = 3) -> None:
    """Print the module tree of ptyrad_tpu_torch (reference dev_tools.py:14-74)."""
    import ptyrad_tpu_torch

    package = package or ptyrad_tpu_torch
    root = os.path.dirname(package.__file__)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames) if not d.startswith(("_", "."))]
        depth = dirpath[len(root):].count(os.sep)
        if depth >= max_depth:
            dirnames[:] = []
            continue
        indent = "  " * depth
        vprint(f"{indent}{os.path.basename(dirpath)}/")
        for f in sorted(filenames):
            if f.endswith(".py"):
                vprint(f"{indent}  {f}")


def _leaves(tree, path: str = ""):
    """(keystr path, leaf) pairs of a tree, None leaves skipped."""
    if tree is None:
        return
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, float, int)):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def _inexact(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point() or leaf.is_complex()
    arr = np.asarray(leaf)
    return np.issubdtype(arr.dtype, np.floating) or np.issubdtype(arr.dtype, np.complexfloating)


def check_nan_inf(tree, name: str = "tree", raise_on_bad: bool = False) -> bool:
    """NaN/Inf check over a tree (reference dev_tools.py:76-92), each
    tensor counted on its own device. Returns True when clean."""
    bad = []
    for path, leaf in _leaves(tree):
        if not _inexact(leaf):
            continue
        if isinstance(leaf, torch.Tensor):
            n_nan, n_inf = int(torch.isnan(leaf).sum()), int(torch.isinf(leaf).sum())
        else:
            arr = np.asarray(leaf)
            n_nan, n_inf = int(np.isnan(arr).sum()), int(np.isinf(arr).sum())
        if n_nan or n_inf:
            bad.append(f"{name}{path}: {n_nan} NaN, {n_inf} Inf")
    for line in bad:
        vprint(f"WARNING: {line}")
    if bad and raise_on_bad:
        raise FloatingPointError(f"NaN/Inf found in {name}: {bad}")
    return not bad


def print_tree_sizes(tree, name: str = "tree") -> int:
    """Print per-leaf shapes/dtypes/bytes and the total (reference 94-105);
    returns the total bytes."""
    total = 0
    for path, leaf in _leaves(tree):
        if not hasattr(leaf, "shape"):
            continue
        if isinstance(leaf, torch.Tensor):
            nbytes = leaf.numel() * leaf.element_size()
            where = f" on {leaf.device}"
        else:
            nbytes = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
            where = ""
        total += nbytes
        vprint(f"  {name}{path}: {tuple(leaf.shape)} {leaf.dtype}{where} {nbytes/1e6:.2f} MB")
    vprint(f"  total: {total/1e6:.2f} MB")
    return total


def check_modes_ortho(modes, atol: float = 1e-4) -> bool:
    """Verify mutual orthogonality of mixed-state modes (reference 107-125):
    the Gram matrix of a complex tensor (on its device) or array of shape
    (n, Ny, Nx)."""
    t = modes if isinstance(modes, torch.Tensor) else torch.as_tensor(np.asarray(modes))
    flat = t.reshape(t.shape[0], -1)
    gram = flat @ flat.conj().T
    off = gram - torch.diag(torch.diagonal(gram))
    max_off = float(off.abs().max())
    scale = float(torch.diagonal(gram).abs().max())
    ok = max_off < atol * max(scale, 1e-12)
    vprint(f"mode orthogonality: max off-diagonal / max power = {max_off/max(scale,1e-12):.2e} "
           f"({'OK' if ok else 'NOT orthogonal'})")
    return ok


def yaml_to_json(yaml_path: str, json_path: Optional[str] = None) -> str:
    """Convert a params YAML to JSON (reference 127-143)."""
    import json

    import yaml

    with open(yaml_path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f)
    json_path = json_path or os.path.splitext(yaml_path)[0] + ".json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, default=str)
    return json_path


def test_loss_fn(params, buffers, geom, indices, loss_params=None):
    """Smoke-run the loss terms for a batch and print each value (reference
    dev_tools.py:146-160): forward() (B4a on the card at N <= 128) and
    combined_loss, without gradients, on the parameters' device. Returns
    (total, {term: value}) as floats."""
    from ptyrad_tpu_torch.losses import combined_loss
    from ptyrad_tpu_torch.models.forward import forward, get_measurements

    idx = torch.as_tensor(np.asarray(indices), device=params.obja.device)
    with torch.no_grad():
        dp, (obja_p, objp_p) = forward(params, buffers, geom, idx)
        meas = get_measurements(buffers, geom, idx)
        total, terms = combined_loss(dp, meas, obja_p, objp_p, buffers.omode_occu, loss_params)
    for name, val in terms.items():
        vprint(f"  {name}: {float(val):.6f}")
    vprint(f"  total: {float(total):.6f}")
    return float(total), {k: float(v) for k, v in terms.items()}


def test_constraint_fn(params, buffers, geom, constraint_params):
    """Apply the constraints once to a copy of the params and report each
    tensor's max |delta| (reference dev_tools.py:162-173), at the LCM of the
    active frequencies: niter = max(freqs) would skip a constraint whose
    freq does not divide it (the gate is niter % freq == 0) and misreport it
    as a no-op. Returns the constrained copy; ``params`` is not touched."""
    from ptyrad_tpu_torch.constraints import ConstraintScheduler

    sched = ConstraintScheduler(constraint_params, geom)
    after = dataclasses.replace(params, **{name: t.detach().clone()
                                           for name, t in params.named()})
    freqs = [f for _, f, _, _ in sched._active] or [1]
    niter = int(np.lcm.reduce(np.asarray(freqs, dtype=np.int64)))
    sched(after, buffers, niter)
    for name, b in params.named():
        a = getattr(after, name)
        delta = float((a - b.detach()).abs().max()) if b.numel() else 0.0
        vprint(f"  params.{name}: max |delta| = {delta:.3e}")
    return after


# ---------------------------------------------------------------------------
# Timing / profiling
# ---------------------------------------------------------------------------

def time_sync(*tensors) -> float:
    """perf_counter after the devices of the given tensors (any tree) have
    finished their queued work (reference utils/common.py:553-567): each
    CUDA device among them is synchronised; with no tensors, the current
    CUDA device if CUDA has started."""
    devices = {leaf.device for tree in tensors for _, leaf in _leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    if not tensors and torch.cuda.is_available() and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for device in devices:
        torch.cuda.synchronize(device)
    return time.perf_counter()


@contextlib.contextmanager
def trace(log_dir: str = "ptyrad_tpu_torch_trace"):
    """A torch.profiler context over the host and, where CUDA is available,
    the card, writing a Chrome trace (chrome://tracing, Perfetto) to
    <log_dir>/trace.json on exit. Yields that path.

    The trace holds the port's spans (utils/tracing.py) as ranges of the
    profiler's own: ``ptyrad.iter`` (an iteration of recon_loop) with
    ``ptyrad.iter.batches``, ``ptyrad.iter.table``,
    ``ptyrad.iter.constraints`` (each due constraint under
    ``ptyrad.constraint.<name>``) and ``ptyrad.iter.end``; ``ptyrad.step``
    (a batch) with ``ptyrad.step.loss``, ``ptyrad.step.backward`` and
    ``ptyrad.step.optimizer``; the model's ``ptyrad.model.patches``,
    ``.probe``, ``.propagators``, ``.measurements``, ``.multislice`` and
    ``.loss``; set-up's ``ptyrad.setup.optimizer`` and
    ``ptyrad.setup.kernels``. Without a profiler the spans time the host
    alone (tracing.totals()).

    Usage: ``with trace("traces") as path: solver.run()``
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    vprint(f"Profiler trace written to {path}")
