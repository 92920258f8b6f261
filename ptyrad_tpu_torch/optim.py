"""Optimizer construction, start-iter gating and the optimizer state of a
checkpoint.

Counterpart of ptyrad_tpu/optim.py (create_optimizer, mask_unstarted_grads,
load_opt_state_hdf5) for Adam, the optimizer of the ported slice:

  - one torch.optim param group per optimized tensor, with its own lr, in
    the order update_params lists the tensors with a nonzero lr (upstream
    PtyRAD's order, which indexes the groups of its checkpoints); tensors
    with lr 0 are left out (and need no gradient);
  - gradients of tensors whose start_iter has not come are set to ZERO
    tensors, not None, so torch's Adam advances every tensor's step count
    each iteration as optax's shared ``count`` does. Zero gradients keep the
    moments at zero and the update exactly zero, and the bias correction
    matches once a gated tensor starts;
  - Adam on the complex probe works elementwise on (re, im), as optax does
    on the JAX package's (re, im) pair.

Checkpoints hold the optimizer state under ``optim_state_dict`` of
model.hdf5. The port writes torch Adam's ``state_dict`` in upstream
PtyRAD's layout (``torch_optim_state``: ``state``/``<i>``/``step``,
``exp_avg``, ``exp_avg_sq``, the probe's moments as a real view with a
trailing axis of 2, and ``param_groups``), which the JAX package reads. It
reads that layout and the JAX package's flattened-keystr layout
(``.inner_states['<name>'].inner_state[0].count``, ``.mu.<name>``,
``.nu.<name>``, the probe's as ``.probe.re``/``.probe.im``):
``load_opt_state_values`` on the dict, ``load_opt_state_hdf5`` on a file.
The JAX package's orbax directory is a format of JAX's own, which the port
neither writes nor reads.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ptyrad_tpu_torch.models.state import PARAM_NAMES, PtychoParams
from ptyrad_tpu_torch.utils.logging import vprint

# The optimizer names a params file may give (the keys of the JAX package's
# registry: the torch.optim names and optax's lowercase aliases).
# params/schema.py validates against it; create_optimizer runs Adam only
# (ROADMAP item A5).
OPTIMIZER_REGISTRY_NAMES = (
    "Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "Adamax", "NAdam", "RAdam", "Adadelta",
    "LBFGS", "Rprop", "ASGD", "Adafactor", "Muon", "SparseAdam",
    "adam", "adamw", "sgd", "rmsprop", "lbfgs",
)


class OptStateMismatchError(ValueError):
    """A checkpoint's optimizer state does not fit the current optimizer
    (another optimizer, or other tensors optimized). Raised, not warned:
    a fresh state in its place would pass for a resume."""


def parse_update_params(update_params: Optional[dict]):
    """{name: lr} and {name: start_iter} from the update_params dict
    ({name: {start_iter, lr}}); start_iter None means never (-1)."""
    update_params = update_params or {}
    lr = {name: 0.0 for name in PARAM_NAMES}
    start = {name: 1 for name in PARAM_NAMES}
    for name, cfg in update_params.items():
        if name not in PARAM_NAMES:
            raise ValueError(f"Unknown optimizable tensor '{name}'; choose from {PARAM_NAMES}")
        cfg = cfg or {}
        lr[name] = float(cfg.get("lr", 0.0) or 0.0)
        si = cfg.get("start_iter", 1)
        start[name] = int(si) if si is not None else -1
    return lr, start


def create_optimizer(optimizer_params: Optional[dict], update_params: Optional[dict],
                     params: PtychoParams):
    """(torch.optim.Adam, lr_dict, start_dict).

    optimizer_params: {'name': 'Adam', 'configs': {...}} with torch.optim.Adam
    keyword names. Marks the optimized tensors as requiring gradients. The
    groups follow update_params' order (each group's ``name`` says whose).
    """
    optimizer_params = optimizer_params or {"name": "Adam"}
    name = optimizer_params.get("name", "Adam")
    if name not in ("Adam", "adam"):
        raise NotImplementedError(
            f"optimizer '{name}': only Adam is ported (ROADMAP queue A, optimizers)")
    configs = dict(optimizer_params.get("configs") or {})
    configs.pop("lr", None)  # per-tensor lrs own this
    if configs.get("weight_decay"):
        raise NotImplementedError(
            "Adam weight_decay would move tensors before their start_iter; not ported")
    lr_dict, start_dict = parse_update_params(update_params)
    for pname, tensor in params.named():
        tensor.requires_grad_(lr_dict[pname] != 0)
    groups = [{"params": [getattr(params, pname)], "lr": lr_dict[pname], "name": pname}
              for pname in (update_params or {}) if lr_dict[pname] != 0]
    if not groups:
        raise ValueError("no tensor has a nonzero lr in update_params")
    return torch.optim.Adam(groups, **configs), lr_dict, start_dict


def mask_unstarted_grads(params: PtychoParams, niter: int, start_dict: Dict[str, int]) -> None:
    """Zero the gradients of tensors whose start_iter has not been reached
    (start_iter -1: never), and give every optimized tensor a gradient."""
    for name, tensor in params.named():
        if not tensor.requires_grad:
            continue
        if tensor.grad is None:
            tensor.grad = torch.zeros_like(tensor)
        si = start_dict.get(name, 1)
        if si < 0 or niter < si:
            tensor.grad.zero_()


# ---------------------------------------------------------------------------
# The optimizer state of a checkpoint
# ---------------------------------------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a state tensor; a complex one as its real view (..., 2)."""
    t = t.detach()
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.cpu().numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def torch_optim_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The optimizer's state_dict in upstream PtyRAD's checkpoint layout, on
    the host: {"state": {"<i>": {"step", "exp_avg", "exp_avg_sq"}},
    "param_groups": [...]}, group i being the i-th tensor update_params
    lists with a nonzero lr."""
    sd = optimizer.state_dict()
    state = {str(i): {k: _host(v) if isinstance(v, torch.Tensor) else v for k, v in entry.items()}
             for i, entry in sd["state"].items()}
    return {"state": state, "param_groups": [dict(g) for g in sd["param_groups"]]}


def _keystr_prefix(name: str) -> str:
    return f".inner_states['{name}'].inner_state[0]"


def _moment_keys(name: str, moment: str) -> List[str]:
    leaf = f"{_keystr_prefix(name)}.{moment}.{name}"
    return [f"{leaf}.re", f"{leaf}.im"] if name == "probe" else [leaf]


def torch_layout_to_keystr(torch_state: Dict[str, Any], names: List[str]) -> Dict[str, Any]:
    """Upstream's torch layout as the JAX package's keystr layout (the port's
    copy of ptyrad_tpu/optim.py:convert_torch_optim_state): group i is
    ``names[i]``, step -> count, exp_avg/exp_avg_sq -> mu/nu, the probe's
    trailing real axis -> .re/.im."""
    state = torch_state.get("state") or {}
    out: Dict[str, Any] = {}
    for i, name in enumerate(names):
        entry = state.get(str(i), state.get(i))
        if entry is None:
            continue
        out[f"{_keystr_prefix(name)}.count"] = np.asarray(entry["step"])
        for torch_key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            arr = np.asarray(entry[torch_key])
            keys = _moment_keys(name, moment)
            if name == "probe":
                out[keys[0]], out[keys[1]] = arr[..., 0], arr[..., 1]
            else:
                out[keys[0]] = arr
    return out


_CANON_VOCAB = frozenset({"mu", "nu", "count", "re", "im", *PARAM_NAMES})


def _canonical_key(keystr: str) -> tuple:
    """The meaningful tokens of a keystr (moment and tensor names), without
    optax's wrapper names, which optax may rename between versions (as
    ptyrad_tpu/optim.py:_canonical_key)."""
    return tuple(t for t in re.findall(r"\w+", keystr) if t in _CANON_VOCAB)


def load_opt_state_values(optimizer: torch.optim.Optimizer, values: Dict[str, Any]) -> None:
    """Set the optimizer's state from a checkpoint's ``optim_state_dict``
    (either layout, as NumPy values). Each optimized tensor takes its step
    and both moments, or stays fresh with a warning when the checkpoint
    lacks any of them; a complex tensor's moments come back complex, and the
    step stays on the CPU unless the group is capturable or fused (torch
    Adam's own placement). Raises OptStateMismatchError when no tensor
    matches (a structurally different optimizer, e.g. one with gradient
    accumulation) or the optimizer keeps state neither layout holds
    (amsgrad), and ValueError when a moment's size differs."""
    groups = optimizer.param_groups
    names = [g["name"] for g in groups]
    if any(g.get("amsgrad") for g in groups):
        raise OptStateMismatchError(
            "Adam(amsgrad=True) keeps max_exp_avg_sq, which no checkpoint layout holds")
    if "state" in values and "param_groups" in values:
        values = torch_layout_to_keystr(values, names)
    wanted = {name: [f"{_keystr_prefix(name)}.count"] + _moment_keys(name, "mu")
              + _moment_keys(name, "nu") for name in names}
    if len(values) == sum(len(k) for k in wanted.values()):
        # as many arrays as wanted: match optax paths renamed between
        # versions by their tokens (unique ones only)
        by_token: Dict[tuple, Optional[str]] = {}
        for k in values:
            t = _canonical_key(k)
            by_token[t] = None if t in by_token else k
        values = dict(values)
        for key in (k for keys in wanted.values() for k in keys if k not in values):
            alias = by_token.get(_canonical_key(key))
            if alias is not None:
                values[key] = values[alias]
    restored, fresh = {}, []
    for group, name in zip(groups, names):
        keys = wanted[name]
        if not all(k in values for k in keys):
            fresh.append(name)
            continue
        p = group["params"][0]
        arrays = [np.asarray(values[k], dtype=np.float32) for k in keys[1:]]
        if name == "probe":
            arrays = [a + 1j * b for a, b in (arrays[:2], arrays[2:])]
        mu, nu = (torch.tensor(np.asarray(a).reshape(p.shape), dtype=p.dtype, device=p.device)
                  for a in arrays)
        on_device = group.get("capturable") or group.get("fused")
        step = torch.tensor(float(np.asarray(values[keys[0]])), dtype=torch.float32,
                            device=p.device if on_device else "cpu")
        restored[p] = {"step": step, "exp_avg": mu, "exp_avg_sq": nu}
    if not restored:
        sample = next(iter(values), "<empty>")
        raise OptStateMismatchError(
            "optimizer state mismatch: no checkpoint entry matches the optimized tensors "
            f"{names} (checkpoint keys look like '{sample}'); was it saved with another "
            "optimizer, other tensors optimized or gradient accumulation?")
    for p, state in restored.items():  # all or nothing: a raise above leaves it fresh
        optimizer.state[p] = state
    if fresh:
        vprint(f"WARNING: partial optimizer-state restore: {fresh} had no complete entry in "
               "the checkpoint and start fresh")


def load_opt_state_hdf5(optimizer: torch.optim.Optimizer, ckpt_path: str) -> None:
    """load_opt_state_values from a model.hdf5's ``optim_state_dict`` (one
    written by either package or by upstream PtyRAD); needs h5py. A
    checkpoint saved without 'optim_state' in save_result raises
    ValueError."""
    from ptyrad_tpu_torch.load import load_hdf5

    values = load_hdf5(ckpt_path, key="optim_state_dict")
    if not isinstance(values, dict) or not values:
        raise ValueError(f"'{ckpt_path}' has no optimizer state; save it with 'optim_state' "
                         "in recon_params.save_result")
    load_opt_state_values(optimizer, values)
