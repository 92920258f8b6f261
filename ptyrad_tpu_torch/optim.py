"""Optimizer construction: per-tensor learning rates and start-iter gating.

Counterpart of ptyrad_tpu/optim.py (create_optimizer, mask_unstarted_grads)
for Adam, the optimizer of the ported slice:

  - one torch.optim param group per optimizable tensor, with its own lr;
    tensors with lr 0 are left out (and need no gradient);
  - gradients of tensors whose start_iter has not come are set to ZERO
    tensors, not None, so torch's Adam advances every tensor's step count
    each iteration as optax's shared ``count`` does. Zero gradients keep the
    moments at zero and the update exactly zero, and the bias correction
    matches once a gated tensor starts;
  - Adam on the complex probe works elementwise on (re, im), as optax does
    on the JAX package's (re, im) pair.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ptyrad_tpu_torch.models.state import PARAM_NAMES, PtychoParams

# The optimizer names a params file may give (the keys of the JAX package's
# registry: the torch.optim names and optax's lowercase aliases).
# params/schema.py validates against it; create_optimizer runs Adam only
# (ROADMAP item A5).
OPTIMIZER_REGISTRY_NAMES = (
    "Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "Adamax", "NAdam", "RAdam", "Adadelta",
    "LBFGS", "Rprop", "ASGD", "Adafactor", "Muon", "SparseAdam",
    "adam", "adamw", "sgd", "rmsprop", "lbfgs",
)


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
    keyword names. Marks the optimized tensors as requiring gradients.
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
    groups = []
    for pname, tensor in params.named():
        tensor.requires_grad_(lr_dict[pname] != 0)
        if lr_dict[pname] != 0:
            groups.append({"params": [tensor], "lr": lr_dict[pname], "name": pname})
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
