"""Optimizer construction, start-iter gating and the optimizer state of a
checkpoint.

Counterpart of ptyrad_tpu/optim.py (create_optimizer, mask_unstarted_grads,
load_opt_state_hdf5). The JAX package runs optax's update rules with
torch-named configs translated onto optax's names (``_translate_configs``);
the port computes the same rules:

  - one param group per optimized tensor, with its own lr, in the order
    update_params lists the tensors with a nonzero lr (upstream PtyRAD's
    order, which indexes the groups of its checkpoints); tensors with lr 0
    are left out (and need no gradient), as optax.set_to_zero leaves them;
  - gradients of tensors whose start_iter has not come are set to ZERO
    tensors, not None, so every tensor's step count advances each batch as
    optax's per-tensor ``count`` does; the solver also puts the updates of
    those tensors back (weight decay would move them otherwise);
  - Adam and SparseAdam (dense gradients: Adam's rule) are torch.optim.Adam,
    whose rule is optax.adam's, a ``weight_decay`` coupled into the gradient
    as optax.add_decayed_weights ahead of it, while ``eps_root`` is 0,
    ``nesterov`` false and ``mu_dtype`` None; otherwise, and for every other
    family, an ``OptaxRule``, a torch.optim.Optimizer that computes optax's
    rule leaf by leaf, the complex probe as its (re, im) pair of real leaves
    (optax's leaves in the JAX package), with the chain's scalars in
    float32;
  - every optax config a params file can spell is computed: the moments'
    storage dtypes (``mu_dtype``, ``accumulator_dtype``,
    ``dtype_momentum``: a name such as "bfloat16", the moment rounded as
    optax rounds it) and the decay masks as bools (``mask``,
    ``weight_decay_mask``: False turns the decay off). Muon's
    ``muon_weight_dimension_numbers`` and LBFGS's ``linesearch`` take
    optax objects and raise unless None, as does a mask that is not a bool;
  - a torch-only config (Adam's ``amsgrad``, RMSprop's ``alpha``, ...) is
    dropped with the JAX package's warning, never switched on;
  - ``grad_accumulation`` k > 1 wraps the optimizer in ``MultiSteps``
    (optax.MultiSteps); LBFGS is optim_lbfgs.LBFGS and is never wrapped.

Checkpoints hold the optimizer state under ``optim_state_dict`` of
model.hdf5 (``optim_state_values``). torch's Adam writes its
``state_dict`` in upstream PtyRAD's layout (``torch_optim_state``:
``state``/``<i>``/``step``, ``exp_avg``, ``exp_avg_sq``, the probe's moments
as a real view with a trailing axis of 2, and ``param_groups``), which the
JAX package reads. Every other optimizer writes the JAX package's
flattened-keystr layout, the keys ptyrad_tpu/save.py writes for that optax
state (``.inner_states['<name>'].inner_state[0].mu.<name>``, the probe's
as ``.probe.re``/``.probe.im``; ``.mini_step``, ``.acc_grads.<name>`` and
``.inner_opt_state...`` with accumulation; ``[1][0].diff_params_memory``
... for LBFGS). Both layouts are read (``load_opt_state_values`` on the
dict, ``load_opt_state_hdf5`` on a file): a checkpoint none of whose
arrays fits raises OptStateMismatchError, as the JAX package's
_apply_keystr_dict does; one that fits in part warns. A float16 moment
is written as float16; a bfloat16 one as its raw bits (``bf16_bits``), the
opaque 2-byte dataset the JAX package writes, which neither package's
reader casts back: such a state does not resume (the solver warns and
starts fresh). The JAX package's orbax directory is a format of JAX's
own, which the port neither writes nor reads.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ptyrad_tpu_torch.models.state import PARAM_NAMES, PtychoParams
from ptyrad_tpu_torch.utils.logging import vprint

F32 = np.float32


class OptStateMismatchError(ValueError):
    """A checkpoint's optimizer state does not fit the current optimizer
    (another optimizer, other tensors optimized or gradient accumulation).
    Raised, not warned: a fresh state in its place would pass for a
    resume."""


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


def started(name: str, niter: int, start_dict: Dict[str, int]) -> bool:
    """Has tensor ``name`` reached its start_iter at iteration niter
    (start_iter -1: never)?"""
    si = start_dict.get(name, 1)
    return si >= 0 and niter >= si


def mask_unstarted_grads(params: PtychoParams, niter: int, start_dict: Dict[str, int]) -> None:
    """Zero the gradients of tensors whose start_iter has not been reached,
    and give every optimized tensor a gradient."""
    for name, tensor in params.named():
        if not tensor.requires_grad:
            continue
        if tensor.grad is None:
            tensor.grad = torch.zeros_like(tensor)
        if not started(name, niter, start_dict):
            tensor.grad.zero_()


def unstarted_tensors(params: PtychoParams, niter: int, start_dict: Dict[str, int]) -> list:
    """The optimized tensors whose start_iter has not come: their updates
    are masked (the solver puts their values back after a step)."""
    return [t for name, t in params.named()
            if t.requires_grad and not started(name, niter, start_dict)]


# ---------------------------------------------------------------------------
# Leaves and keys
# ---------------------------------------------------------------------------

def leaves(t: torch.Tensor) -> List[torch.Tensor]:
    """optax's leaves of a tensor: itself, or a complex one's (re, im) pair
    as views into it."""
    if t.is_complex():
        r = torch.view_as_real(t)
        return [r[..., 0], r[..., 1]]
    return [t]


def leaf_keys(name: str, t: torch.Tensor) -> List[str]:
    """The keystr suffixes of a tensor's leaves: ``.name`` or
    ``.probe.re``/``.probe.im``."""
    return [f".{name}.re", f".{name}.im"] if t.is_complex() else [f".{name}"]


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor on the host as the JAX package writes one: its raw
    16 bits as a 2-byte opaque ('V2') array, which h5py stores as an
    opaque dataset (NumPy has no bfloat16)."""
    return t.detach().cpu().view(torch.int16).numpy().view("V2").copy()


def _host(t) -> np.ndarray:
    """A host copy of a state value; a complex tensor as its real view
    (..., 2), a bfloat16 one as its bits (bf16_bits)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.is_complex():
            t = torch.view_as_real(t)
        if t.dtype == torch.bfloat16:
            return bf16_bits(t)
        return t.cpu().numpy().copy()
    return np.asarray(t)


def _widened(a) -> np.ndarray:
    """A getter's host array as its setter takes it back: bfloat16 bits
    widened to float32 (exact), anything else as it is."""
    a = np.asarray(a)
    if a.dtype.kind != "V":
        return a
    return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _numeric(arr) -> np.ndarray:
    """A checkpoint array that casts to a number type. A 2-byte opaque one
    (bfloat16's bits) raises ValueError, as in the JAX package's reader,
    which has no cast for it either: a bfloat16 optimizer state does not
    resume, and the solver warns and starts fresh."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V":
        raise ValueError(f"No cast function available for a checkpoint array of type "
                         f"{arr.dtype} (bfloat16's bits)")
    return arr


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=dtype))


def _decayed(t: torch.Tensor, decay: float) -> torch.Tensor:
    """decay * t in t's dtype with decay first rounded to it, as JAX's weakly
    typed Python scalar (torch would multiply by the float32 scalar); for a
    float32 t the product torch computes anyway."""
    return t * _rounded(decay, t.dtype)


def _store(slot: list, i: int, value: torch.Tensor) -> None:
    """slot[i] = value cast to the slot's storage dtype (optax.tree.cast
    after the update: the update itself comes from the float32 value)."""
    slot[i] = value.to(slot[i].dtype)


def _pow32(base: float, count: int) -> np.float32:
    """base ** count in float32, as optax's weakly typed scalar arithmetic."""
    return F32(base) ** F32(count)


def _bias_correction(t: torch.Tensor, decay: float, count: int) -> torch.Tensor:
    """optax.tree.bias_correction: t / (1 - decay ** count)."""
    return t / float(F32(1) - _pow32(decay, count))


# ---------------------------------------------------------------------------
# optax's rules as torch optimizers
# ---------------------------------------------------------------------------

class OptaxRule(torch.optim.Optimizer):
    """One of optax's update rules over one param group per tensor.

    Per tensor the state holds slots: a count (a Python int), a tensor, or
    a list of tensors, one per leaf (None where the slot does not apply to
    a leaf). ``paths`` maps each slot to its place in the optax state
    (``[0].mu``); with ``coupled_wd`` the rule runs behind
    optax.add_decayed_weights (grad + wd param), which puts it at ``[1]``
    of a chain. Subclasses define ``init_slots(leaves, lr)`` and
    ``update(grads, state, leaves, lr)``, which returns the update of each
    leaf (added to the parameter) and updates the state in place; a rule
    with ``takes_slab`` gets each group's ``slab`` as a keyword of both.
    """

    paths: Dict[str, str] = {}
    # a rule whose update reduces over a whole tensor (Adafactor) takes the
    # ``slab`` of the tensor's group: the parallel.canvas.CanvasShard that
    # create_optimizer puts in obja's and objp's groups under canvas sharding
    takes_slab = False

    def __init__(self, groups, coupled_wd: float = 0.0, **hyper):
        super().__init__(groups, {})
        self.hyper = hyper
        self.coupled_wd = float(coupled_wd)
        self.prefix = "[1]" if self.coupled_wd else ""

    def init_slots(self, lv: List[torch.Tensor], lr: float) -> dict:
        raise NotImplementedError

    def update(self, grads, state, lv, lr):
        raise NotImplementedError

    def _slab_arg(self, group) -> dict:
        return {"slab": group.get("slab")} if self.takes_slab else {}

    def slot_state(self, group) -> dict:
        p = group["params"][0]
        st = self.state[p]
        if not st:
            st.update(self.init_slots([x.detach() for x in leaves(p)], group["lr"],
                                      **self._slab_arg(group)))
        return st

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            p = group["params"][0]
            st = self.slot_state(group)
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            lv = leaves(p)
            gl = leaves(g)
            if self.coupled_wd:
                gl = [x + self.coupled_wd * w for x, w in zip(gl, lv)]
            for w, u in zip(lv, self.update(gl, st, lv, group["lr"], **self._slab_arg(group))):
                w.add_(u)

    def keyed_arrays(self) -> list:
        """(key, getter, setter) for every array of the state, in the JAX
        package's keystr naming; a getter gives a host copy, a setter takes
        a checkpoint array."""
        out = []
        for group in self.param_groups:
            name, p = group["name"], group["params"][0]
            st = self.slot_state(group)
            head = f".inner_states['{name}'].inner_state{self.prefix}"
            for slot, path in self.paths.items():
                v = st[slot]
                if isinstance(v, int):
                    out.append((head + path, lambda st=st, slot=slot: np.int32(st[slot]),
                                lambda a, st=st, slot=slot: st.__setitem__(slot, int(a))))
                elif isinstance(v, torch.Tensor):
                    out.append((head + path, lambda st=st, slot=slot: _host(st[slot]),
                                lambda a, st=st, slot=slot: st.__setitem__(
                                    slot, _coerce(a, st[slot]))))
                else:
                    for i, suffix in enumerate(leaf_keys(name, p)):
                        if v[i] is not None:
                            out.append((head + path + suffix,
                                        lambda st=st, slot=slot, i=i: _host(st[slot][i]),
                                        lambda a, st=st, slot=slot, i=i: st[slot].__setitem__(
                                            i, _coerce(a, st[slot][i]))))
        return out


def _coerce(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A checkpoint array as a state tensor of ``like``'s shape, dtype and
    device, cast from its own type straight into like's as the JAX reader
    casts (ValueError when its size differs, as the JAX reader's reshape,
    or when it is bfloat16's bits: _numeric)."""
    arr = np.array(_numeric(arr)).reshape(tuple(like.shape))
    return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)


def _zeros(lv, dtype: Optional[torch.dtype] = None):
    """Zeros like each leaf, in ``dtype`` when given (optax.tree.zeros_like)."""
    return [torch.zeros_like(x, dtype=dtype) for x in lv]


def _decays(mask) -> bool:
    """Whether a weight decay runs under its optax ``mask``: None (no mask)
    or True keep it on, False turns it off (_translate_configs lets only a
    bool or None through)."""
    return mask is not False


class AdamRule(OptaxRule):
    """optax.scale_by_adam (+ nesterov: NAdam; eps_root; the first moment
    stored in ``mu_dtype``) then the learning rate, and optax.adamw's
    decoupled decay (``weight_decay``, off under ``mask`` False) between
    the two. A stored moment of a narrower type takes optax's order of
    rounding: b1 times it in its own type, the sum with (1 - b1) g in
    float32, the update from that float32 moment, and the moment cast to
    its type after (optax/_src/transform.py scale_by_adam)."""

    paths = {"count": "[0].count", "mu": "[0].mu", "nu": "[0].nu"}

    def init_slots(self, lv, lr):
        return {"count": 0, "mu": _zeros(lv, self.hyper.get("mu_dtype")), "nu": _zeros(lv)}

    def update(self, grads, st, lv, lr):
        h = self.hyper
        b1, b2, eps, eps_root = h["b1"], h["b2"], h["eps"], h["eps_root"]
        wd = h.get("weight_decay", 0.0) if _decays(h.get("mask")) else 0.0
        st["count"] += 1
        c = st["count"]
        out = []
        for i, (g, w) in enumerate(zip(grads, lv)):
            mu = (1 - b1) * g + _decayed(st["mu"][i], b1)
            nu = (1 - b2) * g * g + b2 * st["nu"][i]
            _store(st["mu"], i, mu)
            st["nu"][i] = nu
            if h.get("nesterov"):
                mu_hat = b1 * _bias_correction(mu, b1, c + 1) + (1 - b1) * _bias_correction(g, b1, c)
            else:
                mu_hat = _bias_correction(mu, b1, c)
            u = mu_hat / (torch.sqrt(_bias_correction(nu, b2, c) + eps_root) + eps)
            if wd:
                u = u + wd * w
            out.append(-lr * u)
        return out


class SGDRule(OptaxRule):
    """optax.sgd: optax.trace (momentum, nesterov; the trace stored in
    ``accumulator_dtype``) when momentum is given, then the learning
    rate."""

    def __init__(self, groups, coupled_wd=0.0, **hyper):
        super().__init__(groups, coupled_wd, **hyper)
        self.paths = {"trace": "[0].trace"} if hyper.get("momentum") is not None else {}

    def init_slots(self, lv, lr):
        return {"trace": _zeros(lv, self.hyper.get("accumulator_dtype"))} if self.paths else {}

    def update(self, grads, st, lv, lr):
        m = self.hyper.get("momentum")
        if m is None:
            return [-lr * g for g in grads]
        out = []
        for i, g in enumerate(grads):
            t = g + _decayed(st["trace"][i], m)
            _store(st["trace"], i, t)
            out.append(-lr * ((g + m * t) if self.hyper.get("nesterov") else t))
        return out


class RMSpropRule(OptaxRule):
    """optax.rmsprop: scale_by_rms (scale_by_stddev when centered; a count
    with bias_correction), the learning rate, then optax.trace when
    momentum is given."""

    def __init__(self, groups, coupled_wd=0.0, **hyper):
        super().__init__(groups, coupled_wd, **hyper)
        self.paths = {"nu": "[0].nu"}
        if hyper["centered"]:
            self.paths["mu"] = "[0].mu"
        if hyper["bias_correction"]:
            self.paths["count"] = "[0].count"
        if hyper.get("momentum") is not None:
            self.paths["trace"] = "[2].trace"

    def init_slots(self, lv, lr):
        st = {"nu": [torch.full_like(x, self.hyper["initial_scale"]) for x in lv]}
        if "mu" in self.paths:
            st["mu"] = _zeros(lv)
        if "count" in self.paths:
            st["count"] = 0
        if "trace" in self.paths:
            st["trace"] = _zeros(lv)
        return st

    def update(self, grads, st, lv, lr):
        h = self.hyper
        d, eps = h["decay"], h["eps"]
        if "count" in st:
            st["count"] += 1
        out = []
        for i, g in enumerate(grads):
            nu = (1 - d) * g * g + d * st["nu"][i]
            st["nu"][i] = nu
            nu_hat = _bias_correction(nu, d, st["count"]) if "count" in st else nu
            if "mu" in st:
                mu = (1 - d) * g + d * st["mu"][i]
                st["mu"][i] = mu
                mu_hat = _bias_correction(mu, d, st["count"]) if "count" in st else mu
                nu_hat = nu_hat - mu_hat * mu_hat
            if h["eps_in_sqrt"]:
                scale = torch.rsqrt(nu_hat + eps)
            else:
                scale = 1 / (torch.sqrt(nu_hat) + eps)
            u = -lr * (scale * g)
            if "trace" in st:
                m = h["momentum"]
                t = u + m * st["trace"][i]
                st["trace"][i] = t
                u = (u + m * t) if h.get("nesterov") else t
            out.append(u)
        return out


class AdagradRule(OptaxRule):
    """optax.adagrad: scale_by_rss, then the learning rate."""

    paths = {"sum_of_squares": "[0].sum_of_squares"}

    def init_slots(self, lv, lr):
        return {"sum_of_squares": [torch.full_like(x, self.hyper["initial_accumulator_value"])
                                   for x in lv]}

    def update(self, grads, st, lv, lr):
        out = []
        for i, g in enumerate(grads):
            s = g * g + st["sum_of_squares"][i]
            st["sum_of_squares"][i] = s
            inv = torch.where(s > 0, torch.rsqrt(s + self.hyper["eps"]), torch.zeros_like(s))
            out.append(-lr * (inv * g))
        return out


class AdamaxRule(OptaxRule):
    """optax.adamax: scale_by_adamax, then the learning rate."""

    paths = {"count": "[0].count", "mu": "[0].mu", "nu": "[0].nu"}

    def init_slots(self, lv, lr):
        return {"count": 0, "mu": _zeros(lv), "nu": _zeros(lv)}

    def update(self, grads, st, lv, lr):
        b1, b2, eps = self.hyper["b1"], self.hyper["b2"], self.hyper["eps"]
        st["count"] += 1
        out = []
        for i, g in enumerate(grads):
            mu = (1 - b1) * g + b1 * st["mu"][i]
            nu = torch.maximum(torch.abs(g) + eps, b2 * st["nu"][i])
            st["mu"][i], st["nu"][i] = mu, nu
            out.append(-lr * (_bias_correction(mu, b1, st["count"]) / nu))
        return out


class RAdamRule(AdamRule):
    """optax.radam: scale_by_radam, then the learning rate."""

    def update(self, grads, st, lv, lr):
        h = self.hyper
        b1, b2, eps, eps_root = h["b1"], h["b2"], h["eps"], h["eps_root"]
        st["count"] += 1
        c = st["count"]
        ro_inf = F32(2.0 / (1.0 - b2) - 1.0)
        b2t = _pow32(b2, c)
        ro = ro_inf - F32(2) * F32(c) * b2t / (F32(1) - b2t)
        use_r = bool(ro >= F32(h["threshold"]))
        r = float(np.sqrt((ro - F32(4)) * (ro - F32(2)) * ro_inf
                          / ((ro_inf - F32(4)) * (ro_inf - F32(2)) * ro))) if use_r else 1.0
        out = []
        for i, g in enumerate(grads):
            mu = (1 - b1) * g + b1 * st["mu"][i]
            nu = (1 - b2) * g * g + b2 * st["nu"][i]
            st["mu"][i], st["nu"][i] = mu, nu
            if h.get("nesterov"):
                mu_hat = b1 * _bias_correction(mu, b1, c + 1) + (1 - b1) * _bias_correction(g, b1, c)
            else:
                mu_hat = _bias_correction(mu, b1, c)
            if use_r:
                u = r * mu_hat / (torch.sqrt(_bias_correction(nu, b2, c) + eps_root) + eps)
            else:
                u = mu_hat
            out.append(-lr * u)
        return out


class AdadeltaRule(OptaxRule):
    """optax.adadelta: add_decayed_weights (its own weight_decay, always in
    the chain; off under ``weight_decay_mask`` False), scale_by_adadelta,
    then the learning rate."""

    paths = {"e_g": "[1].e_g", "e_x": "[1].e_x"}

    def init_slots(self, lv, lr):
        return {"e_g": _zeros(lv), "e_x": _zeros(lv)}

    def update(self, grads, st, lv, lr):
        rho, eps, wd = self.hyper["rho"], self.hyper["eps"], self.hyper["weight_decay"]
        if not _decays(self.hyper.get("weight_decay_mask")):
            wd = 0.0
        out = []
        for i, (g, w) in enumerate(zip(grads, lv)):
            if wd:
                g = g + wd * w
            e_g = (1 - rho) * g * g + rho * st["e_g"][i]
            u = torch.sqrt(st["e_x"][i] + eps) / torch.sqrt(e_g + eps) * g
            st["e_g"][i] = e_g
            st["e_x"][i] = (1 - rho) * u * u + rho * st["e_x"][i]
            out.append(-lr * u)
        return out


class RpropRule(OptaxRule):
    """optax.rprop: scale_by_rprop (its step sizes start at the lr; the
    update is the previous step's signed step size where the gradient kept
    its sign), then a sign flip."""

    paths = {"step_sizes": "[0].step_sizes", "prev_updates": "[0].prev_updates"}

    def init_slots(self, lv, lr):
        return {"step_sizes": [torch.full_like(x, lr) for x in lv], "prev_updates": _zeros(lv)}

    def update(self, grads, st, lv, lr):
        h = self.hyper
        out = []
        for i, g in enumerate(grads):
            s = g * st["prev_updates"][i]
            step = st["step_sizes"][i]
            grown = torch.clamp(step * torch.where(s > 0, h["eta_plus"], h["eta_minus"]),
                                min=h["min_step_size"], max=h["max_step_size"])
            step = torch.where(s == 0, step, grown)
            prev = torch.where(s < 0, torch.zeros_like(g), step * torch.sign(g))
            # optax's update is the previous step's signed step size
            out.append(-1.0 * torch.where(s < 0, torch.zeros_like(prev), st["prev_updates"][i]))
            st["step_sizes"][i], st["prev_updates"][i] = step, prev
        return out


class ASGDRule(OptaxRule):
    """The JAX package's _asgd (ptyrad_tpu/optim.py:40-68): torch.optim.ASGD's
    update, -eta_t (grad + lambd param), eta_t = lr / (1 + lambd lr t)^alpha."""

    paths = {"count": "['count']"}

    def init_slots(self, lv, lr):
        return {"count": 0}

    def update(self, grads, st, lv, lr):
        lambd, alpha = self.hyper["lambd"], self.hyper["alpha"]
        eta = F32(lr) / (F32(1) + F32(lambd) * F32(lr) * F32(st["count"])) ** F32(alpha)
        st["count"] += 1
        return [-float(eta) * (g + lambd * w) for g, w in zip(grads, lv)]


def _factored_dims(shape, factored: bool, min_dim: int):
    """optax's _factored_dims: the two largest axes, when the second
    largest reaches min_dim_size_to_factor."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _rms(x: torch.Tensor, slab=None) -> torch.Tensor:
    """The root mean square; of a whole canvas over the ranks' real rows
    when x is a rank's slab."""
    if slab is None:
        return torch.sqrt(torch.mean(x * x))
    rows = slab.rows(x)
    return torch.sqrt(slab.sum(torch.sum(rows * rows)) / (x.numel() // x.shape[-2] * slab.noy))


def _rows_last(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.movedim(axis, -1).unsqueeze(-1)


def _from_rows_last(x: torch.Tensor, axis: int) -> torch.Tensor:
    return x.squeeze(-1).movedim(-1, axis)


class AdafactorRule(OptaxRule):
    """optax.adafactor: scale_by_factored_rms, clip_by_block_rms, the
    learning rate, scale_by_param_block_rms, optionally an ema (momentum,
    stored in ``dtype_momentum``) and add_decayed_weights
    (weight_decay_rate, off under ``weight_decay_mask`` False), then a
    sign flip; each factored or not per leaf as optax decides. Under canvas sharding (the
    group's ``slab``) a slab is factored as its whole canvas would be, the moments'
    and the block RMS's reductions span the ranks' real rows, and the
    factored moments are whole canvases' on every rank (so the checkpoint
    holds what a replicated run's holds)."""

    takes_slab = True

    def __init__(self, groups, coupled_wd=0.0, **hyper):
        super().__init__(groups, coupled_wd, **hyper)
        self.paths = {"count": "[0].count", "v_row": "[0].v_row", "v_col": "[0].v_col",
                      "v": "[0].v"}
        if hyper.get("momentum") is not None:
            ema_at = 1 + (hyper["clipping_threshold"] is not None) + 1 \
                + bool(hyper["multiply_by_parameter_scale"])
            self.paths.update({"ema_count": f"[{ema_at}].count", "ema": f"[{ema_at}].ema"})

    @staticmethod
    def _shape(x, slab):
        """The leaf's shape; a slab's whole canvas's under canvas sharding."""
        shape = list(x.shape)
        if slab is not None:
            shape[-2] = slab.noy
        return tuple(shape)

    def _dims(self, x, slab):
        return _factored_dims(self._shape(x, slab), self.hyper["factored"],
                              self.hyper["min_dim_size_to_factor"])

    @staticmethod
    def _mean(x, dim: int, slab):
        """torch.mean over dim; of a slab, the whole canvas's mean: over the
        rows axis summed over the ranks' real rows, over another axis the
        per-row means gathered whole (the factored moments stay whole and
        replicated, as in a replicated run)."""
        rows_axis = x.dim() - 2
        if slab is None:
            return torch.mean(x, dim=dim)
        if dim == rows_axis:
            return slab.sum(slab.rows(x).sum(dim=dim)) / slab.noy
        local = torch.mean(x, dim=dim)
        axis = rows_axis - (dim < rows_axis)
        return _from_rows_last(slab.gather(_rows_last(local, axis)), axis)

    @staticmethod
    def _local(factor, deleted: int, ndim: int, slab):
        """A factor over the whole canvas's rows cut to the rank's padded
        rows (1 on a padding row, where the gradient is 0)."""
        rows_axis = ndim - 2
        if slab is None or deleted == rows_axis:
            return factor
        axis = rows_axis - (deleted < rows_axis)
        return _from_rows_last(slab.own_rows(_rows_last(factor, axis), 1.0), axis)

    def init_slots(self, lv, lr, slab=None):
        st = {"count": 0, "v_row": [], "v_col": [], "v": []}
        for x in lv:
            one = torch.zeros((1,), dtype=x.dtype, device=x.device)
            dims = self._dims(x, slab)
            if dims is None:
                st["v_row"].append(one)
                st["v_col"].append(one.clone())
                st["v"].append(torch.zeros_like(x))
            else:
                d1, d0 = dims
                shape = self._shape(x, slab)
                st["v_row"].append(torch.zeros(tuple(np.delete(shape, d0)), dtype=x.dtype,
                                               device=x.device))
                st["v_col"].append(torch.zeros(tuple(np.delete(shape, d1)), dtype=x.dtype,
                                               device=x.device))
                st["v"].append(one)
        if "ema" in self.paths:
            st["ema_count"] = 0
            st["ema"] = _zeros(lv, self.hyper.get("dtype_momentum"))
        return st

    def update(self, grads, st, lv, lr, slab=None):
        h = self.hyper
        t = F32(st["count"] - h["decay_offset"] + 1)
        decay = float(F32(1) - t ** F32(-h["decay_rate"]))
        eps = h["eps"]
        out = []
        for i, (g, w) in enumerate(zip(grads, lv)):
            dims = self._dims(w, slab)
            gsq = g * g + eps
            if dims is not None:
                d1, d0 = dims
                v_row = decay * st["v_row"][i] + (1.0 - decay) * self._mean(gsq, d0, slab)
                v_col = decay * st["v_col"][i] + (1.0 - decay) * self._mean(gsq, d1, slab)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = torch.mean(v_row, dim=reduced_d1, keepdim=True)
                row_factor = self._local((v_row / row_col_mean) ** -0.5, d0, g.dim(), slab)
                col_factor = self._local(v_col ** -0.5, d1, g.dim(), slab)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                st["v_row"][i], st["v_col"][i] = v_row, v_col
            else:
                v = decay * st["v"][i] + (1.0 - decay) * gsq
                u = g * v ** -0.5
                st["v"][i] = v
            if h["clipping_threshold"] is not None:
                u = u / torch.clamp(_rms(u, slab) / h["clipping_threshold"], min=1.0)
            u = u * lr
            if h["multiply_by_parameter_scale"]:
                rms = _rms(w, slab)
                u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
            if "ema" in st:
                m = h["momentum"]
                u = (1 - m) * u + _decayed(st["ema"][i], m)
                _store(st["ema"], i, u)
            if h["weight_decay_rate"] is not None and _decays(h.get("weight_decay_mask")):
                u = u + h["weight_decay_rate"] * w
            out.append(-1 * u)
        st["count"] += 1
        if "ema" in st:
            st["ema_count"] += 1
        return out


def _newton_schulz(x: torch.Tensor, coeffs, steps: int, eps: float) -> torch.Tensor:
    """optax.contrib's orthogonalize_via_newton_schulz of a 2-D leaf."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.norm(x) + eps)
    a0, a1, a2 = (float(c) for c in coeffs)
    for _ in range(steps):
        a = x @ x.T
        b = a1 * a + a2 * (a @ a)
        x = a0 * x + b @ x
    return x.T if transposed else x


class MuonRule(OptaxRule):
    """optax.contrib.muon: Newton-Schulz on the 2-D leaves (the scan-position
    shifts and the tilts) behind a nesterov momentum, then its
    weight_decay (off under ``weight_decay_mask`` False); optax.adamw
    (nesterov, adam_* configs) on the others, each leaf in its partition;
    both first moments stored in ``mu_dtype`` (AdamRule's rounding)."""

    def __init__(self, groups, coupled_wd=0.0, **hyper):
        super().__init__(groups, coupled_wd, **hyper)
        adam = ".inner_states['adam'].inner_state[0]"
        muon = ".inner_states['muon'].inner_state[0]"
        self.paths = {"adam_count": adam + ".count", "adam_mu": adam + ".mu",
                      "adam_nu": adam + ".nu", "muon_count": muon + ".count",
                      "muon_mu": muon + ".mu", "ns_coeffs": muon + ".ns_coeffs"}

    def init_slots(self, lv, lr):
        two = [x.dim() == 2 for x in lv]
        z = _zeros(lv, self.hyper.get("mu_dtype"))
        dev = lv[0].device
        return {"adam_count": 0, "muon_count": 0,
                "adam_mu": [None if t else x for t, x in zip(two, z)],
                "adam_nu": [None if t else torch.zeros_like(x) for t, x in zip(two, lv)],
                "muon_mu": [x if t else None for t, x in zip(two, z)],
                "ns_coeffs": torch.tensor(self.hyper["ns_coeffs"], dtype=torch.float32,
                                          device=dev)}

    def update(self, grads, st, lv, lr):
        h = self.hyper
        st["adam_count"] += 1
        st["muon_count"] += 1
        ca, cm = st["adam_count"], st["muon_count"]
        b1, b2, beta = h["adam_b1"], h["adam_b2"], h["beta"]
        out = []
        for i, (g, w) in enumerate(zip(grads, lv)):
            if st["muon_mu"][i] is not None:
                mu = (1 - beta) * g + _decayed(st["muon_mu"][i], beta)
                _store(st["muon_mu"], i, mu)
                if h["nesterov"]:
                    mu_hat = (beta * _bias_correction(mu, beta, cm + 1)
                              + (1 - beta) * _bias_correction(g, beta, cm))
                else:
                    mu_hat = _bias_correction(mu, beta, cm)
                u = _newton_schulz(mu_hat, st["ns_coeffs"].tolist(), h["ns_steps"], h["eps"])
                if h["adaptive"]:
                    u = torch.sum(mu_hat * u) * u
                u = math.sqrt(max(1.0, w.shape[1] / w.shape[0])) * u
                if h["weight_decay"] and _decays(h.get("weight_decay_mask")):
                    u = u + h["weight_decay"] * w
            else:
                mu = (1 - b1) * g + _decayed(st["adam_mu"][i], b1)
                nu = (1 - b2) * g * g + b2 * st["adam_nu"][i]
                _store(st["adam_mu"], i, mu)
                st["adam_nu"][i] = nu
                if h["nesterov"]:
                    mu_hat = (b1 * _bias_correction(mu, b1, ca + 1)
                              + (1 - b1) * _bias_correction(g, b1, ca))
                else:
                    mu_hat = _bias_correction(mu, b1, ca)
                u = mu_hat / (torch.sqrt(_bias_correction(nu, b2, ca) + h["adam_eps_root"])
                              + h["eps"])
                if h["adam_weight_decay"]:
                    u = u + h["adam_weight_decay"] * w
            out.append(-lr * u)
        return out


# ---------------------------------------------------------------------------
# The registry: each name's rule and optax's constructor signature
# ---------------------------------------------------------------------------

_ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0, "nesterov": False}

# name -> (rule class or "torch_adam", {optax config name: default}, has
# weight_decay in its optax signature). The config names are the optax
# constructor's (the JAX package's _translate_configs keeps a key only if
# the constructor takes it).
_FAMILIES = {
    "adam": ("torch_adam", {**_ADAM, "mu_dtype": None}, False),
    "adamw": (AdamRule, {**_ADAM, "mu_dtype": None, "weight_decay": 1e-4, "mask": None}, True),
    "nadam": (AdamRule, {**_ADAM, "mu_dtype": None, "nesterov": True}, False),
    "sgd": (SGDRule, {"momentum": None, "nesterov": False, "accumulator_dtype": None}, False),
    "rmsprop": (RMSpropRule, {"decay": 0.9, "eps": 1e-8, "initial_scale": 0.0,
                              "eps_in_sqrt": True, "centered": False, "momentum": None,
                              "nesterov": False, "bias_correction": False}, False),
    "adagrad": (AdagradRule, {"initial_accumulator_value": 0.1, "eps": 1e-7}, False),
    "adamax": (AdamaxRule, {"b1": 0.9, "b2": 0.999, "eps": 1e-8}, False),
    "radam": (RAdamRule, {**_ADAM, "threshold": 5.0}, False),
    "adadelta": (AdadeltaRule, {"rho": 0.9, "eps": 1e-6, "weight_decay": 0.0,
                                "weight_decay_mask": None}, True),
    "rprop": (RpropRule, {"eta_minus": 0.5, "eta_plus": 1.2, "min_step_size": 1e-6,
                          "max_step_size": 50.0}, False),
    "asgd": (ASGDRule, {"lambd": 1e-4, "alpha": 0.75, "t0": 1e6}, False),
    "adafactor": (AdafactorRule, {"min_dim_size_to_factor": 128, "decay_rate": 0.8,
                                  "decay_offset": 0, "multiply_by_parameter_scale": True,
                                  "clipping_threshold": 1.0, "momentum": None,
                                  "dtype_momentum": None, "weight_decay_rate": None,
                                  "weight_decay_mask": None, "eps": 1e-30, "factored": True},
                  False),
    "muon": (MuonRule, {"ns_coeffs": (3.4445, -4.775, 2.0315), "ns_steps": 5, "beta": 0.95,
                        "eps": 1e-8, "weight_decay": 0.0, "weight_decay_mask": None,
                        "mu_dtype": None, "nesterov": True, "adaptive": False,
                        "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps_root": 0.0,
                        "adam_weight_decay": 0.0, "muon_weight_dimension_numbers": None}, True),
    "lbfgs": ("lbfgs", {"memory_size": 10, "scale_init_precond": True, "linesearch": None},
              False),
}
# optax configs no params file can spell: each must stay None (its reason)
_REFUSED = {
    "muon_weight_dimension_numbers": "it takes optax MuonDimensionNumbers or a function of the "
    "parameters; the JAX package refuses a list or dict for it with a ValueError ('Expected "
    "list/dict, got PtychoParams')",
    "linesearch": "it takes an optax line-search object, which a params file cannot hold",
}
# optax configs naming a storage dtype, and the decay masks (a bool is a
# prefix of the parameter tree; a tree or a function is refused)
_DTYPE_KEYS = ("mu_dtype", "accumulator_dtype", "dtype_momentum")
_MASK_KEYS = ("mask", "weight_decay_mask")
# a dtype name as optax's utils.canonicalize_dtype reads it (JAX's 64-bit
# types off, so float64 is stored as float32); other names through NumPy's
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
           "float64": torch.float32}


def storage_dtype(value) -> Optional[torch.dtype]:
    """A dtype config (None, a torch.dtype, or a name such as "bfloat16",
    "float16", "float32") as the torch.dtype a moment is stored in."""
    if value is None or isinstance(value, torch.dtype):
        return value
    name = str(value)
    if name not in _DTYPES:
        try:
            name = np.dtype(value).name
        except TypeError:
            pass
    if name not in _DTYPES:
        raise ValueError(f"dtype config {value!r} is not a floating type; use bfloat16, "
                         "float16 or float32")
    return _DTYPES[name]


# The optimizer names a params file may give: the keys of the JAX package's
# registry (ptyrad_tpu/optim.py:OPTIMIZER_REGISTRY), the torch.optim names
# and optax's lowercase aliases, each with the family whose rule it runs.
OPTIMIZER_REGISTRY = {
    "Adam": "adam", "AdamW": "adamw", "SGD": "sgd", "RMSprop": "rmsprop",
    "Adagrad": "adagrad", "Adamax": "adamax", "NAdam": "nadam", "RAdam": "radam",
    "Adadelta": "adadelta", "LBFGS": "lbfgs", "Rprop": "rprop", "ASGD": "asgd",
    "Adafactor": "adafactor", "Muon": "muon", "SparseAdam": "adam",
    "adam": "adam", "adamw": "adamw", "sgd": "sgd", "rmsprop": "rmsprop", "lbfgs": "lbfgs",
}
OPTIMIZER_REGISTRY_NAMES = tuple(OPTIMIZER_REGISTRY)


def is_lbfgs(name: str) -> bool:
    return name in ("LBFGS", "lbfgs")


def _translate_configs(name: str, configs: dict):
    """Torch-named configs onto optax's names, as the JAX package's
    _translate_configs (ptyrad_tpu/optim.py:133-180): betas -> b1/b2, lr ->
    learning_rate, history_size -> memory_size, etas -> eta_minus/eta_plus,
    step_sizes -> min_step_size/max_step_size; a ``weight_decay`` the optax
    constructor does not take becomes add_decayed_weights ahead of the rule
    (returned as the coupled weight decay); every other key the constructor
    does not take is dropped with the JAX package's warning. A dtype config
    becomes a torch.dtype (storage_dtype); a config no params file can
    spell (_REFUSED) other than None, or a decay mask that is not a bool,
    raises NotImplementedError. Returns (configs, coupled weight decay)."""
    _, defaults, takes_wd = _FAMILIES[OPTIMIZER_REGISTRY[name]]
    sig = {"learning_rate", *defaults}
    out = dict(configs)
    if "betas" in out:
        b = out.pop("betas")
        out.setdefault("b1", float(b[0]))
        out.setdefault("b2", float(b[1]))
    if "lr" in out:
        out.setdefault("learning_rate", out.pop("lr"))
    if "history_size" in out:
        out.setdefault("memory_size", int(out.pop("history_size")))
    if "etas" in out:
        em, ep = out.pop("etas")
        out.setdefault("eta_minus", float(em))
        out.setdefault("eta_plus", float(ep))
    if "step_sizes" in out:
        smin, smax = out.pop("step_sizes")
        out.setdefault("min_step_size", float(smin))
        out.setdefault("max_step_size", float(smax))
    coupled = 0.0
    if "weight_decay" in out and not takes_wd:
        coupled = float(out.pop("weight_decay"))
    for k in [k for k in out if k not in sig]:
        vprint(f"WARNING: optimizer '{name}' does not support config '{k}' "
               f"(torch-only or renamed); ignoring it.")
        out.pop(k)
    for k, why in _REFUSED.items():
        if out.get(k) is not None:
            raise NotImplementedError(
                f"optimizer '{name}': optax config '{k}' is not ported ({why}); leave it null")
    for k in _MASK_KEYS:
        if not isinstance(out.get(k), (type(None), bool, np.bool_)):
            raise NotImplementedError(
                f"optimizer '{name}': optax config '{k}' must be true, false or null in "
                "ptyrad_tpu_torch (a tree of bools or a function cannot be spelled in a "
                f"params file), got {out[k]!r}")
        if k in out and out[k] is not None:
            out[k] = bool(out[k])
    for k in _DTYPE_KEYS:
        if k in out:
            out[k] = storage_dtype(out[k])
    return out, coupled


def create_optimizer(optimizer_params: Optional[dict], update_params: Optional[dict],
                     params: PtychoParams, grad_accumulation: int = 1, slab=None):
    """(optimizer, lr_dict, start_dict).

    optimizer_params: {'name': <a name of OPTIMIZER_REGISTRY>, 'configs':
    {...}} with torch.optim (or optax) keyword names. Marks the optimized
    tensors as requiring gradients. The groups follow update_params' order
    (each group's ``name`` says whose). LBFGS gives an optim_lbfgs.LBFGS over
    every tensor at the smallest nonzero lr, never wrapped; otherwise
    grad_accumulation k > 1 wraps the optimizer in MultiSteps(k). ``slab``
    (a parallel.canvas.CanvasShard; params its slab parameters) goes to the
    rules that reduce over a whole tensor: LBFGS, and the groups of obja
    and objp of an OptaxRule (torch's Adam is elementwise).
    """
    optimizer_params = optimizer_params or {"name": "Adam"}
    name = optimizer_params.get("name", "Adam")
    if name not in OPTIMIZER_REGISTRY:
        raise ValueError(
            f"Optimizer '{name}' not supported; choose from "
            f"{sorted(k for k in OPTIMIZER_REGISTRY if k[0].isupper())} "
            "(every torch.optim 2.x name the reference accepts)")
    family = OPTIMIZER_REGISTRY[name]
    if name == "SparseAdam":
        vprint("SparseAdam: gradients are dense under XLA, where SparseAdam's "
               "update coincides with Adam; using Adam.")
    configs, coupled = _translate_configs(name, dict(optimizer_params.get("configs") or {}))
    lr_dict, start_dict = parse_update_params(update_params)
    for pname, tensor in params.named():
        tensor.requires_grad_(lr_dict[pname] != 0)

    if family == "lbfgs":
        from ptyrad_tpu_torch.optim_lbfgs import LBFGS

        # one global lr, the smallest nonzero one, forced over any 'lr'
        # config (ptyrad_tpu/optim.py:216-226)
        nonzero = [v for v in lr_dict.values() if v != 0]
        configs.pop("learning_rate", None)
        return (LBFGS(params, lr_dict, learning_rate=min(nonzero) if nonzero else 1.0,
                      coupled_wd=coupled, slab=slab, **configs), lr_dict, start_dict)

    configs.pop("learning_rate", None)  # per-tensor lrs own this
    groups = [{"params": [getattr(params, pname)], "lr": lr_dict[pname], "name": pname}
              for pname in (update_params or {}) if lr_dict[pname] != 0]
    if not groups:
        raise ValueError("no tensor has a nonzero lr in update_params")
    rule, defaults, _ = _FAMILIES[family]
    if rule == "torch_adam" and (configs.get("eps_root", 0.0) or configs.get("nesterov")
                                 or configs.get("mu_dtype") is not None):
        rule = AdamRule  # torch's Adam computes optax.adam only at these three's defaults
    if slab is not None and rule != "torch_adam":
        for group in groups:
            if group["name"] in slab.canvas_names:
                group["slab"] = slab
    if rule == "torch_adam":
        opt = torch.optim.Adam(groups, betas=(configs.get("b1", 0.9), configs.get("b2", 0.999)),
                               eps=configs.get("eps", 1e-8), weight_decay=coupled)
    else:
        opt = rule(groups, coupled, **{**defaults, **configs})
    if int(grad_accumulation) > 1:
        opt = MultiSteps(opt, int(grad_accumulation), params)
    return opt, lr_dict, start_dict


# ---------------------------------------------------------------------------
# Gradient accumulation
# ---------------------------------------------------------------------------

class MultiSteps:
    """optax.MultiSteps(k) around an optimizer: each step() adds the
    (masked) gradients into a running mean, acc + (g - acc) / (n + 1);
    every k-th step hands the mean to the inner optimizer, which steps,
    and zeroes the mean. The steps between leave the parameters and the
    inner state unchanged. The mini-step counter and the mean carry across
    iterations and are part of the checkpoint (``.mini_step``,
    ``.gradient_step``, ``.acc_grads.<name>`` for all six tensors,
    ``.inner_opt_state`` + the inner optimizer's keys)."""

    def __init__(self, inner, every_k: int, params: PtychoParams):
        self.inner = inner
        self.every_k = every_k
        self.params = params
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = {name: torch.zeros_like(t, requires_grad=False) for name, t in params.named()}

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for name, t in self.params.named():
            if t.grad is None:
                continue
            for a, g in zip(leaves(self.acc[name]), leaves(t.grad)):
                a.copy_(a + (g - a) / (n + 1))
        if n == self.every_k - 1:
            for name, t in self.params.named():
                if t.requires_grad:
                    t.grad = self.acc[name].clone()
            self.inner.step()
            for a in self.acc.values():
                a.zero_()
            self.gradient_step += 1
        self.mini_step = (n + 1) % self.every_k

    def keyed_arrays(self) -> list:
        """(key, getter, setter) for every array of the state."""
        out = [(".mini_step", lambda: np.int32(self.mini_step),
                lambda v: setattr(self, "mini_step", int(v))),
               (".gradient_step", lambda: np.int32(self.gradient_step),
                lambda v: setattr(self, "gradient_step", int(v)))]
        for name, t in self.params.named():
            for suffix, leaf in zip(leaf_keys(name, t), leaves(self.acc[name])):
                out.append((".acc_grads" + suffix, lambda leaf=leaf: _host(leaf),
                            lambda v, leaf=leaf: leaf.copy_(_coerce(v, leaf))))
        return out


# ---------------------------------------------------------------------------
# The optimizer state of a checkpoint
# ---------------------------------------------------------------------------

def torch_optim_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """torch Adam's state_dict in upstream PtyRAD's checkpoint layout, on
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


def _torch_adam_arrays(opt: torch.optim.Adam) -> list:
    """(key, getter, setter) of torch Adam's state in the keystr layout
    (inside MultiSteps, which the torch layout cannot hold); a fresh
    tensor's state starts at zero as optax's does."""
    out = []
    for group in opt.param_groups:
        name, p = group["name"], group["params"][0]

        def st(p=p):
            s = opt.state[p]
            if not s:
                on_device = group.get("capturable") or group.get("fused")
                s.update(step=torch.tensor(0.0, device=p.device if on_device else "cpu"),
                         exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
            return s

        out.append((f"{_keystr_prefix(name)}.count", lambda st=st: np.int32(float(st()["step"])),
                    lambda v, st=st: st()["step"].fill_(float(np.asarray(v)))))
        for torch_key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            for k, j in zip(_moment_keys(name, moment), range(2)):
                def get(st=st, torch_key=torch_key, j=j):
                    return _host(leaves(st()[torch_key])[j])

                def put(v, st=st, torch_key=torch_key, j=j):
                    leaf = leaves(st()[torch_key])[j]
                    leaf.copy_(_coerce(v, leaf))
                out.append((k, get, put))
    return out


def keyed_arrays(optimizer) -> list:
    """(key, getter, setter) for every array of an optimizer's state in the
    JAX package's keystr layout (optax's leaf order)."""
    if isinstance(optimizer, MultiSteps):
        inner = [(".inner_opt_state" + k, g, s) for k, g, s in keyed_arrays(optimizer.inner)]
        head = optimizer.keyed_arrays()
        return head[:2] + inner + head[2:]
    if isinstance(optimizer, torch.optim.Adam):
        return _torch_adam_arrays(optimizer)
    return optimizer.keyed_arrays()  # an OptaxRule or optim_lbfgs.LBFGS


def optim_state_values(optimizer) -> Dict[str, Any]:
    """The optimizer state for a checkpoint's ``optim_state_dict``: torch
    Adam's in upstream's torch layout, every other optimizer's in the JAX
    package's keystr layout."""
    if isinstance(optimizer, torch.optim.Adam):
        return torch_optim_state(optimizer)
    return {k: get() for k, get, _ in keyed_arrays(optimizer)}


_CANON_VOCAB = frozenset({"mu", "nu", "count", "trace", "re", "im", *PARAM_NAMES})


def _canonical_key(keystr: str) -> tuple:
    """The meaningful tokens of a keystr (moment and tensor names), without
    optax's wrapper names, which optax may rename between versions (as
    ptyrad_tpu/optim.py:_canonical_key)."""
    return tuple(t for t in re.findall(r"\w+", keystr) if t in _CANON_VOCAB)


def _match(wanted: List[str], values: Dict[str, Any]) -> Dict[str, str]:
    """{wanted key: checkpoint key}: exact keys, then (only when the
    checkpoint has as many arrays as wanted: an optax rename keeps the
    count, a structural change does not) keys with the same canonical
    tokens, unique ones only (ptyrad_tpu/optim.py:_apply_keystr_dict)."""
    canon: Dict[tuple, Optional[str]] = {}
    if len(values) == len(wanted):
        for k in values:
            t = _canonical_key(k)
            canon[t] = None if t in canon else k
    out = {}
    for key in wanted:
        if key in values:
            out[key] = key
        else:
            alias = canon.get(_canonical_key(key))
            if alias is not None:
                out[key] = alias
    return out


def load_opt_state_values(optimizer, values: Dict[str, Any]) -> None:
    """Set the optimizer's state from a checkpoint's ``optim_state_dict``
    (either layout, as NumPy values). A torch-layout state is first turned
    into the keystr one. Every array of the optimizer's state takes the
    checkpoint's value of its key (or of the key with its canonical tokens,
    as the JAX reader matches optax renames); arrays the checkpoint lacks
    stay fresh with a warning. Raises OptStateMismatchError when no array
    matches (a structurally different optimizer: another family, other
    tensors optimized, gradient accumulation) and ValueError when an
    array's size differs, leaving the state as it was."""
    names = [g["name"] for g in optimizer.param_groups]
    if "state" in values and "param_groups" in values:
        values = torch_layout_to_keystr(values, names)
    if isinstance(optimizer, torch.optim.Adam):
        _load_torch_adam(optimizer, values, names)
        return
    slots = keyed_arrays(optimizer)
    found = _match([k for k, _, _ in slots], values)
    if not found:
        sample = next(iter(values), "<empty>")
        raise OptStateMismatchError(
            "optimizer state mismatch: no checkpoint entry matches the optimizer's state "
            f"(checkpoint keys look like '{sample}'); was it saved with another optimizer, "
            "other tensors optimized or gradient accumulation?")
    backup = {k: _widened(get()) for k, get, _ in slots}
    try:
        for key, _, put in slots:
            if key in found:
                put(values[found[key]])
    except ValueError:
        for key, _, put in slots:
            put(backup[key])
        raise
    missing = [k for k, _, _ in slots if k not in found]
    if missing:
        vprint(f"WARNING: partial optimizer-state restore — {len(missing)} state array(s) had "
               "no checkpoint entry and start fresh: " + ", ".join(missing[:6])
               + (" ..." if len(missing) > 6 else ""))


def _load_torch_adam(optimizer: torch.optim.Adam, values: Dict[str, Any], names) -> None:
    """torch Adam's state from keystr values: each optimized tensor takes
    its step and both moments, or stays fresh with a warning when the
    checkpoint lacks any of them; a complex tensor's moments come back
    complex, and the step stays on the CPU unless the group is capturable
    or fused (torch Adam's own placement). All or nothing: a size that
    differs raises ValueError before any tensor is set."""
    groups = optimizer.param_groups
    wanted = {name: [f"{_keystr_prefix(name)}.count"] + _moment_keys(name, "mu")
              + _moment_keys(name, "nu") for name in names}
    found = _match([k for keys in wanted.values() for k in keys], values)
    restored, fresh = {}, []
    for group, name in zip(groups, names):
        keys = wanted[name]
        if not all(k in found for k in keys):
            fresh.append(name)
            continue
        p = group["params"][0]
        arrays = [_numeric(values[found[k]]).astype(np.float32) for k in keys[1:]]
        if name == "probe":
            arrays = [a + 1j * b for a, b in (arrays[:2], arrays[2:])]
        mu, nu = (torch.tensor(np.asarray(a).reshape(p.shape), dtype=p.dtype, device=p.device)
                  for a in arrays)
        on_device = group.get("capturable") or group.get("fused")
        step = torch.tensor(float(np.asarray(values[found[keys[0]]])), dtype=torch.float32,
                            device=p.device if on_device else "cpu")
        restored[p] = {"step": step, "exp_avg": mu, "exp_avg_sq": nu}
    if not restored:
        sample = next(iter(values), "<empty>")
        raise OptStateMismatchError(
            "optimizer state mismatch: no checkpoint entry matches the optimized tensors "
            f"{names} (checkpoint keys look like '{sample}'); was it saved with another "
            "optimizer, other tensors optimized or gradient accumulation?")
    for p, state in restored.items():
        optimizer.state[p] = state
    if fresh:
        vprint(f"WARNING: partial optimizer-state restore: {fresh} had no complete entry in "
               "the checkpoint and start fresh")


def load_opt_state_hdf5(optimizer, ckpt_path: str, cut=None) -> None:
    """load_opt_state_values from a model.hdf5's ``optim_state_dict`` (one
    written by either package or by upstream PtyRAD); needs h5py. A
    checkpoint saved without 'optim_state' in save_result raises
    ValueError. ``cut`` maps the values first (the canvas path's
    CanvasShard.cut_state: the rank's rows of every canvas-shaped array)."""
    from ptyrad_tpu_torch.load import load_hdf5

    values = load_hdf5(ckpt_path, key="optim_state_dict")
    if not isinstance(values, dict) or not values:
        raise ValueError(f"'{ckpt_path}' has no optimizer state; save it with 'optim_state' "
                         "in recon_params.save_result")
    load_opt_state_values(optimizer, values if cut is None else cut(values))

