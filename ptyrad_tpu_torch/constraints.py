"""Iteration-wise constraints, applied in place between iterations.

Counterpart of ptyrad_tpu/constraints.py. ``ConstraintScheduler`` keeps the
reference application order (probe constraints, then object constraints,
then tilt smoothing), the freq gating and the strict-config checks. Each
constraint computes new tensors under ``torch.no_grad`` and copies them into
the parameters in place, so the optimizer keeps its references.

Ported: ortho_pmode, fix_probe_int, obj_rblur, obj_zblur, obja_thresh,
objp_postiv (the six the tBL configuration runs). The other six raise
NotImplementedError when enabled; ROADMAP queue A lists them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ptyrad_tpu_torch.models.state import Buffers, PtychoParams
from ptyrad_tpu_torch.ops.blur import gaussian_blur_1d, gaussian_blur_2d

DEFAULT_CONSTRAINT_PARAMS = {
    "ortho_pmode": {"freq": None},
    "probe_mask_k": {"freq": None, "radius": 0.22, "width": 0.05, "power_thresh": 0.95},
    "fix_probe_int": {"freq": None},
    "obj_rblur": {"freq": None, "obj_type": "both", "kernel_size": 5, "std": 0.5},
    "obj_zblur": {"freq": None, "obj_type": "both", "kernel_size": 5, "std": 1.0},
    "kr_filter": {"freq": None, "obj_type": "both", "radius": 0.15, "width": 0.05},
    "kz_filter": {"freq": None, "obj_type": "both", "beta": 1.0, "alpha": 1.0},
    "complex_ratio": {"freq": None, "obj_type": "both", "alpha1": 1.0, "alpha2": 0.0},
    "mirrored_amp": {"freq": None, "relax": 0.1, "scale": 0.03, "power": 4.0},
    "obja_thresh": {"freq": None, "relax": 0.0, "thresh": (0.98, 1.02)},
    "objp_postiv": {"freq": None, "relax": 0.0, "mode": "clip_neg"},
    "tilt_smooth": {"freq": None, "std": 2.0},
}


def sort_by_mode_intensity(modes: torch.Tensor) -> torch.Tensor:
    """Sort the leading mode axis by descending total intensity."""
    power = (modes.real ** 2 + modes.imag ** 2).sum(dim=tuple(range(1, modes.dim())))
    return modes[torch.argsort(-power)]


def orthogonalize_modes(modes: torch.Tensor, sort: bool = True) -> torch.Tensor:
    """Orthogonalize incoherent modes (n, Ny, Nx) in the eigenbasis of the
    Hermitian Gram matrix A = M M^H (torch.linalg.eigh on complex64): the
    projected modes evecs^H M are mutually orthogonal and keep the total
    intensity. Each eigenvector's phase is a free gauge."""
    n = modes.shape[0]
    flat = modes.reshape(n, -1)
    gram = flat @ flat.conj().T
    _, evecs = torch.linalg.eigh(gram)
    ortho = (evecs.conj().T @ flat).reshape(modes.shape)
    return sort_by_mode_intensity(ortho) if sort else ortho


def _apply_obj(params: PtychoParams, obj_type: str, fn) -> None:
    if obj_type in ("amplitude", "both"):
        params.obja.copy_(fn(params.obja))
    if obj_type in ("phase", "both"):
        params.objp.copy_(fn(params.objp))


def ortho_pmode(params: PtychoParams, buffers: Buffers, cfg: dict) -> None:
    params.probe.copy_(orthogonalize_modes(params.probe, sort=True))


def fix_probe_int(params: PtychoParams, buffers: Buffers, cfg: dict) -> None:
    """Rescale the probe to its initial total intensity."""
    probe = params.probe
    current = torch.sqrt((probe.real ** 2 + probe.imag ** 2).sum())
    probe.copy_(probe * (torch.sqrt(buffers.probe_int_sum) / current))


def obj_rblur(params: PtychoParams, buffers: Buffers, cfg: dict) -> None:
    if cfg["std"] == 0:
        return
    _apply_obj(params, cfg["obj_type"],
               lambda o: gaussian_blur_2d(o, kernel_size=cfg["kernel_size"], sigma=cfg["std"]))


def obj_zblur(params: PtychoParams, buffers: Buffers, cfg: dict) -> None:
    """Gaussian blur along z (axis 1 of (omode, Nz, Ny, Nx)), replicate pad."""
    if cfg["std"] == 0:
        return

    def blur_z(o):
        moved = o.movedim(1, -1)
        blurred = gaussian_blur_1d(moved, kernel_size=cfg["kernel_size"], sigma=cfg["std"])
        return blurred.movedim(-1, 1)

    _apply_obj(params, cfg["obj_type"], blur_z)


def obja_thresh(params: PtychoParams, buffers: Buffers, cfg: dict) -> None:
    lo, hi = cfg["thresh"]
    clamped = params.obja.clamp(lo, hi)
    params.obja.copy_(cfg["relax"] * params.obja + (1.0 - cfg["relax"]) * clamped)


def objp_postiv(params: PtychoParams, buffers: Buffers, cfg: dict) -> None:
    if cfg.get("mode", "clip_neg") == "subtract_min":
        modified = params.objp - params.objp.min()
    else:
        modified = params.objp.clamp(min=0.0)
    params.objp.copy_(cfg["relax"] * params.objp + (1.0 - cfg["relax"]) * modified)


# Reference application order (reference constraints.py:227-246)
_ORDER: Tuple[str, ...] = (
    "ortho_pmode",
    "probe_mask_k",
    "fix_probe_int",
    "obj_rblur",
    "obj_zblur",
    "kr_filter",
    "kz_filter",
    "complex_ratio",
    "mirrored_amp",
    "obja_thresh",
    "objp_postiv",
    "tilt_smooth",
)

_FNS: Dict[str, Callable] = {
    "ortho_pmode": ortho_pmode,
    "fix_probe_int": fix_probe_int,
    "obj_rblur": obj_rblur,
    "obj_zblur": obj_zblur,
    "obja_thresh": obja_thresh,
    "objp_postiv": objp_postiv,
}


class ConstraintScheduler:
    """Applies the due constraints each iteration, in the reference order."""

    def __init__(self, constraint_params: dict | None):
        cfg = {k: {**v} for k, v in DEFAULT_CONSTRAINT_PARAMS.items()}
        for key, val in (constraint_params or {}).items():
            if key not in cfg:
                raise ValueError(f"Unknown constraint '{key}'")
            val = val or {}
            bad = set(val) - set(cfg[key])
            if bad:
                raise ValueError(
                    f"Unknown option(s) {sorted(bad)} for constraint '{key}'; "
                    f"expected {sorted(cfg[key])}"
                )
            cfg[key].update(val)
        self.cfg = cfg
        self._active: List[Tuple[str, int, Callable, dict]] = []
        for name in _ORDER:
            freq = cfg[name].get("freq")
            if freq is None:
                continue
            if int(freq) < 1:
                raise ValueError(
                    f"Constraint '{name}' freq must be >= 1 (got {freq}); "
                    "use freq=None to disable it"
                )
            if name not in _FNS:
                raise NotImplementedError(
                    f"constraint '{name}' waits for ROADMAP queue A (constraints)")
            c = dict(cfg[name])
            c.pop("freq")
            self._active.append((name, int(freq), _FNS[name], c))

    @torch.no_grad()
    def __call__(self, params: PtychoParams, buffers: Buffers, niter: int) -> PtychoParams:
        for _name, freq, fn, c in self._active:
            if niter % freq == 0:
                fn(params, buffers, c)
        return params

    @property
    def active_names(self) -> List[str]:
        return [name for name, _, _, _ in self._active]
