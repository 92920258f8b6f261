"""Iteration-wise constraints, applied in place between iterations.

Counterpart of ptyrad_tpu/constraints.py. ``ConstraintScheduler`` keeps the
reference application order (probe constraints, then object constraints,
then tilt smoothing), the freq gating and the strict-config checks. Each
constraint computes new tensors under ``torch.no_grad`` and copies them into
the parameters in place, so the optimizer keeps its references.

All twelve constraints of the JAX package are here: ortho_pmode,
probe_mask_k, fix_probe_int, obj_rblur, obj_zblur, kr_filter, kz_filter,
complex_ratio, mirrored_amp, obja_thresh, objp_postiv and tilt_smooth.
Under the bfloat16 compute policy (``geom.bf16_operands``) the transforms of
probe_mask_k, kr_filter and kz_filter round their operands to bfloat16, as
the JAX package's do under its matmul switch (ptyrad_tpu/constraints.py:103,
:122-123, :174-175).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import torch

from ptyrad_tpu_torch.models.state import Buffers, Geometry, PtychoParams
from ptyrad_tpu_torch.ops.blur import gaussian_blur_1d, gaussian_blur_2d
from ptyrad_tpu_torch.ops.fourier import fft2, fftn3, fftshift2, ifft2, ifftshift2
from ptyrad_tpu_torch.ops.masks import make_sigmoid_mask
from ptyrad_tpu_torch.utils.tracing import span

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


def probe_mask_k(params: PtychoParams, buffers: Buffers, cfg: dict,
                 bf16_operands: bool = False) -> None:
    """Sigmoid k-space mask on the strongest probe modes: mode 0 and every
    mode i whose predecessors hold at most power_thresh of the total power
    (ptyrad_tpu/constraints.py:160-177); then the modes are sorted by
    intensity."""
    probe = params.probe
    power = (probe.real ** 2 + probe.imag ** 2).sum(dim=(-2, -1))
    csum = torch.cumsum(power / power.sum(), dim=0)
    masked = torch.cat([torch.ones(1, dtype=torch.bool, device=probe.device),
                        csum[:-1] <= cfg["power_thresh"]])
    mask2d = make_sigmoid_mask(probe.shape[-1], cfg["radius"], cfg["width"], device=probe.device)
    ops = bf16_operands
    probe_k = fftshift2(fft2(ifftshift2(probe), norm="ortho", bf16_operands=ops))
    probe_masked = fftshift2(ifft2(ifftshift2(probe_k * mask2d), norm="ortho",
                                   bf16_operands=ops))
    new_probe = torch.where(masked[:, None, None], probe_masked, probe)
    probe.copy_(sort_by_mode_intensity(new_probe))


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


def kr_filter_fn(obj: torch.Tensor, radius: float, width: float,
                 bf16_operands: bool = False) -> torch.Tensor:
    """Lateral Fourier low-pass with a sigmoid cutoff over the last two axes
    (ptyrad_tpu/constraints.py:87-103). On a rectangular canvas the square
    mask is stretched by nearest-neighbour lookup with the floor source
    mapping src = dst * S // D."""
    ny, nx = obj.shape[-2:]
    mask = make_sigmoid_mask(min(ny, nx), radius, width, device=obj.device)
    if (ny, nx) != tuple(mask.shape):
        sy, sx = mask.shape
        iy = (torch.arange(ny, device=obj.device) * sy) // ny
        ix = (torch.arange(nx, device=obj.device) * sx) // nx
        mask = mask[iy][:, ix]
    ops = bf16_operands
    return ifft2(fft2(obj, bf16_operands=ops) * ifftshift2(mask),
                 bf16_operands=ops).real.to(obj.dtype)


def kr_filter(params: PtychoParams, buffers: Buffers, cfg: dict,
              bf16_operands: bool = False) -> None:
    _apply_obj(params, cfg["obj_type"],
               lambda o: kr_filter_fn(o, cfg["radius"], cfg["width"], bf16_operands))


def kz_filter_fn(obj: torch.Tensor, beta: float = 1.0, alpha: float = 1.0,
                 obj_type: str = "phase", bf16_operands: bool = False) -> torch.Tensor:
    """Missing-wedge arctan kz filter (ptyrad_tpu/constraints.py:106-126).

    W = 1 - atan((beta |kz| / sqrt(kx^2 + ky^2 + 1e-3))^2) / (pi/2), times a
    lateral Gaussian exp(-alpha (kx^2 + ky^2)), applied over the last three
    axes (Nz, Ny, Nx). For amplitude the filtered object is pulled softly
    toward 1 (fobj -> 1 + 0.9 (fobj - 1))."""
    nz, ny, nx = obj.shape[-3:]
    kz, ky, kx = (torch.fft.fftfreq(k, device=obj.device, dtype=torch.float32)
                  for k in (nz, ny, nx))
    gz, gy, gx = torch.meshgrid(kz, ky, kx, indexing="ij")
    w = 1.0 - torch.arctan((beta * gz.abs() / torch.sqrt(gx**2 + gy**2 + 1e-3)) ** 2) / (
        torch.pi / 2)
    wa = w * torch.exp(-alpha * (gx**2 + gy**2))
    ops = bf16_operands
    fobj = fftn3(fftn3(obj, bf16_operands=ops) * wa, inverse=True,
                 bf16_operands=ops).real.to(obj.dtype)
    if obj_type == "amplitude":
        fobj = 1.0 + 0.9 * (fobj - 1.0)
    return fobj


def kz_filter(params: PtychoParams, buffers: Buffers, cfg: dict,
              bf16_operands: bool = False) -> None:
    for obj_type, t in (("amplitude", params.obja), ("phase", params.objp)):
        if cfg["obj_type"] in (obj_type, "both"):
            t.copy_(kz_filter_fn(t, cfg["beta"], cfg["alpha"], obj_type, bf16_operands))


def complex_ratio_fn(obja: torch.Tensor, objp: torch.Tensor, alpha1: float, alpha2: float):
    """Amplitude-phase coupling (ptyrad_tpu/constraints.py:129-140):
    Cbar = sum|log a| / sum|phi|;  a' = exp((1 - a1) log a - a1 Cbar phi);
    phi' = (1 - a2) phi - a2 / Cbar log a. Returns (a', phi', Cbar)."""
    log_a = torch.log(obja)
    cbar = log_a.abs().sum() / (objp.abs().sum() + 1e-8)
    obja_c = torch.exp((1.0 - alpha1) * log_a - alpha1 * cbar * objp)
    objp_c = (1.0 - alpha2) * objp - alpha2 / (cbar + 1e-8) * log_a
    return obja_c, objp_c, cbar


def complex_ratio(params: PtychoParams, buffers: Buffers, cfg: dict) -> None:
    obja_c, objp_c, _ = complex_ratio_fn(params.obja, params.objp, cfg["alpha1"], cfg["alpha2"])
    if cfg["obj_type"] in ("amplitude", "both"):
        params.obja.copy_(obja_c)
    if cfg["obj_type"] in ("phase", "both"):
        params.objp.copy_(objp_c)


def mirrored_amp(params: PtychoParams, buffers: Buffers, cfg: dict) -> None:
    """a' = relax a + (1 - relax) (1 - scale clamp(phi, 0)^power)."""
    amp_new = 1.0 - cfg["scale"] * params.objp.clamp(min=0.0) ** cfg["power"]
    params.obja.copy_(cfg["relax"] * params.obja + (1.0 - cfg["relax"]) * amp_new)


def tilt_smooth(params: PtychoParams, buffers: Buffers, cfg: dict, n_slow: int = 1,
                n_fast: int = 1) -> None:
    """5x5 Gaussian blur of per-position tilts over the (n_slow, n_fast)
    scan grid (ptyrad_tpu/constraints.py:255-264); nothing for a global
    tilt (tilt_type 'all') or std 0."""
    if params.obj_tilts.shape[0] == 1 or cfg["std"] == 0:
        return
    grid = params.obj_tilts.reshape(n_slow, n_fast, 2).movedim(-1, 0)  # (2, slow, fast)
    blurred = gaussian_blur_2d(grid, kernel_size=5, sigma=cfg["std"])
    params.obj_tilts.copy_(blurred.movedim(0, -1).reshape(-1, 2))


# the constraints whose transforms follow the bfloat16 compute policy
DFT_CONSTRAINTS = ("probe_mask_k", "kr_filter", "kz_filter")

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
# each constraint's span (utils.tracing), one static name each
_SPANS: Dict[str, str] = {name: f"ptyrad.constraint.{name}" for name in _ORDER}

_FNS: Dict[str, Callable] = {
    "ortho_pmode": ortho_pmode,
    "probe_mask_k": probe_mask_k,
    "fix_probe_int": fix_probe_int,
    "obj_rblur": obj_rblur,
    "obj_zblur": obj_zblur,
    "kr_filter": kr_filter,
    "kz_filter": kz_filter,
    "complex_ratio": complex_ratio,
    "mirrored_amp": mirrored_amp,
    "obja_thresh": obja_thresh,
    "objp_postiv": objp_postiv,
    "tilt_smooth": tilt_smooth,
}


class ConstraintScheduler:
    """Applies the due constraints each iteration, in the reference order.
    tilt_smooth is bound to the scan grid of ``geom``, as the JAX scheduler
    binds it (ptyrad_tpu/constraints.py:341-342), and the constraints with
    transforms to ``geom.bf16_operands``."""

    def __init__(self, constraint_params: dict | None, geom: Geometry):
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
            c = dict(cfg[name])
            c.pop("freq")
            fn = _FNS[name]
            if name == "tilt_smooth":
                fn = functools.partial(fn, n_slow=geom.n_scan_slow, n_fast=geom.n_scan_fast)
            elif name in DFT_CONSTRAINTS and geom.bf16_operands:
                fn = functools.partial(fn, bf16_operands=True)
            self._active.append((name, int(freq), fn, c))

    @torch.no_grad()
    def __call__(self, params: PtychoParams, buffers: Buffers, niter: int) -> PtychoParams:
        for name, freq, fn, c in self._active:
            if niter % freq == 0:
                with span(_SPANS[name]):
                    fn(params, buffers, c)
        return params

    def due(self, niter: int) -> bool:
        """Is any constraint applied at iteration niter?"""
        return any(niter % freq == 0 for _, freq, _, _ in self._active)

    @property
    def active_names(self) -> List[str]:
        return [name for name, _, _, _ in self._active]
