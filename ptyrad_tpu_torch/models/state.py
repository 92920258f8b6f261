"""Model state: optimizable tensors, constant buffers, static geometry.

Counterpart of ptyrad_tpu/models/state.py. The six optimizable tensors are a
dataclass of leaf tensors (the probe is native complex64), the constant
tensors another, and everything that decides code paths or shapes lives in
the frozen ``Geometry``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ptyrad_tpu_torch.device import resolve_device
from ptyrad_tpu_torch.physics.propagator import near_field_evolution, propagator_kgrid

PARAM_NAMES = ("obja", "objp", "probe", "probe_pos_shifts", "obj_tilts", "slice_thickness")


@dataclasses.dataclass
class PtychoParams:
    """The optimizable tensors.

    obja, objp: (omode, Nz, Noy, Nox) float32 object amplitude and phase
    probe: (pmode, Ny, Nx) complex64 mixed-state probe
    probe_pos_shifts: (N, 2) float32 sub-pixel scan-position shifts [px]
    obj_tilts: (1 or N, 2) float32 crystal tilts [mrad], (tilt_y, tilt_x)
    slice_thickness: () float32 inter-slice distance [Ang]
    """

    obja: torch.Tensor
    objp: torch.Tensor
    probe: torch.Tensor
    probe_pos_shifts: torch.Tensor
    obj_tilts: torch.Tensor
    slice_thickness: torch.Tensor

    def named(self):
        """(name, tensor) pairs in PARAM_NAMES order."""
        return [(name, getattr(self, name)) for name in PARAM_NAMES]


@dataclasses.dataclass
class Buffers:
    """Constant tensors used by the forward pass."""

    H: torch.Tensor              # (Ny, Nx) complex64 base propagator (corner-centred)
    measurements: torch.Tensor   # (N, Ky, Kx) float32 diffraction data
    crop_pos: torch.Tensor       # (N, 2) int32 top-left patch corners
    omode_occu: torch.Tensor     # (omode,) float32
    Ky: torch.Tensor             # (Ny, Nx) float32 angular k-grid (corner layout)
    Kx: torch.Tensor
    Kz: torch.Tensor             # sqrt(k^2 - Kx^2 - Ky^2)
    probe_int_sum: torch.Tensor  # () float32 initial total probe intensity


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static configuration: shapes, flags and physical scalars."""

    probe_shape: Tuple[int, int]
    obj_shape: Tuple[int, int, int, int]   # (omode, Nz, Noy, Nox)
    n_scan_slow: int
    n_scan_fast: int
    dx: float
    lambd: float
    shift_probes: bool = False
    tilt_obj: bool = False
    global_tilt: bool = True
    change_thickness: bool = False
    obj_preblur_std: Optional[float] = None
    detector_blur_std: Optional[float] = None
    eps: float = 1e-10


def _f32(x, device) -> torch.Tensor:
    # torch.tensor copies: parameters are updated in place and must not
    # share memory with the caller's arrays
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def params_from_numpy(d: dict, device=None) -> PtychoParams:
    """The port's parameters from numpy arrays (obja, objp, probe complex64,
    probe_pos_shifts, obj_tilts, slice_thickness) — e.g. the JAX package's
    ``PtychoParams`` with its probe as ``re + 1j*im`` — on ``device``, so that
    both packages compute the same thing."""
    dev = resolve_device(device)
    return PtychoParams(
        obja=_f32(d["obja"], dev),
        objp=_f32(d["objp"], dev),
        probe=torch.tensor(np.asarray(d["probe"], dtype=np.complex64), device=dev),
        probe_pos_shifts=_f32(d["probe_pos_shifts"], dev),
        obj_tilts=_f32(np.asarray(d["obj_tilts"]).reshape(-1, 2), dev),
        slice_thickness=_f32(d["slice_thickness"], dev).reshape(()),
    )


def _measurements(meas, device) -> torch.Tensor:
    """The measurement store on the device as float32; a tensor already there
    (e.g. simulated on the card) is kept without a host round trip."""
    if isinstance(meas, torch.Tensor):
        return meas.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(meas, dtype=np.float32), device=device)


def make_model(init_variables: dict, model_params: Optional[dict] = None, device=None):
    """Build (params, buffers, geometry) from an init_variables dict.

    Keys as in ptyrad_tpu.models.make_model: obj, probe, probe_pos_shifts,
    obj_tilts, slice_thickness, measurements, crop_pos, omode_occu, dx,
    lambd, N_scan_slow, N_scan_fast, optional H. ``model_params`` carries
    update_params (per-tensor lr), obj_preblur_std and detector_blur_std.
    ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    model_params = model_params or {}
    for key, supported in (("compute_dtype", "float32"), ("meas_dtype", "float32")):
        if model_params.get(key, supported) != supported:
            raise NotImplementedError(
                f"model_params.{key}={model_params[key]!r}: only {supported!r} is ported "
                "(ROADMAP queue A, PSO slice)")
    update = model_params.get("update_params", {}) or {}

    def lr_of(name):
        return float((update.get(name) or {}).get("lr", 0.0) or 0.0)

    obj = np.asarray(init_variables["obj"])
    probe = np.asarray(init_variables["probe"], dtype=np.complex64)
    tilts = np.asarray(init_variables["obj_tilts"], dtype=np.float32).reshape(-1, 2)
    dz = float(np.asarray(init_variables["slice_thickness"]))
    meas = _measurements(init_variables["measurements"], dev)
    crop_pos = np.asarray(init_variables["crop_pos"], dtype=np.int32)
    omode_occu = np.asarray(init_variables["omode_occu"], dtype=np.float32)
    dx = float(np.asarray(init_variables["dx"]))
    lambd = float(np.asarray(init_variables["lambd"]))

    params = params_from_numpy({
        "obja": np.abs(obj), "objp": np.angle(obj), "probe": probe,
        "probe_pos_shifts": init_variables["probe_pos_shifts"], "obj_tilts": tilts,
        "slice_thickness": dz,
    }, dev)

    probe_shape = probe.shape[-2:]
    H = init_variables.get("H")
    if H is None:
        H = near_field_evolution(probe_shape, dx, dz, lambd)
    Ky, Kx = propagator_kgrid(probe_shape, dx)
    k = 2.0 * np.pi / lambd
    Kz = np.sqrt(np.maximum(k**2 - Kx**2 - Ky**2, 0.0))

    on_the_fly = [k for k in ("on_the_fly_meas_padded", "on_the_fly_meas_padded_idx",
                              "on_the_fly_meas_scale_factors")
                  if init_variables.get(k) is not None]
    if on_the_fly:
        raise NotImplementedError(
            f"{on_the_fly}: on-the-fly measurement pad/resample waits for the PSO slice "
            "(ROADMAP queue A)")

    buffers = Buffers(
        H=torch.tensor(np.asarray(H, dtype=np.complex64), device=dev),
        measurements=meas,
        crop_pos=torch.tensor(crop_pos, device=dev),
        omode_occu=_f32(omode_occu, dev),
        Ky=_f32(Ky, dev),
        Kx=_f32(Kx, dev),
        Kz=_f32(Kz, dev),
        probe_int_sum=_f32(np.sum(np.abs(probe) ** 2), dev),
    )

    geom = Geometry(
        probe_shape=tuple(int(v) for v in probe_shape),
        obj_shape=tuple(int(v) for v in obj.shape),
        n_scan_slow=int(np.asarray(init_variables.get("N_scan_slow", meas.shape[0]))),
        n_scan_fast=int(np.asarray(init_variables.get("N_scan_fast", 1))),
        dx=dx,
        lambd=lambd,
        shift_probes=lr_of("probe_pos_shifts") != 0,
        tilt_obj=bool(lr_of("obj_tilts") != 0 or np.any(tilts)),
        global_tilt=bool(tilts.shape[0] == 1),
        change_thickness=lr_of("slice_thickness") != 0,
        obj_preblur_std=model_params.get("obj_preblur_std"),
        detector_blur_std=model_params.get("detector_blur_std"),
    )
    return params, buffers, geom
