"""Model state: optimizable tensors, constant buffers, static geometry.

Counterpart of ptyrad_tpu/models/state.py. The six optimizable tensors are a
dataclass of leaf tensors (the probe is native complex64), the constant
tensors another, and everything that decides code paths or shapes lives in
the frozen ``Geometry``.
"""

from __future__ import annotations

import dataclasses
import warnings
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
    measurements: torch.Tensor   # (N, Ky, Kx) diffraction data, stored as meas_dtype
    crop_pos: torch.Tensor       # (N, 2) int32 top-left patch corners
    omode_occu: torch.Tensor     # (omode,) float32
    Ky: torch.Tensor             # (Ny, Nx) float32 angular k-grid (corner layout)
    Kx: torch.Tensor
    Kz: torch.Tensor             # sqrt(k^2 - Kx^2 - Ky^2)
    probe_int_sum: torch.Tensor  # () float32 initial total probe intensity
    meas_padded: Optional[torch.Tensor] = None  # (Kp, Kp) on-the-fly pad background
    # parallel.StoreSplit when ``measurements`` is this rank's block of a
    # store split over ranks (shard_measurements); None: the whole store
    store_split: Optional[object] = None


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
    meas_pad_idx: Optional[Tuple[int, int, int, int]] = None  # (h1, h2, w1, w2)
    meas_padded_shape: Optional[Tuple[int, int]] = None
    meas_scale_factors: Optional[Tuple[float, float]] = None
    fwd_fused: bool = True  # False: forward() takes multislice_dp, no kernel chain
    # the plain route checkpoints each slice step (multislice_dp's remat):
    # the backward recomputes the step's intermediates instead of storing them
    fwd_remat: bool = False
    # the bfloat16 compute policy: compute_dtype 'bfloat16' keeps the plain
    # route's wavefield in bfloat16 between ops; bf16_operands rounds the
    # operand of every DFT pass (every kernel's and the f32 transforms
    # outside them) to bfloat16. Parameters, gradients, loss and dp stay f32.
    compute_dtype: str = "float32"
    bf16_operands: bool = False
    # read by save.make_save_dict (model_attributes) and make_output_folder;
    # make_model fills them
    n_scans: Optional[int] = None
    dk: Optional[float] = None     # [1/Ang] detector pixel
    scan_affine: Optional[Tuple[float, float, float, float]] = None  # (scale, asym, rot, shear)


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


COMPUTE_DTYPES = ("float32", "bfloat16")


MEAS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_F16_MAX = 65504.0


def _measurements(meas, device, meas_dtype: str = "float32") -> torch.Tensor:
    """The measurement store on the device in its storage type (model_params
    meas_dtype: float32, bfloat16 or float16; get_measurements upcasts each
    batch). A tensor already on the device (e.g. simulated on the card) is
    converted there without a host round trip. float16 overflows to inf above
    65504, which would surface as a NaN loss, so such values are clipped with
    a warning; bfloat16 keeps float32's exponent range."""
    if meas_dtype not in MEAS_DTYPES:
        raise ValueError(f"model_params.meas_dtype={meas_dtype!r}; use one of "
                         f"{sorted(MEAS_DTYPES)}")
    dtype = MEAS_DTYPES[meas_dtype]
    if not isinstance(meas, torch.Tensor):
        # torch.tensor copies: the store never shares memory with the caller's array
        meas = torch.tensor(np.asarray(meas, dtype=np.float32))
    if dtype == torch.float16 and meas.numel():
        top = float(meas.max())
        if top > _F16_MAX:
            warnings.warn(
                f"meas_dtype='float16': measurement max {top:.3g} exceeds float16 range; "
                "clipping to 65504. Use 'bfloat16' (full float32 exponent range) or "
                "normalize the measurements.", stacklevel=3)
            meas = meas.clamp(max=_F16_MAX)
    return meas.to(device=device, dtype=dtype)


def _dtype_key(model_params: dict, key: str, default):
    value = model_params.get(key, default)
    if value is not None and value not in COMPUTE_DTYPES:
        raise ValueError(f"model_params.{key}={value!r}; use one of {list(COMPUTE_DTYPES)}")
    return value


def resolve_compute_policy(model_params: dict) -> Tuple[str, bool]:
    """(compute_dtype, bf16_operands) from model_params as
    ptyrad_tpu/engine/solver.py:437-449 resolves them: an explicit
    matmul_dtype wins; without it the operands are bfloat16 exactly when
    compute_dtype is."""
    compute = _dtype_key(model_params, "compute_dtype", "float32") or "float32"
    matmul = _dtype_key(model_params, "matmul_dtype", None)
    if matmul is None:
        matmul = compute
    return compute, matmul == "bfloat16"


def make_model(init_variables: dict, model_params: Optional[dict] = None, device=None,
               store_on_host: bool = False):
    """Build (params, buffers, geometry) from an init_variables dict, such
    as the Initializer's as it comes (keys this function does not read, e.g.
    Npix, meas_avg, fitRBF, obj_lateral_extent, are ignored, as the JAX
    package's make_model ignores them).

    Keys as in ptyrad_tpu.models.make_model: obj (complex; a complex128 obj
    keeps a float32 amplitude and phase exact through abs and angle),
    probe, probe_pos_shifts, obj_tilts, slice_thickness, measurements, crop_pos, omode_occu, dx,
    lambd, N_scan_slow, N_scan_fast, optional H, dk and scan_affine (kept in
    ``Geometry`` for the checkpoint), the on-the-fly pad pair
    on_the_fly_meas_padded / on_the_fly_meas_padded_idx (both or neither;
    see initialization.meas_pad_on_the_fly) and on_the_fly_meas_scale_factors
    (initialization.meas_resample_on_the_fly). ``model_params`` carries
    update_params (per-tensor lr), obj_preblur_std, detector_blur_std,
    meas_dtype (the store's type), fwd_fused (None or True: the kernel
    routes where the shapes fit; False: the plain torch.fft chain) and the
    bfloat16 compute policy, compute_dtype and matmul_dtype
    (resolve_compute_policy: bfloat16 operands in every DFT pass, the
    kernels' included, and with compute_dtype a bfloat16 wavefield on the
    plain route) and fwd_remat (the plain route recomputes each slice step
    in the backward instead of storing its intermediates; the kernel
    routes ignore it). ``device=None`` means CUDA. ``store_on_host``
    leaves the measurement store where it is and as it is (a NumPy array as
    a CPU tensor over its memory, no copy): the canvas path
    (parallel/canvas.py) moves each rank's slab alone to the device, in
    meas_dtype, and reads no other row; so does the store split over ranks
    (parallel.split_store) with its block.
    """
    dev = resolve_device(device)
    model_params = model_params or {}
    compute_dtype, bf16_operands = resolve_compute_policy(model_params)
    update = model_params.get("update_params", {}) or {}

    def lr_of(name):
        return float((update.get(name) or {}).get("lr", 0.0) or 0.0)

    obj = np.asarray(init_variables["obj"])
    probe = np.asarray(init_variables["probe"], dtype=np.complex64)
    tilts = np.asarray(init_variables["obj_tilts"], dtype=np.float32).reshape(-1, 2)
    dz = float(np.asarray(init_variables["slice_thickness"]))
    meas = init_variables["measurements"]
    if not store_on_host:
        meas = _measurements(meas, dev, model_params.get("meas_dtype", "float32"))
    elif not isinstance(meas, torch.Tensor):
        meas = torch.as_tensor(np.asarray(meas, dtype=np.float32))
    crop_pos = np.asarray(init_variables["crop_pos"], dtype=np.int32)
    omode_occu = np.asarray(init_variables["omode_occu"], dtype=np.float32)
    dx = float(np.asarray(init_variables["dx"]))
    dk = float(np.asarray(init_variables.get("dk", 1.0 / (dx * probe.shape[-1]))))
    scan_affine = init_variables.get("scan_affine")
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

    meas_scale = init_variables.get("on_the_fly_meas_scale_factors")
    meas_padded = init_variables.get("on_the_fly_meas_padded")
    meas_pad_idx = init_variables.get("on_the_fly_meas_padded_idx")
    if (meas_padded is None) != (meas_pad_idx is None):
        # the pair travels together (meas_pad_on_the_fly returns both)
        raise ValueError(
            "init_variables must carry both 'on_the_fly_meas_padded' and "
            "'on_the_fly_meas_padded_idx' (or neither); got "
            f"padded={'set' if meas_padded is not None else 'None'}, "
            f"idx={'set' if meas_pad_idx is not None else 'None'}")

    buffers = Buffers(
        H=torch.tensor(np.asarray(H, dtype=np.complex64), device=dev),
        measurements=meas,
        crop_pos=torch.tensor(crop_pos, device=dev),
        omode_occu=_f32(omode_occu, dev),
        Ky=_f32(Ky, dev),
        Kx=_f32(Kx, dev),
        Kz=_f32(Kz, dev),
        probe_int_sum=_f32(np.sum(np.abs(probe) ** 2), dev),
        meas_padded=None if meas_padded is None else _f32(meas_padded, dev),
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
        meas_pad_idx=None if meas_pad_idx is None else tuple(int(i) for i in meas_pad_idx),
        meas_padded_shape=(None if meas_padded is None
                           else tuple(int(v) for v in np.shape(meas_padded)[-2:])),
        meas_scale_factors=None if meas_scale is None else tuple(float(s) for s in meas_scale),
        fwd_fused=model_params.get("fwd_fused") is None or bool(model_params["fwd_fused"]),
        fwd_remat=bool(model_params.get("fwd_remat", False)),
        compute_dtype=compute_dtype,
        bf16_operands=bf16_operands,
        n_scans=int(meas.shape[0]),
        dk=dk,
        scan_affine=None if scan_affine is None else tuple(scan_affine),
    )
    return params, buffers, geom
