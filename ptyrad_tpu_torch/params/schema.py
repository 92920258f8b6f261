"""Pydantic schema of a params file: strict validation and default filling.

The port's own copy of ptyrad_tpu/params/schema.py, field for field, so a
params file validates the same way in both packages and gives the same
dict. That includes the keys of the JAX package beyond the reference
configs: ModelParams fwd_remat, which rematerialises the plain route's
slice loop; recon_params shard_measurements, which the port accepts; and
recon_params shard_canvas, which it runs on more than one rank. Optimizer names validate against
ptyrad_tpu_torch.optim.OPTIMIZER_REGISTRY_NAMES, the same names as the JAX
package's registry.

pydantic is imported by this module only; load.load_params imports it when
asked to validate.
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict, List, Literal, Optional, Union

import numpy as np
from pydantic import BaseModel, ConfigDict, Field, field_validator, model_validator

_STRICT = ConfigDict(extra="forbid", arbitrary_types_allowed=True)


# ---------------------------------------------------------------------------
# Shared sub-models
# ---------------------------------------------------------------------------

class FilePathWithKey(BaseModel):
    model_config = _STRICT
    path: pathlib.Path = Field(description="File path")
    key: Optional[str] = None
    shape: Optional[List[int]] = None   # for .raw
    offset: Optional[int] = None        # for .raw
    gap: Optional[int] = None           # for .raw


class MeasCalibration(BaseModel):
    model_config = _STRICT
    mode: Literal["dx", "dk", "kMax", "da", "angleMax", "n_alpha", "RBF", "fitRBF"] = "fitRBF"
    value: Optional[float] = Field(default=None, gt=0.0)
    thresh: Optional[float] = Field(default=0.5, gt=0.0, lt=1.0)


class ObjOmodeInitOccu(BaseModel):
    model_config = _STRICT
    occu_type: Literal["uniform", "custom"] = "uniform"
    init_occu: Optional[List[float]] = None


class MeasPad(BaseModel):
    model_config = _STRICT
    mode: Optional[Literal["on_the_fly", "precompute"]] = "on_the_fly"
    padding_type: Literal["constant", "edge", "linear_ramp", "exp", "power"] = "power"
    target_Npix: int = 256
    value: Optional[float] = 0
    threshold: Optional[float] = 70


class MeasResample(BaseModel):
    model_config = _STRICT
    mode: Optional[Literal["on_the_fly", "precompute"]] = "on_the_fly"
    scale_factors: List[float] = Field(default=[2, 2], min_length=2, max_length=2)


class MeasRemoveNegValues(BaseModel):
    model_config = _STRICT
    mode: Literal["subtract_min", "subtract_value", "clip_neg", "clip_value"] = "clip_neg"
    value: Optional[float] = None
    force: bool = False


class MeasNormalization(BaseModel):
    model_config = _STRICT
    mode: Literal["max_at_one", "mean_at_one", "sum_to_one", "divide_const"] = "max_at_one"
    value: Optional[float] = None


class MeasAddPoissonNoise(BaseModel):
    model_config = _STRICT
    unit: Literal["total_e_per_pattern", "e_per_Ang2"]
    value: Union[int, float] = Field(gt=0.0)


class MeasExport(BaseModel):
    model_config = _STRICT
    file_dir: Optional[str] = None
    file_name: str = "ptyrad_init_meas"
    file_format: Literal["hdf5", "tif", "npy", "mat"] = "hdf5"
    output_shape: Optional[List[int]] = None
    append_shape: bool = True


class TiltParams(BaseModel):
    model_config = _STRICT
    tilt_type: Literal["all", "each"] = "all"
    init_tilts: List[List[float]] = Field(default=[[0, 0]])


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------

class InitParams(BaseModel):
    """Experimental metadata + initialization sources (reference
    params/init_params.py:185-773)."""

    model_config = _STRICT

    # illumination
    probe_illum_type: Literal["electron", "xray"] = "electron"
    probe_kv: Optional[float] = None
    probe_conv_angle: Optional[float] = Field(default=None, gt=0.0)
    probe_defocus: Optional[float] = 0.0
    probe_c3: Optional[float] = 0.0
    probe_c5: Optional[float] = 0.0
    # xray FZP geometry
    beam_kev: Optional[float] = None
    probe_dRn: Optional[float] = None
    probe_Rn: Optional[float] = None
    probe_D_H: Optional[float] = None
    probe_D_FZP: Optional[float] = None
    probe_Ls: Optional[float] = None

    # geometry
    meas_Npix: int = Field(ge=1)
    pos_N_scans: Optional[int] = Field(default=None, ge=1)
    pos_N_scan_slow: int = Field(ge=1)
    pos_N_scan_fast: int = Field(ge=1)
    pos_scan_step_size: float = Field(gt=0.0)
    meas_calibration: MeasCalibration = Field(default_factory=MeasCalibration)

    # model complexity
    probe_pmode_max: int = Field(ge=1)
    probe_pmode_init_pows: List[float] = Field(default=[0.02])
    obj_omode_max: int = Field(default=1, ge=1)
    obj_omode_init_occu: ObjOmodeInitOccu = Field(default_factory=ObjOmodeInitOccu)
    obj_Nlayer: int = Field(ge=1)
    obj_slice_thickness: float = Field(gt=0.0)

    # measurement preprocessing
    meas_permute: Optional[List[int]] = None
    meas_reshape: Optional[List[int]] = Field(default=None, min_length=3, max_length=3)
    meas_flipT: Optional[List[int]] = Field(default=None, min_length=3, max_length=3)
    meas_crop: Optional[List[Optional[List[int]]]] = None
    meas_pad: Optional[MeasPad] = None
    meas_resample: Optional[MeasResample] = None
    meas_add_source_size: Optional[float] = Field(default=None, gt=0.0)
    meas_add_detector_blur: Optional[float] = Field(default=None, gt=0.0)
    meas_remove_neg_values: MeasRemoveNegValues = Field(default_factory=MeasRemoveNegValues)
    meas_normalization: MeasNormalization = Field(default_factory=MeasNormalization)
    meas_add_poisson_noise: Optional[MeasAddPoissonNoise] = None
    meas_export: Optional[Union[bool, MeasExport]] = None

    # probe / pos processing
    probe_permute: Optional[List[int]] = None
    pos_scan_flipT: Optional[List[int]] = None
    pos_scan_affine: Optional[List[float]] = None
    pos_scan_rand_std: Optional[float] = Field(default=0.15, ge=0.0)

    # sources (validated against per-source parameter types below)
    meas_source: Literal["file", "custom"] = "file"
    meas_params: Union[FilePathWithKey, np.ndarray] = Field()
    probe_source: Literal["simu", "PtyRAD", "PtyShv", "py4DSTEM", "custom"] = "simu"
    probe_params: Optional[Union[Dict[str, Any], pathlib.Path, np.ndarray]] = None
    pos_source: Literal["simu", "PtyRAD", "PtyShv", "py4DSTEM", "foldslice_hdf5", "custom"] = "simu"
    pos_params: Optional[Union[pathlib.Path, np.ndarray]] = None
    obj_source: Literal["simu", "PtyRAD", "PtyShv", "py4DSTEM", "custom"] = "simu"
    obj_params: Optional[Union[List[int], pathlib.Path, np.ndarray]] = None
    tilt_source: Literal["simu", "PtyRAD", "file", "custom"] = "simu"
    tilt_params: Union[TiltParams, FilePathWithKey, pathlib.Path, np.ndarray, List] = Field(
        default_factory=TiltParams
    )

    @model_validator(mode="after")
    def _infer_n_scans(self):
        if self.pos_N_scans is None:
            self.pos_N_scans = self.pos_N_scan_slow * self.pos_N_scan_fast
        return self

    @model_validator(mode="after")
    def _require_illum_fields(self):
        if self.probe_illum_type == "electron":
            missing = [k for k in ("probe_kv", "probe_conv_angle") if getattr(self, k) is None]
        else:
            missing = [
                k for k in ("beam_kev", "probe_dRn", "probe_Rn", "probe_D_H", "probe_D_FZP", "probe_Ls")
                if getattr(self, k) is None
            ]
        if missing:
            raise ValueError(
                f"probe_illum_type='{self.probe_illum_type}' requires fields: {missing}"
            )
        return self

    @model_validator(mode="after")
    def _validate_source_params(self):
        """Per-source parameter-type table (reference SOURCE_PARAMS_MAPPING,
        params/init_params.py:120-183)."""
        file_like = (str, pathlib.Path)
        rules = {
            "meas": {"file": (FilePathWithKey, dict), "custom": (np.ndarray,)},
            "probe": {"simu": (dict, type(None)), "PtyRAD": file_like, "PtyShv": file_like,
                      "py4DSTEM": file_like, "custom": (np.ndarray,)},
            "pos": {"simu": (dict, type(None)), "PtyRAD": file_like, "PtyShv": file_like,
                    "py4DSTEM": file_like, "foldslice_hdf5": file_like, "custom": (np.ndarray,)},
            "obj": {"simu": (list, tuple, type(None)), "PtyRAD": file_like, "PtyShv": file_like,
                    "py4DSTEM": file_like, "custom": (np.ndarray,)},
            "tilt": {"simu": (TiltParams, dict, type(None)), "PtyRAD": file_like,
                     "file": (FilePathWithKey, dict), "custom": (np.ndarray, list)},
        }
        for field, table in rules.items():
            source = getattr(self, f"{field}_source")
            value = getattr(self, f"{field}_params")
            if source in table and not isinstance(value, table[source]):
                raise ValueError(
                    f"{field}_source='{source}' expects {field}_params of type "
                    f"{[t.__name__ for t in table[source]]}, got {type(value).__name__}"
                )
        return self

    def model_dump(self, **kwargs):
        d = super().model_dump(**kwargs)
        for k, v in d.items():
            if isinstance(v, pathlib.Path):
                d[k] = str(v)
        for field in ("meas_params", "probe_params", "pos_params", "obj_params", "tilt_params"):
            v = d.get(field)
            if isinstance(v, pathlib.Path):
                d[field] = str(v)
            elif isinstance(v, dict) and isinstance(v.get("path"), pathlib.Path):
                v["path"] = str(v["path"])
        return d


# ---------------------------------------------------------------------------
# model_params
# ---------------------------------------------------------------------------

class OptimizerParams(BaseModel):
    model_config = _STRICT
    name: str = "Adam"
    configs: Dict[str, Any] = Field(default_factory=dict)
    load_state: Optional[str] = None

    @field_validator("name")
    @classmethod
    def _check_name(cls, v):
        from ptyrad_tpu_torch.optim import OPTIMIZER_REGISTRY_NAMES

        if v not in OPTIMIZER_REGISTRY_NAMES:
            raise ValueError(
                f"Optimizer '{v}' not in registry {sorted(set(OPTIMIZER_REGISTRY_NAMES))}")
        return v


class UpdateParams(BaseModel):
    model_config = _STRICT
    obja: Dict[str, Union[int, float, None]] = Field(default={"start_iter": 1, "lr": 5e-4})
    objp: Dict[str, Union[int, float, None]] = Field(default={"start_iter": 1, "lr": 5e-4})
    obj_tilts: Dict[str, Union[int, float, None]] = Field(default={"start_iter": None, "lr": 0})
    slice_thickness: Dict[str, Union[int, float, None]] = Field(default={"start_iter": None, "lr": 0})
    probe: Dict[str, Union[int, float, None]] = Field(default={"start_iter": 1, "lr": 1e-4})
    # reference default (params/model_params.py:52-55): position refinement ON
    probe_pos_shifts: Dict[str, Union[int, float, None]] = Field(default={"start_iter": 1, "lr": 5e-4})

    @model_validator(mode="after")
    def _consistent(self):
        for name in ("obja", "objp", "obj_tilts", "slice_thickness", "probe", "probe_pos_shifts"):
            cfg = getattr(self, name)
            lr = cfg.get("lr", 0) or 0
            si = cfg.get("start_iter")
            if lr != 0 and si is None:
                raise ValueError(f"update_params.{name}: nonzero lr requires a start_iter")
            if lr < 0:
                raise ValueError(f"update_params.{name}: lr must be >= 0")
        return self


class ModelParams(BaseModel):
    """(reference params/model_params.py:98-152)"""

    model_config = _STRICT
    obj_preblur_std: Optional[float] = Field(default=None, ge=0.0)
    detector_blur_std: Optional[float] = Field(default=None, ge=0.0)
    optimizer_params: OptimizerParams = Field(default_factory=OptimizerParams)
    update_params: UpdateParams = Field(default_factory=UpdateParams)
    # Keys of the JAX package beyond the reference configs. In the port:
    # fwd_fused None or True takes the kernel routes where the shapes fit,
    # False the plain torch.fft chain; fwd_remat rematerialises the plain
    # route's slice loop (models/forward.py:multislice_dp); compute_dtype
    # and matmul_dtype are the bfloat16 compute policy
    # (models/state.py:resolve_compute_policy); meas_dtype is the
    # measurement store's type.
    fwd_fused: Optional[bool] = None
    fwd_remat: bool = False
    compute_dtype: Literal["float32", "bfloat16"] = "float32"
    matmul_dtype: Optional[Literal["float32", "bfloat16"]] = None
    meas_dtype: Literal["float32", "bfloat16", "float16"] = "float32"


# ---------------------------------------------------------------------------
# loss_params
# ---------------------------------------------------------------------------

class LossSingle(BaseModel):
    model_config = _STRICT
    state: bool = True
    weight: float = Field(default=1.0, ge=0.0)
    dp_pow: float = 0.5


class LossPoissn(BaseModel):
    model_config = _STRICT
    state: bool = False
    weight: float = Field(default=1.0, ge=0.0)
    dp_pow: float = 1.0
    eps: float = Field(default=1e-6, gt=0.0)


class LossPacbed(BaseModel):
    model_config = _STRICT
    state: bool = False
    weight: float = Field(default=0.5, ge=0.0)
    dp_pow: float = 0.2


class LossSparse(BaseModel):
    model_config = _STRICT
    state: bool = True
    weight: float = Field(default=0.1, ge=0.0)
    ln_order: int = Field(default=1, ge=1)


class LossSimlar(BaseModel):
    model_config = _STRICT
    state: bool = False
    weight: float = Field(default=0.1, ge=0.0)
    obj_type: Literal["amplitude", "phase", "both"] = "both"
    scale_factor: List[float] = Field(default=[1.0, 1.0], min_length=2, max_length=3)
    blur_std: float = Field(default=1.0, ge=0.0)


class LossParams(BaseModel):
    """(reference params/loss_params.py:49-115)"""

    model_config = _STRICT
    loss_single: LossSingle = Field(default_factory=LossSingle)
    loss_poissn: LossPoissn = Field(default_factory=LossPoissn)
    loss_pacbed: LossPacbed = Field(default_factory=LossPacbed)
    loss_sparse: LossSparse = Field(default_factory=LossSparse)
    loss_simlar: LossSimlar = Field(default_factory=LossSimlar)

    @model_validator(mode="after")
    def _at_least_one_data_term(self):
        if not (self.loss_single.state or self.loss_poissn.state or self.loss_pacbed.state):
            raise ValueError(
                "At least one data-error term (loss_single, loss_poissn, loss_pacbed) must be enabled"
            )
        return self


# ---------------------------------------------------------------------------
# constraint_params (reference params/constraint_params.py:107-259)
# ---------------------------------------------------------------------------

class OrthoPmode(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=1, ge=1)


class ProbeMaskK(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=None, ge=1)
    radius: float = Field(default=0.22, ge=0.0)
    width: float = Field(default=0.05, ge=0.0)
    power_thresh: float = Field(default=0.95, ge=0.0, le=1.0)


class FixProbeInt(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=1, ge=1)


class ObjBlur(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=1, ge=1)
    obj_type: Literal["amplitude", "phase", "both"] = "both"
    kernel_size: int = Field(default=5, ge=1)
    std: float = Field(default=0.5, ge=0.0)


class KrFilter(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=None, ge=1)
    obj_type: Literal["amplitude", "phase", "both"] = "both"
    radius: float = Field(default=0.15, ge=0.0)
    width: float = Field(default=0.05, ge=0.0)


class KzFilter(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=None, ge=1)
    obj_type: Literal["amplitude", "phase", "both"] = "both"
    beta: float = Field(default=1.0, ge=0.0)
    alpha: float = Field(default=1.0, ge=0.0)


class ComplexRatio(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=None, ge=1)
    obj_type: Literal["amplitude", "phase", "both"] = "both"
    alpha1: float = 1.0
    alpha2: float = 0.0


class MirroredAmp(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=None, ge=1)
    relax: float = Field(default=0.1, ge=0.0, le=1.0)
    scale: float = Field(default=0.03, ge=0.0)
    power: float = Field(default=4.0, ge=0.0)


class ObjaThresh(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=1, ge=1)
    relax: float = Field(default=0.0, ge=0.0, le=1.0)
    thresh: List[float] = Field(default=[0.98, 1.02], min_length=2, max_length=2)


class ObjpPostiv(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=1, ge=1)
    relax: float = Field(default=0.0, ge=0.0, le=1.0)
    mode: Literal["clip_neg", "subtract_min"] = "clip_neg"


class TiltSmooth(BaseModel):
    model_config = _STRICT
    freq: Optional[int] = Field(default=None, ge=1)
    std: float = Field(default=2.0, ge=0.0)


class ConstraintParams(BaseModel):
    model_config = _STRICT
    ortho_pmode: OrthoPmode = Field(default_factory=OrthoPmode)
    probe_mask_k: ProbeMaskK = Field(default_factory=ProbeMaskK)
    fix_probe_int: FixProbeInt = Field(default_factory=FixProbeInt)
    obj_rblur: ObjBlur = Field(default_factory=ObjBlur)
    obj_zblur: ObjBlur = Field(default_factory=lambda: ObjBlur(std=1.0))
    kr_filter: KrFilter = Field(default_factory=KrFilter)
    kz_filter: KzFilter = Field(default_factory=KzFilter)
    complex_ratio: ComplexRatio = Field(default_factory=ComplexRatio)
    mirrored_amp: MirroredAmp = Field(default_factory=MirroredAmp)
    obja_thresh: ObjaThresh = Field(default_factory=ObjaThresh)
    objp_postiv: ObjpPostiv = Field(default_factory=ObjpPostiv)
    tilt_smooth: TiltSmooth = Field(default_factory=TiltSmooth)


# ---------------------------------------------------------------------------
# recon_params (reference params/recon_params.py:52-283)
# ---------------------------------------------------------------------------

class IndicesMode(BaseModel):
    model_config = _STRICT
    mode: Literal["full", "sub", "center"] = "full"
    subscan_slow: Optional[int] = Field(default=None, ge=1)
    subscan_fast: Optional[int] = Field(default=None, ge=1)


class BatchSize(BaseModel):
    model_config = _STRICT
    size: int = Field(default=32, ge=1)
    grad_accumulation: int = Field(default=1, ge=1)


class ResultModes(BaseModel):
    model_config = _STRICT
    obj_dim: List[int] = Field(default=[2, 3, 4], min_length=1)
    FOV: List[str] = Field(default=["crop"], min_length=1)
    bit: List[str] = Field(default=["8"], min_length=1)

    @field_validator("FOV")
    @classmethod
    def _fov(cls, v):
        for item in v:
            if item not in ("full", "crop"):
                raise ValueError(f"FOV entries must be 'full' or 'crop', got '{item}'")
        return v

    @field_validator("bit")
    @classmethod
    def _bit(cls, v):
        for item in v:
            if item not in ("raw", "8", "16", "32"):
                raise ValueError(f"bit entries must be 'raw', '8', '16', or '32', got '{item}'")
        return v


class ReconParams(BaseModel):
    model_config = _STRICT
    NITER: int = Field(default=200, ge=1)
    INDICES_MODE: IndicesMode = Field(default_factory=IndicesMode)
    BATCH_SIZE: BatchSize = Field(default_factory=BatchSize)
    GROUP_MODE: Literal["random", "sparse", "compact"] = "random"
    # batch-grouping RNG seed; None = a fresh shuffle per run
    GROUP_MODE_SEED: Optional[int] = None
    SAVE_ITERS: Optional[int] = Field(default=10, ge=1)
    # the JAX package's device-mesh options: on more than one rank
    # shard_canvas splits the object and the store into row slabs
    # (parallel/canvas.py); shard_measurements' split of the store in the
    # replicated path is ROADMAP item A6b
    shard_measurements: bool = True
    shard_canvas: bool = False
    output_dir: str = "output/"
    recon_dir_affixes: List[str] = Field(default=["default"])
    prefix_time: Union[bool, str] = "date"
    prefix: str = ""
    postfix: str = ""
    save_result: List[str] = Field(default=["model", "objp"])
    result_modes: ResultModes = Field(default_factory=ResultModes)
    selected_figs: List[str] = Field(default=["loss", "forward", "probe_r_amp", "pos"])
    copy_params: bool = True
    if_quiet: bool = False

    @field_validator("prefix_time")
    @classmethod
    def _prefix_time(cls, v):
        if isinstance(v, str) and v == "date":
            return "%Y%m%d"
        return v


# ---------------------------------------------------------------------------
# hypertune_params (reference params/hypertune_params.py:145-244)
# ---------------------------------------------------------------------------

class SamplerParams(BaseModel):
    model_config = _STRICT
    name: str = "TPESampler"
    configs: Dict[str, Any] = Field(default_factory=dict)


class PrunerParams(BaseModel):
    model_config = _STRICT
    name: str = "HyperbandPruner"
    configs: Dict[str, Any] = Field(default_factory=dict)


class TuneParam(BaseModel):
    model_config = _STRICT
    state: bool
    suggest: Literal["int", "float", "cat"]
    kwargs: Dict[str, Any]

    @model_validator(mode="after")
    def _check_kwargs(self):
        if self.suggest == "cat" and "choices" not in self.kwargs:
            raise ValueError("suggest='cat' requires kwargs['choices']")
        if self.suggest in ("int", "float") and not {"low", "high"} <= set(self.kwargs):
            raise ValueError(f"suggest='{self.suggest}' requires kwargs 'low' and 'high'")
        return self


def _tp(state=False, suggest="float", **kwargs):
    return lambda: TuneParam(state=state, suggest=suggest, kwargs=kwargs)


class TuneParams(BaseModel):
    """22 tunable params (reference params/hypertune_params.py:111-142)."""

    model_config = _STRICT
    optimizer: TuneParam = Field(default_factory=_tp(False, "cat", choices=["Adam", "AdamW", "RMSprop", "SGD"], optim_configs={}))
    batch_size: TuneParam = Field(default_factory=_tp(False, "int", low=16, high=512, log=True))
    plr: TuneParam = Field(default_factory=_tp(False, "cat", choices=[1e-2, 1e-3, 1e-4]))
    oalr: TuneParam = Field(default_factory=_tp(False, "float", low=1e-4, high=1e-2, log=True))
    oplr: TuneParam = Field(default_factory=_tp(False, "float", low=1e-4, high=1e-2, log=True))
    slr: TuneParam = Field(default_factory=_tp(False, "float", low=1e-4, high=1e-2, log=True))
    tlr: TuneParam = Field(default_factory=_tp(False, "float", low=1e-4, high=1e-2, log=True))
    dzlr: TuneParam = Field(default_factory=_tp(False, "float", low=1e-4, high=1e-2, log=True))
    dx: TuneParam = Field(default_factory=_tp(False, "float", low=0.14, high=0.16, step=0.001))
    pmode_max: TuneParam = Field(default_factory=_tp(False, "int", low=1, high=8, step=1))
    conv_angle: TuneParam = Field(default_factory=_tp(False, "float", low=24, high=26, step=1))
    defocus: TuneParam = Field(default_factory=_tp(False, "float", low=-50, high=50, step=0.1))
    c3: TuneParam = Field(default_factory=_tp(False, "float", low=4000, high=10000, step=100))
    c5: TuneParam = Field(default_factory=_tp(False, "float", low=50000, high=100000, step=5000))
    Nlayer: TuneParam = Field(default_factory=_tp(False, "int", low=1, high=8, step=1))
    dz: TuneParam = Field(default_factory=_tp(False, "float", low=4, high=8, step=0.5))
    scale: TuneParam = Field(default_factory=_tp(True, "float", low=0.8, high=1.2, step=0.02))
    asymmetry: TuneParam = Field(default_factory=_tp(False, "float", low=-0.2, high=0.2, step=0.05))
    rotation: TuneParam = Field(default_factory=_tp(True, "float", low=-4, high=4, step=0.5))
    shear: TuneParam = Field(default_factory=_tp(False, "float", low=-4, high=4, step=0.5))
    tilt_y: TuneParam = Field(default_factory=_tp(False, "float", low=-5, high=5, step=0.5))
    tilt_x: TuneParam = Field(default_factory=_tp(False, "float", low=-5, high=5, step=0.5))


class HypertuneParams(BaseModel):
    model_config = _STRICT
    if_hypertune: bool = False
    collate_results: bool = True
    append_params: bool = True
    sampler_params: SamplerParams = Field(default_factory=SamplerParams)
    pruner_params: Optional[PrunerParams] = Field(default_factory=PrunerParams)
    n_trials: int = Field(default=50, ge=1)
    timeout: Optional[int] = None
    error_metric: Literal["loss", "contrast"] = "loss"
    # None = in-memory study (reference passes storage=None to optuna)
    storage_path: Optional[str] = "hypertune.db"
    study_name: str = "ptyrad_hypertune"
    tune_params: TuneParams = Field(default_factory=TuneParams)


# ---------------------------------------------------------------------------
# Aggregate
# ---------------------------------------------------------------------------

class PtyRADParams(BaseModel):
    """Top-level params (reference params/base.py:11-36)."""

    model_config = _STRICT
    init_params: InitParams
    model_params: ModelParams = Field(default_factory=ModelParams)
    loss_params: LossParams = Field(default_factory=LossParams)
    constraint_params: ConstraintParams = Field(default_factory=ConstraintParams)
    recon_params: ReconParams = Field(default_factory=ReconParams)
    hypertune_params: HypertuneParams = Field(default_factory=HypertuneParams)
    params_path: Optional[str] = None
