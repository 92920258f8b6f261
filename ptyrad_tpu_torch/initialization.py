"""Host-side data engine: measurements, calibration, probe, positions,
object, propagator and tilts into an ``init_variables`` dict.

The port's own copy of ptyrad_tpu/initialization.py. Entirely NumPy/SciPy;
the device boundary is models.state.make_model. The staged structure
(init_measurements / init_calibration / init_probe / init_pos / init_obj /
init_H / init_obj_tilts) stays, so a caller can re-run only the stages that
a changed hyperparameter invalidates.

Measurement pipeline: permute -> reshape -> flipT -> shape check -> crop ->
remove_neg -> normalize -> pad (meas_pad_on_the_fly: a constant, edge,
linear-ramp or fitted exp/power background, precomputed or on the fly) ->
resample (meas_resample_on_the_fly) -> source-size blur -> detector blur ->
Poisson noise -> final clip.

The random draws come from the Initializer's ``rng`` (a
``np.random.RandomState``), in the JAX package's order, where that package
draws from NumPy's global state.
"""

from __future__ import annotations

import os
from collections import Counter
from math import floor
from typing import Optional

import numpy as np

from ptyrad_tpu_torch.load import load_array_from_file, load_hdf5, load_mat, load_ptyrad
from ptyrad_tpu_torch.ops.affine import compose_affine_matrix
from ptyrad_tpu_torch.ops.resize import out_size
from ptyrad_tpu_torch.physics.constants import get_em_constants, infer_dx, xray_wavelength
from ptyrad_tpu_torch.physics.probe import make_fzp_probe, make_mixed_probe, make_stem_probe
from ptyrad_tpu_torch.physics.propagator import near_field_evolution
from ptyrad_tpu_torch.utils.image_proc import (create_one_hot_mask, exponential_decay,
                                               fit_background, fit_cbed_pattern,
                                               guess_radius_of_bright_field_disk, power_law)
from ptyrad_tpu_torch.utils.logging import vprint
from ptyrad_tpu_torch.utils.nested import get_nested

PADDING_TYPES = ("constant", "edge", "linear_ramp", "exp", "power")


def meas_pad_on_the_fly(meas: np.ndarray, padding_type: str, target_npix: int,
                        threshold: float = 70, value: float = 10):
    """The background canvas for padding (N, h, w) patterns to
    target_npix^2 on the device, batch by batch.

    Returns (meas_padded (Kp, Kp) float32, [h1, h2, w1, w2]): the squared
    padded mean amplitude with the measured window [h1:h2, w1:w2] zeroed,
    and that window. ``make_model`` takes them as on_the_fly_meas_padded and
    on_the_fly_meas_padded_idx; ``get_measurements`` writes each batch into
    the window. padding_type: constant / edge / linear_ramp (with
    ``value``), or exp / power (a radial decay fitted to the dimmest
    ``threshold`` % of the mean amplitude).
    """
    if padding_type not in PADDING_TYPES:
        raise ValueError(f"Unsupported padding_type '{padding_type}'; use one of "
                         f"{sorted(PADDING_TYPES)}")
    amp_avg = np.sqrt(np.asarray(meas).mean(axis=0))
    h, w = amp_avg.shape
    pad_y, pad_x = max(0, target_npix - h), max(0, target_npix - w)
    py1, py2 = pad_y // 2, pad_y - pad_y // 2
    px1, px2 = pad_x // 2, pad_x - pad_x // 2
    h1, h2, w1, w2 = py1, py1 + h, px1, px1 + w
    pads = ((py1, py2), (px1, px2))

    if padding_type == "constant":
        amp_padded = np.pad(amp_avg, pads, mode="constant", constant_values=value)
    elif padding_type == "edge":
        amp_padded = np.pad(amp_avg, pads, mode="edge")
    elif padding_type == "linear_ramp":
        amp_padded = np.pad(amp_avg, pads, mode="linear_ramp", end_values=value)
    else:
        y, x = np.ogrid[:target_npix, :target_npix]
        cy, cx = h // 2 + py1, w // 2 + px1
        r = np.sqrt((y - cy) ** 2 + (x - cx) ** 2) + 1e-10
        model = exponential_decay if padding_type == "exp" else power_law
        mask = create_one_hot_mask(amp_avg, percentile=threshold)
        amp_padded = model(r, *fit_background(amp_avg, mask, padding_type))

    meas_padded = np.square(amp_padded).astype("float32")
    meas_padded[h1:h2, w1:w2] = 0
    return meas_padded, [h1, h2, w1, w2]


def meas_resample_on_the_fly(meas: np.ndarray, scale_factors, meas_padded=None):
    """The scale factors for resampling (N, h, w) patterns on the device,
    batch by batch, and the pattern size that results.

    Returns ([s, s], npix): the two factors equalised to the smaller one, and
    floor(base * s), where the base size is the padded template's when an
    on-the-fly pad is active (``meas_padded`` from meas_pad_on_the_fly; the
    stored array stays unpadded) and the data's otherwise. ``make_model``
    takes the factors as on_the_fly_meas_scale_factors; ``get_measurements``
    pads, then resamples each batch; the probe must be npix wide.
    """
    scale = list(scale_factors)
    if len(scale) != 2:
        raise ValueError("scale_factors must have two entries")
    if scale[0] != scale[1]:
        scale = [min(scale)] * 2
    base = np.shape(meas_padded)[-1] if meas_padded is not None else np.shape(meas)[-1]
    return scale, out_size(int(base), scale[-1])


def default_probe_simu_params(init_params: dict) -> dict:
    """Default probe-simulation params from the experiment's metadata."""
    illum = init_params.get("probe_illum_type") or "electron"
    if illum == "electron":
        return {
            "kv": init_params["probe_kv"],
            "conv_angle": init_params["probe_conv_angle"],
            "Npix": init_params["meas_Npix"],
            "dx": init_params["probe_dx"],
            "pmodes": init_params["probe_pmode_max"],
            "pmode_init_pows": init_params["probe_pmode_init_pows"],
            "df": init_params.get("probe_defocus", 0),
            "c3": init_params.get("probe_c3", 0),
            "c5": init_params.get("probe_c5", 0),
            "c7": 0, "f_a2": 0, "f_a3": 0, "f_c3": 0,
            "theta_a2": 0, "theta_a3": 0, "theta_c3": 0,
            "shifts": [0.0, 0.0],
        }
    if illum == "xray":
        return {
            "beam_kev": init_params["beam_kev"],
            "Npix": init_params["meas_Npix"],
            "dx": init_params["probe_dx"],
            "pmodes": init_params["probe_pmode_max"],
            "pmode_init_pows": init_params["probe_pmode_init_pows"],
            "Ls": init_params["probe_Ls"],
            "Rn": init_params["probe_Rn"],
            "dRn": init_params["probe_dRn"],
            "D_FZP": init_params["probe_D_FZP"],
            "D_H": init_params["probe_D_H"],
        }
    raise ValueError(f"probe_illum_type '{illum}' not supported; use 'electron' or 'xray'")


def _copy_config(obj):
    """Deep copy of dict/list/tuple structure with ndarray (and other
    non-container) leaves shared by reference."""
    if isinstance(obj, dict):
        return {k: _copy_config(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_copy_config(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_copy_config(v) for v in obj)
    return obj


class Initializer:
    """Builds the init_variables dict that models.state.make_model takes.

    ``rng``: the generator of the random draws, anything with
    ``np.random.RandomState``'s ``poisson``, ``randn`` and ``rand``; None
    means a fresh unseeded ``RandomState()``. ``RandomState(s)`` here draws
    what the JAX package's Initializer draws after ``np.random.seed(s)``.
    """

    def __init__(self, init_params: dict, verbose: bool = True, rng=None):
        # config-level copies: crop/pad/resample mutate scalar fields
        # (meas_Npix, pos_N_scan_*) while init_params_original keeps the
        # user's values for provenance. ndarray leaves are SHARED, never
        # mutated — a plain deepcopy would triple resident memory for
        # in-memory 'custom' sources (e.g. a 20 GB measurement array)
        self.init_params = _copy_config(init_params)
        self.init_params_original = _copy_config(init_params)
        self.init_variables: dict = {}
        self.verbose = verbose
        # the three random draws (Poisson noise, position jitter, the
        # random-phase object) come from this generator, in this order
        self.rng = np.random.RandomState() if rng is None else rng

    # ------------------------------------------------------------------
    # Cache
    # ------------------------------------------------------------------

    def init_cache(self):
        """Load a shared source file once when obj/probe/pos point at the same
        path."""
        self.use_cached_obj = False
        self.use_cached_probe = False
        self.use_cached_pos = False
        self.cache_source = None
        self.cache_path = None
        self.cache_contents = None

        for source in ("PtyRAD", "PtyShv", "py4DSTEM"):
            paths = []
            for field in ("obj", "probe", "pos"):
                if self.init_params.get(f"{field}_source") == source:
                    p = self.init_params.get(f"{field}_params")
                    if isinstance(p, str):
                        paths.append((field, p))
            counts = Counter(p for _, p in paths)
            for path, n in counts.items():
                if n >= 2:
                    self.cache_source = source
                    self.cache_path = path
                    for field, p in paths:
                        if p == path:
                            setattr(self, f"use_cached_{field}", True)

        if self.cache_path is not None:
            vprint(f"Caching shared '{self.cache_source}' file: {self.cache_path}", verbose=self.verbose)
            if self.cache_source == "PtyRAD":
                self.cache_contents = load_ptyrad(self.cache_path)
            elif self.cache_source == "PtyShv":
                self.cache_contents = load_mat(
                    self.cache_path, key=["object", "probe", "outputs.probe_positions"], delimiter="."
                )
            else:
                # targeted read, same as the non-cached py4DSTEM loads: a
                # full py4DSTEM results file also holds the reconstruction
                # stack (GBs); the cache consumers only ever read these
                # three (missing ones skipped — a shared file may carry two)
                self.cache_contents = {}
                for k in ("object", "probe", "positions_px"):
                    try:
                        self.cache_contents[k] = load_hdf5(self.cache_path, key=k)
                    except KeyError:
                        pass

    # ------------------------------------------------------------------
    # Measurements
    # ------------------------------------------------------------------

    def init_measurements(self):
        meas = self._load_meas()
        meas = self._process_meas(meas)

        meas_avg = meas.mean(0)
        meas_avg_sum = meas_avg.sum()
        if get_nested(self.init_params, ["meas_pad", "mode"], safe=True) == "on_the_fly":
            padded = self.init_variables.get("on_the_fly_meas_padded")
            if padded is not None:
                meas_avg_sum += padded.sum()

        self.init_variables["meas_avg"] = meas_avg
        self.init_variables["meas_avg_sum"] = meas_avg_sum
        self.init_variables["measurements"] = meas

        export = self.init_params.get("meas_export")
        if export is True or isinstance(export, dict):
            self._export_meas(export if isinstance(export, dict) else {})
        vprint(f"measurements (N, Ky, Kx) = {meas.dtype}, {meas.shape}", verbose=self.verbose)

    def _load_meas(self) -> np.ndarray:
        source = self.init_params["meas_source"]
        params = self.init_params["meas_params"]
        if source == "custom":
            if not isinstance(params, np.ndarray):
                raise TypeError(f"'custom' meas_params must be an ndarray, got {type(params)}")
            meas = params
        elif source in ("file", "tif", "tiff", "mat", "h5", "hdf5", "npy", "raw"):
            params = dict(params)
            if "path" not in params:
                raise KeyError(f"'path' is required in meas_params for source '{source}'")
            ext = os.path.splitext(params["path"])[1].lower()
            if ext == ".raw" and params.get("shape") is None:
                # ORIGINAL config, not the working copy: crop/resample stages
                # overwrite the working pos_N_scans/meas_Npix, and a staged
                # re-run must still read the file at its on-disk geometry
                params["shape"] = (
                    self.init_params_original["pos_N_scans"],
                    self.init_params_original["meas_Npix"],
                    self.init_params_original["meas_Npix"],
                )
            meas = load_array_from_file(**params)
        else:
            raise ValueError(f"Unsupported meas_source '{source}'; use 'custom' or 'file'")
        return meas.astype("float32", copy=False)

    def _process_meas(self, meas: np.ndarray) -> np.ndarray:
        meas = self._meas_permute(meas, self.init_params.get("meas_permute"))
        meas = self._meas_reshape(meas, self.init_params.get("meas_reshape"))
        meas = self._meas_flipT(meas, self.init_params.get("meas_flipT"))
        self.init_variables["meas_raw_avg"] = meas.mean(0)

        n_scans = self.init_params_original["pos_N_scans"]
        npix = self.init_params_original["meas_Npix"]
        if meas.ndim != 3 or meas.shape[0] != n_scans or meas.shape[1:] != (npix, npix):
            raise ValueError(
                f"Measurement shape mismatch: expected (N_scans={n_scans}, {npix}, {npix}), got "
                f"{meas.shape}. Use meas_permute/meas_reshape to arrange the data as (N, ky, kx)."
            )

        meas = self._meas_crop(meas, self.init_params.get("meas_crop"))
        meas = self._meas_remove_neg(meas, self.init_params.get("meas_remove_neg_values"))
        meas = self._meas_normalize(meas, self.init_params.get("meas_normalization"))
        meas = self._meas_pad(meas, self.init_params.get("meas_pad"))
        meas = self._meas_resample(meas, self.init_params.get("meas_resample"))
        meas = self._meas_add_source_size(meas, self.init_params.get("meas_add_source_size"))
        meas = self._meas_add_detector_blur(meas, self.init_params.get("meas_add_detector_blur"))
        meas = self._meas_add_poisson_noise(meas, self.init_params.get("meas_add_poisson_noise"))
        meas = self._meas_remove_neg(meas, {"mode": "clip_neg"})
        return meas.astype("float32", copy=False)

    def _meas_permute(self, meas, order):
        return meas.transpose(order) if order is not None else meas

    def _meas_reshape(self, meas, shape):
        return meas.reshape(shape) if shape is not None else meas

    def _meas_flipT(self, meas, flipT):
        """[flipud, fliplr, transpose] applied over (ky, kx)."""
        if flipT is None:
            return meas
        if len(flipT) != 3:
            raise ValueError(f"meas_flipT must have 3 entries, got {flipT}")
        f = [int(v) for v in flipT]
        if f[0]:
            meas = np.flip(meas, axis=1)
        if f[1]:
            meas = np.flip(meas, axis=2)
        if f[2]:
            meas = np.transpose(meas, (0, 2, 1))
        return meas

    def _meas_crop(self, meas, crop_ranges):
        """4-axis crop [[slow], [fast], [ky], [kx]]; updates Npix/N_scans."""
        if crop_ranges is None:
            return meas
        if len(crop_ranges) != 4:
            raise ValueError(f"meas_crop expects 4 ranges, got {crop_ranges}")
        # pre-crop counts come from the ORIGINAL params: init_measurements
        # must be re-runnable (staged hypertune re-init), and a prior run
        # already overwrote the working copies with post-crop counts
        nslow = self.init_params_original["pos_N_scan_slow"]
        nfast = self.init_params_original["pos_N_scan_fast"]
        meas = meas.reshape(nslow, nfast, *meas.shape[-2:])
        slices = [slice(*b) if b is not None else slice(None) for b in crop_ranges]
        meas = meas[slices[0], slices[1], slices[2], slices[3]]
        self.init_params["meas_Npix"] = meas.shape[-1]
        self.init_params["pos_N_scans"] = meas.shape[0] * meas.shape[1]
        self.init_params["pos_N_scan_slow"] = meas.shape[0]
        self.init_params["pos_N_scan_fast"] = meas.shape[1]
        return meas.reshape(-1, *meas.shape[-2:])

    # mode tables for the measurement-cleanup stages; modes marked True
    # require an explicit cfg 'value'
    _REMOVE_NEG_MODES = {
        "clip_neg": (False, lambda m, v: np.clip(m, 0, None)),
        "subtract_min": (False, lambda m, v: m - m.min()),
        "clip_value": (True, lambda m, v: np.where(m < v, 0, m)),
        "subtract_value": (True, lambda m, v: m - v),
    }

    _NORMALIZE_MODES = {
        "max_at_one": (False, lambda m, v: m.mean(0).max()),
        "mean_at_one": (False, lambda m, v: m.mean(0).mean()),
        "sum_to_one": (False, lambda m, v: m.mean(0).sum()),
        "divide_const": (True, lambda m, v: v),
    }

    @staticmethod
    def _dispatch(table: dict, mode: str, meas, value, what: str):
        if mode not in table:
            raise ValueError(f"Unsupported {what} mode '{mode}'; use one of {sorted(table)}")
        needs_value, fn = table[mode]
        if needs_value and value is None:
            raise KeyError(f"Mode '{mode}' requires a 'value'")
        return fn(meas, value)

    def _meas_remove_neg(self, meas, cfg):
        cfg = cfg or {}
        if not (meas < 0).any() and not cfg.get("force", False):
            return meas
        meas = self._dispatch(
            self._REMOVE_NEG_MODES, cfg.get("mode", "clip_neg"), meas,
            cfg.get("value"), "remove_neg",
        )
        return np.clip(meas, 0, None)

    def _meas_normalize(self, meas, cfg):
        cfg = cfg or {}
        const = self._dispatch(
            self._NORMALIZE_MODES, cfg.get("mode", "max_at_one"), meas,
            cfg.get("value"), "normalization",
        )
        return (meas / const).astype("float32")

    def _meas_pad(self, meas, cfg):
        """Pad to target_Npix with one of five background types
        (meas_pad_on_the_fly builds the background): 'precompute' pads the
        array here, 'on_the_fly' keeps the background and its window for
        the pad on the device (models/forward.get_measurements)."""
        if cfg is None or cfg.get("mode") is None:
            self.init_variables["on_the_fly_meas_padded"] = None
            self.init_variables["on_the_fly_meas_padded_idx"] = None
            return meas

        mode = cfg["mode"]
        meas_padded, (h1, h2, w1, w2) = meas_pad_on_the_fly(
            meas, cfg["padding_type"], cfg["target_Npix"],
            threshold=cfg.get("threshold", 70), value=cfg.get("value", 10))

        if mode == "precompute":
            canvas = np.broadcast_to(meas_padded, (meas.shape[0], *meas_padded.shape)).copy()
            canvas[..., h1:h2, w1:w2] = meas
            meas = canvas
            self.init_variables["on_the_fly_meas_padded"] = None
            self.init_variables["on_the_fly_meas_padded_idx"] = None
        elif mode == "on_the_fly":
            self.init_variables["on_the_fly_meas_padded"] = meas_padded
            self.init_variables["on_the_fly_meas_padded_idx"] = [h1, h2, w1, w2]
        else:
            raise ValueError(f"meas_pad mode '{mode}' not supported; use 'precompute' or 'on_the_fly'")

        self.init_params["meas_Npix"] = meas_padded.shape[-1]
        return meas

    def _meas_resample(self, meas, cfg):
        """Resample by scale_factors (equalised to the smaller):
        'precompute' zooms the array here, 'on_the_fly' (forced while an
        on-the-fly pad is active) keeps the factors for the device
        (meas_resample_on_the_fly)."""
        if cfg is None or cfg.get("mode") is None:
            self.init_variables["on_the_fly_meas_scale_factors"] = None
            return meas
        mode = cfg["mode"]
        # the base size comes from the DATA of this run (or the on-the-fly
        # pad's template), not the working-copy init_params['meas_Npix']: a
        # previous run's on-the-fly resample already wrote the scaled value
        # there, and a staged re-run must not apply the scale twice
        padded = self.init_variables.get("on_the_fly_meas_padded")
        scale, npix = meas_resample_on_the_fly(meas, cfg["scale_factors"], padded)
        if padded is not None:
            mode = "on_the_fly"

        if mode == "precompute":
            from scipy.ndimage import zoom

            meas = zoom(meas, (1.0, *scale), order=1)
            npix = meas.shape[-1]
            self.init_variables["on_the_fly_meas_scale_factors"] = None
        elif mode == "on_the_fly":
            self.init_variables["on_the_fly_meas_scale_factors"] = scale
        else:
            raise ValueError(f"meas_resample mode '{mode}' not supported")
        self.init_params["meas_Npix"] = npix
        return meas

    def _meas_add_source_size(self, meas, std_ang):
        """Partial spatial coherence: mix DPs of nearby scan positions."""
        if not std_ang:
            return meas
        nslow = self.init_params["pos_N_scan_slow"]
        nfast = self.init_params["pos_N_scan_fast"]
        std_px = std_ang / self.init_params["pos_scan_step_size"]
        meas = meas.reshape(nslow, nfast, *meas.shape[-2:])
        from scipy.ndimage import gaussian_filter

        meas = gaussian_filter(meas, sigma=std_px, axes=(0, 1))
        return meas.reshape(-1, *meas.shape[-2:])

    def _meas_add_detector_blur(self, meas, std_px):
        if not std_px:
            return meas
        from scipy.ndimage import gaussian_filter

        return gaussian_filter(meas, sigma=std_px, axes=(-2, -1))

    def _meas_add_poisson_noise(self, meas, cfg):
        if cfg is None:
            return meas
        unit = cfg["unit"]
        value = cfg["value"]
        step = self.init_params["pos_scan_step_size"]
        if meas.min() < 0:
            if meas.min() / abs(meas.mean() + 1e-12) > -1e-5:
                meas = np.clip(meas, 0, None)
            else:
                raise ValueError(f"Measurements must be non-negative for Poisson noise, min={meas.min():.4g}")
        if unit == "total_e_per_pattern":
            total_e = value
        elif unit == "e_per_Ang2":
            total_e = value * step**2
        else:
            raise ValueError(f"Unsupported Poisson unit '{unit}'; use 'total_e_per_pattern' or 'e_per_Ang2'")
        const = meas.sum() / meas.shape[0]  # each pattern sums ~1
        meas = meas / const
        meas = self.rng.poisson(meas * total_e).astype("float32")
        return meas * const / total_e

    def _export_meas(self, export_params: dict):
        from ptyrad_tpu_torch.save import save_array

        export_params = dict(export_params)
        if not export_params.get("file_dir"):
            meas_path = get_nested(self.init_params, ["meas_params", "path"], safe=True, default="")
            export_params["file_dir"] = os.path.dirname(meas_path) if meas_path else "."
        save_array(self.init_variables["measurements"], **export_params)

    # ------------------------------------------------------------------
    # Calibration
    # ------------------------------------------------------------------

    def init_calibration(self):
        """Derive dx from one of the 8 calibration modes, adjusted for crop
        and pad."""
        calib = self.init_params["meas_calibration"]
        mode = calib["mode"]
        value = calib.get("value")
        npix = self.init_params_original.get("meas_Npix")
        conv_angle = self.init_params.get("probe_conv_angle")
        illum = self.init_params.get("probe_illum_type") or "electron"

        if "meas_raw_avg" not in self.init_variables:
            self.init_measurements()
        meas_raw_avg = self.init_variables["meas_raw_avg"]

        if illum == "electron":
            wavelength = get_em_constants(self.init_params["probe_kv"], "wavelength")
            fit_rbf = guess_radius_of_bright_field_disk(meas_raw_avg, thresh=calib.get("thresh", 0.5))
            self.init_variables["fitRBF"] = fit_rbf
            if self.verbose:
                # sanity fit: prints the fitted center/radius/blur so a user
                # can eyeball the calibration
                fit_cbed_pattern(meas_raw_avg, verbose=self.verbose)
            if mode == "fitRBF":
                dx = infer_dx(RBF=fit_rbf, Npix=npix, wavelength=wavelength, conv_angle=conv_angle)
            else:
                dx = infer_dx(**{mode: value}, Npix=npix, wavelength=wavelength, conv_angle=conv_angle)
        elif illum == "xray":
            if mode in ("RBF", "fitRBF", "n_alpha"):
                raise ValueError(f"Calibration mode '{mode}' unsupported for xray")
            wavelength = xray_wavelength(self.init_params["beam_kev"])
            dx = infer_dx(**{mode: value}, Npix=npix, wavelength=wavelength)
        else:
            raise ValueError(f"probe_illum_type '{illum}' not supported")

        # crop changes Npix -> rescale dx so kMax is preserved
        npix_eff = npix
        crop = self.init_params.get("meas_crop")
        if crop is not None and len(crop) == 4 and crop[-1] is not None and len(crop[-1]) == 2:
            new_npix = crop[-1][1] - crop[-1][0]
            dx = dx * npix_eff / new_npix
            npix_eff = new_npix
        pad = self.init_params.get("meas_pad")
        if pad is not None and pad.get("mode") is not None:
            dx = dx * npix_eff / pad["target_Npix"]

        self.init_params["probe_dx"] = dx
        vprint(f"dx set to {dx:.4f} (calibration mode '{mode}')", verbose=self.verbose)

    def set_variables_dict(self):
        """Derived quantities after measurement processing."""
        illum = self.init_params.get("probe_illum_type") or "electron"
        npix = self.init_params["meas_Npix"]
        n_slow = self.init_params["pos_N_scan_slow"]
        n_fast = self.init_params["pos_N_scan_fast"]
        dx = self.init_params["probe_dx"]
        dk = 1.0 / (dx * npix)

        self.init_variables.update({
            "probe_illum_type": illum,
            "Npix": npix,
            "probe_shape": np.array([npix, npix], dtype=float),
            "N_scan_slow": n_slow,
            "N_scan_fast": n_fast,
            "N_scans": n_slow * n_fast,
            "scan_step_size": self.init_params["pos_scan_step_size"],
            "dx": dx,
            "dk": dk,
            "slice_thickness": self.init_params["obj_slice_thickness"],
        })

    # ------------------------------------------------------------------
    # Probe
    # ------------------------------------------------------------------

    def init_probe(self):
        probe = self._load_probe()
        probe = self._probe_permute(probe, self.init_params.get("probe_permute"))
        probe = self._probe_normalize(probe)
        probe = probe[: self.init_params["probe_pmode_max"]]
        self.init_variables["probe"] = probe
        vprint(f"probe (pmode, Ny, Nx) = {probe.dtype}, {probe.shape}", verbose=self.verbose)

    def _load_probe(self) -> np.ndarray:
        source = self.init_params["probe_source"]
        params = self.init_params["probe_params"]
        illum = self.init_variables["probe_illum_type"]

        if source == "custom":
            probe = np.asarray(params)
        elif source == "PtyRAD":
            ckpt = self.cache_contents if self.use_cached_probe else load_ptyrad(params)
            probe = np.asarray(ckpt["optimizable_tensors"]["probe"])
        elif source == "PtyShv":
            probe = self._load_probe_ptyshv(params)
        elif source == "py4DSTEM":
            contents = self.cache_contents if self.use_cached_probe else load_hdf5(params, key="probe")
            probe = contents["probe"] if isinstance(contents, dict) else contents
            if probe.ndim == 2:
                probe = probe[None]
        elif source == "simu":
            probe = self._simulate_probe(params, illum)
        else:
            raise ValueError(
                f"Unsupported probe_source '{source}'; use 'custom', 'PtyRAD', 'PtyShv', 'py4DSTEM', or 'simu'"
            )
        return probe

    @staticmethod
    def _mat_needs_h5py(mat_path: str) -> bool:
        """v7.3 .mat files are HDF5 (h5py path, axes come back REVERSED);
        an unsniffable header is treated as v7.3, matching load_mat's own
        fallback. Shared by all three PtyShv loaders."""
        from scipy.io.matlab import matfile_version

        try:
            return matfile_version(mat_path)[0] == 2
        except ValueError:
            return True

    def _load_probe_ptyshv(self, mat_path: str) -> np.ndarray:
        use_h5py = self._mat_needs_h5py(mat_path)
        probe = self.cache_contents["probe"] if self.use_cached_probe else load_mat(mat_path, key="probe")
        # unify axes: PtyShv stores (Ny, Nx, pmode[, vp]); h5py reverses order
        if use_h5py:
            probe = probe.transpose(range(probe.ndim)[::-1])
        if probe.ndim == 4:
            probe = probe[..., 0]  # keep only the 1st variable-probe mode
        elif probe.ndim == 2:
            probe = probe[..., None]
        return probe.transpose(2, 0, 1)

    def _simulate_probe(self, simu_params: Optional[dict], illum: str) -> np.ndarray:
        if simu_params is None:
            simu_params = default_probe_simu_params(self.init_params)
        if illum == "electron":
            probe = make_stem_probe(simu_params, verbose=self.verbose)[None]
        elif illum == "xray":
            probe = make_fzp_probe(simu_params, verbose=self.verbose)[None]
        else:
            raise ValueError(f"Unsupported illumination '{illum}'")
        if simu_params["pmodes"] > 1:
            probe = make_mixed_probe(
                probe[0], simu_params["pmodes"], simu_params["pmode_init_pows"], verbose=self.verbose
            )
        return probe

    def _probe_permute(self, probe, order):
        return probe.transpose(order) if order is not None else probe

    def _probe_normalize(self, probe):
        """Scale so total probe intensity equals the average measurement
        sum."""
        if "meas_avg_sum" not in self.init_variables:
            self.init_measurements()
        meas_avg_sum = self.init_variables["meas_avg_sum"]
        factor = (np.sum(np.abs(probe) ** 2) / meas_avg_sum) ** 0.5
        return (probe / factor).astype("complex64")

    # ------------------------------------------------------------------
    # Positions
    # ------------------------------------------------------------------

    def init_pos(self):
        pos = self._load_pos()
        pos = self._pos_scan_flipT(pos, self.init_params.get("pos_scan_flipT"))
        pos = self._pos_affine(pos, self.init_params.get("pos_scan_affine"))
        pos = self._pos_jitter(pos, self.init_params.get("pos_scan_rand_std"))

        probe_shape = self.init_variables["probe_shape"]
        obj_lateral_extent = (1.2 * np.ceil(pos.max(0) - pos.min(0) + probe_shape)).astype(int)
        crop_pos = np.round(pos).astype("int32")
        probe_pos_shifts = (pos - crop_pos).astype("float32")

        self.init_variables["obj_lateral_extent"] = obj_lateral_extent
        self.init_variables["crop_pos"] = crop_pos
        self.init_variables["probe_pos_shifts"] = probe_pos_shifts
        self.init_variables["scan_affine"] = self.init_params.get("pos_scan_affine")
        vprint(f"crop_pos (N,2) = {crop_pos.dtype}, {crop_pos.shape}", verbose=self.verbose)

    def _load_pos(self) -> np.ndarray:
        source = self.init_params["pos_source"]
        params = self.init_params["pos_params"]
        if source == "custom":
            return np.asarray(params, dtype=float)
        if source == "PtyRAD":
            ckpt = self.cache_contents if self.use_cached_pos else load_ptyrad(params)
            return np.asarray(ckpt["model_attributes"]["crop_pos"]) + np.asarray(
                ckpt["optimizable_tensors"]["probe_pos_shifts"]
            )
        if source == "PtyShv":
            return self._load_pos_ptyshv(params)
        if source == "py4DSTEM":
            # targeted read: a full py4DSTEM results file also holds the
            # reconstruction stack (GBs); only two small arrays are needed
            contents = (
                self.cache_contents if self.use_cached_pos
                else load_hdf5(params, key=["positions_px", "probe"])
            )
            positions = np.asarray(contents["positions_px"])
            probe_shape = np.asarray(contents["probe"]).shape[-2:]
            return positions - np.array(probe_shape) / 2
        if source == "simu":
            return self._simulate_pos(params)
        if source == "foldslice_hdf5":
            return self._load_pos_foldslice(params)
        raise ValueError(
            f"Unsupported pos_source '{source}'; use 'custom', 'PtyRAD', 'PtyShv', 'py4DSTEM', 'simu', or 'foldslice_hdf5'"
        )

    def _load_pos_ptyshv(self, mat_path: str) -> np.ndarray:
        use_h5py = self._mat_needs_h5py(mat_path)
        contents = (
            self.cache_contents
            if self.use_cached_pos
            else load_mat(mat_path, key=["object", "probe", "outputs.probe_positions"], delimiter=".")
        )
        if use_h5py:
            contents = {k: np.asarray(v).transpose(range(np.asarray(v).ndim)[::-1]) for k, v in contents.items()}
        positions = np.asarray(contents["outputs.probe_positions"])
        probe_shape = np.asarray(contents["probe"]).shape[:2]
        obj_shape = np.asarray(contents["object"]).shape[:2]
        offset = np.ceil(np.array(obj_shape) / 2 - np.array(probe_shape) / 2) - 1  # Matlab 1-index shift
        return positions[:, [1, 0]] + offset

    def _load_pos_foldslice(self, hdf5_path: str) -> np.ndarray:
        dx = self.init_variables["dx"]
        probe_shape = self.init_variables["probe_shape"]
        ppY = load_hdf5(hdf5_path, key="ppY")
        ppX = load_hdf5(hdf5_path, key="ppX")
        pos = np.stack((-np.asarray(ppY), -np.asarray(ppX)), axis=1) / dx
        pos = np.flipud(pos)
        obj_shape = 1.2 * np.ceil(pos.max(0) - pos.min(0) + probe_shape)
        return pos + np.ceil(obj_shape / 2 - np.array(probe_shape) / 2)

    def _simulate_pos(self, simu_params: Optional[dict]) -> np.ndarray:
        simu_params = simu_params or {}
        dx = simu_params.get("dx", self.init_variables["dx"])
        step = simu_params.get("scan_step_size", self.init_variables["scan_step_size"])
        n_slow = simu_params.get("N_scan_slow", self.init_variables["N_scan_slow"])
        n_fast = simu_params.get("N_scan_fast", self.init_variables["N_scan_fast"])
        probe_shape = simu_params.get("probe_shape", self.init_variables["probe_shape"])

        ys, xs = np.meshgrid(np.arange(n_slow), np.arange(n_fast), indexing="ij")
        pos = step / dx * np.stack([ys.ravel(), xs.ravel()], axis=1).astype(float)
        pos = pos - pos.mean(0)
        obj_shape = 1.2 * np.ceil(pos.max(0) - pos.min(0) + probe_shape)
        return pos + np.ceil(obj_shape / 2 - np.array(probe_shape) / 2)

    def _pos_scan_flipT(self, pos, flipT):
        if flipT is None:
            return pos
        if len(flipT) != 3:
            raise ValueError(f"pos_scan_flipT must have 3 entries, got {flipT}")
        axes = np.nonzero([int(v) for v in flipT])[0]
        if len(axes) > 0:
            pos = pos.reshape(self.init_variables["N_scan_slow"], self.init_variables["N_scan_fast"], 2)
            pos = np.flip(pos, axes).reshape(-1, 2)
        return pos

    def _pos_affine(self, pos, scan_affine):
        """Center, apply scale/asymmetry/rotation/shear, re-center on canvas."""
        if scan_affine is None:
            return pos
        scale, asym, rot, shear = scan_affine
        pos = pos - pos.mean(0)
        pos = pos @ compose_affine_matrix(scale, asym, rot, shear)
        probe_shape = self.init_variables["probe_shape"]
        obj_shape = 1.2 * np.ceil(pos.max(0) - pos.min(0) + probe_shape)
        return pos + np.ceil(obj_shape / 2 - np.array(probe_shape) / 2)

    def _pos_jitter(self, pos, std):
        """Random jitter breaks the raster-grid pathology (periodic artifacts)."""
        if std is None:
            return pos
        return pos + std * self.rng.randn(*pos.shape)

    # ------------------------------------------------------------------
    # Object
    # ------------------------------------------------------------------

    def init_obj(self):
        obj = self._load_obj()
        obj = obj[: self.init_params["obj_omode_max"]].astype("complex64")
        self.init_variables["obj"] = obj
        vprint(f"object (omode, Nz, Ny, Nx) = {obj.dtype}, {obj.shape}", verbose=self.verbose)

    def _load_obj(self) -> np.ndarray:
        source = self.init_params["obj_source"]
        params = self.init_params["obj_params"]
        if source == "custom":
            return np.asarray(params)
        if source == "PtyRAD":
            ckpt = self.cache_contents if self.use_cached_obj else load_ptyrad(params)
            obja = np.asarray(ckpt["optimizable_tensors"]["obja"])
            objp = np.asarray(ckpt["optimizable_tensors"]["objp"])
            return obja * np.exp(1j * objp)
        if source == "PtyShv":
            return self._load_obj_ptyshv(params)
        if source == "py4DSTEM":
            contents = self.cache_contents if self.use_cached_obj else load_hdf5(params, key="object")
            obj = np.asarray(contents["object"] if isinstance(contents, dict) else contents)
            if obj.ndim == 2:
                obj = obj[None, None]
            elif obj.ndim == 3:
                obj = obj[None]
            return obj
        if source == "simu":
            return self._simulate_obj(params)
        raise ValueError(
            f"Unsupported obj_source '{source}'; use 'custom', 'PtyRAD', 'PtyShv', 'py4DSTEM', or 'simu'"
        )

    def _load_obj_ptyshv(self, mat_path: str) -> np.ndarray:
        use_h5py = self._mat_needs_h5py(mat_path)
        obj = self.cache_contents["object"] if self.use_cached_obj else load_mat(mat_path, key="object")
        obj = np.asarray(obj)
        if use_h5py:
            obj = obj.transpose(range(obj.ndim)[::-1])
        # PtyShv layout (Ny, Nx[, Nz]) -> (omode, Nz, Ny, Nx)
        if obj.ndim == 2:
            obj = obj[None, None]
        elif obj.ndim == 3:
            obj = obj[None].transpose(0, 3, 1, 2)
        return obj

    def _simulate_obj(self, simu_params) -> np.ndarray:
        """Near-unity random-phase object exp(i*1e-8*rand)."""
        if simu_params is not None:
            obj_shape = tuple(simu_params)
            if len(obj_shape) != 4:
                raise ValueError(f"obj_params shape must be 4D (omode, Nz, Ny, Nx); got {obj_shape}")
        else:
            omode = self.init_params["obj_omode_max"]
            nz = self.init_params["obj_Nlayer"]
            if "obj_lateral_extent" not in self.init_variables:
                self.init_pos()
            ny, nx = self.init_variables["obj_lateral_extent"]
            obj_shape = (omode, nz, int(ny), int(nx))
        return np.exp(1j * 1e-8 * self.rng.rand(*obj_shape))

    # ------------------------------------------------------------------
    # omode occupancy, propagator, tilts
    # ------------------------------------------------------------------

    def init_omode_occu(self):
        """Fixed (non-optimizable) object-mode occupancy."""
        cfg = self.init_params.get("obj_omode_init_occu") or {}
        occu_type = cfg.get("occu_type", "uniform")
        if occu_type == "custom":
            occu = np.asarray(cfg["init_occu"], dtype="float32")
        elif occu_type == "uniform":
            omode = self.init_params["obj_omode_max"]
            occu = (np.ones(omode) / omode).astype("float32")
        else:
            raise ValueError(f"occu_type '{occu_type}' not supported; use 'uniform' or 'custom'")
        self.init_variables["omode_occu"] = occu

    def init_H(self):
        probe_shape = self.init_variables["probe_shape"]
        dx = self.init_variables["dx"]
        dz = self.init_variables["slice_thickness"]
        illum = self.init_variables["probe_illum_type"]
        if illum == "electron":
            lambd = get_em_constants(self.init_params["probe_kv"], "wavelength")
        elif illum == "xray":
            lambd = xray_wavelength(self.init_params["beam_kev"])
        else:
            raise ValueError(f"probe_illum_type '{illum}' not supported")
        shape = tuple(int(v) for v in probe_shape)
        self.init_variables["lambd"] = lambd
        self.init_variables["H"] = near_field_evolution(shape, dx, dz, lambd).astype("complex64")

    def init_obj_tilts(self):
        source = self.init_params.get("tilt_source", "simu")
        params = self.init_params.get("tilt_params", {})
        if source == "custom":
            tilts = np.asarray(params, dtype="float32").reshape(-1, 2)
        elif source == "file":
            tilts = np.float32(load_array_from_file(**params, ndims=[2]))
        elif source == "PtyRAD":
            ckpt = (
                self.cache_contents
                if params == getattr(self, "cache_path", None)
                else load_ptyrad(params)
            )
            tilts = np.float32(ckpt["optimizable_tensors"]["obj_tilts"])
        elif source == "simu":
            n_scans = self.init_variables["N_scans"]
            tilt_type = (params or {}).get("tilt_type") or "all"
            init_tilts = (params or {}).get("init_tilts") or [[0, 0]]
            if tilt_type == "each":
                tilts = np.broadcast_to(np.float32(init_tilts), (n_scans, 2)).copy()
            elif tilt_type == "all":
                tilts = np.broadcast_to(np.float32(init_tilts), (1, 2)).copy()
            else:
                raise ValueError(f"tilt_type '{tilt_type}' not supported; use 'each' or 'all'")
        else:
            raise ValueError(
                f"Unsupported tilt_source '{source}'; use 'custom', 'file', 'PtyRAD', or 'simu'"
            )
        self.init_variables["obj_tilts"] = tilts

    # ------------------------------------------------------------------
    # Consistency check
    # ------------------------------------------------------------------

    def init_check(self):
        """Fail-fast cross-consistency checks."""
        p = self.init_params
        v = self.init_variables
        npix = p["meas_Npix"]
        meas, probe, H = v["measurements"], v["probe"], v["H"]
        crop_pos, shifts, obj = v["crop_pos"], v["probe_pos_shifts"], v["obj"]
        target_npix = (
            v["on_the_fly_meas_padded"].shape[-1]
            if v.get("on_the_fly_meas_padded") is not None
            else meas.shape[-1]
        )
        scale = v.get("on_the_fly_meas_scale_factors") or [1, 1]

        shapes_ok = (
            npix == meas.shape[-2] == meas.shape[-1]
            or npix == target_npix
            or npix == floor(meas.shape[-1] * scale[-1])
            or npix == floor(target_npix * scale[-1])
        ) and (
            # probe/H must be square at Npix on BOTH trailing axes: a
            # mis-permuted probe (e.g. (1, 130, 128)) is caught here
            npix == probe.shape[-2] == probe.shape[-1] == H.shape[-2] == H.shape[-1]
        )
        if not shapes_ok:
            raise ValueError(
                f"Inconsistent shapes: Npix={npix}, meas={meas.shape[-2:]}, "
                f"probe={probe.shape[-2:]}, H={H.shape[-2:]}"
            )

        n_scans = p["pos_N_scans"]
        if not (n_scans == len(meas) == p["pos_N_scan_slow"] * p["pos_N_scan_fast"] == len(crop_pos) == len(shifts)):
            raise ValueError(
                f"Inconsistent scan counts: N_scans={n_scans}, len(meas)={len(meas)}, "
                f"slow*fast={p['pos_N_scan_slow'] * p['pos_N_scan_fast']}, "
                f"len(crop_pos)={len(crop_pos)}, len(shifts)={len(shifts)}"
            )
        if obj.shape[0] != len(v["omode_occu"]):
            raise ValueError(f"obj omode {obj.shape[0]} != len(omode_occu) {len(v['omode_occu'])}")
        if obj.shape[1] != p["obj_Nlayer"]:
            raise ValueError(f"obj Nz {obj.shape[1]} != obj_Nlayer {p['obj_Nlayer']}")
        if (crop_pos.min(0) < 0).any():
            raise ValueError(f"crop_pos.min(0)={crop_pos.min(0)} must be >= 0")
        if (crop_pos.max(0) + npix - np.array(obj.shape[-2:]) > 0).any():
            raise ValueError(
                f"crop_pos.max(0)+Npix = {crop_pos.max(0) + npix} exceeds object canvas {obj.shape[-2:]}"
            )
        if len(v["obj_tilts"]) not in (1, n_scans):
            raise ValueError(f"len(obj_tilts)={len(v['obj_tilts'])} must be 1 or N_scans={n_scans}")
        vprint("Initialization consistency check passed", verbose=self.verbose)

    def init_all(self):
        self.init_cache()
        self.init_measurements()
        self.init_calibration()
        self.set_variables_dict()
        self.init_probe()
        self.init_pos()
        self.init_obj()
        self.init_omode_occu()
        self.init_H()
        self.init_obj_tilts()
        self.init_check()
        return self
