"""Savers: arrays, checkpoints, self-describing output folders, result images.

The port's own copy of ptyrad_tpu/save.py. The checkpoint (model.hdf5) has
PtyRAD's layout, so either package, and upstream PtyRAD, resumes from the
other's: the recursive dict-to-HDF5 writer with the "__NONE__" sentinel,
the optimizable tensors (the probe complex), the optimizer state
(``optim.optim_state_values``: Adam's in upstream's torch layout, every
other optimizer's in the JAX package's keystr layout), the params, the model
attributes and the histories. Output folders are named from the
configuration with the minimal/default/all affix presets, and save_results
writes the object and probe images at every reduction, bit depth and field
of view the params ask for. h5py and PIL are imported by the functions that
write with them.
"""

from __future__ import annotations

import os
import shutil
import time
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ptyrad_tpu_torch.optim import bf16_bits
from ptyrad_tpu_torch.parallel.mesh import is_main_process
from ptyrad_tpu_torch.utils.common import safe_filename
from ptyrad_tpu_torch.utils.logging import vprint
from ptyrad_tpu_torch.utils.nested import NONE_SENTINEL

# ---------------------------------------------------------------------------
# Primitive writers
# ---------------------------------------------------------------------------


def normalize_from_zero_to_one(arr: np.ndarray) -> np.ndarray:
    lo, hi = arr.min(), arr.max()
    return (arr - lo) / (hi - lo) if hi > lo else np.zeros_like(arr)


def normalize_by_bit_depth(arr: np.ndarray, bit: str) -> np.ndarray:
    """'8'/'16' -> normalized uint; '32' -> normalized float32; 'raw' -> float32."""
    arr = np.asarray(arr)
    if bit == "8":
        return np.uint8(255 * normalize_from_zero_to_one(arr))
    if bit == "16":
        return np.uint16(65535 * normalize_from_zero_to_one(arr))
    if bit == "32":
        return np.float32(normalize_from_zero_to_one(arr))
    return np.float32(arr)


def imwrite_tif(file_path: str, data: np.ndarray) -> None:
    """Write a 2D array, or a stack of them, as TIFF through PIL."""
    from PIL import Image

    file_path = safe_filename(file_path)
    data = np.asarray(data)
    if data.ndim > 3:
        data = data.reshape(-1, *data.shape[-2:])
    if data.ndim == 2:
        Image.fromarray(data).save(file_path)
    else:
        frames = [Image.fromarray(frame) for frame in data]
        frames[0].save(file_path, save_all=True, append_images=frames[1:])


def save_array(data, file_dir: str = "", file_name: str = "ptyrad_init_meas",
               file_format: str = "hdf5", output_shape=None, append_shape: bool = True,
               **kwargs) -> str:
    """Write an array as .tif, .npy or .hdf5 ('mat' is HDF5 under a .mat
    name, dataset 'meas', gzip), reshaped to ``output_shape`` first when it
    fits; returns the path."""
    data = np.asarray(data)
    if output_shape is not None:
        try:
            data = data.reshape(output_shape)
        except ValueError as e:
            vprint(f"WARNING: {e}, the data shape is preserved as {data.shape}")
    shape_str = "_" + "_".join(str(s) for s in data.shape) if append_shape else ""
    if file_dir:
        os.makedirs(file_dir, exist_ok=True)
    file_format = file_format.lower()
    path = safe_filename(os.path.join(file_dir, f"{file_name}{shape_str}.{file_format}"))
    if file_format in ("tif", "tiff"):
        imwrite_tif(path, data)
    elif file_format == "npy":
        np.save(path, data)
    elif file_format in ("hdf5", "h5", "mat"):
        h5py = import_h5py(f"writing '{path}'")
        with h5py.File(path, "w") as hf:
            hf.create_dataset("meas", data=data, compression="gzip", **kwargs)
    else:
        raise ValueError(
            f"Unsupported file_format '{file_format}'; use 'tif', 'npy', 'hdf5', 'h5', or 'mat'")
    vprint(f"Saved array with shape {data.shape} to '{path}'")
    return path


def import_h5py(what: str):
    """h5py, or an ImportError that says what needed it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{what} (HDF5) needs the h5py package, which is not installed "
                          f"({e})") from e
    return h5py


# ---------------------------------------------------------------------------
# Checkpoint serialization
# ---------------------------------------------------------------------------

def _to_numpy(value):
    """A tensor as a NumPy copy on the host (a complex one stays complex), a
    NumPy scalar as a 0-d array (so that a list holding one is written as
    the JAX package writes it), a bfloat16 one as its bits (the opaque
    2-byte dataset the JAX package writes for it); anything else as it is."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            return bf16_bits(value)
        return value.numpy().copy() if value.device.type == "cpu" else value.cpu().numpy()
    if isinstance(value, np.generic):
        return np.asarray(value)
    return value


def save_dict_to_hdf5(d: Dict[str, Any], output_path: str, **kwargs) -> None:
    """Recursively write a nested dict to HDF5.

    None -> the "__NONE__" sentinel; integer keys -> strings; lists of
    numbers, strings, equal-length lists or arrays -> datasets; lists of
    dicts -> groups '0', '1', ...; anything else -> str().
    """
    h5py = import_h5py(f"writing '{output_path}'")
    output_path = safe_filename(output_path)

    def _write(group, d):
        for key, value in d.items():
            key = str(key)
            value = _to_numpy(value)
            if value is None:
                group.create_dataset(key, data=NONE_SENTINEL)
            elif isinstance(value, dict):
                _write(group.create_group(key), value)
            elif isinstance(value, (list, tuple)):
                vals = [_to_numpy(v) for v in value]
                if all(isinstance(v, (int, float, np.number, bool)) for v in vals):
                    group.create_dataset(key, data=np.asarray(vals), **kwargs)
                elif all(isinstance(v, str) for v in vals):
                    group.create_dataset(key, data=np.array(vals, dtype=h5py.special_dtype(vlen=str)))
                elif all(isinstance(v, (list, tuple)) for v in vals):
                    try:
                        group.create_dataset(key, data=np.asarray([list(v) for v in vals]), **kwargs)
                    except (ValueError, TypeError):
                        group.create_dataset(key, data=str(value))
                elif all(isinstance(v, dict) for v in vals):
                    sub = group.create_group(key)
                    for i, item in enumerate(vals):
                        _write(sub.create_group(str(i)), item)
                elif all(isinstance(v, np.ndarray) for v in vals):
                    try:
                        group.create_dataset(key, data=np.stack(vals), **kwargs)
                    except (ValueError, TypeError):
                        group.create_dataset(key, data=str(value))
                else:
                    group.create_dataset(key, data=str(value))
            elif isinstance(value, (int, float, str, bool, np.number)):
                group.create_dataset(key, data=value)
            elif isinstance(value, np.ndarray):
                group.create_dataset(key, data=value, **kwargs)
            else:
                group.create_dataset(key, data=str(value))

    with h5py.File(output_path, "w") as hf:
        _write(hf, d)


def make_save_dict(output_path: str, params, buffers, geom, params_dict: dict, optimizer,
                   history, niter: int, indices, lr_dict=None, start_dict=None) -> Dict[str, Any]:
    """The checkpoint dict (PtyRAD's model.hdf5 layout): version, the
    optimizable tensors (the probe complex), the optimizer state when
    save_result holds 'optim_state' (``optimizer`` the optimizer, or its
    optim_state_values as the canvas path gathers them on every rank), the
    params dict, the model attributes and the loss, time and dz histories. Every tensor is copied to the host
    once; nothing on the device is kept or changed."""
    from ptyrad_tpu_torch import __version__

    t = {name: _to_numpy(tensor) for name, tensor in params.named()}
    last_terms = dict(history.term_iters[-1]) if history.term_iters else {}
    save_optim = "optim_state" in (params_dict.get("recon_params", {}).get("save_result") or [])
    optim_state_dict = None
    if save_optim and isinstance(optimizer, dict):
        optim_state_dict = optimizer  # already gathered (the canvas path)
    elif save_optim and optimizer is not None:
        from ptyrad_tpu_torch.optim import optim_state_values

        optim_state_dict = optim_state_values(optimizer)

    return {
        "ptyrad_version": f"ptyrad_tpu_torch-{__version__}",
        "output_path": output_path,
        "optimizable_tensors": {
            "obja": t["obja"], "objp": t["objp"], "obj_tilts": t["obj_tilts"],
            "slice_thickness": t["slice_thickness"], "probe": t["probe"],
            "probe_pos_shifts": t["probe_pos_shifts"],
        },
        "optim_state_dict": optim_state_dict,
        "params": params_dict,
        "model_attributes": {
            "detector_blur_std": geom.detector_blur_std,
            "obj_preblur_std": geom.obj_preblur_std,
            "start_iter": start_dict,
            "lr_params": lr_dict,
            "omode_occu": _to_numpy(buffers.omode_occu),
            "H": _to_numpy(buffers.H),
            "N_scan_slow": geom.n_scan_slow,
            "N_scan_fast": geom.n_scan_fast,
            "crop_pos": _to_numpy(buffers.crop_pos),
            "slice_thickness": float(t["slice_thickness"]),
            "dx": geom.dx,
            "dk": geom.dk,
            "scan_affine": geom.scan_affine,
            "tilt_obj": geom.tilt_obj,
            "shift_probes": geom.shift_probes,
            "probe_int_sum": float(buffers.probe_int_sum),
        },
        "loss_iters": [[n, v] for n, v in history.loss_iters],
        "iter_times": history.iter_times,
        "dz_iters": [[n, v] for n, v in history.dz_iters],
        "avg_iter_t": float(np.mean(history.iter_times)) if history.iter_times else 0.0,
        "niter": niter,
        "indices": np.asarray(indices),
        # the last iteration's per-batch values of each term
        "batch_losses": ({k: list(v) for k, v in history.batch_terms.items()}
                         if history.batch_terms else {k: [v] for k, v in last_terms.items()}),
        "avg_losses": last_terms,
    }


# ---------------------------------------------------------------------------
# Output folder naming
# ---------------------------------------------------------------------------

_DIR_PRESETS = {
    "minimal": ["indices", "meas", "batch", "pmode", "omode", "nlayer"],
    "default": ["indices", "meas", "batch", "pmode", "omode", "nlayer",
                "lr", "model", "constraint", "loss", "affine", "tilt"],
    "all": ["indices", "meas", "batch", "pmode", "omode", "nlayer",
            "optimizer", "start_iter", "lr", "model", "constraint",
            "loss", "illumination", "dx", "affine", "tilt"],
}


def _fmt_lr(v: float) -> str:
    return f"{v:.0e}".replace("e-0", "e-").replace("e+0", "e")


def make_output_folder(output_dir: str, indices, params_dict: dict, params, geom,
                       recon_dir_affixes: Optional[List[str]] = None,
                       make_dir: bool = True) -> str:
    """The run's output folder: ``output_dir``/<name>, the name composed from
    the configuration by the affixes (presets minimal, default, all, or
    single affixes), with the optional time prefix, prefix and postfix."""
    init_params = params_dict.get("init_params", {})
    recon_params = params_dict.get("recon_params", {})
    model_params = params_dict.get("model_params", {})
    constraint_params = params_dict.get("constraint_params", {}) or {}
    loss_params = params_dict.get("loss_params", {}) or {}

    affixes = list(recon_dir_affixes or recon_params.get("recon_dir_affixes") or ["default"])
    expanded: List[str] = []
    for tag in affixes:
        expanded.extend(_DIR_PRESETS.get(tag, [tag]))
    affixes = expanded

    parts: List[str] = []
    prefix_time = recon_params.get("prefix_time", False)
    if prefix_time:
        named = {"date": "%Y%m%d", "time": "%H%M%S", "datetime": "%Y%m%d_%H%M%S", True: "%Y%m%d"}
        fmt = named.get(prefix_time, prefix_time if isinstance(prefix_time, str) else "%Y%m%d")
        parts.append(datetime.now().strftime(fmt))
    if recon_params.get("prefix"):
        parts.append(recon_params["prefix"])

    if "indices" in affixes:
        mode = (recon_params.get("INDICES_MODE") or {}).get("mode", "full")
        parts.append(f"{mode}_N{len(indices)}")
    if "meas" in affixes:
        parts.append(f"dp{geom.probe_shape[-1]}")
        flipT = init_params.get("meas_flipT")
        if flipT is not None:
            parts.append("flipT" + "".join(str(int(x)) for x in flipT))
    if "batch" in affixes:
        group_mode = recon_params.get("GROUP_MODE", "random")
        bs = (recon_params.get("BATCH_SIZE") or {}).get("size", 32)
        bs *= (recon_params.get("BATCH_SIZE") or {}).get("grad_accumulation", 1)
        parts.append(f"{group_mode}{bs}")
    if "pmode" in affixes:
        parts.append(f"p{params.probe.shape[0]}")
    if "omode" in affixes:
        parts.append(f"{params.obja.shape[0]}obj")
    if "nlayer" in affixes:
        nz = params.obja.shape[1]
        dz = float(params.slice_thickness)
        parts.append(f"{nz}slice" + (f"_dz{dz:g}" if nz > 1 else ""))
    if "optimizer" in affixes:
        parts.append((model_params.get("optimizer_params") or {}).get("name", "Adam"))
    update = model_params.get("update_params", {}) or {}
    if "start_iter" in affixes:
        # delayed starts only: None and a start at 1 add nothing
        si_map = {"probe": "ps", "obja": "oas", "objp": "ops", "probe_pos_shifts": "ss",
                  "obj_tilts": "ts", "slice_thickness": "dzs"}
        for key, tag in si_map.items():
            si = (update.get(key) or {}).get("start_iter")
            if si is not None and si > 1:
                parts.append(f"{tag}{si}")
    if "lr" in affixes:
        lr_map = {"probe": "plr", "obja": "oalr", "objp": "oplr", "probe_pos_shifts": "slr",
                  "obj_tilts": "tlr", "slice_thickness": "dzlr"}
        for key, tag in lr_map.items():
            lr_val = (update.get(key) or {}).get("lr", 0)
            if lr_val:
                parts.append(f"{tag}{_fmt_lr(lr_val)}")
    if "model" in affixes:
        if geom.obj_preblur_std:
            parts.append(f"preblur{geom.obj_preblur_std:g}")
        if geom.detector_blur_std:
            parts.append(f"dblur{geom.detector_blur_std:g}")
    if "constraint" in affixes:
        tags = {
            "ortho_pmode": "ortho", "probe_mask_k": "maskk", "fix_probe_int": "fixint",
            "obj_rblur": "rblur", "obj_zblur": "zblur", "kr_filter": "kr",
            "kz_filter": "kz", "complex_ratio": "cratio", "mirrored_amp": "mamp",
            "obja_thresh": "athr", "objp_postiv": "postiv", "tilt_smooth": "tsm",
        }
        active = [tag for name, tag in tags.items()
                  if (constraint_params.get(name) or {}).get("freq") is not None]
        if active:
            parts.append("+".join(active))
    if "loss" in affixes:
        active = [name.replace("loss_", "") for name, cfg in loss_params.items()
                  if isinstance(cfg, dict) and cfg.get("state")]
        if active:
            parts.append("L-" + "+".join(active))
    if "illumination" in affixes:
        parts.append(init_params.get("probe_illum_type") or "electron")
    if "dx" in affixes:
        parts.append(f"dx{geom.dx:.4f}")
    if "affine" in affixes and geom.scan_affine is not None:
        parts.append("affine" + "_".join(f"{v:g}" for v in geom.scan_affine))
    if "tilt" in affixes:
        tilts = _to_numpy(params.obj_tilts)
        if np.any(tilts):
            parts.append(f"tilt{tilts[:, 0].mean():.1f}_{tilts[:, 1].mean():.1f}")
    if recon_params.get("postfix"):
        parts.append(recon_params["postfix"])

    folder = "_".join(str(p) for p in parts if p != "")
    path = os.path.join(output_dir, folder)
    if make_dir:
        os.makedirs(path, exist_ok=True)
    return path


def copy_params_to_dir(params_path: Optional[str], output_dir: str) -> None:
    """Copy the params file into the output folder (provenance)."""
    if not params_path or not os.path.isfile(params_path):
        return
    os.makedirs(output_dir, exist_ok=True)
    shutil.copy2(params_path, os.path.join(output_dir, os.path.basename(params_path)))


# ---------------------------------------------------------------------------
# Result saving
# ---------------------------------------------------------------------------

_RESULT_MODE_KEYS = ("obj_dim", "FOV", "bit")


def _default_result_modes() -> dict:
    """The schema's ResultModes defaults, for a params dict that skipped
    validation (needs pydantic)."""
    from ptyrad_tpu_torch.params.schema import ResultModes

    return ResultModes().model_dump()


def save_results(output_path: str, params, buffers, geom, params_dict: dict, optimizer,
                 history, niter: int, indices, lr_dict=None, start_dict=None,
                 collate_str: str = "") -> None:
    """Write model.hdf5 and the object and probe TIFFs of iteration
    ``niter`` at the configured reductions, bit depths and fields of view,
    then print the seconds it took.

    Object reductions by (omode, Nz): zsum/zstack (multislice), omean/ostd
    (mixed-state), 4D and the combined reductions; the amplitude takes
    zmean/zprod where the phase takes zsum.
    """
    if not is_main_process():
        return  # only rank 0 writes (ptyrad_tpu/save.py:446-447)
    t0 = time.perf_counter()
    recon_params = params_dict.get("recon_params", {})
    save_list = recon_params.get("save_result") or ["model", "obj", "probe"]
    modes = dict(recon_params.get("result_modes") or {})
    if any(k not in modes for k in _RESULT_MODE_KEYS):
        modes = {**_default_result_modes(), **modes}
    iter_str = "_iter" + str(niter).zfill(4)

    prop_amp = None
    if "probe_prop" in save_list:
        from ptyrad_tpu_torch.models.forward import propagated_probe

        index = torch.as_tensor(np.asarray(indices)[:1], device=params.probe.device)
        with torch.no_grad():
            pp = _to_numpy(propagated_probe(params, buffers, geom, index))  # (Z, pmode, Y, X)
        prop_amp = np.abs(np.transpose(pp, (0, 2, 1, 3)).reshape(pp.shape[0], pp.shape[2], -1))

    os.makedirs(output_path, exist_ok=True)
    if "model" in save_list:
        save_dict = make_save_dict(output_path, params, buffers, geom, params_dict, optimizer,
                                   history, niter, indices, lr_dict, start_dict)
        save_dict_to_hdf5(save_dict, os.path.join(output_path,
                                                  f"model{collate_str}{iter_str}.hdf5"))

    probe = _to_numpy(params.probe)
    # (pmode, Ny, Nx) -> the modes' amplitudes side by side, transposed
    probe_amp = np.abs(probe.reshape(-1, probe.shape[-1])).T
    objp = _to_numpy(params.objp)
    obja = _to_numpy(params.obja)
    omode, zslice = objp.shape[0], objp.shape[1]

    pos = _to_numpy(buffers.crop_pos)[np.asarray(indices)] + np.array(geom.probe_shape) // 2
    y0, y1 = pos[:, 0].min(), pos[:, 0].max()
    x0, x1 = pos[:, 1].min(), pos[:, 1].max()

    def w(name, arr, bit, postfix):
        imwrite_tif(os.path.join(output_path, f"{name}{postfix}.tif"),
                    normalize_by_bit_depth(arr, bit))

    for bit in modes["bit"]:
        bit_str = {"8": "_08bit", "16": "_16bit", "32": "_32bit"}.get(bit, "")
        if "probe" in save_list:
            w("probe_amp", probe_amp, bit, bit_str + collate_str + iter_str)
        if "probe_prop" in save_list:
            w("probe_prop_amp", prop_amp, bit, bit_str + collate_str + iter_str)
        for fov in modes["FOV"]:
            fov_str = "_crop" if fov == "crop" else ""
            if fov == "crop":
                op = objp[:, :, max(y0 - 1, 0):y1, max(x0 - 1, 0):x1]
                oa = obja[:, :, max(y0 - 1, 0):y1, max(x0 - 1, 0):x1]
            else:
                op, oa = objp, obja
            postfix = fov_str + bit_str + collate_str + iter_str

            if any(k in save_list for k in ("obj", "objp", "object")):
                for dim in modes["obj_dim"]:
                    if omode == 1 and zslice == 1 and dim == 2:
                        w("objp", op[0, 0], bit, postfix)
                    elif omode == 1 and zslice > 1:
                        if dim == 3:
                            w("objp_zstack", op[0], bit, postfix)
                        if dim == 2:
                            w("objp_zsum", op[0].sum(0), bit, postfix)
                    elif omode > 1 and zslice == 1:
                        if dim == 3:
                            w("objp_ostack", op[:, 0], bit, postfix)
                        if dim == 2:
                            w("objp_omean", op[:, 0].mean(0), bit, postfix)
                            w("objp_ostd", op[:, 0].std(0), bit, postfix)
                    elif omode > 1 and zslice > 1:
                        if dim == 4:
                            w("objp_4D", op, bit, postfix)
                        if dim == 3:
                            w("objp_ostack_zsum", op.sum(1), bit, postfix)
                            w("objp_omean_zstack", op.mean(0), bit, postfix)
                        if dim == 2:
                            w("objp_omean_zsum", op.mean(0).sum(0), bit, postfix)

            if "obja" in save_list:
                for dim in modes["obj_dim"]:
                    if omode == 1 and zslice == 1 and dim == 2:
                        w("obja", oa[0, 0], bit, postfix)
                    elif omode == 1 and zslice > 1:
                        if dim == 3:
                            w("obja_zstack", oa[0], bit, postfix)
                        if dim == 2:
                            w("obja_zmean", oa[0].mean(0), bit, postfix)
                            w("obja_zprod", oa[0].prod(0), bit, postfix)
                    elif omode > 1 and zslice == 1:
                        if dim == 3:
                            w("obja_ostack", oa[:, 0], bit, postfix)
                        if dim == 2:
                            w("obja_omean", oa[:, 0].mean(0), bit, postfix)
                            w("obja_ostd", oa[:, 0].std(0), bit, postfix)
                    elif omode > 1 and zslice > 1:
                        if dim == 4:
                            w("obja_4D", oa, bit, postfix)
                        if dim == 3:
                            w("obja_ostack_zmean", oa.mean(1), bit, postfix)
                            w("obja_ostack_zprod", oa.prod(1), bit, postfix)
                            w("obja_omean_zstack", oa.mean(0), bit, postfix)
                        if dim == 2:
                            w("obja_omean_zmean", oa.mean(0).mean(0), bit, postfix)
                            w("obja_omean_zprod", oa.mean(0).prod(0), bit, postfix)
    vprint(f"Saved the results of iteration {niter} to '{output_path}' in "
           f"{time.perf_counter() - t0:.3f} sec")
