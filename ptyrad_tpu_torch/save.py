"""Array writers used by the Initializer's measurement export.

The port's own copy of ptyrad_tpu/save.py:imwrite_tif and save_array. The
checkpoint writer, output folders and result images are ROADMAP item A3.
"""

from __future__ import annotations

import os

import numpy as np

from ptyrad_tpu_torch.utils.common import safe_filename
from ptyrad_tpu_torch.utils.logging import vprint


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
        import h5py

        with h5py.File(path, "w") as hf:
            hf.create_dataset("meas", data=data, compression="gzip", **kwargs)
    else:
        raise ValueError(
            f"Unsupported file_format '{file_format}'; use 'tif', 'npy', 'hdf5', 'h5', or 'mat'")
    vprint(f"Saved array with shape {data.shape} to '{path}'")
    return path
