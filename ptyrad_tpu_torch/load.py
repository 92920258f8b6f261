"""Loaders for measurement data, reconstructions and params files (host side).

The port's own copy of ptyrad_tpu/load.py: EMPAD .raw (frames with an
inter-frame gap, read by the C reader of native/fastraw.c or, when that
cannot be built, by NumPy), TIFF through PIL, .npy, .mat (scipy below v7.3,
h5py for v7.3, hierarchical keys), recursive HDF5, discovery of the one ND
dataset of a file, PtyRAD checkpoints (reading; the writer is ROADMAP item
A3) and YAML / TOML / JSON / .py params files with optional validation.

scipy, h5py, yaml, PIL and pydantic are imported by the functions that need
them, so the module imports without them.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ptyrad_tpu_torch.utils.logging import vprint
from ptyrad_tpu_torch.utils.nested import get_nested, handle_hdf5_types

KeyType = Union[str, List[str], None]


def _check_exists(file_path: str) -> None:
    if not os.path.exists(file_path):
        raise FileNotFoundError(
            f"The specified file '{file_path}' does not exist. Check the path and working directory."
        )


# ---------------------------------------------------------------------------
# Array loaders
# ---------------------------------------------------------------------------

# The last load_raw call: which reader ran ("native" or "numpy"), the bytes
# it returned and its seconds.
LAST_RAW_READ: Dict[str, Any] = {}


def load_raw(
    file_path: str, shape, dtype=np.float32, offset: int = 0, gap: int = 1024,
    nthreads: int = 8,
) -> np.ndarray:
    """Load an EMPAD-style .raw stack: N frames of (H, W) dtype values, each
    followed by ``gap`` junk bytes, after ``offset`` leading bytes.

    Reads through the multithreaded C reader (native/fastraw.c) when the
    system compiler builds it, else through NumPy's structured dtype; both
    give the same bytes. LAST_RAW_READ records which ran.
    """
    _check_exists(file_path)
    n, height, width = shape
    itemsize = np.dtype(dtype).itemsize
    expected = offset + n * (height * width * itemsize + gap)
    actual = os.path.getsize(file_path)
    if actual != expected:
        raise ValueError(
            f"File size mismatch for '{file_path}': expected {expected} bytes "
            f"(offset + N*(H*W*{itemsize} + gap)), found {actual}. Check shape/offset/gap."
        )

    from ptyrad_tpu_torch.native import load_fastraw

    fastraw = load_fastraw()  # built on first use; the build is not timed
    t0 = time.perf_counter()
    if fastraw is not None:
        buf = fastraw.read_frames(
            file_path, int(n), int(height), int(width), int(itemsize),
            int(offset), int(gap), int(nthreads),
        )
        data, reader = buf.view(dtype).reshape(n, height, width), "native"
    else:
        frame_dtype = np.dtype([("data", dtype, (height, width)), ("gap", np.uint8, gap)])
        with open(file_path, "rb") as f:
            f.seek(offset)
            raw = np.fromfile(f, dtype=frame_dtype, count=n)
        data, reader = raw["data"], "numpy"
    LAST_RAW_READ.clear()
    LAST_RAW_READ.update(reader=reader, bytes=int(data.nbytes),
                         seconds=time.perf_counter() - t0)
    return data


def load_tif(file_path: str) -> np.ndarray:
    """Load a (possibly multi-page) TIFF as an ndarray via PIL."""
    from PIL import Image

    _check_exists(file_path)
    frames = []
    with Image.open(file_path) as img:  # close the fd (hypertune re-reads)
        try:
            i = 0
            while True:
                img.seek(i)
                frames.append(np.asarray(img))
                i += 1
        except EOFError:
            pass
    data = frames[0] if len(frames) == 1 else np.stack(frames)
    vprint(f"Loaded .tif '{file_path}' with shape {data.shape}")
    return data


def load_npy(file_path: str) -> np.ndarray:
    _check_exists(file_path)
    return np.load(file_path)


def load_hdf5(file_path: str, key: KeyType = None, delimiter: str = ".") -> Union[np.ndarray, Dict[str, Any]]:
    """Load dataset(s) from HDF5.

    key=None loads the whole file as a nested dict; a string key (supports
    'group/sub/dataset' paths) returns that dataset/group; a list of keys
    returns a flat dict. Needs h5py (a .mat v7.3 file is HDF5).
    """
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading '{file_path}' (HDF5, or .mat v7.3) needs the h5py "
                          f"package, which is not installed ({e})") from e

    _check_exists(file_path)

    def _read(node):
        if isinstance(node, h5py.Dataset):
            return handle_hdf5_types(node[()])
        return {k: _read(v) for k, v in node.items()}

    with h5py.File(file_path, "r") as hf:
        if key in (None, "", []):
            return _read(hf)
        def _resolve(k):
            # verbatim first (a dataset may literally contain the delimiter
            # in its name), then with the caller's delimiter mapped to HDF5's
            # '/' hierarchy (load_mat passes '.' for MATLAB-style nesting)
            if k in hf:
                return k
            if delimiter != "/" and delimiter in k:
                alt = k.replace(delimiter, "/")
                if alt in hf:
                    return alt
            raise KeyError(f"Key '{k}' not found in '{file_path}'")

        if isinstance(key, str):
            return _read(hf[_resolve(key)])
        if isinstance(key, list):
            return {k: _read(hf[_resolve(k)]) for k in key}
    raise TypeError(f"key must be None, str, or list of str; got {type(key)}")


def load_mat(
    file_path: str, key: KeyType = None, delimiter: str = ".",
    squeeze_me: bool = True, simplify_cells: bool = True,
) -> Union[np.ndarray, Dict[str, Any]]:
    """Load .mat datasets; v7.3 (HDF5-format) files delegate to load_hdf5."""
    import scipy.io as sio
    from scipy.io.matlab import matfile_version as get_matfile_version

    _check_exists(file_path)
    try:
        version = get_matfile_version(file_path)
    except ValueError:
        version = (2, 0)  # not a scipy-readable .mat -> very likely HDF5
    if version[0] == 2:
        return load_hdf5(file_path, key=key, delimiter=delimiter)

    contents = sio.loadmat(file_path, squeeze_me=squeeze_me, simplify_cells=simplify_cells)
    if key in (None, "", []):
        return contents
    if isinstance(key, str):
        return get_nested(contents, key=key, delimiter=delimiter)
    if isinstance(key, list):
        return {k: get_nested(contents, key=k, delimiter=delimiter) for k in key}
    raise TypeError(f"key must be None, str, or list of str; got {type(key)}")


def collect_ND_datasets(
    data_dict: Dict[str, Any], ndims: Optional[List[int]] = None,
    delimiter: str = ".", _parent: str = "",
) -> Dict[str, np.ndarray]:
    """Recursively collect arrays with the desired dimensionalities, keys
    flattened with the delimiter."""
    ndims = ndims or [3, 4]
    out: Dict[str, np.ndarray] = {}
    for k, v in data_dict.items():
        full = f"{_parent}{delimiter}{k}" if _parent else str(k)
        if isinstance(v, np.ndarray) and v.ndim in ndims:
            out[full] = v
        elif isinstance(v, dict):
            out.update(collect_ND_datasets(v, ndims, delimiter, full))
    return out


def load_ND_with_key(
    file_path: str, key: Optional[str] = None, ndims: Optional[List[int]] = None,
) -> np.ndarray:
    """Load exactly one ND dataset from a .mat/.h5/.hdf5 file, auto-discovering when no key is given."""
    _check_exists(file_path)
    ext = os.path.splitext(file_path)[1].lower()
    loader = load_mat if ext == ".mat" else load_hdf5
    if ext not in (".mat", ".h5", ".hdf5"):
        raise ValueError(f"Unsupported file type '{ext}' for ND discovery")

    if key in (None, ""):
        found = collect_ND_datasets(loader(file_path), ndims=ndims)
        if len(found) == 1:
            return next(iter(found.values()))
        if not found:
            raise ValueError(f"No dataset with ndim in {ndims or [3, 4]} found in '{file_path}'")
        raise ValueError(
            f"Multiple eligible datasets found: {list(found)}. Specify 'key' explicitly."
        )
    data = loader(file_path, key)
    if not isinstance(data, np.ndarray):
        raise ValueError(
            f"Key '{key}' is not an array dataset (got {type(data).__name__}); "
            "use key=None to discover eligible datasets."
        )
    return data


def load_array_from_file(
    path: str, key: Optional[str] = None, ndims: Optional[List[int]] = None,
    shape: Optional[Tuple[int, ...]] = None, offset: Optional[int] = None,
    gap: Optional[int] = None,
) -> np.ndarray:
    """Dispatch on file extension: .tif/.tiff/.npy/.mat/.h5/.hdf5/.raw"""
    _check_exists(path)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        return load_tif(path)
    if ext == ".npy":
        return load_npy(path)
    if ext in (".mat", ".h5", ".hdf5"):
        return load_ND_with_key(path, key, ndims)
    if ext == ".raw":
        if shape is None:
            raise ValueError(f"Loading '{path}' requires 'shape' = (N, H, W) for .raw data")
        kwargs = {k: v for k, v in {"offset": offset, "gap": gap}.items() if v is not None}
        return load_raw(path, shape, **kwargs)
    raise ValueError(
        f"Unsupported file type '{ext}'. Supported: .tif, .tiff, .npy, .mat, .h5, .hdf5, .raw"
    )


# ---------------------------------------------------------------------------
# Reconstruction checkpoints
# ---------------------------------------------------------------------------

def load_ptyrad(file_path: str) -> Dict[str, Any]:
    """Load a reconstruction checkpoint (.h5/.hdf5, or a legacy torch .pt)
    as a nested dict of NumPy values; the layout is PtyRAD's, so a checkpoint
    of either package or of PtyRAD reads the same way."""
    _check_exists(file_path)
    ext = os.path.splitext(file_path)[1].lower()
    if ext in (".h5", ".hdf5"):
        return load_hdf5(file_path)
    if ext == ".pt":
        import torch

        data = torch.load(file_path, weights_only=False)

        def to_np(x):
            if isinstance(x, torch.Tensor):
                return x.detach().cpu().numpy()
            if isinstance(x, dict):
                return {k: to_np(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(to_np(v) for v in x)
            return x

        return to_np(data)
    raise ValueError(f"Unsupported checkpoint type '{ext}'; use .h5, .hdf5, or .pt")


# ---------------------------------------------------------------------------
# Params files
# ---------------------------------------------------------------------------

def load_params(file_path: str, validate: bool = True) -> dict:
    """Load a YAML/TOML/JSON/py params file. With ``validate`` (the default)
    the dict goes through the pydantic schema (params/schema.py), which
    checks it and fills the defaults; an ImportError names validate=False
    when pydantic is missing. Without it the dict is returned as read. Either
    way ``params_path`` is set to ``file_path``."""
    _check_exists(file_path)
    stem, ext = os.path.splitext(file_path)
    ext = ext.lower()
    if ext in (".yml", ".yaml"):
        import yaml

        with open(file_path, "r", encoding="utf-8") as f:
            params = yaml.safe_load(f)
    elif ext == ".toml":
        try:
            import tomllib  # 3.11+
        except ModuleNotFoundError:
            # requires-python is >=3.10; tomllib landed in 3.11 (the
            # reference falls back the same way, load.py:560)
            import tomli as tomllib

        with open(file_path, "r", encoding="utf-8") as f:
            params = tomllib.loads(f.read())
    elif ext == ".json":
        import json

        with open(file_path, "r", encoding="utf-8") as f:
            params = json.load(f)
    elif ext == ".py":
        import importlib.util

        import types

        spec = importlib.util.spec_from_file_location("user_params", file_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        # scrape only plain values: a params.py is allowed to carry imports
        # and helper functions ('import numpy as np' must not inject an 'np'
        # key that the strict schema then rejects)
        params = {
            k: v for k in dir(mod) if not k.startswith("__")
            for v in [getattr(mod, k)]
            if not isinstance(v, (types.ModuleType, types.FunctionType, type))
        }
    else:
        raise ValueError(f"Unsupported params type '{ext}'; use .yml, .yaml, .toml, .json, or .py")

    if not isinstance(params, dict):
        raise ValueError(
            f"Params file '{file_path}' is empty or does not define a mapping "
            f"(parsed to {type(params).__name__}); expected the six params "
            "sections (init_params, model_params, ...)"
        )
    if validate:
        try:
            from ptyrad_tpu_torch.params import PtyRADParams
        except ImportError as e:
            raise ImportError(
                f"load_params('{file_path}', validate=True) needs pydantic to validate the "
                f"params and fill their defaults ({e}); install pydantic, or call "
                "load_params(..., validate=False) with a file that states every key"
            ) from e

        params = PtyRADParams(**params).model_dump()
    params["params_path"] = file_path
    return params
