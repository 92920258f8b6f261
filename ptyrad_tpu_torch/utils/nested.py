"""Nested-dict utilities and HDF5 type coercion (host-side).

The port's own copy of ptyrad_tpu/utils/nested.py: get_nested /
set_nested / list_nested_keys over 'a.b.c' paths, and handle_hdf5_types,
which turns what h5py reads back into natural Python and NumPy values.
"""

from __future__ import annotations

from typing import Any, List, Union

import numpy as np

NONE_SENTINEL = "__NONE__"


def get_nested(d: dict, key: Union[str, List[str]], delimiter: str = ".", safe: bool = False,
               default=None):
    """Fetch a nested value by 'a.b.c' path or ['a', 'b', 'c'] list; with
    ``safe``, a missing key gives ``default`` instead of KeyError."""
    keys = key.split(delimiter) if isinstance(key, str) else list(key)
    cur = d
    for k in keys:
        if isinstance(cur, dict) and k in cur:
            cur = cur[k]
        elif safe:
            return default
        else:
            raise KeyError(f"Key path {keys} not found (missing '{k}')")
    return cur


def set_nested(d: dict, key: Union[str, List[str]], value, delimiter: str = ".") -> None:
    keys = key.split(delimiter) if isinstance(key, str) else list(key)
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = value


def list_nested_keys(d: dict, delimiter: str = ".", _prefix: str = "") -> List[str]:
    """All leaf key paths of a nested dict, delimiter-joined."""
    out: List[str] = []
    for k, v in d.items():
        path = f"{_prefix}{delimiter}{k}" if _prefix else str(k)
        if isinstance(v, dict) and v:
            out.extend(list_nested_keys(v, delimiter, path))
        else:
            out.append(path)
    return out


def handle_hdf5_types(value: Any, none_sentinel: str = NONE_SENTINEL) -> Any:
    """Coerce h5py-loaded values into natural Python/NumPy types.

    - bytes -> str; the none sentinel -> None; a stringified literal (the
      savers' str() fallback for tuples, ragged lists, dicts in lists) ->
      the Python object
    - 0-d arrays -> Python scalars
    - MATLAB v7.3's complex compound dtype ('real'/'imag') -> complex ndarray
    """
    if isinstance(value, bytes):
        value = value.decode("utf-8")
    if isinstance(value, str):
        if value == none_sentinel:
            return None
        import ast

        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    if isinstance(value, np.ndarray):
        if value.dtype.names and set(value.dtype.names) >= {"real", "imag"}:
            return value["real"] + 1j * value["imag"]
        if value.ndim == 0:
            return handle_hdf5_types(value[()], none_sentinel)
        if value.dtype.kind == "S" or value.dtype == object:
            try:
                return np.array([handle_hdf5_types(v, none_sentinel)
                                 for v in value.ravel()]).reshape(value.shape)
            except Exception:
                return value
        return value
    if isinstance(value, np.void) and value.dtype.names and set(value.dtype.names) >= {"real",
                                                                                         "imag"}:
        return complex(value["real"], value["imag"])
    if isinstance(value, (np.generic,)):
        return value.item()
    return value
