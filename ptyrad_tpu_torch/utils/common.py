"""Host utilities: time strings and filename safety.

The port's own copy of ptyrad_tpu/utils/common.py:get_time and
safe_filename.
"""

from __future__ import annotations

import os
import re
import sys
from datetime import datetime


def get_time(fmt="%Y%m%d") -> str:
    """Formatted local time string. True and 'date' give the date,
    'time' the time, 'datetime' both; False, None and '' give ''."""
    if not fmt:
        return ""
    if fmt is True or fmt == "date":
        fmt = "%Y%m%d"
    elif fmt == "time":
        fmt = "%H%M%S"
    elif fmt == "datetime":
        fmt = "%Y%m%d_%H%M%S"
    return datetime.now().strftime(fmt)


_WINDOWS_FORBIDDEN = r'[<>:"|?*]'


def safe_filename(path: str, max_len: int = 255) -> str:
    """Sanitize a path for cross-platform use: strip the characters Windows
    forbids (on Windows) and truncate an over-long basename, keeping its
    extension."""
    directory, base = os.path.split(path)
    if sys.platform.startswith("win"):
        base = re.sub(_WINDOWS_FORBIDDEN, "_", base)
    if len(base) > max_len:
        stem, ext = os.path.splitext(base)
        base = stem[: max_len - len(ext)] + ext
    return os.path.join(directory, base)
