"""Verbosity-gated printing and the run's log file (counterpart of
ptyrad_tpu/utils/logging.py: vprint and CustomLogger).

``vprint`` prints, or, once a ``CustomLogger`` has installed its handlers,
logs through the named logger, so every line reaches the console, the
in-memory buffer and, after ``flush_to_dir``, the log file in the run's
output folder. In a distributed run only rank 0 prints, logs and writes the
log file (ptyrad_tpu/utils/logging.py:25-49).
"""

from __future__ import annotations

import io
import logging
import os
import sys
from datetime import datetime
from typing import Optional

from ptyrad_tpu_torch.parallel.mesh import is_main_process

_LOGGER_NAME = "ptyrad_tpu_torch"


def vprint(*args, verbose: bool = True, **kwargs) -> None:
    """print() when ``verbose``, on rank 0 only. Through the logger, ``sep``
    is honoured and ``end``, ``file`` and ``flush`` are dropped: every call
    is one record."""
    if not verbose or not is_main_process():
        return
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        logger.info(kwargs.get("sep", " ").join(str(a) for a in args))
    else:
        print(*args, **kwargs)


class CustomLogger:
    """Console and log-file logging, buffered in memory until the output
    folder exists.

    ``flush_to_dir(dir)`` writes the buffer to ``dir``/<name>, empties the
    buffer and logs to that file from then on; a second flush starts a new
    file with only what came after the first and stops writing to the old
    one. The file name is ``log_file``, prefixed by the job id when one is
    given and by the date when ``prefix_date``.
    """

    def __init__(self, log_file: str = "ptyrad_log.txt", prefix_date: bool = True,
                 prefix_jobid: str = "",
                 append_to_file: bool = True, show_timestamp: bool = True):
        self.log_file = log_file
        self.prefix_date = prefix_date
        self.prefix_jobid = str(prefix_jobid or "")
        self.append_to_file = append_to_file

        self.logger = logging.getLogger(_LOGGER_NAME)
        self.logger.setLevel(logging.INFO)
        self.logger.handlers.clear()
        self.logger.propagate = False
        self._formatter = logging.Formatter(
            "%(asctime)s | %(message)s" if show_timestamp else "%(message)s",
            datefmt="%Y-%m-%d %H:%M:%S")
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(self._formatter)
        self.logger.addHandler(console)
        self._buffer = io.StringIO()
        buffer_handler = logging.StreamHandler(self._buffer)
        buffer_handler.setFormatter(self._formatter)
        self.logger.addHandler(buffer_handler)
        self._file_handler: Optional[logging.FileHandler] = None

    def _file_name(self) -> str:
        name = self.log_file
        if self.prefix_jobid:
            name = f"{self.prefix_jobid}_{name}"
        if self.prefix_date:
            name = f"{datetime.now().strftime('%Y%m%d')}_{name}"
        return name

    def flush_to_dir(self, output_dir: str) -> str:
        """Write what is buffered into ``output_dir`` and log there from now
        on; returns the log file's path (on rank 0; other ranks write
        nothing)."""
        path = os.path.join(output_dir, self._file_name())
        if not is_main_process():
            return path
        os.makedirs(output_dir, exist_ok=True)
        with open(path, "a" if self.append_to_file else "w") as f:
            f.write(self._buffer.getvalue())
        self._buffer.truncate(0)
        self._buffer.seek(0)
        if self._file_handler is not None:
            self.logger.removeHandler(self._file_handler)
            self._file_handler.close()
        self._file_handler = logging.FileHandler(path, mode="a")
        self._file_handler.setFormatter(self._formatter)
        self.logger.addHandler(self._file_handler)
        return path

    def close(self) -> None:
        """Close and remove every handler: vprint prints again."""
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
        self._file_handler = None
