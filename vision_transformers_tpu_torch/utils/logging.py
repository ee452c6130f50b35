"""Console logger (counterpart of ``vision_transformers_tpu/utils/logging.py``;
reference: tensorfn.get_logger, train.py:94).

The port runs one process on one card, so every process is the primary one:
:func:`is_primary` is always true until multi-GPU is ported.
"""

from __future__ import annotations

import logging
import sys
import time

__all__ = ["get_logger", "is_primary"]

_LOGGERS: dict[str, logging.Logger] = {}


def is_primary() -> bool:
    return True


class _ElapsedFormatter(logging.Formatter):
    def __init__(self):
        super().__init__()
        self.start = time.time()

    def format(self, record: logging.LogRecord) -> str:
        elapsed = time.time() - self.start
        h, rem = divmod(int(elapsed), 3600)
        m, s = divmod(rem, 60)
        return f"[{h:02d}:{m:02d}:{s:02d}] {record.getMessage()}"


class _StdoutHandler(logging.StreamHandler):
    """StreamHandler that resolves ``sys.stdout`` at emit time, so a
    redirected stdout (pytest capsys, ``contextlib.redirect_stdout``) gets
    the lines of the cached logger."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):  # base __init__/setStream assign it; ignore
        pass


def get_logger(name: str = "vtx_torch") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handler = _StdoutHandler()
    handler.setFormatter(_ElapsedFormatter())
    logger.addHandler(handler)
    _LOGGERS[name] = logger
    return logger
