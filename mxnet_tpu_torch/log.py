"""Logging helpers (counterpart of `mxnet_tpu/log.py`; reference:
python/mxnet/log.py): `get_logger` with the reference's level names and
an optional file handler."""
from __future__ import annotations

import logging
import os

__all__ = ["get_logger", "getLogger", "DEBUG", "INFO", "WARNING", "ERROR",
           "CRITICAL", "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
CRITICAL = logging.CRITICAL
NOTSET = logging.NOTSET

_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def get_logger(name=None, filename=None, filemode="a", level=WARNING):
    """The logger `name` at `level`, writing to `filename` (one handler a
    file, however often it is asked for) or, where it has no handler
    yet, to a formatted console handler."""
    logger = logging.getLogger(name)
    if filename:
        target = os.path.abspath(filename)
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == target
                   for h in logger.handlers):
            handler = logging.FileHandler(filename, filemode)
            handler.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(handler)
    elif not logger.handlers:
        # the reference's behaviour: INFO / DEBUG print at the requested
        # level (the root logger's last resort prints WARNING and up)
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


getLogger = get_logger
