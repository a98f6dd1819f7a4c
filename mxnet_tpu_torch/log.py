"""Logging helpers of the port (counterpart of ``mxnet_tpu/log.py``, the
reference's ``python/mxnet/log.py``): a thin layer over ``logging`` with the
reference's level-tagged (and tty-colored) single-line format and a
``getLogger(name, filename, filemode, level)`` convenience.
"""
from __future__ import annotations

import logging
import sys

PY3 = sys.version_info[0] >= 3

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET


class _Formatter(logging.Formatter):
    """Level-tagged (and tty-colored) format, reference log.py:22."""

    def __init__(self, colored=True):
        self.colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def _color(self, level):
        return {
            logging.WARNING: "\x1b[0;33m",
            logging.ERROR: "\x1b[0;31m",
            logging.CRITICAL: "\x1b[0;35m",
        }.get(level, "\x1b[0;32m")

    def format(self, record):
        label = record.levelname[0]
        if self.colored and sys.stderr.isatty():
            head = "%s%s%%(asctime)s %%(process)d %%(pathname)s:%%(lineno)d]\x1b[0m" \
                % (self._color(record.levelno), label)
        else:
            head = "%s%%(asctime)s %%(process)d %%(pathname)s:%%(lineno)d]" % label
        # build a per-call formatter instead of mutating the SHARED
        # self._style._fmt: two handlers (or two threads) formatting
        # records of different levels concurrently would race on the
        # instance and emit each other's level tag/color
        return logging.Formatter(
            head + " %(message)s", datefmt=self.datefmt).format(record)


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """Create/configure a logger (parity log.py:48)."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, "_init_done", False):
        logger._init_done = True
        if filename:
            mode = filemode if filemode else "a"
            hdlr = logging.FileHandler(filename, mode)
        else:
            hdlr = logging.StreamHandler()
        hdlr.setFormatter(_Formatter())
        logger.addHandler(hdlr)
        logger.setLevel(level)
    return logger
