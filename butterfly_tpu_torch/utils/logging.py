"""Leveled structured logging.

TPU-native replacement for the reference's printf logger
(reference: src/logging.c:5-76, include/bf/logging.h:15-19). Same level
lattice (TODO < DEBUG < INFO < WARN < ERROR), implemented on top of the
stdlib logging module so it composes with host frameworks. The program's
spans and counters are in `utils/profiling.py`.
"""

from __future__ import annotations

import logging as _pylogging
import sys
from typing import Any

LOG_TODO = 5
LOG_DEBUG = _pylogging.DEBUG
LOG_INFO = _pylogging.INFO
LOG_WARN = _pylogging.WARNING
LOG_ERROR = _pylogging.ERROR

_pylogging.addLevelName(LOG_TODO, "TODO")

_logger = _pylogging.getLogger("butterfly_tpu_torch")
if not _logger.handlers:
    _handler = _pylogging.StreamHandler(sys.stderr)
    _handler.setFormatter(
        _pylogging.Formatter("[%(levelname)s %(asctime)s] %(message)s", "%H:%M:%S")
    )
    _logger.addHandler(_handler)
    _logger.setLevel(LOG_INFO)
    _logger.propagate = False


def set_log_level(level: int) -> None:
    """Set the global log level (reference: bfSetLogLevel, src/logging.c:18)."""
    _logger.setLevel(level)


def get_logger() -> _pylogging.Logger:
    return _logger


def log_todo(msg: str, *args: Any) -> None:
    _logger.log(LOG_TODO, msg, *args)


def log_debug(msg: str, *args: Any) -> None:
    _logger.debug(msg, *args)


def log_info(msg: str, *args: Any) -> None:
    _logger.info(msg, *args)


def log_warn(msg: str, *args: Any) -> None:
    _logger.warning(msg, *args)


def log_error(msg: str, *args: Any) -> None:
    _logger.error(msg, *args)
