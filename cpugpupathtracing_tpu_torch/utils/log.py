"""Severity-leveled logger.

The reference has a printf-style severity logger whose Log() returns the
formatted message so the EXCEPT macro can both log and throw
(Include/Logger.h:6-55, Include/Common.h:8-9).  Here that maps onto
Python's logging plus an `except_error` helper that logs and raises.
"""

from __future__ import annotations

import enum
import logging
import sys


class Severity(enum.IntEnum):
    VERBOSE = 0
    INFO = 1
    WARNING = 2
    ERROR = 3


_LEVEL_MAP = {
    Severity.VERBOSE: logging.DEBUG,
    Severity.INFO: logging.INFO,
    Severity.WARNING: logging.WARNING,
    Severity.ERROR: logging.ERROR,
}

_logger = logging.getLogger("cpugpupathtracing_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False


def set_min_severity(severity: Severity) -> None:
    """Compile-time min level in the reference (Include/Logger.h:17);
    runtime-settable here."""
    _logger.setLevel(_LEVEL_MAP[severity])


def log(severity: Severity, sender: str, fmt: str, *args) -> str:
    msg = fmt.format(*args) if args else fmt
    line = f"[{sender}] {msg}"
    _logger.log(_LEVEL_MAP[severity], line)
    return line


def log_verbose(sender: str, fmt: str, *args) -> str:
    return log(Severity.VERBOSE, sender, fmt, *args)


def log_info(sender: str, fmt: str, *args) -> str:
    return log(Severity.INFO, sender, fmt, *args)


def log_warn(sender: str, fmt: str, *args) -> str:
    return log(Severity.WARNING, sender, fmt, *args)


def log_error(sender: str, fmt: str, *args) -> str:
    return log(Severity.ERROR, sender, fmt, *args)


def except_error(sender: str, fmt: str, *args) -> None:
    """Log at ERROR and raise, mirroring EXCEPT (Include/Common.h:9)."""
    raise RuntimeError(log_error(sender, fmt, *args))
