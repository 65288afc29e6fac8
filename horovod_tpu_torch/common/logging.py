"""Leveled, rank-prefixed logger.

The port's copy of the JAX package's logger: levels
TRACE/DEBUG/INFO/WARNING/ERROR/FATAL selected by ``HOROVOD_LOG_LEVEL``,
timestamps suppressed by ``HOROVOD_LOG_HIDE_TIME``.
"""

from __future__ import annotations

import logging as _pylogging
import sys

from . import config as _config

_LEVELS = {
    "trace": 5,
    "debug": _pylogging.DEBUG,
    "info": _pylogging.INFO,
    "warning": _pylogging.WARNING,
    "error": _pylogging.ERROR,
    "fatal": _pylogging.CRITICAL,
}

_pylogging.addLevelName(5, "TRACE")

_logger = None


class _StderrHandler(_pylogging.StreamHandler):
    """Writes each record to the ``sys.stderr`` of its moment.

    A handler that kept the stream of its first use would go on writing to
    whatever had replaced ``sys.stderr`` then (a test's capture, a
    redirection since undone), and later records would never reach fd 2.
    """

    def __init__(self) -> None:
        _pylogging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


def get_logger() -> _pylogging.Logger:
    global _logger
    if _logger is None:
        _logger = _pylogging.getLogger("horovod_tpu_torch.log")
        level_name = _config.log_level_name()
        _logger.setLevel(_LEVELS.get(level_name, _pylogging.WARNING))
        handler = _StderrHandler()
        hide_time = _config.log_hide_time()
        fmt = "[%(levelname)s] %(message)s" if hide_time else (
            "%(asctime)s [%(levelname)s] %(message)s"
        )
        handler.setFormatter(_pylogging.Formatter(fmt))
        _logger.addHandler(handler)
        _logger.propagate = False
    return _logger


def _prefix(msg: str) -> str:
    rank = _config.rank_string()
    return f"[rank {rank}] {msg}" if rank is not None else msg


def trace(msg: str) -> None:
    get_logger().log(5, _prefix(msg))


def debug(msg: str) -> None:
    get_logger().debug(_prefix(msg))


def info(msg: str) -> None:
    get_logger().info(_prefix(msg))


def warning(msg: str) -> None:
    get_logger().warning(_prefix(msg))


def error(msg: str) -> None:
    get_logger().error(_prefix(msg))
