"""Level-filtered logging (copy of ``mvslam_tpu.utils.logging``).

Rebuild of the reference's ``Logging`` static class + tagged ``Logger`` facade
(``source/base/debug.hpp:75-221``): levels NONE < ERROR < INFO < DEBUG,
redirectable output streams per level, and per-module taggged loggers with an
enable bit (several reference modules ship with logging compiled off).
"""

from __future__ import annotations

import enum
import sys
from typing import IO, Any


class LoggingLevel(enum.IntEnum):
    NONE = 0
    ERROR = 1
    INFO = 2
    DEBUG = 3


class Logging:
    """Process-global logging configuration (reference ``base/debug.hpp:75-171``)."""

    _level: LoggingLevel = LoggingLevel.ERROR
    _debug_stream: IO = sys.stderr
    _info_stream: IO = sys.stderr
    _error_stream: IO = sys.stderr

    @classmethod
    def set_logging_level(cls, level: LoggingLevel) -> None:
        cls._level = LoggingLevel(level)

    @classmethod
    def get_logging_level(cls) -> LoggingLevel:
        return cls._level

    @classmethod
    def set_streams(cls, debug: IO = None, info: IO = None, error: IO = None) -> None:
        if debug is not None:
            cls._debug_stream = debug
        if info is not None:
            cls._info_stream = info
        if error is not None:
            cls._error_stream = error

    @classmethod
    def debug(cls, *parts: Any) -> None:
        if cls._level >= LoggingLevel.DEBUG:
            print(*parts, sep="", file=cls._debug_stream)

    @classmethod
    def info(cls, *parts: Any) -> None:
        if cls._level >= LoggingLevel.INFO:
            print(*parts, sep="", file=cls._info_stream)

    @classmethod
    def error(cls, *parts: Any) -> None:
        if cls._level >= LoggingLevel.ERROR:
            print(*parts, sep="", file=cls._error_stream)


class Logger:
    """Tag-prefixed logger facade (reference ``base/debug.hpp:174-221``)."""

    def __init__(self, tag: str, enabled: bool = True) -> None:
        self.tag = tag
        self.enabled = enabled

    def debug(self, *parts: Any) -> None:
        if self.enabled:
            Logging.debug(self.tag, " ", *parts)

    def info(self, *parts: Any) -> None:
        if self.enabled:
            Logging.info(self.tag, " ", *parts)

    def error(self, *parts: Any) -> None:
        if self.enabled:
            Logging.error(self.tag, " ", *parts)
