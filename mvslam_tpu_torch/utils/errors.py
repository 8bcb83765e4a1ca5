"""Application error codes (copy of ``mvslam_tpu.utils.errors``)."""

from __future__ import annotations

import enum


class ApplicationErrorCode(enum.IntEnum):
    NONE = 0
    INVALID_ARGS = 1
    BAD_IO = 2
    BAD_DATA = 3
    HARDWARE_ERROR = 4
    UNKNOWN = 5
