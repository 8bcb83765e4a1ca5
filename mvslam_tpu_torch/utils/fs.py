"""Filesystem helpers: directory iteration with extension filter (copy of
``mvslam_tpu.utils.fs``).

Reference ``source/os/directory-iterator.{hpp,cpp}`` (readdir-based, no
ordering guarantee; we sort for determinism, a strict improvement the
reference tests do not forbid).
"""

from __future__ import annotations

import os
from typing import Iterator, List


def iterate_directory(directory: str, extension: str = "") -> Iterator[str]:
    """Yield file names (not paths) in ``directory`` with the given extension."""
    ext = extension.lstrip(".").lower()
    for name in sorted(os.listdir(directory)):
        if not os.path.isfile(os.path.join(directory, name)):
            continue
        if ext and not name.lower().endswith("." + ext):
            continue
        yield name


def list_directory(directory: str, extension: str = "") -> List[str]:
    return list(iterate_directory(directory, extension))
