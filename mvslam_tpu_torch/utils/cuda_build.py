"""Build one of the package's CUDA sources (``csrc/*.cu``) into a shared
library with nvcc for ``sm_90a`` at first use, and load it with ctypes.

A library is built once per source: the file in ``BUILD_DIR`` is named by
the source's hash, so an edited source is rebuilt and an unchanged one is
loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

#: the package's CUDA sources
CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: build products live beside the checkout, in a directory git ignores
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def build_library(source: Path) -> ctypes.CDLL:
    """Build ``source`` with nvcc for ``sm_90a`` unless its library is in
    ``BUILD_DIR`` already, and load it; raises if nvcc fails."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
