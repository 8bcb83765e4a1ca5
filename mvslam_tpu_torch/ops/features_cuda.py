"""The dense ORB corner front as one hand-written CUDA kernel (port of
``mvslam_tpu.ops.features_pallas``).

:func:`fast_nms_harris_rank` is the rank map of one pyramid level —
``where(suppress(nms(fast(img))) > 0, harris(img), -inf)`` — in one pass:

- on a CUDA tensor it launches ``csrc/fast_nms_harris.cu`` (built with
  ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at first use, rebuilt
  when the source changes) and raises if the build or the launch fails;
- on a CPU tensor it runs :func:`fast_nms_harris_rank_ref`, the plain
  torch composition of ``ops.features``.

The kernel's corner set is bit-exact against the plain version; Harris
values differ by summation order only (see the source's header).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from mvslam_tpu_torch.ops import features

Tensor = torch.Tensor

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fast_nms_harris.cu"
#: build products live beside the checkout, in a directory git ignores
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: nearest image border the kernel's clamp-to-edge halo matches exactly
MIN_BORDER = 4

_lib = None


def fast_nms_harris_rank_ref(img: Tensor, threshold: float, k: float,
                             border: int) -> Tensor:
    """Plain torch composition of the corner front (the JAX package's
    unfused ``features.py`` path)."""
    score = features.fast_score(img, threshold)
    score = features.nms3x3(score)
    score = features._suppress_border(score, border)
    harris = features.harris_response(img, k)
    return torch.where(score > 0, harris, torch.full_like(harris, -math.inf))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    so = BUILD_DIR / f"libfast_nms_harris-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.mvslam_fast_nms_harris_rank.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mvslam_fast_nms_harris_rank.restype = ctypes.c_int
    lib.mvslam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mvslam_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def fast_nms_harris_rank(img: Tensor, threshold: float, k: float,
                         border: int) -> Tensor:
    """Rank map of one pyramid level: Harris where a FAST corner survives
    strict 3x3 NMS and the border, -inf elsewhere.

    ``img``: (h, w) float32 in [0, 1]. CUDA tensors launch the kernel (no
    fallback); CPU tensors run the plain composition.
    """
    if border < MIN_BORDER:
        raise ValueError(f"border must be >= {MIN_BORDER}, got {border}")
    if img.device.type == "cpu":
        return fast_nms_harris_rank_ref(img, threshold, k, border)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("fast_nms_harris_rank takes a contiguous 2-D "
                         f"float32 tensor, got {img.dtype} {tuple(img.shape)}")
    h, w = img.shape
    lib = load_library()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        err = lib.mvslam_fast_nms_harris_rank(
            img.data_ptr(), out.data_ptr(), h, w, float(threshold), float(k),
            int(border), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("fast_nms_harris_rank launch failed: "
                           + lib.mvslam_cuda_error_string(err).decode())
    fast_nms_harris_rank.launches += 1
    return out


#: kernel launches since import (or since a caller reset it)
fast_nms_harris_rank.launches = 0
