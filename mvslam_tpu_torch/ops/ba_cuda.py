"""The two-frame Levenberg-Marquardt solve of :func:`ops.ba.ba_solve` as one
hand-written CUDA kernel (``csrc/ba_two_frame.cu``, K2).

:func:`takes` is the scope rule: a problem on a CUDA device, in float32,
with two poses and 1 to ``CAPACITY`` points, solved without a process group
and without covariances. ``ba_solve`` hands such a problem to
:func:`two_frame_solve`, which launches the kernel once on the current
stream (built with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at first
use, rebuilt when the source changes) and raises if the build or the launch
fails; every other problem runs ``ba_solve``'s plain body.
"""

from __future__ import annotations

import ctypes

import torch

from mvslam_tpu_torch import config
from mvslam_tpu_torch.utils.cuda_build import CSRC, build_library

Tensor = torch.Tensor

_SOURCE = CSRC / "ba_two_frame.cu"
#: poses a problem has
FRAMES = 2
#: most points one launch takes (the source's THREADS x MAX_BLOCKS)
CAPACITY = 2048

# the float32 values of math/lie.py's Taylor thresholds, as the plain
# solve compares with them
_F32 = torch.float32
_TAYLOR2 = float(torch.tensor(config.taylor_threshold(_F32) ** 2, dtype=_F32))
_COS_TAYLOR = float(torch.cos(torch.tensor(config.taylor_threshold(_F32),
                                           dtype=_F32)))

_lib = None


def takes(device: torch.device, dtype: torch.dtype, frames: int, points: int,
          grouped: bool, covariance: bool) -> bool:
    """Whether ``ba_solve`` gives a problem of ``frames`` poses and
    ``points`` points of ``dtype`` on ``device`` to the kernel, solved with
    a process group where ``grouped`` and with covariances where
    ``covariance``."""
    return (device.type == "cuda" and dtype == torch.float32
            and frames == FRAMES and 1 <= points <= CAPACITY
            and not grouped and not covariance)


def load_library() -> ctypes.CDLL:
    """Build the kernel (``utils.cuda_build.build_library``) and load it;
    idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build_library(_SOURCE)
    if lib.mvslam_ba_two_frame_capacity() != CAPACITY:
        raise RuntimeError("the kernel's capacity is not CAPACITY")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mvslam_ba_two_frame.argtypes = (
        [i32, i32] + [ptr] * 18 + [f32] * 7 + [i32] + [f32] * 3 + [ptr])
    lib.mvslam_ba_two_frame.restype = ctypes.c_int
    lib.mvslam_ba_two_frame_error_string.argtypes = [ctypes.c_int]
    lib.mvslam_ba_two_frame_error_string.restype = ctypes.c_char_p
    _lib = lib
    return _lib


def _check(prob) -> list[Tensor]:
    """The problem's tensors in the kernel's order; raise ``ValueError`` on
    what the kernel does not take."""
    P = prob.points0.shape[0]
    F = FRAMES
    want = [
        ("poses0.R", prob.poses0.R, (F, 3, 3), torch.float32),
        ("poses0.t", prob.poses0.t, (F, 3), torch.float32),
        ("points0", prob.points0, (P, 3), torch.float32),
        ("obs", prob.obs, (F, P, 2), torch.float32),
        ("obs_mask", prob.obs_mask, (F, P), torch.bool),
        ("obs_weight", prob.obs_weight, (F, P), torch.float32),
        ("pose_prior.R", prob.pose_prior.R, (F, 3, 3), torch.float32),
        ("pose_prior.t", prob.pose_prior.t, (F, 3), torch.float32),
        ("pose_prior_info", prob.pose_prior_info, (F, 6, 6), torch.float32),
        ("point_prior", prob.point_prior, (P, 3), torch.float32),
        ("point_prior_info", prob.point_prior_info, (P, 3, 3),
         torch.float32),
    ]
    if not 1 <= P <= CAPACITY:
        raise ValueError(f"the kernel takes 1 to {CAPACITY} points, got {P}")
    dev = prob.points0.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
    for name, t, shape, dtype in want:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: the kernel takes a contiguous {dtype} {shape} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}, strides {t.stride()}")
    return [t for _, t, _, _ in want]


def two_frame_solve(prob, params):
    """Solve the two-frame problem ``prob`` (an ``ops.ba.BAProblem``) with
    ``params`` (``ops.ba.BAParams``, ``compute_covariance`` False) in one
    kernel launch on the current stream: (R (2, 3, 3), t (2, 3), points
    (P, 3), error (), iterations () int32, converged () bool, point
    information (P, 3, 3) where ``params.compute_point_info``, else None).
    The same iterations and rules as ``ba_solve``'s plain body, summed in
    another order."""
    if params.compute_covariance:
        raise ValueError("the kernel computes no covariances")
    ins = _check(prob)
    lib = load_library()
    dev = prob.points0.device
    P = prob.points0.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    R = torch.empty((FRAMES, 3, 3), **f32)
    t = torch.empty((FRAMES, 3), **f32)
    points = torch.empty((P, 3), **f32)
    error = torch.empty((), **f32)
    iterations = torch.empty((), dtype=torch.int32, device=dev)
    converged = torch.empty((), dtype=torch.bool, device=dev)
    info = (torch.empty((P, 3, 3), **f32) if params.compute_point_info
            else None)
    outs = [R, t, points, error, iterations, converged]
    huber = params.huber_delta is not None
    with torch.cuda.device(dev):
        err = lib.mvslam_ba_two_frame(
            P, int(params.max_iterations), *(x.data_ptr() for x in ins),
            *(x.data_ptr() for x in outs),
            None if info is None else info.data_ptr(),
            params.lambda_init, params.lambda_up, params.lambda_down,
            params.lambda_min, params.lambda_max, params.rel_decrease,
            params.abs_decrease, int(huber),
            params.huber_delta if huber else 0.0, _TAYLOR2, _COS_TAYLOR,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("ba_two_frame launch failed: "
                           + lib.mvslam_ba_two_frame_error_string(err)
                           .decode())
    two_frame_solve.launches += 1
    return R, t, points, error, iterations, converged, info


#: kernel launches since import (or since a caller reset it)
two_frame_solve.launches = 0
