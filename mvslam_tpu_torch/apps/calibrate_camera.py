"""calibrate-camera: chessboard intrinsics calibration over a directory (port
of ``mvslam_tpu.apps.calibrate_camera``).

Rebuild of ``utility/calibrate-camera.cpp:77-215``. The numerical solve is
our own Zhang's-method implementation (``mvslam_tpu_torch.ops.calibration``:
per-view homographies, absolute-conic intrinsics, joint GN refinement);
chessboard corner *detection* uses OpenCV when available (input tooling, not
the compute path — the reference uses ``cv::findChessboardCorners`` too).
Writes a :class:`PinholeCamera` text file.

The solve after detection is :func:`calibrate_views` (corner arrays in; the
result, the camera and the undistorted preview out), float64 on the card
unless ``--device cpu`` is given.

Usage:
    python -m mvslam_tpu_torch.apps.calibrate_camera IMAGE_DIR OUT_CONFIG
        [--rows 6] [--cols 9] [--square-size 1.0] [--extension .jpg]
        [--distortion] [--undistort-preview OUT_PNG] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from mvslam_tpu_torch.io import iter_directory, load_image_grayscale, save_image
from mvslam_tpu_torch.ops.calibration import calibrate_planar, undistort_image
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.utils.errors import ApplicationErrorCode


def find_chessboard(img01: np.ndarray, rows: int, cols: int):
    """(N, 2) corner pixels or None. OpenCV-backed detection."""
    try:
        import cv2
    except ImportError:
        print("chessboard detection requires cv2", file=sys.stderr)
        return None
    img8 = (np.asarray(img01) * 255).astype(np.uint8)
    ok, corners = cv2.findChessboardCorners(img8, (cols, rows))
    if not ok:
        return None
    corners = cv2.cornerSubPix(
        img8, corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3),
    )
    return corners.reshape(-1, 2)


def board_points(rows: int, cols: int, square_size: float = 1.0) -> np.ndarray:
    """(rows * cols, 2) float64 inner-corner coordinates on the board plane,
    row-major as the detector orders them."""
    gx, gy = np.meshgrid(np.arange(cols), np.arange(rows))
    board = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float64)
    return board * square_size


def calibrate_views(views: Sequence[np.ndarray], rows: int, cols: int,
                    square_size: float = 1.0, distortion: bool = False,
                    preview=None, refine_iterations: int = 10,
                    device="cuda"):
    """Calibrate from detected corners: ``views`` are (rows * cols, 2) pixel
    arrays, one per image. The solve runs in float64 on ``device``;
    ``preview`` (an (H, W) image in [0, 1], or None) is undistorted with the
    estimated coefficients (``distortion`` must be on). Returns
    (CalibrationResult, the pinhole camera in float64 on ``device``, the
    undistorted preview as a float64 tensor or None)."""
    f64 = torch.float64
    image_points = torch.tensor(np.stack(views), dtype=f64, device=device)
    weights = torch.ones(image_points.shape[:2], dtype=f64, device=device)
    board = torch.tensor(board_points(rows, cols, square_size), dtype=f64,
                         device=device)
    result = calibrate_planar(board, image_points, weights,
                              refine_iterations=refine_iterations,
                              estimate_distortion=distortion)
    und = None
    if preview is not None:
        und = undistort_image(
            torch.as_tensor(preview).to(device=device, dtype=f64),
            result.K, result.dist)
    fx, fy, shear, px, py = torch.stack([
        result.K[0, 0], result.K[1, 1], result.K[0, 1], result.K[0, 2],
        result.K[1, 2]]).tolist()
    cam = PinholeCamera.from_params(fx, fy, shear, px, py, dtype=f64,
                                    device=device)
    return result, cam, und


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="calibrate-camera", description=__doc__)
    ap.add_argument("image_dir")
    ap.add_argument("out_config")
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--cols", type=int, default=9)
    ap.add_argument("--square-size", type=float, default=1.0)
    ap.add_argument("--extension", default=".jpg")
    ap.add_argument("--distortion", action="store_true",
                    help="estimate radial (k1, k2) jointly (reference "
                         "calibrate-camera.cpp:171-186)")
    ap.add_argument("--undistort-preview", metavar="OUT_PNG", default=None,
                    help="write the first view undistorted with the "
                         "estimated coefficients (implies --distortion; "
                         "reference :208)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    if args.undistort_preview:
        args.distortion = True

    views = []
    for path in iter_directory(args.image_dir, args.extension):
        img = load_image_grayscale(path)
        corners = find_chessboard(img.numpy(), args.rows, args.cols)
        if corners is None:
            print(f"no chessboard in {path}", file=sys.stderr)
            continue
        views.append(corners)
        print(f"{path}: {len(corners)} corners", file=sys.stderr)
    if len(views) < 3:
        print("need at least 3 usable views", file=sys.stderr)
        return ApplicationErrorCode.BAD_DATA

    preview: Optional[torch.Tensor] = None
    if args.undistort_preview:
        first = next(iter(iter_directory(args.image_dir, args.extension)))
        preview = load_image_grayscale(first)
    result, cam, und = calibrate_views(
        views, args.rows, args.cols, args.square_size, args.distortion,
        preview, device=args.device)
    K = result.K.cpu().numpy()
    print(f"K =\n{K.round(3)}")
    print(f"rms reprojection error: {float(result.rms_error):.4f} px")
    if args.distortion:
        k1, k2 = (float(x) for x in result.dist.cpu().numpy())
        print(f"radial distortion: k1={k1:.6f} k2={k2:.6f}")
    if und is not None:
        save_image(args.undistort_preview, und)
        print(f"wrote undistorted preview {args.undistort_preview}")
    cam.save_to_file(args.out_config)
    print(f"wrote {args.out_config}")
    return ApplicationErrorCode.NONE


if __name__ == "__main__":
    raise SystemExit(main())
