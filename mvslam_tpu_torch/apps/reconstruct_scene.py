"""reconstruct-scene: two-image SfM demo (port of
``mvslam_tpu.apps.reconstruct_scene``).

Rebuild of ``utility/reconstruct-scene.cpp:22-81``: extract + match ORB
features from two images, run the two-view solve, print the recovered pose
and point count, and export the scene (PLY) plus a match-overlay PNG instead
of opening viewer windows.

Everything between loading the images and writing the PNG is
:func:`reconstruct` (two image tensors and a camera in; the pair, the PLY
and the overlay out), on the card unless ``--device cpu`` is given.

Usage:
    python -m mvslam_tpu_torch.apps.reconstruct_scene IMG1 IMG2 CAMERA_CONFIG
        [--out-dir OUT] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from mvslam_tpu_torch.frontend import FrameManager, ImagePair
from mvslam_tpu_torch.io import load_image_grayscale, save_image
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.utils.errors import ApplicationErrorCode
from mvslam_tpu_torch.viz import draw_matches, save_scene_ply


class Reconstruction(NamedTuple):
    pair: ImagePair            # refined
    ply: str                   # the scene file written
    num_points: int            # triangulated points in it
    overlay: np.ndarray        # (H, W1 + W2, 3) match overlay in [0, 1]


def reconstruct(img1, img2, cam: PinholeCamera, out_dir: str,
                device="cuda", uniforms: Optional[torch.Tensor] = None,
                ) -> Optional[Reconstruction]:
    """The two-view solve of ``img1`` and ``img2`` ((H, W) float32 arrays or
    tensors in [0, 1]) on ``device``: features, matches, reconstruction and
    refinement, the pose and counts printed, ``reconstruction.ply`` written
    into ``out_dir``. ``uniforms`` are the RANSAC draws of
    :class:`ImagePair` (its seeded generator when None). Returns None when
    the pair does not reconstruct."""
    fm = FrameManager(camera=cam, device=device)
    f1 = fm.add_frame(0.0, img1)
    f2 = fm.add_frame(0.1, img2)
    pair = ImagePair(f1, f2, uniforms=uniforms)
    if pair.result is None or not bool(pair.result.success):
        return None
    pair.refine()

    T = pair.T_pair_to_base
    print("pose2in1 translation:", T.t.cpu().numpy().round(5))
    print("pose2in1 rotation (tangent):", T.log()[3:].cpu().numpy().round(5))
    print("match inliers:", pair.match_inlier_count,
          "mean error:", round(pair.mean_error, 4))
    points, mask = pair.points
    pts = points[mask].cpu().numpy()
    print("triangulated points:", len(pts))

    os.makedirs(out_dir, exist_ok=True)
    ply = os.path.join(out_dir, "reconstruction.ply")
    save_scene_ply(ply, pts, [SE3.identity(dtype=T.t.dtype), T])
    host = [t.cpu().numpy() for t in (
        f1.image, f1.features.xy, f2.image, f2.features.xy, pair.match.idx,
        pair.match.mask, pair.result.inlier_mask)]
    return Reconstruction(pair, ply, len(pts), draw_matches(*host))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="reconstruct-scene", description=__doc__)
    ap.add_argument("image1")
    ap.add_argument("image2")
    ap.add_argument("camera_config")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)

    try:
        cam = PinholeCamera.load_from_file(args.camera_config)
        img1 = load_image_grayscale(args.image1)
        img2 = load_image_grayscale(args.image2)
    except Exception as e:
        print(f"bad input: {e}", file=sys.stderr)
        return ApplicationErrorCode.BAD_IO

    rec = reconstruct(img1, img2, cam, args.out_dir, device=args.device)
    if rec is None:
        print("reconstruction failed", file=sys.stderr)
        return ApplicationErrorCode.BAD_DATA
    png = os.path.join(args.out_dir, "matches.png")
    save_image(png, rec.overlay)
    print(f"wrote {rec.ply} and {png}")
    return ApplicationErrorCode.NONE


if __name__ == "__main__":
    raise SystemExit(main())
