"""Demo apps: image IO round trip, feature matching, visualizer exports (port
of ``mvslam_tpu.apps.demos``).

File-output rebuilds of the reference's manual/visual test utilities
(``utility/test-image-io.cpp``, ``test-visual-feature.cpp``,
``test-visualizer-2d.cpp``, ``test-visualizer-3d.cpp``) — the interactive
windows become PNG/PLY artifacts. Features are detected on the card unless
``--device cpu`` is given (one corner-kernel launch per image).

Usage:
    python -m mvslam_tpu_torch.apps.demos image-io IMG OUT_DIR
    python -m mvslam_tpu_torch.apps.demos visual-feature IMG1 IMG2 OUT_DIR
    python -m mvslam_tpu_torch.apps.demos visualizer-2d IMG1 IMG2 OUT_DIR
    python -m mvslam_tpu_torch.apps.demos visualizer-3d OUT_DIR
    (each takes [--device cuda|cpu])
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from mvslam_tpu_torch.io import load_image_grayscale, save_image
from mvslam_tpu_torch.utils.errors import ApplicationErrorCode


def demo_image_io(img_path: str, out_dir: str) -> int:
    """Load/save round trip (reference ``test-image-io.cpp:16-40``)."""
    img = load_image_grayscale(img_path)
    out = os.path.join(out_dir, "roundtrip.png")
    save_image(out, img)
    back = load_image_grayscale(out)
    err = float((img - back).abs().max())
    print(f"shape={tuple(img.shape)} roundtrip_max_err={err:.4f} wrote {out}")
    return ApplicationErrorCode.NONE


def _detect_and_match(p1: str, p2: str, device, **match_kw):
    """Both images on ``device``, their features and the matches."""
    from mvslam_tpu_torch.ops import features, matching

    img1 = load_image_grayscale(p1).to(device)
    img2 = load_image_grayscale(p2).to(device)
    f1 = features.orb_detect(img1)
    f2 = features.orb_detect(img2)
    m = matching.match_features(f1.desc, f1.mask, f2.desc, f2.mask,
                                **match_kw)
    return img1, img2, f1, f2, m


def _host(*tensors):
    return [t.cpu().numpy() for t in tensors]


def demo_visual_feature(p1: str, p2: str, out_dir: str,
                        device="cuda") -> int:
    """Match two images, draw matches (reference ``test-visual-feature.cpp``)."""
    from mvslam_tpu_torch.viz import draw_matches

    img1, img2, f1, f2, m = _detect_and_match(p1, p2, device, max_distance=64)
    overlay = draw_matches(*_host(img1, f1.xy, img2, f2.xy, m.idx, m.mask))
    out = os.path.join(out_dir, "matches.png")
    save_image(out, overlay)
    n1, n2, nm = torch.stack([f1.mask.sum(), f2.mask.sum(),
                              m.mask.sum()]).tolist()
    print(f"features: {n1}/{n2} matches: {nm} wrote {out}")
    return ApplicationErrorCode.NONE


def demo_visualizer_2d(p1: str, p2: str, out_dir: str,
                       device="cuda") -> int:
    """Drive the threaded 2D viewer with a keyframe + matched pair
    (reference ``test-visualizer-2d.cpp:10-74`` drives Visualizer2d the
    same way with the tsukuba pair)."""
    from mvslam_tpu_torch.viz import Visualizer2d

    img1, img2, f1, f2, m = _detect_and_match(p1, p2, device)
    viewer = Visualizer2d(out_dir)
    viewer.show_keyframe(img1, f1.xy, f1.mask)
    viewer.show_matched_pair(img1, f1.xy, img2, f2.xy, m.idx, m.mask)
    viewer.close()
    print(f"wrote {viewer.window_path}")
    return demo_visual_feature(p1, p2, out_dir, device)


def demo_visualizer_3d(out_dir: str, device="cuda") -> int:
    """Random clouds + camera poses to PLY (reference
    ``test-visualizer-3d.cpp:45-69``)."""
    from mvslam_tpu_torch.math.lie import SE3, so3_from_rpy
    from mvslam_tpu_torch.viz import save_scene_ply

    rng = np.random.default_rng(0)
    cloud = rng.normal(0, 1, (500, 3)) + [0, 0, 5]
    f32 = torch.float32
    poses = [
        SE3.identity(dtype=f32, device=device),
        SE3(so3_from_rpy(0.1, 0.2, 0.3, dtype=f32).to(device),
            torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=device)),
    ]
    out = os.path.join(out_dir, "scene.ply")
    n = save_scene_ply(out, cloud, poses)
    print(f"wrote {out} ({n} vertices)")

    # drive the threaded 3D viewer as the reference's test utility does
    from mvslam_tpu_torch.viz import Visualizer3d

    viewer = Visualizer3d(out_dir)
    viewer.set_point_cloud(0, cloud)
    for i, pose in enumerate(poses):
        viewer.set_camera_pose(i, pose)
    viewer.close()
    print(f"wrote {viewer.window_path}")
    return ApplicationErrorCode.NONE


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="demos", description=__doc__)
    ap.add_argument("demo", choices=["image-io", "visual-feature",
                                     "visualizer-2d", "visualizer-3d"])
    ap.add_argument("args", nargs="*")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    ns = ap.parse_args(argv)
    try:
        if ns.demo == "image-io":
            img, out = ns.args
            os.makedirs(out, exist_ok=True)
            return demo_image_io(img, out)
        if ns.demo == "visual-feature":
            p1, p2, out = ns.args
            os.makedirs(out, exist_ok=True)
            return demo_visual_feature(p1, p2, out, ns.device)
        if ns.demo == "visualizer-2d":
            p1, p2, out = ns.args
            os.makedirs(out, exist_ok=True)
            return demo_visualizer_2d(p1, p2, out, ns.device)
        if ns.demo == "visualizer-3d":
            (out,) = ns.args
            os.makedirs(out, exist_ok=True)
            return demo_visualizer_3d(out, ns.device)
    except ValueError:
        print("wrong number of arguments", file=sys.stderr)
        return ApplicationErrorCode.INVALID_ARGS
    return ApplicationErrorCode.UNKNOWN


if __name__ == "__main__":
    raise SystemExit(main())
