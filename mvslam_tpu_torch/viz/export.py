"""Trajectory / point-cloud / image-overlay exports (port of
``mvslam_tpu.viz.export``; numpy on the host, poses in and out as ``SE3``
of CPU tensors). Deterministic file outputs for headless jobs:

- trajectories in TUM format (timestamp tx ty tz qx qy qz qw) + CSV,
- point clouds as ASCII PLY,
- camera frusta + cloud as a single PLY scene,
- keypoint / match overlays rendered into arrays (saved as PNG by
  ``io.image.save_image``).

Poses may live on any device; they are brought to the host here.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from mvslam_tpu_torch.math.lie import SE3


def _np(x) -> np.ndarray:
    """Tensor or array -> float64 numpy on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
        x, y, z, w = q
    return np.array([x, y, z, w])


def save_trajectory_tum(path: str, trajectory: Iterable[tuple]) -> int:
    """(frame_id, time, SE3) tuples -> TUM-format text file. Returns rows."""
    n = 0
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for _, t_cap, pose in trajectory:
            R = _np(pose.R)
            t = _np(pose.t)
            q = _rot_to_quat(R)
            f.write(
                f"{t_cap:.6f} {t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g}\n"
            )
            n += 1
    return n


def load_trajectory_tum(path: str) -> list[tuple]:
    """TUM file -> [(index, time, SE3)]."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            t_cap, t, q = vals[0], np.asarray(vals[1:4]), np.asarray(vals[4:8])
            x, y, z, w = q
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            out.append((i, t_cap, SE3(torch.from_numpy(R),
                                      torch.from_numpy(t))))
    return out


def save_point_cloud_ply(
    path: str, points: np.ndarray, colors: np.ndarray | None = None
) -> int:
    """(N, 3) points (+ optional (N, 3) uint8 colors) -> ASCII PLY."""
    pts = _np(points)
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{pts[i,0]:.6g} {pts[i,1]:.6g} {pts[i,2]:.6g}"
            if colors is not None:
                c = colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")
    return n


def save_scene_ply(
    path: str,
    points: np.ndarray,
    poses: Sequence[SE3],
    axis_length: float = 0.2,
    samples_per_axis: int = 8,
) -> int:
    """Cloud (white) + camera-pose RGB axis triads, one PLY: each axis is
    a few colored samples so any PLY viewer shows the frusta."""
    rows = [_np(points)]
    cols = [np.full((len(rows[0]), 3), 200, np.uint8)]
    axis_colors = np.eye(3, dtype=np.uint8) * 255      # x=red, y=green, z=blue
    for pose in poses:
        R = _np(pose.R)
        t = _np(pose.t)
        for a in range(3):
            ts = np.linspace(0, axis_length, samples_per_axis)
            rows.append(t[None] + ts[:, None] * R[:, a][None])
            cols.append(np.tile(axis_colors[a], (samples_per_axis, 1)))
    allp = np.concatenate(rows)
    allc = np.concatenate(cols)
    return save_point_cloud_ply(path, allp, allc)


# ---------------------------------------------------------------------------
# 2D overlays
# ---------------------------------------------------------------------------


def _to_rgb(img: np.ndarray) -> np.ndarray:
    arr = np.clip(np.asarray(img, np.float32), 0, 1)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def draw_keypoints(img, xy, mask=None, radius: int = 3,
                   color=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Circles at keypoints."""
    out = _to_rgb(img).copy()
    H, W = out.shape[:2]
    xy = np.asarray(xy)
    mask = np.ones(len(xy), bool) if mask is None else np.asarray(mask)
    th = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    ring = np.stack([np.cos(th), np.sin(th)], axis=-1) * radius
    for p, ok in zip(xy, mask):
        if not ok:
            continue
        pts = np.round(p[None] + ring).astype(int)
        good = (pts[:, 0] >= 0) & (pts[:, 0] < W) & (pts[:, 1] >= 0) & (pts[:, 1] < H)
        out[pts[good, 1], pts[good, 0]] = color
    return out


def draw_matches(img1, xy1, img2, xy2, match_idx, match_mask,
                 inlier_mask=None) -> np.ndarray:
    """Stacked pair with match lines: raw matches blue, inliers green."""
    a = _to_rgb(img1)
    b = _to_rgb(img2)
    H = max(a.shape[0], b.shape[0])
    W = a.shape[1] + b.shape[1]
    out = np.zeros((H, W, 3), np.float32)
    out[: a.shape[0], : a.shape[1]] = a
    out[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]
    xy1 = np.asarray(xy1)
    xy2 = np.asarray(xy2)
    idx = np.asarray(match_idx)
    mm = np.asarray(match_mask)
    im = np.zeros_like(mm) if inlier_mask is None else np.asarray(inlier_mask)
    for i in np.flatnonzero(mm):
        p = xy1[i]
        q = xy2[idx[i]] + [off, 0]
        color = (0.1, 1.0, 0.1) if im[i] else (0.2, 0.4, 1.0)
        n = int(max(abs(q[0] - p[0]), abs(q[1] - p[1]), 1))
        ts = np.linspace(0, 1, n + 1)
        pts = np.round(p[None] + ts[:, None] * (q - p)[None]).astype(int)
        good = (pts[:, 0] >= 0) & (pts[:, 0] < W) & (pts[:, 1] >= 0) & (pts[:, 1] < H)
        out[pts[good, 1], pts[good, 0]] = color
    return out
