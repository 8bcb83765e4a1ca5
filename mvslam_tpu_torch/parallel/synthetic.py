"""Synthetic multi-frame BA problem generators (port of
``mvslam_tpu.parallel.synthetic``).

Windowed BA over keyframe sequences and long sequences with many
landmarks. Every random draw comes from ``numpy.random.default_rng(seed)``
on the host, in float64, and is then cast: the same seed gives the same
problem on every device, so a run on the card and a run on the CPU solve
identical inputs. (The JAX package draws from ``jax.random`` streams, which
torch cannot reproduce; parity tests carry the problem arrays across with
``mvslam_tpu_torch.convert`` instead of matching the draws.)
"""

from __future__ import annotations

import numpy as np
import torch

from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.ops import ba_sparse

Tensor = torch.Tensor


def _march_poses(num_frames: int, dtype) -> tuple[SE3, Tensor]:
    """Ground truth: poses marching +x, slight jitter in y/z."""
    xs = torch.arange(num_frames, dtype=dtype) * 0.5
    t = torch.stack([xs, 0.02 * torch.sin(xs), 0.01 * torch.cos(xs)], dim=-1)
    R = torch.eye(3, dtype=dtype).expand(num_frames, 3, 3).clone()
    return SE3(R, t), xs


def _perturbed(rng, poses_true: SE3, pts_true: Tensor, init_noise: float,
               dtype) -> tuple[SE3, Tensor]:
    """Perturbed initialization; frame 0 (the anchor) stays put."""
    F = poses_true.t.shape[0]
    dpose = init_noise * rng.standard_normal((F, 6))
    dpose[0] = 0.0
    poses0 = poses_true.compose(SE3.exp(torch.tensor(dpose, dtype=dtype)))
    points0 = pts_true + torch.tensor(
        init_noise * rng.standard_normal(tuple(pts_true.shape)), dtype=dtype)
    return poses0, points0


def _priors(F: int, P: int, anchor_stddev: float, point_stddev: float, dtype):
    pose_prior_info = torch.zeros((F, 6, 6), dtype=dtype)
    pose_prior_info[0] = torch.eye(6, dtype=dtype) / (anchor_stddev ** 2)
    point_prior_info = (torch.eye(3, dtype=dtype) / (point_stddev ** 2)
                        ).expand(P, 3, 3).clone()
    return pose_prior_info, point_prior_info


def _to(x, device):
    """Move a tensor or a (nested) tuple of tensors to ``device``."""
    if isinstance(x, Tensor):
        return x.to(device)
    return type(x)(*(_to(v, device) for v in x))


def make_window_ba_problem(
    seed: int,
    num_frames: int = 8,
    num_points: int = 512,
    noise: float = 1e-3,
    init_noise: float = 1e-2,
    anchor_stddev: float = 1e-5,
    point_stddev: float = 0.1,
    dtype=torch.float32,
    device="cuda",
) -> tuple[ba_mod.BAProblem, SE3, Tensor]:
    """A sliding-window BA problem: a camera translating in +x observing a
    random point cloud in front; noisy observations, perturbed initial
    poses/points, frame-0 anchored, weak point regulators for the gauge.

    Returns (problem, true_poses, true_points) on ``device``.
    """
    rng = np.random.default_rng(seed)
    poses_true, _ = _march_poses(num_frames, dtype)
    # points spread in front of the trajectory
    span_x = 0.5 * num_frames
    pts_xy = rng.uniform(-2.0, 2.0, (num_points, 2))
    pts_xy[:, 0] += rng.uniform(0.0, span_x, num_points)
    depth = rng.uniform(4.0, 12.0, num_points)
    pts_true = torch.tensor(np.concatenate([pts_xy, depth[:, None]], -1),
                            dtype=dtype)

    Xc = torch.einsum("fji,fpj->fpi", poses_true.R,
                      pts_true[None] - poses_true.t[:, None, :])
    proj = Xc[..., :2] / Xc[..., 2:3]
    obs = proj + torch.tensor(noise * rng.standard_normal(tuple(proj.shape)),
                              dtype=dtype)
    obs_mask = Xc[..., 2] > 0.5

    poses0, points0 = _perturbed(rng, poses_true, pts_true, init_noise, dtype)
    pose_prior_info, point_prior_info = _priors(
        num_frames, num_points, anchor_stddev, point_stddev, dtype)
    prob = ba_mod.BAProblem.create(
        poses0=poses0, points0=points0, obs=obs, obs_mask=obs_mask,
        obs_weight=torch.full((num_frames, num_points), 1.0 / noise,
                              dtype=dtype),
        pose_prior=poses0, pose_prior_info=pose_prior_info,
        point_prior=points0, point_prior_info=point_prior_info)
    return _to(prob, device), _to(poses_true, device), pts_true.to(device)


def make_sequence_ba_problem(
    seed: int,
    num_frames: int = 64,
    points_per_frame: int = 32,
    window: int = 4,
    noise: float = 1e-3,
    init_noise: float = 1e-2,
    anchor_stddev: float = 1e-5,
    point_stddev: float = 0.5,
    dtype=torch.float32,
    device="cuda",
) -> tuple[ba_sparse.SparseBAProblem, SE3, Tensor]:
    """A long-sequence SLAM problem in fixed-degree sparse form.

    Ground truth: a camera marching +x past a corridor of landmarks; each
    landmark is anchored at one keyframe and observed by the next ``window``
    keyframes (degree D = window observation lists). Landmarks are emitted
    ordered by anchor keyframe. Storage is O(P * window), never O(F * P).

    Returns (problem, true_poses, true_points) on ``device``.
    """
    rng = np.random.default_rng(seed)
    F = num_frames
    P = F * points_per_frame
    poses_true, xs = _march_poses(F, dtype)

    # landmarks: anchored at frame i, spread laterally, 4-12 ahead in depth
    anchor = torch.arange(F).repeat_interleave(points_per_frame)   # (P,)
    lateral = torch.tensor(rng.uniform(-2.0, 2.0, (P, 2)), dtype=dtype)
    depth = torch.tensor(rng.uniform(4.0, 12.0, P), dtype=dtype)
    pts_true = torch.stack(
        [xs[anchor] + lateral[:, 0], lateral[:, 1], depth], dim=-1)

    # observation lists: frames anchor .. anchor+window-1 (clipped)
    obs_frame = torch.clamp(anchor[:, None] + torch.arange(window)[None, :],
                            max=F - 1)                             # (P, W)
    Rg = poses_true.R[obs_frame]
    tg = poses_true.t[obs_frame]
    Xc = torch.einsum("pdji,pdj->pdi", Rg, pts_true[:, None, :] - tg)
    proj = Xc[..., :2] / Xc[..., 2:3]
    obs = proj + torch.tensor(noise * rng.standard_normal(tuple(proj.shape)),
                              dtype=dtype)
    # mask: positive depth, in a loose fov, and no duplicated (clipped) frames
    first = torch.cat([torch.ones_like(obs_frame[:, :1], dtype=torch.bool),
                       obs_frame[:, 1:] != obs_frame[:, :-1]], dim=1)
    obs_mask = (Xc[..., 2] > 0.5) & (torch.abs(proj) < 3.0).all(-1) & first

    poses0, points0 = _perturbed(rng, poses_true, pts_true, init_noise, dtype)
    pose_prior_info, point_prior_info = _priors(F, P, anchor_stddev,
                                                point_stddev, dtype)
    prob = ba_sparse.SparseBAProblem.create(
        poses0=poses0, points0=points0, obs_frame=obs_frame, obs=obs,
        obs_mask=obs_mask,
        obs_weight=torch.full(tuple(obs_frame.shape), 1.0 / noise,
                              dtype=dtype),
        pose_prior=poses0, pose_prior_info=pose_prior_info,
        point_prior=points0, point_prior_info=point_prior_info)
    return _to(prob, device), _to(poses_true, device), pts_true.to(device)
