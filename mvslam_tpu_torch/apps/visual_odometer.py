"""visual-odometer: replay a dataset directory through the SLAM pipeline
(port of ``mvslam_tpu.apps.visual_odometer``).

Loads ``system.param`` (optional) + ``camera.config`` + the ``image.txt``
manifest from a dataset directory. By default every frame goes through the
host-orchestrated front end (``FrameManager.add_frame`` ->
``VisualOdometer.add_frame``); the app prints per-frame tracking status on
stderr (unless ``--quiet``) and a summary line, writes the trajectory
(``trajectory.tum``) and a PLY scene (map + camera frusta, ``scene.ply``),
saves the odometer's state with ``--checkpoint`` and restores it before the
replay with ``--resume``.

With ``--pose-graph`` the replay runs the fused tracker with the pose-graph
back-end attached (keyframe skeleton + loop-closure detection + pose-graph
LM; ``mvslam_tpu_torch.backend.slam``) and also writes the optimized
trajectory (``trajectory_optimized.tum``). The back-end's state is not
checkpointed: ``--checkpoint`` and ``--resume`` combined with
``--pose-graph`` are refused instead of ignored.

The default mode reads a dataset of JPEG frames through the native
prefetching loader (``io.native_loader``: libjpeg, decode-ahead on host
threads) when it builds here, and every other dataset through
``io.image`` (PIL), as the JAX package's app does; ``--pose-graph`` reads
through PIL.

Everything runs on the card unless ``--device cpu`` is given.

Usage:
    python -m mvslam_tpu_torch.apps.visual_odometer DATASET_DIR
        [--out-dir OUT] [--checkpoint CKPT] [--resume CKPT] [--max-frames N]
        [--quiet] [--pose-graph] [--keyframe-every N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from mvslam_tpu_torch import config
from mvslam_tpu_torch.backend.slam import BackendParams, PoseGraphBackend
from mvslam_tpu_torch.frontend import FrameManager, VisualOdometer
from mvslam_tpu_torch.frontend.vo_jit import (
    VoJitParams, make_vo_step, vo_init_state,
)
from mvslam_tpu_torch.io import (
    iter_directory, load_image_grayscale, native_loader, read_manifest,
)
from mvslam_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.utils.errors import ApplicationErrorCode
from mvslam_tpu_torch.viz import save_scene_ply, save_trajectory_tum


def _trajectory(poses) -> list[tuple]:
    """[(frame_idx, R, t)] numpy -> [(frame_idx, time, SE3)]."""
    return [(idx, 0.1 * (idx + 1),
             SE3(torch.from_numpy(R), torch.from_numpy(t)))
            for idx, R, t in poses]


def run_pose_graph(frames, cam: PinholeCamera, backend: PoseGraphBackend,
                   out_dir: str, quiet: bool = True, names=None):
    """The ``--pose-graph`` replay: every frame of ``frames`` (an iterable
    of (H, W) float32 arrays or tensors in [0, 1]) through the fused
    tracker and ``backend.add_frame`` on ``backend.device``, then the files
    into ``out_dir``. ``names`` labels the frames in the per-frame report
    (``quiet=False``, which reads the pose on every frame). Returns the
    tracker's final state."""
    dev = backend.device
    K = cam.K.detach().cpu().numpy().astype(np.float64)
    K_inv = torch.tensor(np.linalg.inv(K), dtype=torch.float32, device=dev)
    focal = torch.tensor(K[0, 0], dtype=torch.float32, device=dev)
    params = VoJitParams()
    step = make_vo_step(params)
    state = vo_init_state(params, device=dev)
    n_frames = 0
    t_start = time.time()
    for i, img in enumerate(frames):
        image = torch.as_tensor(img, dtype=torch.float32).to(dev)
        state, out = step(state, image, K_inv, focal)
        loops = backend.add_frame(i, state, out)
        n_frames += 1
        if not quiet:
            t = out.pose_t.cpu().numpy().round(4)
            name = f" [{names[i]}]" if names is not None else ""
            extra = f" LOOP->kf{loops}" if loops else ""
            print(f"frame {i + 1}{name}: "
                  f"{'tracked' if bool(out.success) else 'lost'} "
                  f"inliers={int(out.num_inliers)} t={t}{extra}",
                  file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.time() - t_start
    print(f"frame_total = {int(state.frame_total)}, "
          f"frame_tracked = {int(state.frame_tracked)}, "
          f"keyframes = {len(backend.keyframes)}, "
          f"loop_edges = {len(backend.loop_edges)}, "
          f"fps = {n_frames / max(elapsed, 1e-9):.2f}")

    os.makedirs(out_dir, exist_ok=True)
    raw_traj = _trajectory(backend.raw_poses())
    if raw_traj:
        tum = os.path.join(out_dir, "trajectory.tum")
        save_trajectory_tum(tum, raw_traj)
        ply = os.path.join(out_dir, "scene.ply")
        save_scene_ply(ply, state.map_pos[state.map_valid],
                       [p for _, _, p in raw_traj])
        print(f"wrote {tum} and {ply}")
    if len(backend.keyframes) >= 2:
        corrected = backend.correct_trajectory(backend.optimize())
        tum_opt = os.path.join(out_dir, "trajectory_optimized.tum")
        save_trajectory_tum(tum_opt, _trajectory(corrected))
        print(f"wrote {tum_opt}")
    return state


def _run_pose_graph(args, cam: PinholeCamera, image_paths) -> int:
    """Fused tracker + pose-graph back-end replay (``--pose-graph``)."""
    backend = PoseGraphBackend(
        BackendParams(keyframe_every=args.keyframe_every),
        focal=float(cam.K[0, 0]), device=args.device)
    run_pose_graph((load_image_grayscale(p) for p in image_paths), cam,
                   backend, args.out_dir or args.dataset, quiet=args.quiet,
                   names=[os.path.basename(p) for p in image_paths])
    return ApplicationErrorCode.NONE


def run_visual_odometer(frames, fm: FrameManager, vo: VisualOdometer,
                        out_dir: str, quiet: bool = False, names=None,
                        checkpoint: str | None = None):
    """The default replay: every frame of ``frames`` (an iterable of (H, W)
    float32 arrays or tensors in [0, 1]) through ``fm.add_frame`` and
    ``vo.add_frame`` on their device, then the summary line, the files
    into ``out_dir`` and, with ``checkpoint``, the odometer's state.
    ``names`` labels the frames in the per-frame report (``quiet=False``,
    which reads the pose on every frame); frame ``i`` is stamped ``0.1 *
    (i + 1)`` seconds. Returns the per-frame results."""
    results = []
    t_start = time.time()
    for i, img in enumerate(frames):
        frame = fm.add_frame(0.1 * (i + 1), img)
        res = vo.add_frame(frame)
        results.append(res)
        if not quiet:
            pose = vo.get_camera_pose()
            t = None if pose is None else pose.t.cpu().numpy().round(4)
            name, total = "", ""
            if names is not None:
                name, total = f" [{names[i]}]", f"/{len(names)}"
            print(f"frame {i + 1}{total}{name}: "
                  f"{'tracked' if res.success else 'lost'} ({res.reason}) "
                  f"inliers={res.num_inliers} t={t}", file=sys.stderr)
    if vo.device.type == "cuda":
        torch.cuda.synchronize(vo.device)
    elapsed = time.time() - t_start
    print(f"frame_total = {vo.frame_total}, "
          f"frame_tracked = {vo.frame_tracked}, "
          f"map_points = {vo.num_tracked_points}, "
          f"fps = {len(results) / max(elapsed, 1e-9):.2f}")

    os.makedirs(out_dir, exist_ok=True)
    if vo.trajectory:
        tum = os.path.join(out_dir, "trajectory.tum")
        save_trajectory_tum(tum, vo.trajectory)
        ply = os.path.join(out_dir, "scene.ply")
        save_scene_ply(ply, vo.get_tracked_points(),
                       [p for _, _, p in vo.trajectory])
        print(f"wrote {tum} and {ply}")
    if checkpoint:
        save_checkpoint(vo, checkpoint)
        print(f"wrote {checkpoint}")
    return results


def frame_source(image_paths):
    """The default mode's frames, in order, as (H, W) float32 CPU tensors:
    through the native prefetch loader (decode-ahead) when it is available
    and every path is a JPEG, through PIL otherwise."""
    if native_loader.available() and all(
            p.lower().endswith((".jpg", ".jpeg")) for p in image_paths):
        with native_loader.PrefetchLoader(image_paths) as it:
            for _, arr in it:
                yield torch.from_numpy(arr)
    else:
        for path in image_paths:
            yield load_image_grayscale(path)


def _run_visual_odometer(args, cam: PinholeCamera, image_paths) -> int:
    """FrameManager -> VisualOdometer replay (the default mode)."""
    fm = FrameManager(camera=cam, device=args.device)
    vo = VisualOdometer(device=args.device)
    if args.resume:
        load_checkpoint(args.resume, vo)
    run_visual_odometer(frame_source(image_paths), fm,
                        vo, args.out_dir or args.dataset, quiet=args.quiet,
                        names=[os.path.basename(p) for p in image_paths],
                        checkpoint=args.checkpoint)
    return ApplicationErrorCode.NONE


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="visual-odometer", description=__doc__)
    ap.add_argument("dataset", help="directory with camera.config + image.txt")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--checkpoint", default=None, help="save state here at end")
    ap.add_argument("--resume", default=None, help="restore state before replay")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--pose-graph", action="store_true",
                    help="fused tracker + keyframe/loop-closure back-end")
    ap.add_argument("--keyframe-every", type=int, default=5,
                    help="tracked frames per keyframe (with --pose-graph)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)

    if args.pose_graph and (args.checkpoint or args.resume):
        print("--checkpoint and --resume are not supported with "
              "--pose-graph (the back-end's state is not checkpointed)",
              file=sys.stderr)
        return ApplicationErrorCode.INVALID_ARGS

    cam_path = os.path.join(args.dataset, "camera.config")
    manifest = os.path.join(args.dataset, "image.txt")
    if not os.path.isfile(cam_path):
        print(f"missing {cam_path}", file=sys.stderr)
        return ApplicationErrorCode.INVALID_ARGS
    param_path = os.path.join(args.dataset, "system.param")
    if os.path.isfile(param_path):
        config.load_from_file(param_path)
    if os.path.isfile(manifest):
        image_paths = read_manifest(manifest)
    else:
        image_paths = list(iter_directory(args.dataset, ".jpg"))
    if not image_paths:
        print("no images found", file=sys.stderr)
        return ApplicationErrorCode.BAD_IO
    if args.max_frames:
        image_paths = image_paths[: args.max_frames]

    try:
        cam = PinholeCamera.load_from_file(cam_path)
    except (OSError, ValueError) as e:
        print(f"bad camera config: {e}", file=sys.stderr)
        return ApplicationErrorCode.BAD_DATA
    if args.pose_graph:
        return _run_pose_graph(args, cam, image_paths)
    return _run_visual_odometer(args, cam, image_paths)


if __name__ == "__main__":
    raise SystemExit(main())
