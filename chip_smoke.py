"""GPU smoke run of the PyTorch port: builds the CUDA corner kernel (K1) and
the two-frame BA kernel (K2), checks both of K1's wrappers against its
plain version, times its one launch per pyramid (eager call, CUDA-graph
replay) beside the plain version and the card's bound, checks K2 against
the plain BA body in float32 and float64 at the tracker's shapes and times
it the same way, checks the 8-point DLT solver on the card against the CPU
and float64 eigh and times it (``solver``), checks the tracker on the card
against the tracker on the CPU, holds the port to the JAX package's own
tests' bars on the card (``reference bars``: the 40-frame yawing sequence
of tests/test_rotation.py through the replay, the tracker's bootstrap
fallbacks and pipelined split,
the two-view, PnP and BA solves of the reference's rigs in float64 and
float32), then drives the tracker's main path (110-frame replay) on the
card and times it. Then the SLAM path: the 90-frame closed loop through the
``visual_odometer --pose-graph`` app function (tracker, keyframes, loop
closure, Sim3 and SE3 pose graphs, corrected trajectory, files) and again
with the tracker's other seeds, each run held to the loop-closure bars, the
back-end on the card against the back-end on the CPU from the same tracker
snapshots (with the host reads of ``add_frame`` counted), and the sparse
bundle adjustment at the bench's size. Then the host-orchestrated front
end (``host vo``): the 110-frame scene through the app's default mode
(``FrameManager`` -> ``VisualOdometer``, files written), timed per frame
and per state with its synchronising host reads counted by source line, a
checkpoint saved at frame 60 and resumed to bit-equal poses, and its first
frames on the card against the CPU under the same draws. Then the
remaining entry points: which image codecs the machine has, the
``reconstruct_scene`` app's two-view solve (against the scene's truth and
against the CPU under the same draws), a 20-view ``calibrate_camera``
solve with radial distortion and its undistorted preview (against truth
and the CPU), the native JPEG prefetch loader feeding the app's default
mode, and the threaded 2D viewer and feature demos on the card's features.
Then the ORB options (the batched layout and the subpixel fit: one kernel
launch per image, batched against unrolled, subpixel against the CPU,
launches and ms per call) and the distributed solvers (one NCCL rank
against the ungrouped solves, two gloo ranks on the same card, ms per LM
iteration with and without the group).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; imports neither JAX nor
the JAX package. PIL and libjpeg's headers are optional: a phase that needs
one says on its own line what it could not check without it. Each phase prints its result; any failure raises and the
script exits non-zero. The last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mvslam_tpu_torch import convert, parallel
from mvslam_tpu_torch.apps import calibrate_camera, demos, reconstruct_scene
from mvslam_tpu_torch.apps.visual_odometer import (
    _run_visual_odometer, run_pose_graph, run_visual_odometer,
)
from mvslam_tpu_torch.backend.slam import BackendParams, PoseGraphBackend
from mvslam_tpu_torch.frontend import (
    FrameManager, ImagePairParams, VisualOdometer, VoState,
)
from mvslam_tpu_torch.frontend.vo_jit import (
    VoJitParams, make_vo_pipelined, make_vo_replay, make_vo_step,
    vo_init_state,
)
from mvslam_tpu_torch.io import load_image_grayscale, native_loader
from mvslam_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from mvslam_tpu_torch.math import fma, linalg
from mvslam_tpu_torch.math.lie import SE3, so3_exp, so3_from_rpy, so3_log
from mvslam_tpu_torch.ops import ba as ba_dense
from mvslam_tpu_torch.ops import (
    ba_cuda, ba_sparse, features, features_cuda, pnp, sfm,
)
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.parallel import dist_ba_sparse
from mvslam_tpu_torch.parallel.synthetic import (
    make_sequence_ba_problem, make_window_ba_problem,
)
from mvslam_tpu_torch.utils import cuda_build
from mvslam_tpu_torch.utils.scene import ellipse_loop, render_planes_sequence
from mvslam_tpu_torch.utils.timing import cuda_ms, graph_ms, sync_sites
from mvslam_tpu_torch.viz import Visualizer2d, load_trajectory_tum

KERNEL_SOURCE = "mvslam_tpu_torch/csrc/fast_nms_harris.cu"
KERNEL_REPLACES = "mvslam_tpu/ops/features_pallas.py:142"
BA_KERNEL_SOURCE = "mvslam_tpu_torch/csrc/ba_two_frame.cu"
#: no TPU kernel: the JAX package leaves the LM loop to XLA
BA_KERNEL_REPLACES = "the plain LM loop of mvslam_tpu_torch/ops/ba.py"
#: where float32 resolves the bottom subspace (eigenvalues 0, 1e-10, 1e-3,
#: ... of the scale for the pair; 0, 0.05, ... for one vector), the
#: solver's span against float64 eigh (radians): the float32 rounding of
#: the matrix over the gap, eps32 * trace / gap = 6e-4 and 1.2e-5
SOLVER_EIGH_ANGLE = {"two": 1e-3, "one": 3e-5}
#: Harris agreement on corners, relative to the level's max |Harris|:
#: direct 7-tap sums (kernel) against cumsum differences (plain version)
HARRIS_RTOL = 1e-5
#: card-vs-CPU tracker poses over 8 frames (unit: the bootstrap baseline).
#: float32 reductions run in another order on each device, and this scene's
#: third tracked frame amplifies rounding: on the CPU a one-ulp change of
#: K^-1 flips that frame from accept to reset, and the JAX tracker and the
#: port, fed the same draws, differ there by 4.3e-2. On the card the kernel
#: and the plain corner front give bit-identical poses, so the drift is not
#: the kernel's. The bound sits at the bootstrap's own 0.1 z-translation
#: gate.
PARITY_T_ATOL = 0.1
PARITY_R_ATOL = 5e-3
MIN_TRACKED_FRAC = 0.9          # tests/test_long_sequence.py's bar
MIN_RUN = 20                    # frames in the longest tracked run

H, W, FOCAL = 288, 384, 300.0   # the bench's synthetic scene
TIMING_REPS = 50

# -- reference bars: the JAX package's own tests' bars, held on the card ----
ROT_FRAMES = 40                 # tests/test_rotation.py
ROT_MIN_TRACKED = 36            # 0.9 of the frames
ROT_MIN_SEGMENT = 24            # the longest tracked segment, 0.6 of them
ROT_MIN_SWING = 0.08            # rad of true yaw inside that segment
ROT_MIN_CHECKED = 6             # segments this long are held to the two below
ROT_MAX_RESID = 0.01            # rad, yaw residual after the segment's offset
ROT_SLOPE = (0.93, 1.07)        # estimated yaw regressed on the true yaw
BRANCH_FRAMES = 8
#: the fallback walk (tests/test_vo_jit.py's construction on the synthetic
#: scene, frames 0, 2 and 4): ring rays of frame 0 perturbed by 0.13 px,
#: a loose gate that takes the first slot walked, and the reference's gate
BRANCH_PERTURB_PX = 0.13
BRANCH_LOOSE_GATE = 2.0
BRANCH_GATE = 0.10
BRANCH_BASELINE_ATOL = 0.08     # the bootstrap past a blank frame vs truth
BRANCH_SEEDS = 12               # draw seeds scanned for the two cases
PIPELINE_ATOL = 1e-5            # pipelined split vs fused step, |dt|
#: tests/conftest.py's tol_for: |ln| pose error of the two-view, PnP and
#: BA solves from truth (points: 10x), and here card vs CPU
GEOM_TOL = {torch.float64: 1e-3, torch.float32: 5e-3}
#: tests/helpers.py's CUBE and L_SHAPE rigs
RIGS = {
    "cube": np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)], np.float64),
    "l_shape": np.array([[1, 0, 0], [0, 0, 0], [0, 2, 0], [1, 0, 3],
                         [0, 0, 3], [0, 2, 3], [0.5, 0.0, 1.5],
                         [0.0, 1.0, 1.5]], np.float64),
}

# -- the SLAM path: the closed ellipse of tests/test_loop_closure.py --------
LOOP_H, LOOP_W, LOOP_FOCAL, LOOP_FRAMES = 240, 320, 280.0, 90
#: tracker seeds the loop is run with; seed 0 is the app's own run. The
#: loop-closure bars below are those of tests/test_loop_closure.py, which
#: holds one run (the JAX tracker's key 0) to them. Whether a run meets them
#: is decided by a hair: the tracker's accept gate on the two-frame BA's
#: mean error (9.0) trips while PnP has 150-250 inliers in hand, and the
#: reset that follows splits the loop into segments that no loop edge
#: joins. One fresh triangulation does it: a wrong match 12-31 px off in
#: the new frame passes the 16 px two-ray consistency gate (which depends
#: on the RANSAC pose) and enters a Gaussian BA at sigmas of 0.02 and 0.25
#: px, where it alone lifts the mean above 9 (``card_vs_cpu.py --why-lost``).
#: Another draw flips it, and so does another device's rounding under the
#: same draws; the JAX tracker loses the loop on 2 of its keys 0..7 and
#: comes within 6.65-8.03 of the gate on the others
#: (``tests/loop_seed_scan.py``). So the phase runs every seed, reports
#: which bars each meets, and needs MIN_PASSING_SEEDS of them to meet all;
#: it stops scanning at the first that does.
#: Measured on the card: seeds 3, 4, 5 keep the loop whole, seeds 3 and 5
#: meet every bar (seed 4 ends at 0.053 from a raw error of only 0.186:
#: x3.5, under the x4 bar): a margin of one.
LOOP_SEEDS = 6
MIN_PASSING_SEEDS = 1
MIN_KEYFRAMES = 10
S_REL_RANGE = (0.8, 1.25)       # every accepted edge's measured scale ratio
MAX_CLOSURE = 0.08              # optimized closure error, ground-truth units
MIN_CLOSURE_GAIN = 4.0          # raw closure error / optimized
#: back-end on the card vs on the CPU from the same tracker snapshots and
#: uniforms. Loop-edge translations relative to the edge's length (or 1):
#: a float32 P3P resection and a 15-iteration BA polish whose reductions run
#: in another order on each device. Graphs on ONE skeleton are float64 on
#: both devices; on each device's OWN skeleton the edge differences pass
#: through the graph, bounded relative to the trajectory's extent.
SLAM_EDGE_RTOL = 2e-3
SLAM_GRAPH_ATOL = 1e-6
SLAM_OWN_RTOL = 2e-3
#: sparse BA at the bench's size, float32, card vs CPU on identical inputs:
#: final cost relative; poses relative to the 127.5-unit trajectory (the
#: chain is anchored at frame 0 only, its global scale is a weak mode)
SBA_COST_RTOL = 1e-2
SBA_POSE_RTOL = 1e-3

# -- the host-orchestrated front end (FrameManager -> VisualOdometer) --------
HOST_VO_FRAMES = 110            # the tracker replay's scene
HOST_VO_SAVE_AT = 60            # frames fed before the checkpoint
#: What this path delivers on this scene, in both packages (on the CPU the
#: JAX package's odometer and the port's agree frame by frame over its
#: first 24 frames): the accept gate on the two-frame BA's mean error (9.0)
#: trips on every second or third frame at errors of 10-48, and the reset
#: costs that frame; the bootstrap that follows succeeds at once. So about
#: six frames in ten are tracked, in runs of 2-7, too short and too noisy
#: (+-0.3 baselines across the path) for the fused tracker's bar of 5 % of
#: the run's span. The limits below are set from the first run on the card
#: (see PERF.md) with the margins stated, and hold the path to what it
#: does, not to what the fused tracker does. That run (NVIDIA H100 80GB
#: HBM3, 700 W) and the CPU both tracked 67 of 110 (25 tracked, 42
#: bootstraps), longest run 7 frames with a drift of 0.254 of its span. The
#: margins: 10 frames (five more resets), 3 frames of the run, 0.15.
HOST_VO_MIN_TRACKED = 57        # of 110
HOST_VO_MIN_RUN = 4             # frames in the longest tracked run
HOST_VO_MAX_DRIFT = 0.4         # of the longest run's span
#: frames of the pass that counts synchronising reads, of the profiled
#: window and of the pass at 10 BA iterations (each covers both states)
HOST_VO_SYNC_FRAMES = 40
HOST_VO_PROFILED = 8
HOST_VO_SHORT_BA = 20
#: card vs CPU over the first frames under the same draws: inlier counts
#: (a boundary point may fall on either side of the PnP gate) and poses
#: (PARITY_T_ATOL, PARITY_R_ATOL: the fused tracker's bars)
HOST_VO_PARITY_FRAMES = 8
HOST_VO_INLIER_TOL = 3

# -- the remaining entry points (reconstruct, calibration, loader, viewer) -----
#: reconstruct-scene: frames 0 and 4 of the tracker replay's scene, held to
#: the scene's truth (rad) and, under the same RANSAC draws, card against
#: CPU (inliers; rad)
REC_FRAMES = (0, 4)
REC_MAX_ROT = 1e-2
REC_MAX_DIR = 5e-2
REC_INLIER_TOL = 3
REC_PARITY_ROT = 1e-3
REC_PARITY_DIR = 1e-2
#: calibrate-camera: the 9x6 inner-corner board of OpenCV's sample set
#: (samples/data/left*.jpg, 640x480), 20 views, projected through a known
#: camera and radial lens with 0.05 px noise; float64, 60 Gauss-Newton
#: iterations, distortion on, an undistorted 640x480 preview
CAL_H, CAL_W, CAL_VIEWS, CAL_ROWS, CAL_COLS = 480, 640, 20, 6, 9
CAL_K = np.array([[536.07, 0.0, 342.37], [0.0, 536.02, 235.54],
                  [0.0, 0.0, 1.0]])
CAL_DIST = np.array([-0.25, 0.08])
CAL_NOISE_PX = 0.05
CAL_ITERATIONS = 60
CAL_MAX_F_ERR = 2.0             # px, fx and fy against truth
CAL_MAX_K1_ERR = 0.02
CAL_MAX_RMS = 0.3               # px
CAL_RTOL = 1e-6                 # K and dist, card against CPU
#: the preview, card against CPU: from the same K and dist (the resampling
#: alone), and end to end. The two solves part at 1e-10..1e-9 of K
#: (float64 reductions in another order over 60 iterations), which moves a
#: sample by up to ~1e-6 px at the image's edge: 2.1e-8 of a gray level on
#: the card's first run (NVIDIA H100 80GB HBM3, 700 W); the end-to-end
#: limit is set a factor 50 above it
CAL_PREVIEW_ATOL = 1e-9
CAL_PREVIEW_E2E_ATOL = 1e-6
#: solves per mode of the call-to-call probe of the float64 solve
CAL_PROBE_CALLS = 5
#: native loader: the first frames of the replay scene as JPEG through the
#: app's default mode
LOADER_FRAMES = 30

# -- the ORB options and the distributed layer ------------------------------
#: orb_detect's two options at default OrbParams() (512 features, 8 levels)
#: on the bench's frame and a 480x640 frame. batched against unrolled on
#: the card: equal but for the angles, whose moment sums reduce over one
#: level's or all K keypoints (2.4e-7 rad on the CPU); subpixel on the card
#: against the CPU from the same pyramid: the fits read a float64 Harris
#: surface on both, positions in px of the keypoint's level
ORB_FRAMES = ((H, W, FOCAL), (480, 640, 500.0))
ORB_ANGLE_ATOL = 1e-6
ORB_SUBPIXEL_ATOL = 1e-4
ORB_TIMING_REPS = 20
#: the distributed solvers on the card: the sparse problem of
#: phase_sparse_ba, a dense 8-frame x 512-point window (float32, default
#: BAParams: 50 masked LM iterations, covariances) and the loop's keyframe
#: skeleton (float64 graphs). One rank on NCCL must equal the ungrouped
#: solves bitwise; two ranks on gloo, both processes on this card, within
#: DIST_RTOL of the ungrouped solve, relative to the poses' extent
DIST_WORLD = 2
DIST_RTOL = 1e-4
#: the sparse solve of phase_sparse_ba: 10 LM x 20 CG, no early stop
DIST_SBA_PARAMS = ba_sparse.SparseBAParams(
    max_iterations=10, cg_iterations=20, rel_decrease=0.0, lambda_max=1e30)
DIST_TIMEOUT_S = 300
DIST_REPS = 3

#: published peaks of one H100 SXM: HBM3 bytes/s, float32 outside the
#: tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
#: float32 operations of the corner front. Every pixel: the 4-pixel compass
#: test (4 x 2 margins of 2 ops, 8 compares), Sobel and the three products
#: (26), strict NMS and the border test (10). Every compass candidate: 32
#: margins of 2 ops, two arc searches of 64 min + 15 max, the final max.
#: Every corner inside the border: 3 x 49 adds and Harris (8).
FLOPS_PER_PIXEL = 24 + 26 + 10
FLOPS_PER_CANDIDATE = 64 + 2 * 79 + 2
FLOPS_PER_CORNER = 147 + 8
#: float32 operations of the two-frame BA kernel, a point an iteration,
#: counted from its source: two observations linearised (~200), Hpp and bp
#: (~130), the 3x3 inverse (~40), Hcp and W (~290), the point's 90 terms of
#: the reduced system (~760) and their column sums (90), the point's step
#: (~90) and the candidate's cost (~90). Bytes a point, read or written
#: once: point, prior and information, two observations, masks and
#: weights in (86); point and information out (48).
BA_FLOPS_PER_POINT_ITERATION = 1700
BA_BYTES_PER_POINT = 86 + 48

#: the two-frame BA at the main path's shapes: tsukuba.track's 512 points
#: and kitti.track's 2,048, Huber off and at the KITTI deployment's
#: sqrt(5.991); the tracker's settings (10 iterations, the first pose held
#: by a 1e10 prior, map priors on three quarters of the points)
BA_POINTS = (512, 2048)
#: the settings the cells run, timed: (points, Huber)
BA_TIMED = ((512, False), (2048, True))
BA_HUBER = math.sqrt(5.991)
BA_FOCAL = 718.856
BA_SEED = 20
#: How far the kernel's solve and the plain body's, both float32 on the
#: card, may lie from the plain body's float64 solve on the same problem
#: where that has converged in the tracker's 10 iterations: the largest
#: rotation between their poses (rad), the largest pose centre gap over
#: the baseline, the largest point gap in the float64 solve's sigmas, the
#: cost's relative gap. tests/test_torch_cuda_ba.py's TOL_SETTLED: a few
#: times the largest the plain float32 body reads over 64 seeds of its
#: settled cases (1.1e-6 rad, 9.9e-5, 0.028 sigma, 1.2e-6). A float32
#: neighbour of the minimum passes, a wrong term does not.
BA_TOL = (4e-6, 4e-4, 0.1, 5e-6)
#: Where the float64 solve is still descending at the cap (the problems
#: with Huber on), both float32 solves stop at neighbouring iterates: the
#: poses and the cost within a few times what the plain float32 body reads
#: on these problems on an H100 (at 2,048 points 3.1e-6 rad, 2.8e-4 of the
#: baseline, 3.1e-3 of the cost; the kernel 1.3e-6, 8.5e-5, 1.8e-3). The
#: point gap is not held: the float64 solve's point information counts a
#: down-weighted observation at full weight.
BA_TOL_UNSETTLED = (2e-5, 2e-3, math.inf, 1e-2)
#: K2's wrapper calls on each driven path, each count set to 0 just
#: before that path's run and read just after: one per eager launch and
#: one per CUDA-graph capture (a replay launches a captured kernel again
#: with no host call)
BA_CALLS: dict[str, int] = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bench_trajectory(n: int) -> np.ndarray:
    i = np.arange(n)
    return np.stack([i * 0.12, 0.03 * np.sin(i * 0.25), np.zeros(n)], 1)


def intrinsics_inv(dev, h: int = H, w: int = W,
                   focal: float = FOCAL) -> torch.Tensor:
    """K^-1 of the centred pinhole camera, inverted in float64, as float32
    on ``dev``."""
    cam = PinholeCamera.from_params(focal, focal, 0.0, (w - 1) / 2,
                                    (h - 1) / 2, dtype=torch.float64)
    return cam.K_inv.to(dev, torch.float32)


def compass_candidates(img: torch.Tensor, threshold: float) -> int:
    """Pixels whose FAST score can be non-zero: at least two of the four
    compass ring pixels brighter than c + t, or two darker than c - t (a
    9-long arc of the 16-ring covers two of them). The arc search is needed
    for these alone."""
    c = img[3:-3, 3:-3]
    ring = torch.stack([img[3:-3, 6:], img[6:, 3:-3], img[3:-3, :-6],
                        img[:-6, 3:-3]])
    bright = (((ring - c) - threshold) > 0).sum(0)
    dark = (((c - ring) - threshold) > 0).sum(0)
    return int(((bright >= 2) | (dark >= 2)).sum())


def k1_bound(levels, ranks, orb: features.OrbParams) -> dict:
    """Least time the card could take for the corner front of ``levels``:
    the larger of bytes over the memory rate and float32 operations over
    the float32 rate, both counted from this data."""
    pixels = sum(lv.numel() for lv in levels)
    candidates = sum(compass_candidates(lv, orb.fast_threshold)
                     for lv in levels)
    corners = sum(int(torch.isfinite(r).sum()) for r in ranks)
    nbytes = pixels * (4 + 4)               # each level read once, written once
    flops = (pixels * FLOPS_PER_PIXEL + candidates * FLOPS_PER_CANDIDATE
             + corners * FLOPS_PER_CORNER)
    ms_bytes = nbytes / H100_BYTES_PER_S * 1e3
    ms_flops = flops / H100_F32_FLOPS * 1e3
    return dict(pixels=pixels, candidates=candidates, corners=corners,
                bytes=nbytes, flops=flops, bound_ms=max(ms_bytes, ms_flops),
                bound_by="bytes" if ms_bytes >= ms_flops else "operations")


def check_against_plain(got: torch.Tensor, want: torch.Tensor, what: str):
    """Corner sets equal, Harris within HARRIS_RTOL of the level's max;
    returns (max abs error, that error over the level's max)."""
    mg, mw = torch.isfinite(got), torch.isfinite(want)
    if not torch.equal(mg, mw):
        raise AssertionError(f"corner sets differ, {what}: "
                             f"{int((mg != mw).sum())} pixels")
    if not int(mw.sum()):
        return 0.0, 0.0
    err = float((got[mw] - want[mw]).abs().max())
    scale = float(want[mw].abs().max())
    if err > HARRIS_RTOL * scale:
        raise AssertionError(
            f"Harris drift {err} > {HARRIS_RTOL} * {scale}, {what}")
    return err, err / scale


def phase_kernel(dev, orb: features.OrbParams):
    """Both wrappers vs plain on the card at every pyramid level of the
    frames the two driven paths give them (288x384 of the replay, 240x320
    with the slanted background of the loop) and of a 480x640 frame,
    pyramid views vs per-level calls bitwise; then the 288x384 pyramid
    timed as plain, eager call and graph replay."""
    args = (orb.fast_threshold, orb.harris_k, orb.border)
    max_err = worst_rel = 0.0
    levels_checked = 0
    shapes = []
    # the renderer sizes its textures by the whole path: the loop's first
    # frame comes from the render of the whole loop
    for (h, w, focal, ts, bg_slope) in (
            (H, W, FOCAL, bench_trajectory(1), 0.0),
            (LOOP_H, LOOP_W, LOOP_FOCAL, ellipse_loop(LOOP_FRAMES), 0.18),
            (480, 640, 500.0, bench_trajectory(1), 0.0)):
        shapes.append(f"{h}x{w}")
        frame = render_planes_sequence(ts, h=h, w=w, focal=focal,
                                       bg_slope=bg_slope)[0]
        levels = features.pyramid(torch.from_numpy(frame).to(dev), orb)
        launches0 = features_cuda.fast_nms_harris_rank_pyramid.launches
        ranks = features_cuda.fast_nms_harris_rank_pyramid(levels, *args)
        if features_cuda.fast_nms_harris_rank_pyramid.launches != launches0 + 1:
            raise AssertionError("a pyramid call is not one launch")
        for lv, from_pyramid in zip(levels, ranks):
            what = f"level {tuple(lv.shape)}"
            alone = features_cuda.fast_nms_harris_rank(lv, *args)
            plain = features_cuda.fast_nms_harris_rank_ref(lv, *args)
            torch.cuda.synchronize()
            if not torch.equal(from_pyramid, alone):
                raise AssertionError(
                    f"pyramid view != per-level call, {what}")
            if not from_pyramid.is_contiguous():
                raise AssertionError(f"pyramid view not dense, {what}")
            for got in (from_pyramid, alone):
                err, rel = check_against_plain(got, plain, what)
                max_err, worst_rel = max(max_err, err), max(worst_rel, rel)
            levels_checked += 1
        if h == H:
            timing_levels, bound = levels, k1_bound(levels, ranks, orb)

    def plain_pyramid():
        return [features_cuda.fast_nms_harris_rank_ref(lv, *args)
                for lv in timing_levels]

    def kernel_pyramid():
        return features_cuda.fast_nms_harris_rank_pyramid(timing_levels, *args)

    # plain, kernel (eager, then its graph replay), kernel, plain. The
    # levels are in L2 as in the tracker, where the resize just wrote them.
    ms_plain = cuda_ms(plain_pyramid, TIMING_REPS)
    ms_eager = cuda_ms(kernel_pyramid, TIMING_REPS)
    ms_device = graph_ms(kernel_pyramid, TIMING_REPS)
    ms_device2 = graph_ms(kernel_pyramid, TIMING_REPS)
    ms_eager2 = cuda_ms(kernel_pyramid, TIMING_REPS)
    ms_plain2 = cuda_ms(plain_pyramid, TIMING_REPS)
    log(f"kernel vs plain: {levels_checked} levels (the pyramids of "
        f"{', '.join(shapes)} frames), both wrappers: corner "
        f"sets equal, max |dHarris| {max_err:.3e} (worst relative "
        f"{worst_rel:.3e}, bound {HARRIS_RTOL}); pyramid views bitwise equal "
        f"to per-level calls")
    log(f"8-level 288x384 pyramid ({bound['pixels']} pixels, "
        f"{bound['candidates']} arc-search candidates, {bound['corners']} "
        f"corners): one launch; eager {ms_eager:.4f}/{ms_eager2:.4f} ms, "
        f"device (CUDA-graph replay) {ms_device:.5f}/{ms_device2:.5f} ms, "
        f"plain {ms_plain:.4f}/{ms_plain2:.4f} ms (plain, kernel, kernel, "
        f"plain; {TIMING_REPS} reps after 5); bound {bound['bound_ms']:.5f} "
        f"ms by {bound['bound_by']} ({bound['bytes']} bytes, "
        f"{bound['flops']} float32 operations)")
    return dict(max_abs_err=max_err, ms=min(ms_eager, ms_eager2),
                device_ms=min(ms_device, ms_device2),
                plain_ms=min(ms_plain, ms_plain2),
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


@contextlib.contextmanager
def ba_calls(path: str):
    """Count K2's wrapper calls while ``path`` runs, into
    ``BA_CALLS[path]``."""
    ba_cuda.two_frame_solve.launches = 0
    yield
    BA_CALLS[path] = ba_cuda.two_frame_solve.launches


def ba_problem(points: int, huber: bool, dev, dtype) -> ba_dense.BAProblem:
    """The tracker's two-frame BA on a made-up pair: two poses 0.12 apart,
    ``points`` points 5-20 units ahead seen on the ideal plane with
    0.25-1 px of noise (weights focal / sigma px), a twentieth of the
    observations of the points with a prior masked; with ``huber`` a
    hundredth of the second frame's observations moved by 10-30 px (the
    KITTI cell's Huber share is 0.1-0.2%). The start is the truth
    perturbed; the first pose is held by the tracker's 1e10 prior, the
    first three quarters of the points by map priors at 0.05 units. The
    same numbers in every dtype."""
    rng = np.random.default_rng([BA_SEED, points, int(huber)])
    P = points

    def rot(w):
        return so3_exp(torch.tensor(w)).numpy()

    R = np.stack([rot(rng.normal(0, 0.01, 3)), rot(rng.normal(0, 0.01, 3))])
    t = np.array([[0.0, 0.0, 0.0], [0.12, 0.01, 0.02]])
    X = np.c_[rng.uniform(-4, 4, P), rng.uniform(-1.5, 1.5, P),
              rng.uniform(5, 20, P)]
    sig = rng.uniform(0.25, 1.0, (2, P))
    obs = np.zeros((2, P, 2))
    for f in range(2):
        Xc = (X - t[f]) @ R[f]
        obs[f] = (Xc[:, :2] / Xc[:, 2:]
                  + rng.normal(0, 1, (P, 2)) * sig[f, :, None] / BA_FOCAL)
    if huber:
        bad = rng.random(P) < 0.01
        obs[1, bad] += (rng.uniform(10, 30, (int(bad.sum()), 2))
                        * rng.choice([-1, 1], (int(bad.sum()), 2))
                        / BA_FOCAL)
    held = np.arange(P) < 3 * P // 4
    mask = (rng.random((2, P)) > 0.05) | ~held
    R0, t0 = R.copy(), t.copy()
    R0[1] = R[1] @ rot(rng.normal(0, 0.002, 3))
    t0[1] = t[1] + rng.normal(0, 0.01, 3)
    X0 = X + rng.normal(0, 0.05, X.shape)
    info = np.where(held[:, None, None], np.eye(3) / 0.05 ** 2, 0.0)
    pose_info = np.zeros((2, 6, 6))
    pose_info[0] = 1e10 * np.eye(6)

    def T(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    poses0 = SE3(T(R0), T(t0))
    return ba_dense.BAProblem.create(
        poses0, T(X0), T(obs), torch.tensor(mask, device=dev),
        T(BA_FOCAL / sig), pose_prior=poses0, pose_prior_info=T(pose_info),
        point_prior=T(X0), point_prior_info=T(info))


def ba_gaps(res, ref) -> tuple[float, float, float, float]:
    """``res`` against ``ref`` as ``BA_TOL`` measures: the largest rotation
    between their poses, the largest centre gap over the baseline, the
    largest point gap in ``ref``'s sigmas, the cost's relative gap."""
    f64 = torch.float64
    R, t, X, rR, rt, rX, info = (x.detach().cpu().to(f64) for x in (
        res.poses.R, res.poses.t, res.points, ref.poses.R, ref.poses.t,
        ref.points, ref.point_information))
    rot = float(so3_log(R.transpose(-1, -2) @ rR).norm(dim=-1).max())
    trans = float((t - rt).norm(dim=-1).max() / (rt[1] - rt[0]).norm())
    d = X - rX
    point = float(torch.einsum("pi,pij,pj->p", d, info, d)
                  .clamp(min=0).sqrt().max())
    cost = abs(float(res.error) / float(ref.error) - 1)
    return rot, trans, point, cost


def ba_bits(res) -> list:
    return [x.reshape(-1).view(torch.uint8) for x in (
        res.poses.R, res.poses.t, res.points, res.error, res.iterations,
        res.converged, res.point_information)]


def phase_ba_kernel(dev) -> dict:
    """K2 on the card at the main path's shapes (BA_POINTS, Huber off and
    on): one launch a solve, the same bits from two calls, and the
    kernel's solve and the plain body's, both float32, within BA_TOL of
    the plain body's float64 solve (BA_TOL_UNSETTLED where that has not
    converged in the 10 iterations); then the cells' settings (512 points
    without Huber, 2,048 with) timed as eager calls and CUDA-graph replays
    beside the plain body's replay and the card's bound."""
    gaps, times = [], {}
    for P in BA_POINTS:
        for huber in (False, True):
            params = ba_dense.BAParams(
                max_iterations=10, compute_covariance=False,
                compute_point_info=True,
                huber_delta=BA_HUBER if huber else None)
            prob = ba_problem(P, huber, dev, torch.float32)
            n = ba_cuda.two_frame_solve.launches
            k2 = ba_dense.ba_solve(prob, params)
            if ba_cuda.two_frame_solve.launches != n + 1:
                raise AssertionError("a two-frame solve is not one launch")
            again = ba_dense.ba_solve(prob, params)
            plain = ba_dense.ba_solve_plain(prob, params)
            ref = ba_dense.ba_solve_plain(
                ba_problem(P, huber, dev, torch.float64), params)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(ba_bits(k2),
                                                         ba_bits(again))):
                raise AssertionError(f"two K2 calls differ, {P} points")
            g_k2, g_plain = ba_gaps(k2, ref), ba_gaps(plain, ref)
            what = (f"{P} points, Huber {'on' if huber else 'off'}: "
                    f"iterations {int(k2.iterations)} / "
                    f"{int(plain.iterations)} / {int(ref.iterations)}, "
                    f"kernel {', '.join(f'{g:.2e}' for g in g_k2)}, plain "
                    f"float32 {', '.join(f'{g:.2e}' for g in g_plain)}")
            tol = BA_TOL if bool(ref.converged) else BA_TOL_UNSETTLED
            what += f" (bound {tol})"
            gaps.append(what)
            if not all(a <= b for g in (g_k2, g_plain) for a, b in zip(g, tol)):
                raise AssertionError(f"two-frame BA beyond its bound: {what}")
            if (P, huber) not in BA_TIMED:
                continue
            # plain, kernel (eager, then replayed), kernel, plain
            ms_plain = graph_ms(lambda: ba_dense.ba_solve_plain(prob, params),
                                reps=20)
            ms_eager = cuda_ms(lambda: ba_dense.ba_solve(prob, params))
            ms_device = graph_ms(lambda: ba_dense.ba_solve(prob, params),
                                 reps=200)
            ms_device2 = graph_ms(lambda: ba_dense.ba_solve(prob, params),
                                  reps=200)
            ms_eager2 = cuda_ms(lambda: ba_dense.ba_solve(prob, params))
            ms_plain2 = graph_ms(lambda: ba_dense.ba_solve_plain(prob,
                                                                 params),
                                 reps=20)
            its = int(k2.iterations)
            flops = BA_FLOPS_PER_POINT_ITERATION * P * its
            nbytes = BA_BYTES_PER_POINT * P
            ms_flops = flops / H100_F32_FLOPS * 1e3
            ms_bytes = nbytes / H100_BYTES_PER_S * 1e3
            times[f"p{P}"] = dict(
                iterations=its, huber=huber, ms=min(ms_eager, ms_eager2),
                device_ms=min(ms_device, ms_device2),
                plain_ms=min(ms_plain, ms_plain2),
                bound_ms=max(ms_flops, ms_bytes),
                bound_by="operations" if ms_flops >= ms_bytes else "bytes")
            log(f"two-frame BA kernel, {P} points, Huber "
                f"{'on' if huber else 'off'}, {its} iterations: eager "
                f"{ms_eager:.4f}/{ms_eager2:.4f} ms, device (CUDA-graph "
                f"replay) {ms_device:.5f}/{ms_device2:.5f} ms, plain body "
                f"replayed {ms_plain:.3f}/{ms_plain2:.3f} ms (plain, kernel, "
                f"kernel, plain); bound {max(ms_flops, ms_bytes):.6f} ms by "
                f"{times[f'p{P}']['bound_by']} ({flops} float32 operations, "
                f"{nbytes} bytes)")
    log("two-frame BA kernel vs the plain body (float32, card) against the "
        "plain body's float64 solve (rotation rad, centre / baseline, "
        "point sigmas, cost); one launch a solve, two calls bitwise equal: "
        + "; ".join(gaps))
    return times


@contextlib.contextmanager
def library_products():
    """The solver on the CPU as it was: the BLAS's own products and the
    reduction kernel's trace."""
    saved = (fma.fma_matmul, linalg.fma_matmul, linalg.chain_matmul,
             linalg._trace_in_order)
    fma.fma_matmul = linalg.fma_matmul = linalg.chain_matmul = torch.matmul
    linalg._trace_in_order = linalg._trace
    try:
        yield
    finally:
        (fma.fma_matmul, linalg.fma_matmul, linalg.chain_matmul,
         linalg._trace_in_order) = saved


def solve_spans(M: torch.Tensor) -> dict:
    """The amplified solvers' spans of ``M`` (the pair of the 8-point DLT,
    the one vector of PnP and triangulation), as numpy (n, k) bases."""
    v1, v2 = linalg.smallest_eigvecs2_psd(M)
    return {"two": torch.stack([v1, v2], -1).cpu().numpy(),
            "one": linalg.smallest_eigvec_psd(M)[..., None].cpu().numpy()}


def frame1_dlt(dev, params: VoJitParams) -> torch.Tensor:
    """The Gram batch of the first RANSAC of the tracker's frame-1
    bootstrap on the card (frames 0 and 1 of the scene of
    tests/test_torch_vo.py, numpy draws of seed 0)."""
    frames, _ = branch_scene()
    K_inv = intrinsics_inv(dev, LOOP_H, LOOP_W, LOOP_FOCAL)
    focal = torch.tensor(LOOP_FOCAL, dtype=torch.float32, device=dev)
    step, rng, seen = make_vo_step(params), np.random.default_rng(0), []
    solve = linalg.smallest_eigvecs2_psd

    def record(M, *args, **kw):
        if not seen and M.shape[0] == params.ransac_hypotheses:
            seen.append(M.clone())
        return solve(M, *args, **kw)

    linalg.smallest_eigvecs2_psd = record
    try:
        state = vo_init_state(params, device=dev)
        for image in frames[:2]:
            draws = tracker_draws(int(state.mode), params, rng)
            state, _ = step(state, torch.from_numpy(image).to(dev), K_inv,
                            focal, None if draws is None else torch.tensor(
                                draws, dtype=torch.float32, device=dev))
    finally:
        linalg.smallest_eigvecs2_psd = solve
    if not seen:
        raise AssertionError("frame 1 ran no RANSAC batch")
    return seen[0]


def phase_solver(dev, params: VoJitParams, gpu: str) -> None:
    """The 8-point DLT solver: on two near-degenerate batches (the
    tracker's frame-1 bootstrap, a two-plane draw) the card's spans against
    the CPU's and both against float64 eigh, printed (float32 cannot
    resolve these subspaces); on the card held to float64 eigh where
    float32 can; a RANSAC batch's solve timed on the card (cuBLAS) and on
    the CPU (the fixed orders of ``math/fma.py``) beside the BLAS's own
    products."""
    batches = {"frame-1 DLT": frame1_dlt(dev, params),
               "two-plane DLT": dlt_gram(two_plane_dlt(), dev)}
    report = []
    for name, M in batches.items():
        card, cpu = solve_spans(M), solve_spans(M.cpu())
        eig = np.linalg.eigh(M.cpu().double().numpy())[1]
        row = [name]
        for which, k in (("two", 2), ("one", 1)):
            e_card = span_angle(card[which], eig[..., :k])
            e_cpu = span_angle(cpu[which], eig[..., :k])
            row.append(
                f"{which}: card vs CPU max "
                f"{span_angle(card[which], cpu[which]).max():.2e} rad; vs "
                f"float64 eigh median card {np.median(e_card):.3e} CPU "
                f"{np.median(e_cpu):.3e} rad")
        report.append(", ".join(row))
    for which, k in (("two", 2), ("one", 1)):
        M32 = separated_psd(which)
        ref = np.linalg.eigh(M32.astype(np.float64))[1][..., :k]
        ang = float(span_angle(solve_spans(torch.from_numpy(M32).to(dev))[
            which], ref).max())
        if ang >= SOLVER_EIGH_ANGLE[which]:
            raise AssertionError(f"separated batch {which}: {ang} rad from "
                                 "float64 eigh")
        report.append(f"separated batch ({which}) on the card vs float64 "
                      f"eigh {ang:.2e} rad (bound {SOLVER_EIGH_ANGLE[which]})")
    log("solver: " + "; ".join(report))

    M = batches["frame-1 DLT"]
    M_cpu = M.cpu()

    def host_ms(fn, reps: int = 20) -> float:
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    def cpu_library():
        with library_products():
            return linalg.smallest_eigvecs2_psd(M_cpu)

    card_ms = [cuda_ms(lambda: linalg.smallest_eigvecs2_psd(M), 20)
               for _ in range(2)]
    lib1 = host_ms(cpu_library)
    fixed = [host_ms(lambda: linalg.smallest_eigvecs2_psd(M_cpu))
             for _ in range(2)]
    lib2 = host_ms(cpu_library)
    log(f"solver: smallest_eigvecs2_psd of a (256, 9, 9) RANSAC batch (24 "
        f"squarings): card {card_ms[0]:.3f}/{card_ms[1]:.3f} ms on {gpu}; "
        f"CPU fixed orders {fixed[0]:.2f}/{fixed[1]:.2f} ms, the BLAS's own "
        f"products {lib1:.2f}/{lib2:.2f} ms (library, fixed, fixed, "
        f"library; {torch.get_num_threads()} threads)")


def tracker_draws(mode: int, params: VoJitParams, rng):
    """The RANSAC uniforms a step starting in ``mode`` consumes."""
    K = params.orb.max_features
    if mode == 1:
        return rng.uniform(size=(params.init_window,
                                 params.ransac_hypotheses, K))
    if mode == 2:
        return rng.uniform(size=(params.pnp_hypotheses, K))
    return None


def lockstep(frames, params: VoJitParams, dev, h: int, w: int, focal: float):
    """``make_vo_step`` over ``frames`` on the CPU (plain corner front) and
    on the card (kernel), both fed the same numpy-drawn RANSAC uniforms.
    Yields per frame (modes before the step, the card's state before it,
    the draws by mode, the outputs), the dicts keyed "cpu" and "cuda"."""
    rng = np.random.default_rng(2024)
    step = make_vo_step(params)
    sides = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        sides[name] = dict(state=vo_init_state(params, device=d), d=d,
                           K_inv=intrinsics_inv(d, h, w, focal),
                           focal=torch.tensor(focal, dtype=torch.float32,
                                              device=d))
    for frame in frames:
        modes = {k: int(r["state"].mode) for k, r in sides.items()}
        draws = {m: tracker_draws(m, params, rng)
                 for m in sorted(set(modes.values()))}
        before = sides["cuda"]["state"]
        outs = {}
        for k, r in sides.items():
            dr = draws[modes[k]]
            r["state"], outs[k] = step(
                r["state"], torch.from_numpy(frame).to(r["d"]), r["K_inv"],
                r["focal"], None if dr is None else torch.tensor(
                    dr, dtype=torch.float32, device=r["d"]))
        yield modes, before, draws, outs


def phase_parity(dev, params: VoJitParams):
    """8 frames of the bench scene through the tracker on the CPU and on
    the card in lockstep."""
    n = 8
    frames = render_planes_sequence(bench_trajectory(n), h=H, w=W,
                                    focal=FOCAL)
    pairs = []
    for t, (modes, _, _, outs) in enumerate(
            lockstep(frames, params, dev, H, W, FOCAL)):
        if modes["cpu"] != modes["cuda"]:
            raise AssertionError(f"frame {t}: modes differ {modes}")
        pairs.append((outs["cuda"], outs["cpu"]))
    seq = {k: [(int(o.mode), bool(o.success)) for o in side]
           for k, side in (("cuda", [a for a, _ in pairs]),
                           ("cpu", [b for _, b in pairs]))}
    if seq["cpu"] != seq["cuda"]:
        raise AssertionError(f"mode/success sequences differ: {seq}")
    dts = [float((a.pose_t.cpu() - b.pose_t).abs().max()) for a, b in pairs]
    dRs = [float((a.pose_R.cpu() - b.pose_R).abs().max()) for a, b in pairs]
    inl = [(int(a.num_inliers), int(b.num_inliers)) for a, b in pairs]
    dt, dR = max(dts), max(dRs)
    log(f"card vs CPU per frame: |dt| {[f'{v:.2e}' for v in dts]}, "
        f"|dR| {[f'{v:.2e}' for v in dRs]}, inliers (card, cpu) {inl}")
    if not (dt <= PARITY_T_ATOL and dR <= PARITY_R_ATOL):
        raise AssertionError(f"card vs CPU poses differ: |dt| {dt}, |dR| {dR}")
    log(f"card vs CPU: {n} frames, mode/success {seq['cuda']}, "
        f"max |dt| {dt:.3e} (bound {PARITY_T_ATOL}), max |dR| {dR:.3e} "
        f"(bound {PARITY_R_ATOL})")


def rotation_scene():
    """tests/test_rotation.py's sequence: frames and true yaws."""
    i = np.arange(ROT_FRAMES)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(ROT_FRAMES)],
                  1)
    yaws = 0.06 * np.sin(i * 0.3)
    return render_planes_sequence(ts, h=LOOP_H, w=LOOP_W, focal=LOOP_FOCAL,
                                  bg_slope=0.18, yaws=yaws), yaws


def branch_scene():
    """The 8-frame translation scene of tests/test_torch_vo.py (240x320,
    slanted background) and the unit f0 -> f1 baseline."""
    i = np.arange(BRANCH_FRAMES)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25),
                   np.zeros(BRANCH_FRAMES)], 1)
    frames = render_planes_sequence(ts, h=LOOP_H, w=LOOP_W, focal=LOOP_FOCAL,
                                    bg_slope=0.18)
    return frames, (ts[1] - ts[0]) / np.linalg.norm(ts[1] - ts[0])


def yaw_of(R: np.ndarray) -> np.ndarray:
    """Yaw of R_y rotations (..., 3, 3): R[0, 2] = sin, R[2, 2] = cos."""
    return np.arctan2(R[..., 0, 2], R[..., 2, 2])


def tracked_segments(ok) -> list:
    """The tracked runs of ``ok`` as (start, end) frame ranges."""
    segs, start = [], None
    for k, o in enumerate(list(ok) + [False]):
        if o and start is None:
            start = k
        if not o and start is not None:
            segs.append((start, k))
            start = None
    return segs


def rotation_bars(ok: np.ndarray, yest: np.ndarray, yaws: np.ndarray,
                  what: str) -> dict:
    """tests/test_rotation.py's bars on one run; raises on a miss."""
    segs = tracked_segments(ok)
    a, b = max(segs, key=lambda s: s[1] - s[0]) if segs else (0, 0)
    resid, slopes = 0.0, []
    for s0, s1 in segs:
        if s1 - s0 < ROT_MIN_CHECKED:
            continue
        r = yest[s0:s1] - yaws[s0:s1]
        resid = max(resid, float(np.abs(r - np.median(r)).max()))
        A = np.vstack([yaws[s0:s1], np.ones(s1 - s0)]).T
        slopes.append(float(np.linalg.lstsq(A, yest[s0:s1], rcond=None)[0][0]))
    got = dict(tracked=int(ok.sum()), longest=b - a,
               swing=float(np.ptp(yaws[a:b])) if b > a else 0.0,
               max_resid=resid, slopes=slopes)
    if (got["tracked"] < ROT_MIN_TRACKED or got["longest"] < ROT_MIN_SEGMENT
            or got["swing"] < ROT_MIN_SWING or not slopes
            or resid >= ROT_MAX_RESID
            or not all(ROT_SLOPE[0] < s < ROT_SLOPE[1] for s in slopes)):
        raise AssertionError(f"rotation bars missed, {what}: {got}")
    return got


def branch_steps(dev, params: VoJitParams, frames, draw_seed: int) -> dict:
    """The tracker's bootstrap fallbacks on ``dev`` under numpy-drawn
    uniforms (the same on every device): the window past a blank frame, and
    the walk past a ring slot that fails the refined-error gate (the
    construction of tests/test_torch_tracker_branches.py). Returns the
    outputs by case."""
    K_inv = intrinsics_inv(dev, LOOP_H, LOOP_W, LOOP_FOCAL)
    focal = torch.tensor(LOOP_FOCAL, dtype=torch.float32, device=dev)
    step = make_vo_step(params)
    rng = np.random.default_rng(draw_seed)

    def run(state, image, draws=None):
        mode = int(state.mode)
        if draws is None:
            draws = tracker_draws(mode, params, rng)
        return step(state, torch.from_numpy(np.asarray(image)).to(dev),
                    K_inv, focal, None if draws is None else torch.tensor(
                        draws, dtype=torch.float32, device=dev))

    def gate(state, g):
        return state._replace(gate_pair_err=torch.full_like(
            state.gate_pair_err, g))

    out = {}
    state = vo_init_state(params, device=dev)
    for k, image in enumerate((frames[0], np.zeros_like(frames[0]),
                               frames[1])):
        state, out[f"window_{k}"] = run(state, image)
    state = gate(vo_init_state(params, device=dev, seed=4), 1e-9)
    state, _ = run(state, frames[0])
    pert = np.random.default_rng(7).normal(
        scale=BRANCH_PERTURB_PX / LOOP_FOCAL,
        size=(state.rb_rays.shape[1], 2))
    rb = state.rb_rays.clone()
    rb[0, :, :2] += torch.tensor(pert, dtype=rb.dtype, device=dev)
    state, out["walk_f2"] = run(state._replace(rb_rays=rb), frames[2])
    draws = tracker_draws(int(state.mode), params, rng)
    for g in (BRANCH_LOOSE_GATE, BRANCH_GATE):
        _, out[f"walk_{g}"] = run(gate(state, g), frames[4], draws)
    return out


def window_ok(out: dict, baseline: np.ndarray) -> bool:
    """tests/test_vo_jit.py's bar of the window past a blank frame: the
    blank fails, the next frame bootstraps against the frame before the
    blank, along the true baseline."""
    o2, o3 = out["window_1"], out["window_2"]
    return (not bool(o2.success) and bool(o3.success) and int(o3.mode) == 2
            and float(np.abs(o3.pose_t.cpu().numpy() - baseline).max())
            < BRANCH_BASELINE_ATOL)


def walk_ok(out: dict) -> bool:
    """tests/test_vo_jit.py's bar of the fallback walk: the loose gate takes
    the first slot walked (the perturbed oldest) with an error above the
    gate; under the gate the walk goes on to the younger slot, which
    passes with more inliers."""
    hi, lo = out[f"walk_{BRANCH_LOOSE_GATE}"], out[f"walk_{BRANCH_GATE}"]
    return (not bool(out["walk_f2"].success) and bool(hi.success)
            and int(hi.init_tried) == 1 and float(hi.mean_error) > BRANCH_GATE
            and bool(lo.success) and int(lo.init_tried) == 2
            and int(lo.mode) == 2 and float(lo.mean_error) <= BRANCH_GATE
            and int(lo.num_inliers) > int(hi.num_inliers))


def outcomes(out: dict) -> tuple:
    """(success, slots tried) of each step of ``branch_steps``."""
    return tuple((int(bool(o.success)), int(o.init_tried))
                 for o in out.values())


def pipelined_vs_fused(dev, params: VoJitParams, frames) -> float:
    """make_vo_pipelined against make_vo_step over ``frames`` on ``dev``
    (both seeded 0): the same success per frame; returns max |dt|."""
    K_inv = intrinsics_inv(dev, LOOP_H, LOOP_W, LOOP_FOCAL)
    focal = torch.tensor(LOOP_FOCAL, dtype=torch.float32, device=dev)
    step = make_vo_step(params)
    pre, combine = make_vo_pipelined(params)
    fused = vo_init_state(params, device=dev)
    split = vo_init_state(params, device=dev)
    dt = 0.0
    for k, frame in enumerate(frames):
        image = torch.from_numpy(frame).to(dev)
        fused, a = step(fused, image, K_inv, focal)
        f, smooth = pre(image, K_inv, focal)
        split, b = combine(split, f, smooth, K_inv, focal)
        if bool(a.success) != bool(b.success):
            raise AssertionError(f"pipelined vs fused: frame {k} success "
                                 f"{bool(b.success)} != {bool(a.success)}")
        dt = max(dt, float((a.pose_t - b.pose_t).abs().max()))
    if dt > PIPELINE_ATOL:
        raise AssertionError(f"pipelined vs fused |dt| {dt} > {PIPELINE_ATOL}")
    return dt


def rig_points(rig: np.ndarray) -> np.ndarray:
    """An 8-point rig of tests/helpers.py placed as the reference's tests
    place it: rotated by rpy (0.1, -0.2, 0.3), 6 units ahead."""
    R = so3_from_rpy(0.1, -0.2, 0.3, dtype=torch.float64).numpy()
    return rig @ R.T + np.array([0.3, -0.2, 6.0])


def two_plane_dlt(seed: int = 0, n_sets: int = 256) -> np.ndarray:
    """DLT rows (n_sets, 8, 9), float32, of 8-point draws of a two-plane
    scene: a fronto-parallel plane at depth 3 on the left of the image, a
    plane sloping with the image row behind it, the camera moving (0.12,
    0.005, 0), 0.3 px of noise at focal 280 on the second view."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform([-0.55, -0.42], [0.55, 0.42], (300, 2))
    depth = np.where(uv[:, 0] < 0.0, 3.0, 6.0 / (1.0 + 0.18 * uv[:, 1]))
    X = np.concatenate([uv * depth[:, None], depth[:, None]], 1)
    cam2 = X - np.array([0.12, 0.005, 0.0])
    p2 = cam2[:, :2] / cam2[:, 2:] + rng.normal(scale=0.3 / 280.0,
                                                size=(300, 2))
    idx = np.stack([rng.choice(300, 8, replace=False)
                    for _ in range(n_sets)])
    x1, y1 = uv[idx, 0], uv[idx, 1]
    x2, y2 = p2[idx, 0], p2[idx, 1]
    one = np.ones_like(x1)
    return np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one],
                    axis=-1).astype(np.float32)


def dlt_gram(A: np.ndarray, dev="cpu") -> torch.Tensor:
    """``A^T A`` of DLT rows, as the 8-point solve forms it."""
    A = torch.as_tensor(A).to(dev)
    return fma.fma_matmul(A.mT, A)


def span_angle(X: np.ndarray, U: np.ndarray) -> np.ndarray:
    """Largest principal angle (radians) between the column spans of two
    batches of (n, k) bases."""
    Q1 = np.linalg.qr(X.astype(np.float64))[0]
    Q2 = np.linalg.qr(U.astype(np.float64))[0]
    s = np.linalg.svd(np.swapaxes(Q1, -1, -2) @ Q2, compute_uv=False)
    return np.arccos(np.clip(s.min(-1), -1.0, 1.0))


def separated_psd(which: str, n_batch: int = 128) -> np.ndarray:
    """A float32 PSD batch whose bottom subspace float32 resolves (see
    SOLVER_EIGH_ANGLE)."""
    rng = np.random.default_rng(9)
    Q = np.linalg.qr(rng.normal(size=(n_batch, 9, 9)))[0]
    lam = np.sort(rng.uniform(0.05, 1.0, (n_batch, 9)), axis=-1)
    lam[:, 0] = 0.0
    if which == "two":
        lam[:, 1], lam[:, 2] = 1e-10, 1e-3
    return ((Q * lam[:, None, :]) @ np.swapaxes(Q, -1, -2)).astype(np.float32)


def geometry_errors(dev, dtype, rig: np.ndarray, uniforms: dict) -> dict:
    """tests/test_sfm.py's and tests/test_ba.py's solves of one rig on
    ``dev`` in ``dtype``: the largest |ln| pose error from truth and point
    error of ``sfm_solve`` (8 padding rows), ``pnp_solve`` and
    ``sfm_refine``, with the solved poses for a card-vs-CPU comparison."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def project(pose: SE3, X):
        p = pose.inverse().apply(X)
        return p / p[..., 2:3]

    def err(T: SE3, T_gt: SE3) -> float:
        return float((T.log() - T_gt.log()).abs().max())

    X = t(rig_points(rig))
    ident = SE3.identity(dtype=dtype, device=dev)
    rpy = {k: so3_from_rpy(*v, dtype=torch.float64).numpy()
           for k, v in (("pair", (0.05, -0.03, 0.02)),
                        ("pnp", (-0.04, 0.06, 0.1)))}
    out = {}
    # sfm_solve: camera 2 one unit along x, 8 padded rows
    pose = SE3(t(np.eye(3)), t([1.0, 0.0, 0.0]))
    pad = torch.zeros((8, 3), dtype=dtype, device=dev)
    r1 = torch.cat([project(ident, X), pad])
    r2 = torch.cat([project(pose, X), pad])
    mask = torch.arange(16, device=dev) < 8
    res = sfm.sfm_solve(r1, r2, mask, uniforms=t(uniforms["sfm"]))
    if not bool(res.success) or not bool(res.point_mask[:8].all()):
        raise AssertionError("sfm_solve failed")
    out["sfm_solve"] = (err(res.pose2in1, pose), float(
        (res.points[:8] - X).abs().max()), res.pose2in1)
    # pnp_solve: the reference's exact-recovery pose
    pose = SE3(t(rpy["pnp"]), t([0.4, -0.2, 0.3]))
    res = pnp.pnp_solve(X, project(pose, X),
                        torch.ones(8, dtype=torch.bool, device=dev),
                        uniforms=t(uniforms["pnp"]))
    if not bool(res.success) or int(res.num_inliers) != 8:
        raise AssertionError("pnp_solve failed")
    out["pnp_solve"] = (err(res.pose, pose), 0.0, res.pose)
    # sfm_refine: the noiseless two-view BA stays exact
    pose = SE3(t(rpy["pair"]), t([1.0, 0.1, -0.05]))
    res = sfm.sfm_refine(project(ident, X), project(pose, X),
                         torch.ones(8, dtype=torch.bool, device=dev), pose, X,
                         obs_stddev=5e-3)
    if not bool(res.converged):
        raise AssertionError("sfm_refine did not converge")
    out["sfm_refine"] = (err(res.pose2in1, pose),
                         float((res.points - X).abs().max()), res.pose2in1)
    return out


def phase_reference_bars(dev, params: VoJitParams, gpu: str) -> int:
    """The JAX package's own bars, held on the card at full width: the
    rotation path (tests/test_rotation.py through make_vo_replay, against
    the CPU under shared draws), the tracker's bootstrap fallbacks and its
    pipelined split, and the two-view / PnP / BA solves on the reference's
    rigs in float64 and float32. Returns the replay's kernel launches."""
    frames, yaws = rotation_scene()
    images = torch.from_numpy(frames).to(dev)
    K_inv = intrinsics_inv(dev, LOOP_H, LOOP_W, LOOP_FOCAL)
    focal = torch.tensor(LOOP_FOCAL, dtype=torch.float32, device=dev)
    replay = make_vo_replay(params)
    torch.cuda.synchronize()
    features_cuda.fast_nms_harris_rank_pyramid.launches = 0
    t0 = time.perf_counter()
    with ba_calls("rotation"):
        _, outs = replay(vo_init_state(params, device=dev), images, K_inv,
                         focal)
        torch.cuda.synchronize()
    fps = ROT_FRAMES / (time.perf_counter() - t0)
    launches = features_cuda.fast_nms_harris_rank_pyramid.launches
    if launches != ROT_FRAMES:
        raise AssertionError(f"rotation: kernel launches {launches} != "
                             f"{ROT_FRAMES}")
    ok = outs.success.cpu().numpy().astype(bool)
    bars = rotation_bars(ok, yaw_of(outs.pose_R.cpu().numpy()), yaws,
                         "card replay")
    both, dyaw, sides = [], 0.0, {"cpu": [], "cuda": []}
    for modes, _, _, o in lockstep(frames, params, dev, LOOP_H, LOOP_W,
                                   LOOP_FOCAL):
        for k in sides:
            sides[k].append((bool(o[k].success),
                             float(yaw_of(o[k].pose_R.cpu().numpy()))))
        if o["cpu"].success and o["cuda"].success:
            both.append(1)
            dyaw = max(dyaw, abs(sides["cpu"][-1][1] - sides["cuda"][-1][1]))
    for k, rows in sides.items():
        rotation_bars(np.array([r[0] for r in rows]),
                      np.array([r[1] for r in rows]), yaws, f"lockstep {k}")
    if dyaw >= ROT_MAX_RESID:
        raise AssertionError(f"rotation card vs CPU |dyaw| {dyaw}")
    log(f"reference bars, rotation: make_vo_replay {ROT_FRAMES} frames "
        f"{LOOP_H}x{LOOP_W} yawing 0.06 sin(0.3 i): tracked "
        f"{bars['tracked']}/{ROT_FRAMES} (bar {ROT_MIN_TRACKED}), longest "
        f"segment {bars['longest']} (bar {ROT_MIN_SEGMENT}) swinging "
        f"{bars['swing']:.4f} rad, max yaw residual {bars['max_resid']:.5f} "
        f"rad (bar {ROT_MAX_RESID}), slopes "
        f"{[round(s, 4) for s in bars['slopes']]} (bar {ROT_SLOPE}); kernel "
        f"launches {launches}; {fps:.2f} frames/s on {gpu}; card vs CPU "
        f"under shared draws: max |dyaw| {dyaw:.3e} rad over {len(both)} "
        f"frames tracked by both")

    bframes, baseline = branch_scene()
    # whether a draw builds each case is the reference's own lottery (the
    # JAX tracker on this scene: the window fails on 3 of 12 keys, the
    # walk happens on 2 of 12; the port the same on 12 numpy seeds), so
    # scan the draw seeds until the card has shown both
    found, tried = {}, []
    for seed in range(BRANCH_SEEDS):
        card = branch_steps(dev, params, bframes, seed)
        cpu = branch_steps(torch.device("cpu"), params, bframes, seed)
        tried.append((seed, outcomes(card) == outcomes(cpu)))
        for case, ok in (("window", window_ok(card, baseline)),
                         ("walk", walk_ok(card))):
            if ok and case not in found:
                found[case] = (seed, card, float(max(
                    (a.pose_t.cpu() - b.pose_t).abs().max()
                    for a, b in zip(card.values(), cpu.values()))))
        if len(found) == 2:
            break
    if len(found) < 2:
        raise AssertionError(f"tracker branches: over draw seeds {tried} "
                             f"the card showed only {sorted(found)}")
    dt = pipelined_vs_fused(dev, params, bframes)
    wseed, wout, wdt = found["window"]
    kseed, kout, kdt = found["walk"]
    hi, lo = (kout[f"walk_{g}"] for g in (BRANCH_LOOSE_GATE, BRANCH_GATE))
    log(f"reference bars, tracker branches on the card: draw seeds tried "
        f"(seed, card and CPU outcomes equal) {tried}; seed {wseed}: the "
        f"window reaches past a blank frame (t "
        f"{wout['window_2'].pose_t.cpu().numpy()} against the baseline "
        f"{baseline}; card vs CPU |dt| {wdt:.2e}); seed {kseed}: the walk "
        f"takes the oldest slot under a loose gate (tried "
        f"{int(hi.init_tried)}, error {float(hi.mean_error):.4f}) and the "
        f"younger under {BRANCH_GATE} (tried {int(lo.init_tried)}, error "
        f"{float(lo.mean_error):.4f}; card vs CPU |dt| {kdt:.2e}); "
        f"pipelined vs fused {BRANCH_FRAMES} frames max |dt| {dt:.2e} "
        f"(bound {PIPELINE_ATOL})")

    rng = np.random.default_rng(5)
    uniforms = {"sfm": rng.uniform(size=(256, 16)),
                "pnp": rng.uniform(size=(256, 8))}
    worst = {}
    for dtype, tol in GEOM_TOL.items():
        for rig_name, rig in RIGS.items():
            got = geometry_errors(dev, dtype, rig, uniforms)
            ref = geometry_errors(torch.device("cpu"), dtype, rig, uniforms)
            for solver, (e_pose, e_pts, T) in got.items():
                d = float((T.log().cpu() - ref[solver][2].log()).abs().max())
                if e_pose >= tol or e_pts >= 10 * tol or d >= tol:
                    raise AssertionError(
                        f"{solver} {rig_name} {dtype}: pose {e_pose}, points "
                        f"{e_pts}, card vs CPU {d} (bar {tol})")
                w = worst.setdefault((solver, str(dtype)[6:]), [0.0, 0.0])
                w[0], w[1] = max(w[0], e_pose), max(w[1], d)
    log("reference bars, geometry on the card (cube and L rigs; largest "
        "|ln| pose error from truth, then card vs CPU): " + ", ".join(
            f"{s} {dt_} {e:.2e} / {d:.2e} (bar {GEOM_TOL[getattr(torch, dt_)]})"
            for (s, dt_), (e, d) in worst.items()))
    return launches


def phase_main(dev, params: VoJitParams, gpu: str):
    """The main path: 110 frames through make_vo_replay on the card."""
    n = 110
    ts_gt = bench_trajectory(n)
    images = torch.from_numpy(render_planes_sequence(
        ts_gt, h=H, w=W, focal=FOCAL)).to(dev)
    K_inv = intrinsics_inv(dev)
    focal = torch.tensor(FOCAL, dtype=torch.float32, device=dev)
    replay = make_vo_replay(params)

    torch.cuda.synchronize()
    features_cuda.fast_nms_harris_rank_pyramid.launches = 0
    t0 = time.perf_counter()
    with ba_calls("tracker_replay"):
        state, outs = replay(vo_init_state(params, device=dev), images,
                             K_inv, focal)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = features_cuda.fast_nms_harris_rank_pyramid.launches

    tracked = int(state.frame_tracked)
    if tracked < MIN_TRACKED_FRAC * n:
        raise AssertionError(f"tracked {tracked}/{n}")
    if not bool(torch.isfinite(outs.pose_t).all() & torch.isfinite(
            outs.pose_R).all()):
        raise AssertionError("non-finite poses")
    if launches != n:                   # one launch per frame's pyramid
        raise AssertionError(f"kernel launches {launches} != {n}")
    s0, s1, resid, span = longest_run_drift(
        outs.success.cpu().numpy().astype(bool),
        outs.pose_t.cpu().numpy().astype(np.float64), ts_gt)

    passes = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        state, _ = replay(vo_init_state(params, device=dev), images, K_inv,
                          focal)
    torch.cuda.synchronize()
    fps = passes * n / (time.perf_counter() - t0)
    log(f"main path: make_vo_replay {n} frames {H}x{W}, tracked {tracked}/{n}, "
        f"longest run {s1 - s0} with drift {resid:.4f} (bound "
        f"{0.05 * span:.4f}), kernel launches {launches}; first pass "
        f"{first_s:.2f} s, then {fps:.2f} frames/s over {passes} passes "
        f"on {gpu}")
    return launches, n, fps


def longest_run_drift(ok, est_t, ts_gt, min_run: int = MIN_RUN,
                      max_drift: float = 0.05):
    """Trajectory health in the longest tracked run (as in tests/
    test_long_sequence.py): a reset restarts the monocular gauge, so fit
    the scale on x within the run and bound the drift by ``max_drift`` of
    the run's span (5 %: that test's bar). ``ok`` (n,) bool, ``est_t``
    (n, 3) with rows valid where ``ok``. Returns (run start, run end,
    drift, span)."""
    s0, s1 = max(tracked_segments(ok), key=lambda r: r[1] - r[0])
    est = est_t[s0:s1]
    gt = ts_gt[s0:s1] - ts_gt[s0]
    ex = est[:, 0] - est[0, 0]
    s = float((ex @ gt[:, 0]) / max(ex @ ex, 1e-9))
    resid = float(np.abs(s * (est - est[0]) - gt).max())
    span = float(gt[:, 0].max())
    if s1 - s0 < min_run or resid >= max_drift * span:
        raise AssertionError(f"trajectory: run {s1 - s0}/{len(ok)}, drift "
                             f"{resid} vs {max_drift * span}")
    return s0, s1, resid, span


class RecordingBackend(PoseGraphBackend):
    """The back-end with a clock around ``add_frame`` (device drained before
    and after, so the time is the call's own) and the snapshots kept."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = []        # (was a keyframe, keyframes stored before, ms)
        self.snapshots = []    # (frame_idx, state, out)

    def add_frame(self, frame_idx, state, out, uniforms=None):
        self.snapshots.append((frame_idx, state, out))
        n_before = len(self.keyframes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accepted = super().add_frame(frame_idx, state, out, uniforms)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        self.calls.append((len(self.keyframes) > n_before, n_before, ms))
        return accepted


def closure_errors(ts_gt, backend, opt):
    """Raw and optimized loop-closure error as tests/test_loop_closure.py
    measures it: the endpoint's displacement from the anchor keyframe
    against ground truth's, after fitting the monocular scale on the first
    half of the raw trajectory."""
    n = len(ts_gt)
    raw = np.zeros((n, 3))
    for idx, _, t in backend.raw_poses():
        raw[idx] = t
    gt = ts_gt - ts_gt[0]
    half = np.arange(2, n // 2)
    Xc, Gc = raw[half] - raw[half].mean(0), gt[half] - gt[half].mean(0)
    s = float((Xc * Gc).sum() / max((Xc * Xc).sum(), 1e-12))
    kf0 = backend.keyframes[0]
    d_gt_end = gt[-1] - gt[kf0.frame_idx]

    def closure(t_end, t_anchor):
        return float(np.linalg.norm(
            s * (np.asarray(t_end) - np.asarray(t_anchor)) - d_gt_end))

    idx_last, _, t_last = backend.correct_trajectory(opt)[-1]
    if idx_last != n - 1:
        raise AssertionError(f"last corrected frame {idx_last} != {n - 1}")
    return (closure(raw[-1], kf0.pose.t.numpy()),
            closure(t_last, opt.t[0].cpu().numpy()))


def timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def drive_loop(frames, backend, seed: int):
    """The tracker seeded ``seed`` and ``backend`` over ``frames``, frame by
    frame as the app drives them (the app itself takes no seed: it runs the
    tracker's default, 0)."""
    dev = backend.device
    params = VoJitParams()
    step = make_vo_step(params)
    state = vo_init_state(params, device=dev, seed=seed)
    K_inv = intrinsics_inv(dev, LOOP_H, LOOP_W, LOOP_FOCAL)
    focal = torch.tensor(LOOP_FOCAL, dtype=torch.float32, device=dev)
    for i, img in enumerate(frames):
        state, out = step(state, torch.from_numpy(img).to(dev), K_inv, focal)
        backend.add_frame(i, state, out)


def loop_outcome(ts_gt, backend, seed: int) -> dict:
    """What one run over the loop gave, each loop-closure bar with whether
    the run met it, and ``passes``: whether it met them all."""
    tracked = [r[0] for r in backend.raw_poses()]
    lost = sorted(set(range(1, LOOP_FRAMES)) - set(tracked))
    kfs = backend.keyframes
    edges = [dict(j=j, i=i, inliers=n_inl, s_rel=round(s_rel, 4),
                  use_ba=dbg["use_ba"])
             for (j, i, _, n_inl, s_rel), dbg in zip(backend.loop_edges,
                                                     backend.loop_debug)]
    res = dict(seed=seed, tracked=len(tracked), lost=lost,
               keyframes=len(kfs), segments=len({k.segment for k in kfs}),
               edges=edges)
    bars = {"every frame after the first tracked": not lost,
            f">= {MIN_KEYFRAMES} keyframes in one segment":
                len(kfs) >= MIN_KEYFRAMES and res["segments"] == 1,
            f">= 1 loop edge, every s_rel in {S_REL_RANGE}":
                bool(edges) and all(S_REL_RANGE[0] < e["s_rel"]
                                    < S_REL_RANGE[1] for e in edges)}
    corrected = backend.correct_trajectory(backend.optimize(method="sim3"))
    if [c[0] for c in corrected] != tracked or not all(
            np.isfinite(c[2]).all() for c in corrected):
        raise AssertionError(f"seed {seed}: corrected trajectory")
    if not lost:                # the closure is defined on a whole loop
        for method in ("sim3", "se3"):
            backend.optimize(method=method)                    # warm
            opt, ms = timed_ms(lambda: backend.optimize(method=method))
            last = backend.last_result             # of the timed call
            raw_cl, opt_cl = closure_errors(ts_gt, backend, opt)
            res[method] = dict(ms=ms, iterations=int(last.iterations),
                               converged=bool(last.converged), closure=opt_cl)
        res["raw_closure"] = raw_cl
        sim3_cl = res["sim3"]["closure"]
        bars[f"sim3 closure <= raw/{MIN_CLOSURE_GAIN:g}"] = (
            sim3_cl <= raw_cl / MIN_CLOSURE_GAIN)
        bars[f"sim3 closure <= {MAX_CLOSURE}"] = sim3_cl <= MAX_CLOSURE
    res["missed"] = [name for name, met in bars.items() if not met]
    res["passes"] = not res["missed"]
    return res


def phase_slam(gpu: str):
    """The SLAM path on the card through the app's function (arrays in,
    files out) as a user runs it; then the same loop with the tracker's
    other seeds. Every run is held against the loop-closure bars (on a
    whole loop: both graph methods and the corrected trajectory); the
    phase needs MIN_PASSING_SEEDS runs that meet them all and returns the
    first such run's back-end."""
    ts_gt = ellipse_loop(LOOP_FRAMES)
    frames = render_planes_sequence(ts_gt, h=LOOP_H, w=LOOP_W,
                                    focal=LOOP_FOCAL, bg_slope=0.18)
    cam = PinholeCamera.from_params(LOOP_FOCAL, LOOP_FOCAL, 0.0,
                                    (LOOP_W - 1) / 2, (LOOP_H - 1) / 2)
    app_run = RecordingBackend(BackendParams(), focal=LOOP_FOCAL)
    if app_run.device.type != "cuda":
        raise AssertionError(f"back-end defaults to {app_run.device}")
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        features_cuda.fast_nms_harris_rank_pyramid.launches = 0
        t0 = time.perf_counter()
        with ba_calls("slam"):
            run_pose_graph(frames, cam, app_run, out_dir, quiet=True)
        wall_s = time.perf_counter() - t0
        launches = features_cuda.fast_nms_harris_rank_pyramid.launches
        raw_tum = load_trajectory_tum(os.path.join(out_dir, "trajectory.tum"))
        opt_tum = load_trajectory_tum(
            os.path.join(out_dir, "trajectory_optimized.tum"))
        if not os.path.getsize(os.path.join(out_dir, "scene.ply")):
            raise AssertionError("scene.ply is empty")
    if launches != LOOP_FRAMES:         # one launch per frame's pyramid
        raise AssertionError(f"kernel launches {launches} != {LOOP_FRAMES}")
    n_tracked = len(app_run.raw_poses())
    if len(raw_tum) != n_tracked or len(opt_tum) != n_tracked:
        raise AssertionError(f"TUM rows {len(raw_tum)}, {len(opt_tum)} != "
                             f"{n_tracked}")

    # the scan stops at the first run that meets every bar: the phase
    # needs MIN_PASSING_SEEDS (one), and each further seed is 17 s
    runs = [(app_run, loop_outcome(ts_gt, app_run, 0))]
    for seed in range(1, LOOP_SEEDS):
        if sum(r["passes"] for _, r in runs) >= MIN_PASSING_SEEDS:
            break
        backend = RecordingBackend(BackendParams(), focal=LOOP_FOCAL)
        drive_loop(frames, backend, seed)
        res = loop_outcome(ts_gt, backend, seed)
        if not res["passes"]:
            backend.snapshots = []     # only a passing run's are used
        runs.append((backend, res))

    r0 = runs[0][1]
    log(f"slam: {LOOP_FRAMES} frames {LOOP_H}x{LOOP_W} through "
        f"apps.visual_odometer.run_pose_graph (its own seed, 0) on {gpu}: "
        f"tracked {r0['tracked']}/{LOOP_FRAMES}, lost {r0['lost']}, "
        f"{r0['keyframes']} keyframes in {r0['segments']} segment(s), "
        f"{len(r0['edges'])} loop edges; kernel launches {launches}; "
        f"{wall_s:.2f} s wall (first pass, each add_frame drained for its "
        f"clock), files trajectory.tum / trajectory_optimized.tum "
        f"{len(raw_tum)} rows each")
    kf_ms = [(n, ms) for is_kf, n, ms in app_run.calls if is_kf]
    other_ms = [ms for is_kf, _, ms in app_run.calls if not is_kf]
    log(f"slam: add_frame ms on keyframes by stored keyframes "
        f"{[(n, round(ms, 1)) for n, ms in kf_ms]}; on the "
        f"{len(other_ms)} other frames median {np.median(other_ms):.3f}, "
        f"max {max(other_ms):.3f}")
    for _, r in runs:
        line = (f"slam: seed {r['seed']}: {r['tracked']}/{LOOP_FRAMES} "
                f"tracked, lost {r['lost']}, {r['keyframes']} keyframes in "
                f"{r['segments']} segment(s), loop edges {r['edges']}")
        if "sim3" in r:
            line += (
                f"; closure error raw {r['raw_closure']:.4f} -> sim3 "
                f"{r['sim3']['closure']:.4f} (x"
                f"{r['raw_closure'] / max(r['sim3']['closure'], 1e-12):.1f})"
                f", se3 {r['se3']['closure']:.4f} (no bar: the loop-closure "
                f"test holds the Sim3 graph only); optimize(): "
                + ", ".join(f"{m} {r[m]['ms']:.1f} ms, {r[m]['iterations']} "
                            f"LM iterations, converged {r[m]['converged']}"
                            for m in ("sim3", "se3")))
        log(line + (": every bar met" if r["passes"]
                    else f": missed {r['missed']}"))
    passing = [(b, r) for b, r in runs if r["passes"]]
    log(f"slam: tracker seeds 0..{len(runs) - 1} (of 0..{LOOP_SEEDS - 1}; "
        f"the scan stops at the first that meets every bar): "
        f"{sum(not r['lost'] for _, r in runs)} keep the loop whole, "
        f"{len(passing)} meet every loop-closure bar (seeds "
        f"{[r['seed'] for _, r in passing]}; needed: {MIN_PASSING_SEEDS})")
    if len(passing) < MIN_PASSING_SEEDS:
        raise AssertionError(f"{len(passing)} of {LOOP_SEEDS} seeds meet the "
                             f"loop-closure bars")
    return passing[0][0], launches


def phase_slam_parity(dev, recorded: RecordingBackend):
    """The back-end on the card and on the CPU from the same tracker
    snapshots and the same uniforms; host reads of the card's ``add_frame``
    counted per call, and under ``torch.profiler`` for the whole feed."""
    bp = recorded.p
    card = PoseGraphBackend(bp, focal=LOOP_FOCAL, device=dev)
    cpu = PoseGraphBackend(bp, focal=LOOP_FOCAL, device="cpu")
    rng = np.random.default_rng(2025)
    K = recorded.snapshots[0][1].lf_mask.shape[0]
    syncs = []                 # (was a keyframe, synchronising calls)
    where = collections.Counter()       # source line -> calls
    feed = []
    for idx, state, out in recorded.snapshots:
        u = torch.tensor(rng.uniform(size=(2, 2, bp.loop_hypotheses, K)))
        feed.append((idx, state, out, u.to(dev), u,
                     convert.state_from_numpy(convert.state_to_numpy(state),
                                              device="cpu"),
                     convert.step_out_from_numpy(
                         convert.step_out_to_numpy(out), device="cpu")))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for idx, state, out, u_dev, _, _, _ in feed:
            n_before = len(card.keyframes)
            _, sites = sync_sites(
                lambda: card.add_frame(idx, state, out, uniforms=u_dev))
            syncs.append((len(card.keyframes) > n_before, len(sites)))
            where.update(sites)
    events = {e.key: e.count for e in prof.key_averages()}
    prof_syncs = sum(v for k, v in events.items()
                     if k in ("cudaStreamSynchronize",
                              "cudaDeviceSynchronize", "cudaEventSynchronize"))
    prof_launches = events.get("cudaLaunchKernel", 0)
    for idx, _, _, _, u, cstate, cout in feed:
        cpu.add_frame(idx, cstate, cout, uniforms=u)

    kf = [k.frame_idx for k in card.keyframes]
    if kf != [k.frame_idx for k in cpu.keyframes]:
        raise AssertionError(f"keyframes differ: {kf} vs "
                             f"{[k.frame_idx for k in cpu.keyframes]}")
    pairs = [e[:2] for e in card.loop_edges]
    if pairs != [e[:2] for e in cpu.loop_edges] or not pairs:
        raise AssertionError(f"loop edges differ: {pairs} vs "
                             f"{[e[:2] for e in cpu.loop_edges]}")
    edge_err = 0.0
    for ce, pe in zip(card.loop_edges, cpu.loop_edges):
        span = max(float(pe[2].t.norm()), 1.0)
        err = float((ce[2].t - pe[2].t).abs().max()) / span
        edge_err = max(edge_err, err)
        if err > SLAM_EDGE_RTOL or float(
                (ce[2].R - pe[2].R).abs().max()) > SLAM_EDGE_RTOL:
            raise AssertionError(f"edge {ce[:2]}: card vs CPU {err}")
    same = convert.backend_from_numpy(convert.backend_to_numpy(cpu), bp,
                                      focal=LOOP_FOCAL, device=dev)
    extent = float(np.ptp(np.stack([k.pose.t.numpy() for k in cpu.keyframes]),
                          axis=0).max())
    same_err, own_err = {}, {}
    for method in ("sim3", "se3"):
        want = cpu.optimize(method=method)
        same_err[method] = float(
            (same.optimize(method=method).t.cpu() - want.t).abs().max())
        own_err[method] = float(
            (card.optimize(method=method).t.cpu() - want.t).abs().max())
        if same_err[method] > SLAM_GRAPH_ATOL:
            raise AssertionError(f"{method} graph, one skeleton: card vs CPU "
                                 f"{same_err[method]}")
        if own_err[method] > SLAM_OWN_RTOL * extent:
            raise AssertionError(f"{method} graph, own skeletons: card vs "
                                 f"CPU {own_err[method]} of {extent}")
    on_kf = [n for is_kf, n in syncs if is_kf]
    off_kf = [n for is_kf, n in syncs if not is_kf]
    if any(off_kf):
        raise AssertionError(f"frames that are not keyframes synchronise: "
                             f"{off_kf}")
    log(f"slam parity: card vs CPU back-end from {len(feed)} shared tracker "
        f"snapshots: keyframes {kf} and loop pairs {pairs} equal; edge "
        f"translations within {edge_err:.2e} of their length (bound "
        f"{SLAM_EDGE_RTOL}); optimized positions on one skeleton "
        f"{ {m: f'{v:.1e}' for m, v in same_err.items()} } (bound "
        f"{SLAM_GRAPH_ATOL}), on own skeletons "
        f"{ {m: f'{v:.1e}' for m, v in own_err.items()} } of extent "
        f"{extent:.1f} (bound {SLAM_OWN_RTOL} of it)")
    log(f"slam parity: synchronising host reads of add_frame on the card "
        f"(sync debug mode): {len(off_kf)} other frames {sorted(set(off_kf))}"
        f", {len(on_kf)} keyframes {on_kf}, by source line "
        f"{dict(where.most_common())}; torch.profiler over the whole feed: "
        f"{prof_syncs} synchronize calls, {prof_launches} kernel launches")


def phase_sparse_ba(dev, gpu: str):
    """Sparse BA at the bench's size on the card against the CPU on
    identical inputs, and its LM iteration rate; then a small float64
    problem against the dense solver, both on the card."""
    kw = dict(num_frames=256, points_per_frame=32, window=4,
              dtype=torch.float32)
    iters = 10
    params = ba_sparse.SparseBAParams(
        max_iterations=iters, cg_iterations=20, rel_decrease=0.0,
        lambda_max=1e30)       # never stop early: the full iteration rate
    prob, _, _ = make_sequence_ba_problem(0, **kw)
    prob_cpu, _, _ = make_sequence_ba_problem(0, device="cpu", **kw)
    if prob.points0.device.type != "cuda":
        raise AssertionError(f"problem built on {prob.points0.device}")
    want = ba_sparse.sparse_ba_solve(prob_cpu, params)
    res, first_ms = timed_ms(lambda: ba_sparse.sparse_ba_solve(prob, params))
    reps = 3
    _, ms = timed_ms(lambda: [ba_sparse.sparse_ba_solve(prob, params)
                              for _ in range(reps)])
    rate = reps * int(res.iterations) / (ms * 1e-3)
    c0 = float(ba_sparse._cost(prob.poses0, prob.points0, prob))
    c_card, c_cpu = float(res.error), float(want.error)
    span = float(np.ptp(want.poses.t[:, 0].numpy()))
    dpose = float((res.poses.t.cpu() - want.poses.t).abs().max())
    if not (c_cpu < 0.1 * c0 and abs(c_card - c_cpu) <= SBA_COST_RTOL * c_cpu
            and dpose <= SBA_POSE_RTOL * span
            and int(res.iterations) == iters):
        raise AssertionError(f"sparse BA: cost {c0} -> card {c_card}, CPU "
                             f"{c_cpu}; |dt| {dpose} of {span}")
    log(f"sparse ba: 256 frames, {prob.points0.shape[0]} landmarks, D=4, "
        f"float32, {iters} LM x 20 CG on {gpu}: cost {c0:.4e} -> "
        f"{c_card:.4e} (CPU {c_cpu:.4e}: factor {c0 / c_cpu:.1f}, card "
        f"within {abs(c_card - c_cpu) / c_cpu:.2e}, bound {SBA_COST_RTOL}); "
        f"poses card vs CPU {dpose:.2e} of span {span:.1f} (bound "
        f"{SBA_POSE_RTOL} of it); first solve {first_ms:.0f} ms, then "
        f"{rate:.1f} LM iterations/s over {reps} solves")

    small, _, _ = make_sequence_ba_problem(
        0, num_frames=8, points_per_frame=24, window=4, dtype=torch.float64)
    dense = ba_dense.ba_solve(
        ba_sparse.densify(small),
        ba_dense.BAParams(max_iterations=40, compute_covariance=False))
    sparse = ba_sparse.sparse_ba_solve(
        small, ba_sparse.SparseBAParams(max_iterations=40, cg_iterations=60))
    dt = float((sparse.poses.t - dense.poses.t).abs().max())
    dp = float((sparse.points - dense.points).abs().max())
    dc = abs(float(sparse.error) - float(dense.error)) / (
        1.0 + float(dense.error))
    if not (dt <= 1e-6 and dp <= 1e-5 and dc < 1e-4):
        raise AssertionError(f"sparse vs dense: {dt}, {dp}, {dc}")
    log(f"sparse ba: float64 8 frames x 192 landmarks on the card, sparse "
        f"(PCG) vs dense (Cholesky) optimum: poses {dt:.1e} (bound 1e-6), "
        f"points {dp:.1e} (1e-5), cost {dc:.1e} (1e-4)")


def host_vo_pair(cam: PinholeCamera):
    """A frame manager and an odometer as a user builds them: no device
    argument, so both sit on the card."""
    fm, vo = FrameManager(camera=cam), VisualOdometer()
    for what, d in (("FrameManager", fm.device), ("VisualOdometer", vo.device),
                    ("its map", vo._map.positions.device),
                    ("the camera", fm.camera.K.device)):
        if d.type != "cuda":
            raise AssertionError(f"{what} sits on {d}")
    return fm, vo


def by_state(rows, key):
    """{state name: [row[key] of the rows that started in that state]}."""
    out = collections.defaultdict(list)
    for r in rows:
        out[r["state"]].append(r[key])
    return out


def host_vo_lockstep(frames, cam: PinholeCamera, n: int):
    """The first ``n`` frames through the front end on the card (kernel)
    and on the CPU (plain corner front), both fed the same numpy-drawn
    uniforms. Returns per frame (card result, CPU result, states after)."""
    rng = np.random.default_rng(2026)
    card = host_vo_pair(cam)
    cpu = (FrameManager(camera=cam, device="cpu"),
           VisualOdometer(device="cpu"))
    rows = []
    for k in range(n):
        u = torch.tensor(rng.uniform(size=(256, 512)), dtype=torch.float32)
        res = []
        for fm, vo in (card, cpu):
            frame = fm.add_frame(0.1 * (k + 1), frames[k])
            res.append(vo.add_frame(frame, uniforms=u.to(vo.device)))
        rows.append((res[0], res[1], card[1].state, cpu[1].state))
    return rows


def host_vo_parity(rows, what: str):
    """Card vs CPU rows of ``host_vo_lockstep``: equal success, reason and
    state per frame, inlier counts within HOST_VO_INLIER_TOL, poses within
    the fused tracker's bars. Returns the first disagreement as text, or
    None after logging the agreement."""
    dts, dRs, inl = [], [], []
    for k, (a, b, sa, sb) in enumerate(rows):
        if (a.success, a.reason, sa) != (b.success, b.reason, sb):
            return (f"{what}: frame {k}: card {a.reason} ({sa.name}, "
                    f"inliers {a.num_inliers}, mean error {a.mean_error:.3f})"
                    f" vs CPU {b.reason} ({sb.name}, inliers "
                    f"{b.num_inliers}, mean error {b.mean_error:.3f})")
        inl.append((a.num_inliers, b.num_inliers))
        if a.success:
            dts.append(float((a.pose.t.cpu() - b.pose.t).abs().max()))
            dRs.append(float((a.pose.R.cpu() - b.pose.R).abs().max()))
    if any(abs(i - j) > HOST_VO_INLIER_TOL for i, j in inl):
        return f"{what}: inliers (card, cpu) {inl}"
    if not dts or max(dts) > PARITY_T_ATOL or max(dRs) > PARITY_R_ATOL:
        return f"{what}: poses |dt| {dts}, |dR| {dRs}"
    log(f"host vo card vs CPU, {what}: {len(rows)} frames, reasons "
        f"{[a.reason for a, _, _, _ in rows]}, inliers (card, cpu) {inl} "
        f"(bound {HOST_VO_INLIER_TOL}), max |dt| {max(dts):.3e} (bound "
        f"{PARITY_T_ATOL}), max |dR| {max(dRs):.3e} (bound {PARITY_R_ATOL})")
    return None


def phase_host_vo(gpu: str):
    """The host-orchestrated front end on the card at its full width
    (default ``VoParams()`` and ``OrbParams()``: 512 features, 8 levels,
    1024 map points, BA over 512 points and 25 iterations, 256 hypotheses,
    a frame queue of 10) over the tracker replay's 110-frame scene."""
    n = HOST_VO_FRAMES
    ts_gt = bench_trajectory(n)
    frames = render_planes_sequence(ts_gt, h=H, w=W, focal=FOCAL)
    cam = PinholeCamera.from_params(FOCAL, FOCAL, 0.0, (W - 1) / 2,
                                    (H - 1) / 2)

    # 1) through the app's function, as a user runs it: arrays in, files out
    fm, vo = host_vo_pair(cam)
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        features_cuda.fast_nms_harris_rank_pyramid.launches = 0
        t0 = time.perf_counter()
        with ba_calls("host_vo"):
            results = run_visual_odometer(frames, fm, vo, out_dir,
                                          quiet=True)
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = features_cuda.fast_nms_harris_rank_pyramid.launches
        tum = load_trajectory_tum(os.path.join(out_dir, "trajectory.tum"))
        if not os.path.getsize(os.path.join(out_dir, "scene.ply")):
            raise AssertionError("scene.ply is empty")
    if launches != n:                   # one launch per frame's pyramid
        raise AssertionError(f"kernel launches {launches} != {n}")
    if (vo.frame_total, len(results)) != (n, n):
        raise AssertionError(f"frames fed {vo.frame_total}, {len(results)}")
    if vo.frame_tracked < HOST_VO_MIN_TRACKED:
        raise AssertionError(f"tracked {vo.frame_tracked}/{n} < "
                             f"{HOST_VO_MIN_TRACKED}")
    if len(tum) != vo.frame_tracked:
        raise AssertionError(f"TUM rows {len(tum)} != {vo.frame_tracked}")
    points = vo.get_tracked_points()       # none after a reset on the last frame
    if not bool(torch.isfinite(points).all()) or (
            vo.state == VoState.TRACKING and not len(points)):
        raise AssertionError("map points: not finite, or none while tracking")
    ok = np.array([r.success for r in results])
    est = np.zeros((n, 3))
    est[ok] = torch.stack([r.pose.t for r in results if r.success]
                          ).cpu().numpy().astype(np.float64)
    s0, s1, resid, span = longest_run_drift(
        ok, est, ts_gt, HOST_VO_MIN_RUN, HOST_VO_MAX_DRIFT)
    reasons = collections.Counter(r.reason for r in results)
    log(f"host vo: apps.visual_odometer.run_visual_odometer, {n} frames "
        f"{H}x{W} at default VoParams/OrbParams on {gpu}: tracked "
        f"{vo.frame_tracked}/{n} (limit {HOST_VO_MIN_TRACKED}), outcomes "
        f"{dict(reasons)}, lost frames {np.flatnonzero(~ok).tolist()}, "
        f"longest run {s1 - s0} (limit {HOST_VO_MIN_RUN}) with drift "
        f"{resid:.4f} = {resid / span:.3f} of its span (limit "
        f"{HOST_VO_MAX_DRIFT}; the fused tracker's 5 % bar "
        f"{'met' if resid < 0.05 * span else 'not met'}), {len(points)} "
        f"map points, kernel launches "
        f"{launches}; first pass {wall_s:.2f} s wall = {n / wall_s:.2f} "
        f"frames/s (one synchronize at the end), trajectory.tum "
        f"{len(tum)} rows")

    # 2) a second odometer, each call timed with the device drained around
    # it; saved after HOST_VO_SAVE_AT frames into a third, then both fed
    # the rest (each drawing from a generator seeded by the step count).
    # The file holds no bootstrap window (as in the JAX package), so an
    # INITIALIZING odometer resumes one frame behind: the save waits for
    # the next frame that leaves the odometer TRACKING
    fm2, vo2 = host_vo_pair(cam)
    vo3, saved_at = None, None
    rows = []
    with tempfile.TemporaryDirectory() as ck_dir:
        for k in range(n):
            if (vo3 is None and k >= HOST_VO_SAVE_AT
                    and vo2.state == VoState.TRACKING):
                saved_at = k
                path = os.path.join(ck_dir, "vo.npz")
                save_checkpoint(vo2, path)
                vo3 = load_checkpoint(path, host_vo_pair(cam)[1])
                if (vo3.state, vo3._step) != (vo2.state, vo2._step):
                    raise AssertionError("resumed state differs")
            state = vo2.state.name
            frame, fm_ms = timed_ms(
                lambda: fm2.add_frame(0.1 * (k + 1), frames[k]))
            res, vo_ms = timed_ms(lambda: vo2.add_frame(frame))
            rows.append(dict(state=state, fm_ms=fm_ms, vo_ms=vo_ms,
                             pairs=vo2.pairs_tried, reason=res.reason))
            if vo3 is not None:
                again = vo3.add_frame(frame)
                same = (again[2:] == res[2:] and again.success == res.success
                        and (not res.success or (
                            torch.equal(again.pose.t, res.pose.t)
                            and torch.equal(again.pose.R, res.pose.R))))
                if not same:
                    raise AssertionError(
                        f"resumed odometer differs at frame {k}: {again} vs "
                        f"{res}")
    if [r["reason"] for r in rows] != [r.reason for r in results]:
        raise AssertionError("the timed pass went another way than the app's")
    if vo3 is None:
        raise AssertionError("never TRACKING after frame "
                             f"{HOST_VO_SAVE_AT}: no checkpoint taken")
    resumed_tracked = sum(r["reason"] in ("tracked", "bootstrap")
                          for r in rows[saved_at:])
    if not (vo3.frame_tracked == vo2.frame_tracked and resumed_tracked
            and torch.equal(vo3._map.positions, vo2._map.positions)):
        raise AssertionError("resumed odometer's counters or map differ")
    log(f"host vo: checkpoint saved after {saved_at} frames (the last one "
        f"{rows[saved_at - 1]['reason']}), loaded into a new "
        f"odometer, both fed the remaining {n - saved_at} frames "
        f"({resumed_tracked} tracked): results, poses and the final map "
        f"bit-equal")
    for key, what in (("fm_ms", "FrameManager.add_frame"),
                      ("vo_ms", "VisualOdometer.add_frame")):
        log(f"host vo: {what} ms per frame by starting state (device "
            f"drained around each call): " + "; ".join(
                f"{st}: {len(v)} frames, median {np.median(v):.2f}, mean "
                f"{np.mean(v):.2f}, max {max(v):.2f}"
                for st, v in sorted(by_state(rows, key).items())))
    boot = [r for r in rows if r["state"] == "INITIALIZING" and r["pairs"]]
    log(f"host vo: candidate pairs tried per bootstrap frame "
        f"{[r['pairs'] for r in boot]} (outcomes "
        f"{[r['reason'] for r in boot]}); ms of those frames "
        f"{[round(r['vo_ms'], 1) for r in boot]}; whole timed pass "
        f"{sum(r['fm_ms'] + r['vo_ms'] for r in rows) / 1e3:.2f} s = "
        f"{n / (sum(r['fm_ms'] + r['vo_ms'] for r in rows) / 1e3):.2f} "
        f"frames/s on {gpu}")

    # 3) synchronising host reads per frame, by state and by source line
    fm4, vo4 = host_vo_pair(cam)
    reads, where = [], {"FrameManager": collections.Counter()}
    for k in range(HOST_VO_SYNC_FRAMES):
        state = vo4.state.name
        frame, fm_sites = sync_sites(
            lambda: fm4.add_frame(0.1 * (k + 1), frames[k]))
        _, vo_sites = sync_sites(lambda: vo4.add_frame(frame))
        reads.append(dict(state=state, fm=len(fm_sites), vo=len(vo_sites)))
        where["FrameManager"].update(fm_sites)
        where.setdefault(state, collections.Counter()).update(vo_sites)
    for key, what in (("fm", "FrameManager.add_frame"),
                      ("vo", "VisualOdometer.add_frame")):
        log(f"host vo: synchronising reads per frame of {what} (sync debug "
            f"mode) by starting state: " + "; ".join(
                f"{st}: {sorted(collections.Counter(v).items())} "
                f"(reads, frames)"
                for st, v in sorted(by_state(reads, key).items())))
    log("host vo: synchronising reads by source line over the first "
        f"{HOST_VO_SYNC_FRAMES} frames: " + "; ".join(
            f"{st}: {dict(c.most_common())}" for st, c in where.items()))

    # 4) where a frame's time goes: launches and device time per frame by
    # starting state (one profiler window per frame), and what the 25
    # masked BA iterations of a tracking frame cost: the same frames at 10
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fm5, vo5 = host_vo_pair(cam)
    prof_rows = []
    for k in range(HOST_VO_PROFILED):
        state = vo5.state.name
        frame = fm5.add_frame(0.1 * (k + 1), frames[k])
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            _, ms = timed_ms(lambda: vo5.add_frame(frame))
        events = prof.key_averages()
        prof_rows.append(dict(
            state=state, ms=ms,
            launches=sum(e.count for e in events
                         if e.key.startswith("cudaLaunchKernel")),
            device_ms=sum(e.self_device_time_total for e in events) / 1e3))
    for st, v in sorted(by_state(prof_rows, "launches").items()):
        dms = by_state(prof_rows, "device_ms")[st]
        wms = by_state(prof_rows, "ms")[st]
        log(f"host vo: VisualOdometer.add_frame under torch.profiler, {st}: "
            f"{len(v)} frames, kernel launches median {int(np.median(v))} "
            f"(min {min(v)}, max {max(v)}), device time median "
            f"{np.median(dms):.2f} ms of {np.median(wms):.1f} ms wall "
            f"(profiled): busy {np.median(dms) / np.median(wms):.1%}")
    ba10 = vo.params._replace(ba=vo.params.ba._replace(max_iterations=10))
    fm6, vo6 = FrameManager(camera=cam), VisualOdometer(ba10)
    short = []
    for k in range(HOST_VO_SHORT_BA):
        state = vo6.state.name
        frame = fm6.add_frame(0.1 * (k + 1), frames[k])
        res, ms = timed_ms(lambda: vo6.add_frame(frame))
        short.append(dict(state=state, ms=ms, reason=res.reason))
    ms25 = np.median([r["vo_ms"] for r in rows[:HOST_VO_SHORT_BA]
                      if r["state"] == "TRACKING"])
    ms10 = np.median(by_state(short, "ms")["TRACKING"])
    log(f"host vo: TRACKING frames among the first {HOST_VO_SHORT_BA}: median "
        f"{ms25:.1f} ms at 25 masked BA iterations, {ms10:.1f} ms at 10: "
        f"{(ms25 - ms10) / 15:.2f} ms per iteration, "
        f"{(ms25 - ms10) / 15 * 25:.0f} ms of a frame's {ms25:.0f}; outcomes "
        f"at 10: {dict(collections.Counter(r['reason'] for r in short))}, at "
        f"25: {dict(collections.Counter(r['reason'] for r in rows[:HOST_VO_SHORT_BA]))}")

    # 5) card vs CPU under the same draws. This scene's third tracked frame
    # is the known sensitive one (see PARITY_T_ATOL): if the two devices
    # part there, that is reported and the check is held on the 240x320
    # scene of the parity tests instead
    m = HOST_VO_PARITY_FRAMES
    parted = host_vo_parity(host_vo_lockstep(frames, cam, m),
                            f"{H}x{W} replay scene")
    if parted is not None:
        log(f"host vo card vs CPU parted on the {H}x{W} scene ({parted}); "
            f"holding the check on the {LOOP_H}x{LOOP_W} scene")
        i = np.arange(m)
        ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(m)], 1)
        small = render_planes_sequence(ts, h=LOOP_H, w=LOOP_W,
                                       focal=LOOP_FOCAL, bg_slope=0.18)
        cam_small = PinholeCamera.from_params(
            LOOP_FOCAL, LOOP_FOCAL, 0.0, (LOOP_W - 1) / 2, (LOOP_H - 1) / 2)
        parted = host_vo_parity(host_vo_lockstep(small, cam_small, m),
                                f"{LOOP_H}x{LOOP_W} scene")
        if parted is not None:
            raise AssertionError(f"host vo card vs CPU: {parted}")
    return launches


def codecs() -> dict:
    """Which host image codecs this machine has: PIL, and libjpeg's header
    (what the native loader's build needs), found by compiling an include
    with the host compiler."""
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    try:
        proc = subprocess.run(
            ["g++", "-fsyntax-only", "-x", "c++", "-"],
            input="#include <cstdio>\n#include <jpeglib.h>\n",
            capture_output=True, text=True, timeout=60)
        jpeglib = proc.returncode == 0
    except (OSError, subprocess.SubprocessError):
        jpeglib = False
    log(f"codecs: PIL {'present' if pil else 'absent'}; jpeglib.h "
        f"{'found' if jpeglib else 'not found'} (g++ -fsyntax-only)")
    return dict(pil=pil, jpeglib=jpeglib)


def bench_camera(h: int = H, w: int = W,
                 focal: float = FOCAL) -> PinholeCamera:
    return PinholeCamera.from_params(focal, focal, 0.0, (w - 1) / 2,
                                     (h - 1) / 2)


def save_8bit(path: str, img: np.ndarray, **save_kw) -> None:
    """An image in [0, 1] as an 8-bit file through PIL (the format by the
    suffix)."""
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)).save(
        path, **save_kw)


def pair_errors(T, baseline: np.ndarray) -> tuple[float, float]:
    """(rotation angle, angle between the translation and ``baseline``) of
    a recovered pose, in rad."""
    t = T.t.double().cpu().numpy()
    cos = float(t @ baseline / (np.linalg.norm(t) * np.linalg.norm(baseline)))
    return (float(so3_log(T.R.double()).norm()),
            float(np.arccos(np.clip(cos, -1.0, 1.0))))


def phase_reconstruct(dev, gpu: str, have: dict):
    """The reconstruct-scene app on the card: frames 0 and 4 of the replay
    scene through its function with the frames in memory (twice: first and
    second call), and through ``main`` on PNG copies where PIL is present;
    held to the scene's truth, then card against CPU under the same draws.
    Returns (launches of the function's first call, what the viewer phase
    draws, the PNG copies or None)."""
    n = max(REC_FRAMES) + 1
    ts = bench_trajectory(HOST_VO_FRAMES)
    frames = render_planes_sequence(ts, h=H, w=W, focal=FOCAL)
    img1, img2 = (torch.from_numpy(frames[k]) for k in REC_FRAMES)
    baseline = ts[REC_FRAMES[1]] - ts[REC_FRAMES[0]]
    cam = bench_camera()
    out_dir = tempfile.mkdtemp()
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        features_cuda.fast_nms_harris_rank_pyramid.launches = 0
        t0 = time.perf_counter()
        with ba_calls("reconstruct"):
            rec = reconstruct_scene.reconstruct(img1, img2, cam, out_dir,
                                                device=dev)
            torch.cuda.synchronize()
        runs.append((rec, time.perf_counter() - t0,
                     features_cuda.fast_nms_harris_rank_pyramid.launches))
    rec, first_s, launches = runs[0]
    if rec is None or runs[1][0] is None:
        raise AssertionError("reconstruct: the pair did not reconstruct")
    if rec.pair.base.image.device != dev:
        raise AssertionError(f"reconstruct ran on {rec.pair.base.image.device}")
    if [r[2] for r in runs] != [2, 2]:
        raise AssertionError(f"kernel launches per call {[r[2] for r in runs]}"
                             f" != 2")
    if not os.path.getsize(rec.ply):
        raise AssertionError("reconstruction.ply is empty")
    rot, ang = pair_errors(rec.pair.T_pair_to_base, baseline)
    if not (rot < REC_MAX_ROT and ang < REC_MAX_DIR):
        raise AssertionError(f"reconstruct vs truth: rotation {rot}, "
                             f"direction {ang}")
    log(f"reconstruct: apps.reconstruct_scene.reconstruct, frames "
        f"{REC_FRAMES} of the {H}x{W} replay scene on {gpu}: "
        f"{rec.pair.match_inlier_count} inliers, mean error "
        f"{rec.pair.mean_error:.4f}, {rec.num_points} points; rotation "
        f"{rot:.2e} rad (limit {REC_MAX_ROT}), translation direction "
        f"{ang:.2e} rad (limit {REC_MAX_DIR}) from truth; kernel launches "
        f"{[r[2] for r in runs]}; wall {first_s * 1e3:.1f} ms first call, "
        f"{runs[1][1] * 1e3:.1f} ms second; overlay {rec.overlay.shape}")

    pngs = None
    if have["pil"]:
        pngs = [os.path.join(out_dir, f"frame{k}.png") for k in REC_FRAMES]
        for p, k in zip(pngs, REC_FRAMES):
            save_8bit(p, frames[k])
        cfg = os.path.join(out_dir, "camera.config")
        cam.save_to_file(cfg)
        app_dir = os.path.join(out_dir, "app")
        features_cuda.fast_nms_harris_rank_pyramid.launches = 0
        rc = reconstruct_scene.main([*pngs, cfg, "--out-dir", app_dir,
                                     "--device", str(dev)])
        app_launches = features_cuda.fast_nms_harris_rank_pyramid.launches
        written = {f: os.path.getsize(os.path.join(app_dir, f))
                   for f in ("reconstruction.ply", "matches.png")}
        if rc != 0 or app_launches != 2 or not all(written.values()):
            raise AssertionError(f"reconstruct_scene.main: rc {rc}, "
                                 f"launches {app_launches}, files {written}")
        log(f"reconstruct: reconstruct_scene.main on PNG copies: rc 0, "
            f"{app_launches} kernel launches, files {written} (bytes)")
    else:
        log("reconstruct: PIL absent: reconstruct_scene.main on image files "
            "and matches.png not checked (the function ran on the frames in "
            "memory above)")

    # card against CPU under the same RANSAC draws
    rng = np.random.default_rng(2027)
    u = torch.tensor(rng.uniform(size=(
        ImagePairParams().sfm.num_hypotheses,
        features.OrbParams().max_features)), dtype=torch.float32)
    side = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        side[name] = reconstruct_scene.reconstruct(
            img1, img2, cam, tempfile.mkdtemp(), device=d,
            uniforms=u.to(d))
    a, b = side["card"].pair, side["cpu"].pair
    dR = float(so3_log(a.T_pair_to_base.R.double().cpu()
                       @ b.T_pair_to_base.R.double().T).norm())
    _, dt = pair_errors(a.T_pair_to_base,
                        b.T_pair_to_base.t.double().numpy())
    d_inl = abs(a.match_inlier_count - b.match_inlier_count)
    log(f"reconstruct card vs CPU, same draws: inliers "
        f"{a.match_inlier_count}/{b.match_inlier_count} (limit "
        f"{REC_INLIER_TOL}), rotation {dR:.2e} rad (limit {REC_PARITY_ROT}), "
        f"translation direction {dt:.2e} rad (limit {REC_PARITY_DIR}), "
        f"points {side['card'].num_points}/{side['cpu'].num_points}")
    if d_inl > REC_INLIER_TOL or dR > REC_PARITY_ROT or dt > REC_PARITY_DIR:
        raise AssertionError("reconstruct: card vs CPU beyond the limits")
    return launches, rec, pngs


def calibration_views(rng) -> np.ndarray:
    """(CAL_VIEWS, 54, 2) pixels of the 9x6 board (unit squares) seen from
    random poses through CAL_K and CAL_DIST, every corner inside the image
    with a 10 px margin, plus CAL_NOISE_PX of noise."""
    board = calibrate_camera.board_points(CAL_ROWS, CAL_COLS)
    X = np.concatenate([board, np.zeros((len(board), 1))], 1)
    centre = X.mean(0)
    views = []
    while len(views) < CAL_VIEWS:
        w = rng.uniform(-0.5, 0.5, 3) * np.array([1.0, 1.0, 0.6])
        R = so3_exp(torch.tensor(w)).numpy()
        t = -R @ centre + np.array([rng.uniform(-2, 2), rng.uniform(-1.5, 1.5),
                                    rng.uniform(11.0, 18.0)])
        Xc = X @ R.T + t
        xy = Xc[:, :2] / Xc[:, 2:3]
        r2 = np.sum(xy * xy, -1, keepdims=True)
        xy = xy * (1.0 + CAL_DIST[0] * r2 + CAL_DIST[1] * r2 * r2)
        px = xy @ CAL_K[:2, :2].T + CAL_K[:2, 2]
        if (px.min() < 10 or px[:, 0].max() > CAL_W - 10
                or px[:, 1].max() > CAL_H - 10):
            continue
        views.append(px + rng.normal(0, CAL_NOISE_PX, px.shape))
    return np.stack(views)


def calibration_probe(dev, args, K_cpu: np.ndarray) -> None:
    """The float64 solve from call to call: CAL_PROBE_CALLS solves on the
    card with PyTorch's default algorithms and as many with deterministic
    algorithms asked for (warnings name the operations that have no
    deterministic form), and two more on the CPU, each K against the first
    CPU solve's; the digests of K let two runs of this script compare."""
    def digest(K):
        return hashlib.sha256(np.ascontiguousarray(K).tobytes()).hexdigest()[:12]

    rows = []
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                Ks = [calibrate_camera.calibrate_views(*args, device=dev)[0]
                      .K.cpu().numpy() for _ in range(CAL_PROBE_CALLS)]
        finally:
            torch.use_deterministic_algorithms(False)
        flagged = sorted({str(w.message).split(".")[0][:90] for w in caught
                          if "deterministic" in str(w.message)})
        rows.append((f"card, {mode}", Ks, flagged))
    rows.append(("CPU", [calibrate_camera.calibrate_views(
        *args, device="cpu")[0].K.numpy() for _ in range(2)], []))
    for name, Ks, flagged in rows:
        rel = [float(np.abs(K - K_cpu).max() / np.abs(K_cpu).max())
               for K in Ks]
        log(f"calibration probe: {name}: K against the first CPU solve "
            f"{', '.join(f'{r:.1e}' for r in rel)}; distinct K "
            f"{len({digest(K) for K in Ks})} of {len(Ks)} (digests "
            f"{sorted({digest(K) for K in Ks})}; first CPU {digest(K_cpu)})"
            + (f"; flagged as nondeterministic: {flagged}" if flagged else ""))


def phase_calibration(dev, gpu: str, orb: features.OrbParams) -> dict:
    """A full-size calibration session on the card through the app's solve
    (float64, distortion, 60 GN iterations, undistorted 640x480 preview,
    camera file), held to truth and to the same solve on the CPU; then one
    K1 pyramid launch on the preview, timed as a graph replay."""
    views = calibration_views(np.random.default_rng(2028))
    preview = render_planes_sequence(bench_trajectory(1), h=CAL_H, w=CAL_W,
                                     focal=500.0)[0]
    args = (list(views), CAL_ROWS, CAL_COLS, 1.0, True, preview,
            CAL_ITERATIONS)
    calibrate_camera.calibrate_views(*args, device=dev)          # warm
    (res, cam, und), ms = timed_ms(
        lambda: calibrate_camera.calibrate_views(*args, device=dev))
    if res.K.device != dev or res.K.dtype != torch.float64:
        raise AssertionError(f"calibration on {res.K.device} {res.K.dtype}")
    _, prev_ms = timed_ms(lambda: calibrate_camera.undistort_image(
        torch.as_tensor(preview).to(dev, torch.float64), res.K, res.dist))
    K, dist = res.K.cpu().numpy(), res.dist.cpu().numpy()
    rms = float(res.rms_error)
    with tempfile.TemporaryDirectory() as d:
        cfg = os.path.join(d, "camera.config")
        cam.save_to_file(cfg)
        back = PinholeCamera.load_from_file(cfg, dtype=torch.float64)
    if not np.allclose(back.K.numpy(), K, rtol=1e-12):
        raise AssertionError("camera file does not hold K")
    if not (abs(K[0, 0] - CAL_K[0, 0]) < CAL_MAX_F_ERR
            and abs(K[1, 1] - CAL_K[1, 1]) < CAL_MAX_F_ERR
            and abs(dist[0] - CAL_DIST[0]) < CAL_MAX_K1_ERR
            and rms < CAL_MAX_RMS):
        raise AssertionError(f"calibration vs truth: K {K}, dist {dist}, "
                             f"rms {rms}")
    cres, _, cund = calibrate_camera.calibrate_views(*args, device="cpu")
    dK = float(np.abs(K - cres.K.numpy()).max() / np.abs(K).max())
    dD = float(np.abs(dist - cres.dist.numpy()).max()
               / np.abs(cres.dist.numpy()).max())
    dP = float((und.cpu() - calibrate_camera.undistort_image(
        torch.as_tensor(preview).double(), res.K.cpu(), res.dist.cpu())
    ).abs().max())
    dE = float((und.cpu() - cund).abs().max())
    # no host read inside the solve: the synchronising calls of one
    # calibrate_planar on the card, by source line
    f64 = torch.float64
    _, sites = sync_sites(lambda: calibrate_camera.calibrate_planar(
        torch.tensor(calibrate_camera.board_points(CAL_ROWS, CAL_COLS),
                     dtype=f64, device=dev),
        torch.tensor(views, dtype=f64, device=dev),
        torch.ones(views.shape[:2], dtype=f64, device=dev),
        refine_iterations=CAL_ITERATIONS, estimate_distortion=True))
    in_solve = [x for x in sites if x.startswith(("calibration.py",
                                                  "homography.py"))]
    log(f"calibration: calibrate_camera.calibrate_views, {CAL_VIEWS} views "
        f"of a {CAL_COLS}x{CAL_ROWS} board at {CAL_W}x{CAL_H}, float64, "
        f"distortion, {CAL_ITERATIONS} GN iterations on {gpu}: fx "
        f"{K[0, 0]:.3f} fy {K[1, 1]:.3f} (truth {CAL_K[0, 0]}, "
        f"{CAL_K[1, 1]}; limit {CAL_MAX_F_ERR} px), cx {K[0, 2]:.3f} cy "
        f"{K[1, 2]:.3f}, k1 {dist[0]:.5f} k2 {dist[1]:.5f} (truth "
        f"{CAL_DIST.tolist()}; k1 limit {CAL_MAX_K1_ERR}), rms {rms:.4f} px "
        f"(limit {CAL_MAX_RMS}); {ms:.1f} ms per solve after a warm call "
        f"(preview included) = {CAL_ITERATIONS / (ms * 1e-3):.1f} GN "
        f"iterations/s; preview alone {prev_ms:.2f} ms; card vs CPU: K "
        f"{dK:.1e}, dist {dD:.1e} relative (limit {CAL_RTOL}), preview "
        f"from the same K and dist {dP:.1e} (limit {CAL_PREVIEW_ATOL}), "
        f"end to end {dE:.1e} (limit {CAL_PREVIEW_E2E_ATOL}); synchronising "
        f"calls of calibrate_planar on the card {len(sites)}: "
        f"{dict(collections.Counter(sites))}")
    if (dK > CAL_RTOL or dD > CAL_RTOL or dP > CAL_PREVIEW_ATOL
            or dE > CAL_PREVIEW_E2E_ATOL):
        raise AssertionError("calibration: card vs CPU beyond the limits")
    if in_solve:
        raise AssertionError(f"calibrate_planar reads on the host: {in_solve}")
    calibration_probe(dev, args, cres.K.numpy())

    # one K1 pyramid launch at 480x640 on the preview, as in phase_kernel
    levels = features.pyramid(und.to(torch.float32).contiguous(), orb)
    kargs = (orb.fast_threshold, orb.harris_k, orb.border)
    ranks = features_cuda.fast_nms_harris_rank_pyramid(levels, *kargs)
    bound = k1_bound(levels, ranks, orb)
    dev_ms = graph_ms(lambda: features_cuda.fast_nms_harris_rank_pyramid(
        levels, *kargs), TIMING_REPS)
    log(f"calibration: K1 on the preview's 8-level {CAL_H}x{CAL_W} pyramid "
        f"({bound['pixels']} pixels, {bound['corners']} corners): device "
        f"(CUDA-graph replay) {dev_ms:.5f} ms, bound {bound['bound_ms']:.5f} "
        f"ms by {bound['bound_by']}")
    return dict(k1_480x640_ms=dev_ms, k1_480x640_bound_ms=bound["bound_ms"])


def phase_native_loader(dev, gpu: str, have: dict) -> int:
    """The native loader: built from the port's source where libjpeg's
    header is found; where PIL is present too, the first LOADER_FRAMES
    frames of the replay scene as JPEG, decoded one by one and through the
    prefetch queue (bitwise equal, in order), then through the app's
    default mode, against the same frames read with PIL. Returns the
    app's kernel launches (0 when not run)."""
    if not have["jpeglib"]:
        log("native loader: jpeglib.h not found: the loader was not built; "
            "its decode, its prefetch queue and the app's JPEG frame source "
            "were not checked (the CPU tests cover them)")
        return 0
    t0 = time.perf_counter()
    native_loader.load_library()            # a failed build raises
    log(f"native loader: built {native_loader._SOURCE.name} with g++ into "
        f"{native_loader.BUILD_DIR} in {time.perf_counter() - t0:.2f} s")
    if not have["pil"]:
        log("native loader: PIL absent: no JPEG could be written; decode, "
            "prefetch order and the app's JPEG frame source not checked")
        return 0
    n = LOADER_FRAMES
    frames = render_planes_sequence(bench_trajectory(HOST_VO_FRAMES), h=H,
                                    w=W, focal=FOCAL)[:n]
    ds = tempfile.mkdtemp()
    paths = [os.path.join(ds, f"{k:03d}.jpg") for k in range(n)]
    for p, img in zip(paths, frames):
        save_8bit(p, img, quality=95)
    direct = [native_loader.decode_jpeg_gray(p) for p in paths]
    with native_loader.PrefetchLoader(paths) as it:
        queued = list(it)
    if [i for i, _ in queued] != list(range(n)) or not all(
            np.array_equal(a, b) for (_, a), b in zip(queued, direct)):
        raise AssertionError("prefetch loader: frames out of order or not "
                             "bitwise equal to direct decodes")
    cam = bench_camera()
    out = os.path.join(ds, "out")
    args = argparse.Namespace(device=str(dev), resume=None, checkpoint=None,
                              out_dir=out, dataset=ds, quiet=True)
    torch.cuda.synchronize()
    native_loader.PrefetchLoader.delivered = 0
    features_cuda.fast_nms_harris_rank_pyramid.launches = 0
    t0 = time.perf_counter()
    with ba_calls("native_loader_app"):
        rc = _run_visual_odometer(args, cam, paths)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = features_cuda.fast_nms_harris_rank_pyramid.launches
    delivered = native_loader.PrefetchLoader.delivered
    written = {f: os.path.exists(os.path.join(out, f))
               for f in ("trajectory.tum", "scene.ply")}
    if rc != 0 or delivered != n or launches != n or not all(
            written.values()):
        raise AssertionError(f"app via the loader: rc {rc}, frames through "
                             f"the loader {delivered}, launches {launches}, "
                             f"files {written}")
    fm, vo = FrameManager(camera=cam, device=dev), VisualOdometer(device=dev)
    t0 = time.perf_counter()
    run_visual_odometer((load_image_grayscale(p) for p in paths), fm, vo,
                        os.path.join(ds, "pil"), quiet=True)
    torch.cuda.synchronize()
    pil_wall = time.perf_counter() - t0
    log(f"native loader: {n} JPEG frames (quality 95) of the {H}x{W} replay "
        f"scene: decode_jpeg_gray equals the prefetch queue's frames bitwise, "
        f"in order; _run_visual_odometer on the directory (default mode, "
        f"{gpu}): {delivered} frames through the loader, {launches} kernel "
        f"launches, files {sorted(written)}, {n / wall:.2f} frames/s "
        f"({wall:.2f} s); the same frames read with PIL through "
        f"run_visual_odometer: {n / pil_wall:.2f} frames/s ({pil_wall:.2f} s)")
    return launches


def phase_viewer(dev, rec, pngs, have: dict) -> None:
    """The threaded 2D viewer on the reconstruct phase's keyframe and
    matched pair (features on the card), and the two feature demos on its
    PNG copies with their launches counted, where PIL is present."""
    if not have["pil"]:
        log("viewer: PIL absent: Visualizer2d's PNGs and the feature demos "
            "not checked")
        return
    pair, f1 = rec.pair, rec.pair.base
    f2 = rec.pair.pair
    if f1.features.xy.device != dev:
        raise AssertionError("viewer: features not on the card")
    out = tempfile.mkdtemp()
    v = Visualizer2d(out)
    v.show_keyframe(f1.image, f1.features.xy, f1.features.mask)
    v.show_matched_pair(f1.image, f1.features.xy, f2.image, f2.features.xy,
                        pair.match.idx, pair.match.mask,
                        pair.result.inlier_mask)
    v.close()
    files = sorted(f for f in os.listdir(out) if f.startswith("view2d_"))
    if v._thread.is_alive() or files != ["view2d_00001.png",
                                         "view2d_00002.png"]:
        raise AssertionError(f"viewer: thread alive {v._thread.is_alive()}, "
                             f"files {files}")
    counts = {}
    for name, fn, want in (("visual-feature", demos.demo_visual_feature, 2),
                           ("visualizer-2d", demos.demo_visualizer_2d, 4)):
        d = os.path.join(out, name)
        os.makedirs(d)
        features_cuda.fast_nms_harris_rank_pyramid.launches = 0
        rc = fn(*pngs, d, dev)
        counts[name] = features_cuda.fast_nms_harris_rank_pyramid.launches
        if rc != 0 or counts[name] != want or not os.path.getsize(
                os.path.join(d, "matches.png")):
            raise AssertionError(f"demo {name}: rc {rc}, launches "
                                 f"{counts[name]} (want {want})")
    log(f"viewer: Visualizer2d on the card's keyframe and matched pair: "
        f"{files} written, render thread joined; demos visual-feature and "
        f"visualizer-2d on the PNG copies: kernel launches {counts}")


def orb_frames(dev):
    """(name, image on ``dev``) of each frame of ORB_FRAMES."""
    for h, w, focal in ORB_FRAMES:
        img = render_planes_sequence(bench_trajectory(1), h=h, w=w,
                                     focal=focal)[0]
        yield f"{h}x{w}", torch.from_numpy(img).to(dev)


def kernel_launches(fn) -> int:
    """CUDA kernels one call of ``fn`` launches (torch.profiler)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunchKernel"))


def keyed(f, anchors) -> dict:
    """Slot of each valid keypoint of ``f`` by (octave, level-0 integer
    position), the positions taken from ``anchors`` (the same detector
    without subpixel: it keeps the same slots)."""
    xy, oc, m = (x.cpu().numpy() for x in (anchors, f.octave, f.mask))
    return {(int(o), float(x), float(y)): i
            for i, (o, (x, y), v) in enumerate(zip(oc, xy, m)) if v}


def phase_orb_options(dev, gpu: str) -> dict:
    """orb_detect's batched layout and subpixel fit on the card: one K1
    launch per image in each, batched equal to unrolled, subpixel on the
    card against the CPU from the same pyramid; kernel launches per call
    and eager ms, both layouts. Returns the launches and images of the
    paths ``orb_batched`` and ``orb_subpixel`` (each counted from 0 around
    its calls)."""
    base = features.OrbParams()
    opts = {"unrolled": base, "batched": base._replace(batched=True),
            "subpixel": base._replace(subpixel=True),
            "batched+subpixel": base._replace(batched=True, subpixel=True)}
    paths = {"orb_batched": "batched", "orb_subpixel": "subpixel"}
    counts = {k: [0, 0] for k in paths}
    failed = []
    for fname, img in orb_frames(dev):
        got = {}
        for name, p in opts.items():
            features_cuda.fast_nms_harris_rank_pyramid.launches = 0
            got[name] = features.orb_detect(img, p)
            n = features_cuda.fast_nms_harris_rank_pyramid.launches
            if n != 1:
                raise AssertionError(f"orb_detect {name} on {fname}: {n} K1 "
                                     f"launches, not 1")
            for path, opt in paths.items():
                if opt == name:
                    counts[path][0] += n
                    counts[path][1] += 1
        for a, b in (("unrolled", "batched"),
                     ("subpixel", "batched+subpixel")):
            fa, fb = got[a], got[b]
            m = fa.mask
            same = (torch.equal(fa.mask, fb.mask)
                    and torch.equal(fa.octave, fb.octave)
                    and torch.equal(fa.desc[m], fb.desc[m]))
            dxy = float((fa.xy[m] - fb.xy[m]).abs().max())
            dang = float((fa.angle[m] - fb.angle[m]).abs().max())
            log(f"orb options: {fname} on {gpu}: {b} vs {a}: {int(m.sum())} "
                f"keypoints, masks, octaves, descriptors "
                f"{'equal' if same else 'DIFFER'}, max |dxy| {dxy:.3e} px, "
                f"max |dangle| {dang:.3e} rad (limit {ORB_ANGLE_ATOL})")
            if not same or dxy != 0.0 or dang > ORB_ANGLE_ATOL:
                failed.append(f"{fname} {b} vs {a}")

        # subpixel, card vs CPU from the card's pyramid
        levels = features.pyramid(img, base)
        cpu_levels = [lv.cpu() for lv in levels]

        def detect(lv, p):
            return features.orb_keypoints(lv, features.corner_ranks(lv, p), p)

        for layout in ("unrolled", "batched"):
            p = base._replace(batched=layout == "batched")
            card, cpu = (detect(lv, p._replace(subpixel=True))
                         for lv in (levels, cpu_levels))
            kc = keyed(card, detect(levels, p).xy)
            kh = keyed(cpu, detect(cpu_levels, p).xy)
            common = sorted(kc.keys() & kh.keys())
            ic = [kc[k] for k in common]
            ih = [kh[k] for k in common]
            scale = torch.tensor([base.scale_factor ** k[0] for k in common],
                                 dtype=torch.float64)[:, None]
            dxy = float(((card.xy.cpu()[ic] - cpu.xy[ih]).double()
                         / scale).abs().max())
            ddesc = int((card.desc.cpu()[ic] != cpu.desc[ih]).any(1).sum())
            same = (torch.equal(card.mask.cpu(), cpu.mask)
                    and torch.equal(card.octave.cpu(), cpu.octave))
            swapped = len(kc.keys() ^ kh.keys())
            log(f"orb options: {fname} subpixel {layout}, card vs CPU from "
                f"the same pyramid: masks and octaves "
                f"{'equal' if same else 'DIFFER'}, keypoints by integer "
                f"anchor {len(common)} common, {swapped} not, descriptors "
                f"differing {ddesc}, max |dxy| {dxy:.3e} px of the level "
                f"(limit {ORB_SUBPIXEL_ATOL})")
            if not same or swapped or ddesc or dxy > ORB_SUBPIXEL_ATOL:
                failed.append(f"{fname} subpixel {layout} card vs CPU")

        # launches and eager time per call, layouts in turns
        launches = {name: kernel_launches(lambda p=p: features.orb_detect(
            img, p)) for name, p in opts.items()}
        order = ["unrolled", "batched", "batched", "unrolled",
                 "subpixel", "batched+subpixel"]
        ms = collections.defaultdict(list)
        for name in order:
            ms[name].append(cuda_ms(lambda p=opts[name]: features.orb_detect(
                img, p), ORB_TIMING_REPS, warmup=3))
        log(f"orb options: {fname} orb_detect per call on {gpu}: "
            + "; ".join(f"{name} {launches[name]} kernel launches, "
                        f"{'/'.join(f'{t:.2f}' for t in ms[name])} ms eager"
                        for name in opts)
            + f" (CUDA events over {ORB_TIMING_REPS} calls after 3; "
            f"unrolled, batched, batched, unrolled, then the subpixel pair)")
    if failed:
        raise AssertionError(f"orb options beyond the limits: {failed}")
    return counts


def distributed_solves(mesh, sprob, dprob, backend) -> tuple[dict, dict]:
    """(outputs by key, ms per LM iteration by solve) of the sparse and
    dense BA and both graphs of ``backend``'s skeleton, sharded over
    ``mesh`` (ungrouped when None)."""
    out, per_it = {}, {}
    if mesh is None:
        sba = lambda: ba_sparse.sparse_ba_solve(sprob, DIST_SBA_PARAMS)
        dba = lambda: ba_dense.ba_solve(dprob)
    else:
        sba = lambda: dist_ba_sparse.distributed_sparse_ba_solve(
            sprob, mesh, DIST_SBA_PARAMS)
        dba = lambda: parallel.distributed_ba_solve(dprob, mesh)
    res, ms = timed_ms(sba)
    out.update({"sba.t": res.poses.t, "sba.points": res.points,
                "sba.error": res.error, "sba.iterations": res.iterations})
    per_it["sba"] = ms / int(res.iterations)
    res, ms = timed_ms(dba)
    out.update({"ba.t": res.poses.t, "ba.points": res.points,
                "ba.pose_cov": res.pose_covariance,
                "ba.iterations": res.iterations})
    per_it["ba"] = ms / ba_dense.BAParams().max_iterations  # all run, masked
    for method in ("sim3", "se3"):
        opt, ms = timed_ms(lambda: backend.optimize(mesh=mesh, method=method))
        it = int(backend.last_result.iterations)
        out.update({f"{method}.t": opt.t, f"{method}.iterations": it})
        per_it[method] = ms / it
    return out, per_it


def dist_rank(rank: int, world: int, tmp: str, device_type: str) -> None:
    """One rank of the distributed check (a spawned process): gloo through
    a file store, every rank on the first card, the solves of
    phase_distributed on a mesh of ``world`` (a warm call, then the one
    kept), outputs and ms per LM iteration to ``tmp/out{rank}.npz``."""
    dev = torch.device(device_type, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        d = dict(np.load(os.path.join(tmp, "inputs.npz")))
        sub = {p: {k[len(p):]: v for k, v in d.items() if k.startswith(p)}
               for p in ("sba.", "ba.", "skel.")}
        args = (parallel.make_mesh(dev.type),
                convert.sparse_ba_problem_from_numpy(sub["sba."], device=dev),
                convert.ba_problem_from_numpy(sub["ba."], device=dev),
                convert.backend_from_numpy(sub["skel."], device=dev))
        distributed_solves(*args)
        out, per_it = distributed_solves(*args)
        out.update({f"{k}.ms_per_it": v for k, v in per_it.items()})
        np.savez(os.path.join(tmp, f"out{rank}.npz"),
                 **{k: np.asarray(torch.as_tensor(v).cpu())
                    for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def phase_distributed(dev, gpu: str, skel: dict) -> None:
    """The distributed layer on the card: one rank on NCCL against the
    ungrouped solves (bitwise), two gloo ranks on this card against them
    (DIST_RTOL), ms per LM iteration with and without the group."""
    sprob, _, _ = make_sequence_ba_problem(0, num_frames=256,
                                           points_per_frame=32, window=4,
                                           dtype=torch.float32, device=dev)
    dprob, _, _ = make_window_ba_problem(0, num_frames=8, num_points=512,
                                         dtype=torch.float32, device=dev)
    backend = convert.backend_from_numpy(skel, device=dev)
    extent = float(np.ptp(np.asarray(skel["kf_t"]), axis=0).max())
    span = float(np.ptp(sprob.poses0.t[:, 0].cpu().numpy()))

    def solves(mesh):
        return distributed_solves(mesh, sprob, dprob, backend)

    # one rank: a one-rank NCCL group formed in this process
    mesh = parallel.make_mesh(dev.type)
    if dist.get_backend() != "nccl" or mesh.size() != 1:
        raise AssertionError(f"one-rank mesh on {dist.get_backend()}, "
                             f"size {mesh.size()}")
    solves(None)                                       # warm both paths
    solves(mesh)
    # index_add_ (sparse BA) sums with atomics on the card unless
    # deterministic algorithms are asked for: the bitwise comparison asks
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain, _ = solves(None)
        plain2, _ = solves(None)
        grouped, _ = solves(mesh)
    finally:
        torch.use_deterministic_algorithms(False)
    differ = [k for k in plain
              if not torch.equal(torch.as_tensor(plain[k]),
                                 torch.as_tensor(grouped[k]))]
    self_differ = [k for k in plain
                   if not torch.equal(torch.as_tensor(plain[k]),
                                      torch.as_tensor(plain2[k]))]
    times = collections.defaultdict(list)
    for m in (None, mesh, mesh, None):                 # in turns
        for k, v in solves(m)[1].items():
            times[(k, m is not None)].append(v)
    dist.destroy_process_group()
    log(f"distributed: world size 1 on NCCL on {gpu}: sparse BA "
        f"({sprob.points0.shape[0]} landmarks, 256 frames, float32, 10 LM x "
        f"20 CG), dense BA (8 frames x 512 points, float32, 50 masked LM "
        f"iterations), the loop skeleton's Sim3 and SE3 graphs through "
        f"PoseGraphBackend.optimize(mesh=...) ({len(skel['kf_t'])} "
        f"keyframes, {len(skel['loop_j'])} loop edges): grouped vs "
        f"ungrouped {'bitwise equal' if not differ else f'DIFFER in {differ}'}"
        f" (deterministic algorithms on; two ungrouped runs "
        f"{'equal' if not self_differ else f'differ in {self_differ}'})")
    log("distributed: ms per LM iteration, without / with the one-rank "
        "group (none, group, group, none): " + "; ".join(
            f"{k} {'/'.join(f'{t:.2f}' for t in times[(k, False)])} / "
            f"{'/'.join(f'{t:.2f}' for t in times[(k, True)])}"
            for k in ("sba", "ba", "sim3", "se3")))
    if differ:
        raise AssertionError(f"one-rank group differs from the ungrouped "
                             f"solve in {differ}")

    # two ranks on gloo, both on this card
    with tempfile.TemporaryDirectory() as tmp:
        inputs = {f"sba.{k}": v for k, v in
                  convert.problem_to_numpy(sprob).items()}
        inputs.update({f"ba.{k}": v for k, v in
                       convert.problem_to_numpy(dprob).items()})
        inputs.update({f"skel.{k}": v for k, v in skel.items()})
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=dist_rank,
                             args=(r, DIST_WORLD, tmp, dev.type))
                 for r in range(DIST_WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(DIST_TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"gloo ranks exited with {codes}")
        ranks = [dict(np.load(os.path.join(tmp, f"out{r}.npz")))
                 for r in range(DIST_WORLD)]
    errs = {}
    for k, scale in (("sba.t", span), ("sba.points", span), ("ba.t", 1.0),
                     ("ba.points", 1.0), ("sim3.t", extent),
                     ("se3.t", extent)):
        want = torch.as_tensor(plain[k]).cpu().numpy()
        errs[k] = max(float(np.abs(r[k] - want).max()) for r in ranks) / scale
    same_ranks = all(np.array_equal(ranks[0][k], r[k])
                     for r in ranks[1:] for k in ranks[0]
                     if not k.endswith("ms_per_it"))
    its = {k: [int(r[f"{k}.iterations"]) for r in ranks]
           for k in ("sba", "ba", "sim3", "se3")}
    log(f"distributed: world size {DIST_WORLD} on gloo, both ranks on "
        f"{gpu}: ranks {'identical' if same_ranks else 'DIFFER'}, LM "
        f"iterations by rank {its} (ungrouped "
        f"{ {k: int(torch.as_tensor(plain[k + '.iterations'])) for k in its} }"
        f"), against the ungrouped solve relative to the extent (sparse "
        f"poses' span {span:.1f}, dense 1, skeleton {extent:.2f}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (limit {DIST_RTOL}); ms per LM iteration by rank: "
        + "; ".join(f"{k} {[round(float(r[k + '.ms_per_it']), 2) for r in ranks]}"
                    for k in ("sba", "ba", "sim3", "se3")))
    if (not same_ranks or any(len(set(v)) != 1 for v in its.values())
            or any(v > DIST_RTOL for v in errs.values())):
        raise AssertionError("two gloo ranks beyond the limits")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the card")
    dev = torch.device("cuda", 0)
    gpu = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {gpu}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    for source, load in ((KERNEL_SOURCE, features_cuda.load_library),
                         (BA_KERNEL_SOURCE, ba_cuda.load_library)):
        t0 = time.perf_counter()
        load()
        log(f"build: {source} -> {cuda_build.BUILD_DIR} (nvcc, sm_90a) "
            f"and load in {time.perf_counter() - t0:.2f} s")

    params = VoJitParams()
    card = f"{gpu} ({smi})"
    k1 = phase_kernel(dev, params.orb)
    k2 = phase_ba_kernel(dev)
    phase_solver(dev, params, card)
    phase_parity(dev, params)
    rot_launches = phase_reference_bars(dev, params, card)
    launches, frames, _ = phase_main(dev, params, card)
    recorded, slam_launches = phase_slam(card)
    phase_slam_parity(dev, recorded)
    skeleton = convert.backend_to_numpy(recorded)
    del recorded
    phase_sparse_ba(dev, card)
    host_launches = phase_host_vo(card)
    have = codecs()
    rec_launches, rec, pngs = phase_reconstruct(dev, card, have)
    k1.update(phase_calibration(dev, card, params.orb))
    loader_launches = phase_native_loader(dev, card, have)
    phase_viewer(dev, rec, pngs, have)
    orb_paths = phase_orb_options(dev, card)
    phase_distributed(dev, card, skeleton)

    # each path was driven with the count set to 0 just before it and read
    # just after; no single PyTorch call computes the corner front: no
    # library time
    by_path = {"tracker_replay": (launches, frames),
               "rotation": (rot_launches, ROT_FRAMES),
               "slam": (slam_launches, LOOP_FRAMES),
               "host_vo": (host_launches, HOST_VO_FRAMES),
               "reconstruct": (rec_launches, len(REC_FRAMES)),
               "native_loader_app": (
                   loader_launches, LOADER_FRAMES if loader_launches else 0),
               **{k: tuple(v) for k, v in orb_paths.items()}}
    total = sum(n for n, _ in by_path.values())
    # K2 launches on the driven tracker paths (the tracker's BA and the
    # bootstrap's refine) and in the back-end's loop polish
    idle = [k for k in ("tracker_replay", "rotation", "slam")
            if not BA_CALLS.get(k)]
    if idle:
        raise AssertionError(f"the two-frame BA kernel never ran on {idle}")
    log(json.dumps({"kernels": [{
        "name": "fast_nms_harris_rank", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": total,
        "launches_by_path": {k: n for k, (n, _) in by_path.items()},
        "launches_per_frame": total / sum(f for _, f in by_path.values()),
        **k1, "library_ms": None,
    }, {
        "name": "ba_two_frame", "route": "cuda", "source": BA_KERNEL_SOURCE,
        "replaces": BA_KERNEL_REPLACES,
        "launches": sum(BA_CALLS.values()),
        "launches_by_path": dict(BA_CALLS),
        "launches_counted": "wrapper calls: eager launches and CUDA-graph "
                            "captures",
        **k2, "library_ms": None,
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
