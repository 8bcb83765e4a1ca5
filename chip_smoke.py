"""GPU smoke run of the PyTorch port: builds the CUDA corner kernel, checks
both of its wrappers against its plain version, times its one launch per
pyramid (eager call, CUDA-graph replay) beside the plain version and the
card's bound, checks the tracker on the card against the tracker on the
CPU, then drives the tracker's main path (110-frame replay) on the card
and times it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; imports neither JAX nor
the JAX package. Each phase prints its result; any failure raises and the
script exits non-zero. The last line is one JSON object naming the device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mvslam_tpu_torch.frontend.vo_jit import (
    VoJitParams, make_vo_replay, make_vo_step, vo_init_state,
)
from mvslam_tpu_torch.ops import features, features_cuda
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.utils.scene import render_planes_sequence
from mvslam_tpu_torch.utils.timing import cuda_ms, graph_ms

KERNEL_SOURCE = "mvslam_tpu_torch/csrc/fast_nms_harris.cu"
KERNEL_REPLACES = "mvslam_tpu/ops/features_pallas.py:142"
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
    """Both wrappers vs plain on the card at every pyramid level of a
    288x384 and a 480x640 frame, pyramid views vs per-level calls bitwise;
    then the 288x384 pyramid timed as plain, eager call and graph replay."""
    args = (orb.fast_threshold, orb.harris_k, orb.border)
    max_err = worst_rel = 0.0
    levels_checked = 0
    for (h, w, focal) in ((H, W, FOCAL), (480, 640, 500.0)):
        frame = render_planes_sequence(bench_trajectory(1), h=h, w=w,
                                       focal=focal)[0]
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
    log(f"kernel vs plain: {levels_checked} levels, both wrappers: corner "
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


def phase_parity(dev, params: VoJitParams):
    """8 frames through make_vo_step on the CPU (plain corner front) and on
    the card (kernel), fed the same numpy-drawn RANSAC uniforms."""
    n = 8
    frames = render_planes_sequence(bench_trajectory(n), h=H, w=W,
                                    focal=FOCAL)
    rng = np.random.default_rng(2024)
    step = make_vo_step(params)
    K = params.orb.max_features
    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        runs[name] = dict(state=vo_init_state(params, device=d), d=d,
                          K_inv=intrinsics_inv(d),
                          focal=torch.tensor(FOCAL, dtype=torch.float32,
                                             device=d), outs=[])
    for t in range(n):
        modes = {k: int(r["state"].mode) for k, r in runs.items()}
        if modes["cpu"] != modes["cuda"]:
            raise AssertionError(f"frame {t}: modes differ {modes}")
        draws = None
        if modes["cpu"] == 1:
            draws = rng.uniform(size=(params.init_window,
                                      params.ransac_hypotheses, K))
        elif modes["cpu"] == 2:
            draws = rng.uniform(size=(params.pnp_hypotheses, K))
        for r in runs.values():
            dr = None if draws is None else torch.tensor(
                draws, dtype=torch.float32, device=r["d"])
            r["state"], out = step(r["state"],
                                   torch.from_numpy(frames[t]).to(r["d"]),
                                   r["K_inv"], r["focal"], dr)
            r["outs"].append(out)
    seq = {k: [(int(o.mode), bool(o.success)) for o in r["outs"]]
           for k, r in runs.items()}
    if seq["cpu"] != seq["cuda"]:
        raise AssertionError(f"mode/success sequences differ: {seq}")
    pairs = list(zip(runs["cuda"]["outs"], runs["cpu"]["outs"]))
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
    state, outs = replay(vo_init_state(params, device=dev), images, K_inv,
                         focal)
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
    # trajectory health in the longest tracked run (as in tests/
    # test_long_sequence.py): a reset restarts the monocular gauge, so fit
    # the scale on x within the run and bound the drift
    ok = outs.success.cpu().numpy().astype(bool)
    runs, start = [], None
    for i, o in enumerate(list(ok) + [False]):
        if o and start is None:
            start = i
        if not o and start is not None:
            runs.append((start, i))
            start = None
    s0, s1 = max(runs, key=lambda r: r[1] - r[0])
    est = outs.pose_t.cpu().numpy().astype(np.float64)[s0:s1]
    gt = ts_gt[s0:s1] - ts_gt[s0]
    ex = est[:, 0] - est[0, 0]
    s = float((ex @ gt[:, 0]) / max(ex @ ex, 1e-9))
    resid = float(np.abs(s * (est - est[0]) - gt).max())
    span = float(gt[:, 0].max())
    if s1 - s0 < MIN_RUN or resid >= 0.05 * span:
        raise AssertionError(f"trajectory: run {s1 - s0}/{n}, drift "
                             f"{resid} vs {0.05 * span}")

    passes = 3
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the card")
    dev = torch.device("cuda", 0)
    gpu = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {gpu}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    features_cuda.load_library()
    log(f"build: {KERNEL_SOURCE} -> {features_cuda.BUILD_DIR} (nvcc, sm_90a) "
        f"and load in {time.perf_counter() - t0:.2f} s")

    params = VoJitParams()
    k1 = phase_kernel(dev, params.orb)
    phase_parity(dev, params)
    launches, frames, _ = phase_main(dev, params, f"{gpu} ({smi})")

    # no single PyTorch call computes the corner front: no library time
    log(json.dumps({"kernels": [{
        "name": "fast_nms_harris_rank", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "launches_per_frame": launches / frames, **k1,
        "library_ms": None,
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
