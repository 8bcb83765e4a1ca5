"""How often the fused tracker keeps the 90-frame closed loop of
``test_loop_closure.py`` whole, by the seed of its RANSAC draws: the JAX
tracker over its keys and the PyTorch port over its generator's seeds, both
on the CPU, each drawing for itself.

    JAX_PLATFORMS=cpu python tests/loop_seed_scan.py [--seeds 8]
                                                     [--package jax|torch|both]

One line per package and seed: the frames lost after the first as (frame,
mode before the step, PnP inliers, the two-frame BA's mean error), and the
largest mean error among the frames that were kept (the accept gate is 9.0).
A lost frame resets the tracker, which splits the loop into segments that no
loop edge joins. Not a test: about 25 s per seed and package.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from helpers import render_planes_sequence  # noqa: E402

H, W, FOCAL, FRAMES = 240, 320, 280.0, 90


def loop_frames() -> np.ndarray:
    th = np.linspace(np.pi / 2, np.pi / 2 + 2 * np.pi, FRAMES)
    ts = np.stack([2.75 * (1 - np.cos(th)), 0.02 * np.sin(3 * th),
                   0.35 * np.sin(th)], 1)
    return render_planes_sequence(ts, h=H, w=W, focal=FOCAL, bg_slope=0.18)


def intrinsics_inv() -> np.ndarray:
    return np.linalg.inv(np.asarray(
        [[FOCAL, 0, (W - 1) / 2], [0, FOCAL, (H - 1) / 2], [0, 0, 1]],
        np.float64))


def report(package: str, seed: int, rows) -> None:
    """``rows``: per frame (mode before, success, inliers, mean error)."""
    lost = [(t, m, n, round(e, 3)) for t, (m, ok, n, e) in enumerate(rows)
            if t and not ok]
    kept = max(e for m, ok, _, e in rows if ok and m == 2)
    print(f"{package} seed {seed}: lost {len(lost)} of {FRAMES - 1} frames "
          f"after the first: {lost}; largest mean error of a kept frame "
          f"{kept:.2f}", flush=True)


def scan_jax(frames, seeds: int) -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)       # as tests/conftest.py
    from mvslam_tpu.frontend.vo_jit import (
        VoJitParams, make_vo_step, vo_init_state,
    )

    params = VoJitParams()
    step = make_vo_step(params)
    K_inv = jnp.asarray(intrinsics_inv(), jnp.float32)
    focal = jnp.asarray(FOCAL, jnp.float32)
    for seed in range(seeds):
        state = vo_init_state(params, seed=seed)
        rows = []
        for img in frames:
            mode = int(state.mode)
            state, out = step(state, jnp.asarray(img), K_inv, focal)
            rows.append((mode, bool(out.success), int(out.num_inliers),
                         float(out.mean_error)))
        report("jax", seed, rows)


def scan_torch(frames, seeds: int) -> None:
    import torch

    from mvslam_tpu_torch.frontend.vo_jit import (
        VoJitParams, make_vo_step, vo_init_state,
    )

    torch.set_num_threads(4)
    params = VoJitParams()
    step = make_vo_step(params)
    K_inv = torch.tensor(intrinsics_inv(), dtype=torch.float32)
    for seed in range(seeds):
        state = vo_init_state(params, device="cpu", seed=seed)
        rows = []
        for img in frames:
            mode = int(state.mode)
            state, out = step(state, torch.from_numpy(img), K_inv, FOCAL)
            rows.append((mode, bool(out.success), int(out.num_inliers),
                         float(out.mean_error)))
        report("torch", seed, rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--package", choices=("jax", "torch", "both"),
                    default="both")
    args = ap.parse_args()
    frames = loop_frames()
    if args.package in ("jax", "both"):
        scan_jax(frames, args.seeds)
    if args.package in ("torch", "both"):
        scan_torch(frames, args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
