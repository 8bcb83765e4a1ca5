"""Where the tracker on the card and the tracker on the CPU part ways on
the 90-frame closed loop of ``chip_smoke.py``, and why the tracker loses a
frame there.

    python3 card_vs_cpu.py [--frames N] [--trace-frame K] [--plain-front]
    python3 card_vs_cpu.py --why-lost S [--frames N]
    python3 card_vs_cpu.py --sync-sites [--frames N]

Default, lockstep and op trace: the fused tracker runs on the card and on
the CPU, both fed the same numpy-drawn RANSAC uniforms (``chip_smoke.py``'s
``lockstep``); one line per frame with each side's mode, success, inliers
and mean error and the pose difference. ``--plain-front`` gives the card
the plain corner front in place of its kernel, to tell the kernel's share
from PyTorch's. Then one frame (``--trace-frame K``; default: the first
frame whose success differs or whose |dt| exceeds 1e-2) is traced: the
card's state before frame K is copied to the CPU, so both sides start from
the same numbers; the step then runs on each device under a
``TorchDispatchMode`` that keeps every op's outputs, with the plain corner
front on both so that the op sequences align. The first discrete (bool/int)
output that differs, and every op at which the running maximum of the
relative float difference grows tenfold, are printed.

``--why-lost S``: the card's tracker alone, drawing from its own generator
seeded 0..S-1. Per seed the frames it lost and, at the first frame lost
while tracking, the two-frame BA's final cost split by observation group
with the largest single observation of each and how many pixels off that
observation is: which input trips the accept gate on the BA's mean error.

``--sync-sites``: the card's tracker alone with every synchronising call (a
read of a device value, an upload from pageable memory) counted by source
line.

Needs one CUDA card; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from chip_smoke import (
    LOOP_FOCAL, LOOP_FRAMES, LOOP_H, LOOP_W, intrinsics_inv, lockstep,
)
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.frontend.vo_jit import (
    VoJitParams, _make_vo_step_fns, make_vo_step, vo_init_state,
)
from mvslam_tpu_torch.ops import ba, features_cuda
from mvslam_tpu_torch.utils.scene import ellipse_loop, render_planes_sequence
from mvslam_tpu_torch.utils.timing import sync_sites


class OpRecorder(TorchDispatchMode):
    """Keeps (op name, outputs on the CPU) of every op run under it."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, list[torch.Tensor]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.records.append((str(func), [
            t.detach().to("cpu", copy=True) for t in tree_leaves(out)
            if isinstance(t, torch.Tensor)]))
        return out


def use_plain_front() -> None:
    """Every device takes the plain corner front."""
    def plain(levels, threshold, k, border):
        return [features_cuda.fast_nms_harris_rank_ref(lv, threshold, k,
                                                       border)
                for lv in levels]

    features_cuda.fast_nms_harris_rank_pyramid = plain


def tracker_sync_sites(frames, params, dev) -> None:
    """Synchronising calls of the tracker's step on ``dev`` by source line,
    split by the mode the frame started in."""
    step = make_vo_step(params)
    K_inv = intrinsics_inv(dev, LOOP_H, LOOP_W, LOOP_FOCAL)
    images = torch.from_numpy(frames).to(dev)
    state = vo_init_state(params, device=dev)
    by_mode = {}
    for t in range(frames.shape[0]):
        mode = int(state.mode)
        (state, _), sites = sync_sites(
            lambda: step(state, images[t], K_inv, LOOP_FOCAL))
        n, where = by_mode.setdefault(mode, [0, collections.Counter()])
        by_mode[mode][0] = n + 1
        where.update(sites)
    for mode, (n, where) in sorted(by_mode.items()):
        print(f"mode {mode}: {n} frames, {sum(where.values()) / n:.1f} "
              f"synchronising calls per frame; calls by source line over "
              f"those frames: {dict(where.most_common())}")


def ba_cost_shares(prob: ba.BAProblem, res: ba.BAResult, n_old: int) -> str:
    """The two-frame BA's final cost by observation group: old map points
    and fresh triangulations, each in the last frame and in the new one."""
    r, _, _ = ba._projection_residuals(res.poses, res.points, prob)
    cost = 0.5 * (r * r).sum(-1)                # (2, P), masked by weight 0
    off_px = (torch.linalg.vector_norm(r, dim=-1)
              / prob.obs_weight.clamp(min=1e-30) * LOOP_FOCAL)
    parts = []
    for name, f, sl in (("old points, last frame", 0, slice(0, n_old)),
                        ("old points, new frame", 1, slice(0, n_old)),
                        ("fresh points, last frame", 0, slice(n_old, None)),
                        ("fresh points, new frame", 1, slice(n_old, None))):
        c, k = cost[f, sl].max(0)
        parts.append(f"{name}: {int(prob.obs_mask[f, sl].sum())} "
                     f"observations, cost {float(cost[f, sl].sum()):.1f}, "
                     f"largest {float(c):.1f} ({float(off_px[f, sl][k]):.2f} "
                     f"px off at sigma "
                     f"{LOOP_FOCAL / float(prob.obs_weight[f, sl][k]):.2f}"
                     f" px)")
    n_obs = int(prob.obs_mask.sum())
    return (f"{n_obs} observations, cost {float(res.error):.1f}, mean error "
            f"{2 * float(res.error) / n_obs:.2f}; " + "; ".join(parts))


def why_lost(frames, params, dev, seeds: int) -> None:
    """Per seed the frames lost, and the BA of the first one lost while
    tracking, split by observation group. The step runs op by op (no CUDA
    graphs), so that each BA goes through ``ba.ba_solve`` as it is called."""
    step, _, _ = _make_vo_step_fns(params, cuda_graphs=False)
    K_inv = intrinsics_inv(dev, LOOP_H, LOOP_W, LOOP_FOCAL)
    images = torch.from_numpy(frames).to(dev)
    solved = []
    solve = ba.ba_solve

    def keeping(prob, ba_params=ba.BAParams()):
        solved[:] = [prob, solve(prob, ba_params)]
        return solved[1]

    ba.ba_solve = keeping
    for seed in range(seeds):
        state = vo_init_state(params, device=dev, seed=seed)
        lost, first = [], None
        for t in range(frames.shape[0]):
            mode = int(state.mode)
            state, out = step(state, images[t], K_inv, LOOP_FOCAL)
            if t and not bool(out.success):
                lost.append((t, mode, int(out.num_inliers),
                             round(float(out.mean_error), 3)))
                if mode == 2 and first is None:
                    first = (t, ba_cost_shares(*solved, params.ba_old))
        print(f"seed {seed} on {dev}: lost {len(lost)} of "
              f"{frames.shape[0] - 1} frames after the first; (frame, mode "
              f"before, inliers, mean error): {lost}")
        if first is not None:
            print(f"  frame {first[0]}, the BA behind the gate: {first[1]}")
    ba.ba_solve = solve


def trace(frame, state_card, draws, params, dev):
    """One step from the same state on both devices, op by op (no CUDA
    graphs on the card: the recorder sees each op)."""
    use_plain_front()
    step, _, _ = _make_vo_step_fns(params, cuda_graphs=False)
    recs = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        state = convert.state_from_numpy(convert.state_to_numpy(state_card),
                                         device=d)
        dr = None if draws is None else torch.tensor(
            draws, dtype=torch.float32, device=d)
        img = torch.from_numpy(frame).to(d)
        K_inv = intrinsics_inv(d, LOOP_H, LOOP_W, LOOP_FOCAL)
        with OpRecorder() as rec:                   # the step's ops alone
            _, out = step(state, img, K_inv, LOOP_FOCAL, dr)
        recs[name] = rec.records
        print(f"trace {name}: {len(rec.records)} ops, success "
              f"{bool(out.success)}, inliers {int(out.num_inliers)}, "
              f"mean error {float(out.mean_error):.4f}")
    running, first_discrete = 0.0, None
    for i, ((na, oa), (nb, ob)) in enumerate(zip(recs["cpu"], recs["card"])):
        if na != nb or len(oa) != len(ob):
            print(f"op {i}: sequences part ways: cpu {na}, card {nb}")
            break
        for a, b in zip(oa, ob):
            if a.shape != b.shape:
                print(f"op {i} {na}: shapes {tuple(a.shape)} vs "
                      f"{tuple(b.shape)}")
                return
            if not a.dtype.is_floating_point:
                n_diff = int((a != b).sum())
                if n_diff and first_discrete is None:
                    first_discrete = i
                    print(f"op {i} {na} {tuple(a.shape)} {a.dtype}: first "
                          f"discrete difference, {n_diff} of {a.numel()} "
                          f"entries (running float difference {running:.2e})")
                continue
            fin = torch.isfinite(a) & torch.isfinite(b)
            if not fin.any():
                continue
            scale = float(a[fin].abs().max())
            rel = float((a[fin] - b[fin]).abs().max()) / max(scale, 1e-30)
            if rel > 10 * max(running, 1e-8):
                print(f"op {i} {na} {tuple(a.shape)}: relative difference "
                      f"{rel:.2e} (scale {scale:.2e}; running maximum was "
                      f"{running:.2e})")
            running = max(running, rel)
    print(f"trace: compared {min(len(recs['cpu']), len(recs['card']))} ops, "
          f"running maximum {running:.2e}, first discrete difference at op "
          f"{first_discrete}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--trace-frame", type=int, default=None)
    ap.add_argument("--plain-front", action="store_true")
    ap.add_argument("--why-lost", type=int, default=0, metavar="SEEDS")
    ap.add_argument("--sync-sites", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("card_vs_cpu: no CUDA device; this script compares "
                         "the card with the CPU")
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", {args.frames} frames of the loop, "
          f"{'plain' if args.plain_front else 'kernel'} corner front on the "
          f"card")
    if args.plain_front:
        use_plain_front()
    params = VoJitParams()
    # the renderer sizes its textures by the whole path: render the loop,
    # then cut
    frames = render_planes_sequence(
        ellipse_loop(LOOP_FRAMES), h=LOOP_H, w=LOOP_W, focal=LOOP_FOCAL,
        bg_slope=0.18)[:args.frames]
    if args.sync_sites:
        tracker_sync_sites(frames, params, dev)
        return 0
    if args.why_lost:
        why_lost(frames, params, dev, args.why_lost)
        return 0
    k = args.trace_frame
    before = []
    for t, (modes, state, draws, outs) in enumerate(
            lockstep(frames, params, dev, LOOP_H, LOOP_W, LOOP_FOCAL)):
        before.append((state, draws[modes["cuda"]]))
        c, p = outs["cuda"], outs["cpu"]
        dt = float((c.pose_t.cpu() - p.pose_t).abs().max())
        odd = bool(c.success) != bool(p.success) or dt > 1e-2
        if odd and k is None:
            k = t
        print(f"frame {t:3d}: modes ({modes['cuda']}, {modes['cpu']}) success "
              f"({bool(c.success)}, {bool(p.success)}) inliers "
              f"({int(c.num_inliers)}, {int(p.num_inliers)}) mean error "
              f"({float(c.mean_error):.3f}, {float(p.mean_error):.3f}) "
              f"|dt| {dt:.2e}" + ("  <--" if odd else ""))
    if k is None:
        print("the two trackers agree on every frame: nothing to trace")
        return 0
    print(f"tracing frame {k} from the card's state before it")
    trace(frames[k], before[k][0], before[k][1], params, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
