"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 slambench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell's frames are rendered on the card from ``--seed`` and kept as
8-bit images in pinned host memory; the tracker is warmed up on a prefix
of them; then one camera is served in a closed loop for ``--seconds``
(``serve.py``). With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy time and the breakdown. Once the window has closed the
comparison with the plain reference (``checks.py``) decides ``correct``;
each number compared is printed beside its limit, last on standard error
and last in the result line. The last line of standard output is the
result, one JSON object.

Exits non-zero, with no result, without a CUDA card, when the cell asks
for more cards than there are, and when ``jax``, ``jaxlib``, ``flax`` or
the JAX package (``mvslam_tpu``) has been loaded by the time the window
closes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the program's build and kernel caches: fixed directories in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "triton"}
#: top-level module names that must not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "mvslam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].split(",")[-1].strip() if lines else "unknown"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> dict:
    """Everything of one run but the card checks and the printing: the
    result's keys, plus ``numbers`` (the comparison) and ``log``."""
    import numpy as np
    import torch

    from slambench import checks, program, scene, serve, stats
    from slambench import trace as tr

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    traffic = cell.traffic
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.empty((traffic.ts.shape[0], cell.camera.height,
                          cell.camera.width), dtype=torch.uint8,
                         pin_memory=cuda)
    phases = {"imports_and_buffer": time.perf_counter() - T_START}
    scene.render_uint8(gen, traffic.ts, traffic.yaws, cell.camera,
                       traffic.bg_slope, frames)
    phases["render"] = time.perf_counter() - T_START
    session = serve.Session(cell, frames, seed, dev)
    session.warm_up()
    phases["warm_up"] = time.perf_counter() - T_START
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng([seed, 0x7A9])
    rank_sample = set(rng.choice(np.arange(2, 40), 4, replace=False).tolist())
    prof = tr.Profiler(program.K1_KERNEL, cuda)
    setup_s = time.perf_counter() - T_START
    log = session.serve(seconds, trace, rank_sample, prof)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit("loaded by the time the window closed: "
                         + ", ".join(loaded))
    n = log.frames
    window_s = log.end - log.start
    entry = np.asarray(log.entry_mode)
    success = np.asarray(log.success)
    poses = np.asarray(log.poses, np.float64).reshape(n, 12)
    # ``failed``: steps that raised or gave a non-finite pose. A frame the
    # tracker loses (entered in TRACKING, not accepted) is an answer, not
    # a failed step: how many there are follows the RANSAC draws and the
    # window's frame count, so it is reported apart as ``lost`` and held
    # by ``correct`` through ``tracked``.
    lost = int(((entry == program.MODE_TRACKING) & ~success).sum())
    nonfinite = ~np.isfinite(poses).all(1)
    failed = int((nonfinite | np.asarray(log.raised)).sum())
    ext = scene.extent(traffic.ts, cell.camera)
    centres = traffic.ts[:n]
    truth = checks.Truth(
        R=scene.rotation_y(traffic.yaws[:n]), c=centres, x_mid=ext.mid,
        bg_slope=traffic.bg_slope,
        extent=float(np.linalg.norm(centres.max(0) - centres.min(0))))
    profile = prof.result() if trace else None
    numbers = checks.compare(log, frames, truth,
                             program.reference_orb(cell.config), seed, dev,
                             control)
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s,
                  "frames_per_s": stats.rate(n, window_s),
                  "frame_ms_p90": 1e3 * stats.percentile(log.latency_s, 90)}
        for name, unit in cell.end_to_end:
            metrics[name] = {"value": values[name], "unit": unit}
    else:
        ctx = Reading(cell, log, profile, frames, dev)
        for m in cell.per_layer:
            v = m.reader.read(ctx)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    out = {"correct": not numbers.failed() and n > 0, "attempted": n,
           "failed": failed, "lost": lost, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if cuda
                      else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)},
           "numbers": numbers, "log": log, "profile": profile,
           "window_s": window_s, "phases": phases}
    if trace and profile is not None:
        out["device"]["busy_s"] = profile.busy_s
        out["device"]["window_s"] = profile.window_s
        out["breakdown"] = {"device_ops": profile.device_ops,
                            "idle_gaps": profile.idle_gaps}
        out["profiled_frames"] = {m: f.frames
                                  for m, f in profile.by_mode.items()}
    return out


class Reading:
    """What a per-layer metric's reader may read: the cell, the traced
    window's log (spans in seconds), its profile, and the frames."""

    def __init__(self, cell, log, profile, frames, device):
        self.cell = cell
        self.log = log
        self.profile = profile
        self.frames = frames
        self.device = device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, path in CACHES.items():
        os.environ[var] = str(path)
    sys.path.insert(0, str(ROOT))

    import torch

    from slambench import cell as cells

    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures on an NVIDIA H100 only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    limit = power_limit()
    print(f"card: {name}, {torch.cuda.device_count()} found, power limit "
          f"{limit}; cell {cell.name} seed {args.seed} seconds "
          f"{args.seconds} trace {args.trace}", file=sys.stderr)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    numbers = res["numbers"]
    log = res["log"]
    print(f"window: {log.frames} frames in {res['window_s']:.4f} s "
          f"({log.cpu_s:.3f} s of the process's CPU time), "
          f"failed {res['failed']}, lost {res['lost']}"
          + (f", first error: {log.first_error}" if log.first_error else ""),
          file=sys.stderr)
    by_mode = {}
    for m, lat in zip(log.entry_mode, log.latency_s):
        by_mode.setdefault(m, []).append(1e3 * lat)
    print("frames by entering mode (0 empty, 1 initializing, 2 tracking): "
          + ", ".join(f"{m}: {len(v)} at median {sorted(v)[len(v) // 2]:.3f}"
                      f" ms" for m, v in sorted(by_mode.items())),
          file=sys.stderr)
    print("set-up, seconds from the start at the end of each phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in res["phases"].items()),
          file=sys.stderr)
    result = {k: res[k] for k in ("correct", "attempted", "failed",
                                  "lost", "metrics", "device")}
    result["device"]["power_limit"] = limit
    for key in ("breakdown", "profiled_frames"):
        if key in res:
            result[key] = res[key]
    result["compared"] = numbers.limits()
    for k, (v, lim) in numbers.limits().items():
        print(f"compared {k} {v!r} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
