"""Device time of the corner kernel's one launch per pyramid beside the
per-level kernel it replaced, on the card.

    python3 k1_device_time.py [--reps 200] [--per-level-source OLD.cu]

For the 8-level pyramid of the 288x384 bench frame it times, as replays of
a CUDA graph (one call per graph, and 20 calls in a row per graph, where
the replay call's own cost no longer shows) and as eager calls:

- the kernel of ``mvslam_tpu_torch/csrc/fast_nms_harris.cu``, one launch;
- the first version of that source, which had the per-level entry point
  ``mvslam_fast_nms_harris_rank(img, out, h, w, threshold, k, border,
  stream)``: its eight launches in one graph. Its maps are held bitwise to
  the present kernel's. The source is read from the commit that added the
  file (``git log --diff-filter=A``); in a copy without git history pass it
  with ``--per-level-source``
  (``git show <that commit>:mvslam_tpu_torch/csrc/fast_nms_harris.cu``);
- two yardsticks of what one replayed launch costs on the card: a device
  copy of as many bytes as the kernel must move, and a fill of its output.

Two rounds, the second in reverse order, so that drift of the card's clocks
shows as spread. Needs one CUDA card and ``nvcc``; prints one JSON object
last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from mvslam_tpu_torch.ops import features, features_cuda
from mvslam_tpu_torch.utils import cuda_build
from mvslam_tpu_torch.utils.scene import render_planes_sequence
from mvslam_tpu_torch.utils.timing import cuda_ms, graph_ms

KERNEL_SOURCE = "mvslam_tpu_torch/csrc/fast_nms_harris.cu"
#: calls captured in one graph for the back-to-back device time
IN_A_ROW = 20


def first_version_of_source() -> str:
    """The kernel source as the commit that added it had it."""
    root = Path(__file__).resolve().parent
    added = subprocess.run(
        ["git", "log", "--diff-filter=A", "--format=%H", "--", KERNEL_SOURCE],
        cwd=root, capture_output=True, text=True, check=True).stdout.split()
    return subprocess.run(
        ["git", "show", f"{added[-1]}:{KERNEL_SOURCE}"], cwd=root,
        capture_output=True, text=True, check=True).stdout


def per_level_runner(source: str, levels, orb):
    """One call = one launch per level of the per-level kernel ``source``."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        cu, so = Path(tmp) / "per_level.cu", Path(tmp) / "libper_level.so"
        cu.write_text(source)
        subprocess.run(
            [cuda_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
             str(so), str(cu)], check=True)
        lib = ctypes.CDLL(str(so))
    lib.mvslam_fast_nms_harris_rank.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.mvslam_fast_nms_harris_rank.restype = ctypes.c_int

    def run():
        outs = [torch.empty_like(lv) for lv in levels]
        stream = torch.cuda.current_stream().cuda_stream
        for lv, out in zip(levels, outs):
            err = lib.mvslam_fast_nms_harris_rank(
                lv.data_ptr(), out.data_ptr(), lv.shape[0], lv.shape[1],
                orb.fast_threshold, orb.harris_k, orb.border, stream)
            if err:
                raise RuntimeError(f"per-level launch failed: {err}")
        return outs
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--per-level-source", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_device_time: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    old_source = (args.per_level_source.read_text() if args.per_level_source
                  else first_version_of_source())

    orb = features.OrbParams()
    frame = render_planes_sequence(np.zeros((1, 3)), h=288, w=384,
                                   focal=300.0)[0]
    levels = features.pyramid(torch.from_numpy(frame).to(dev), orb)
    args_k = (orb.fast_threshold, orb.harris_k, orb.border)
    pixels = sum(lv.numel() for lv in levels)
    src = torch.rand(pixels, device=dev)
    dst = torch.empty_like(src)
    runners = {
        "pyramid_1_launch": lambda: features_cuda.fast_nms_harris_rank_pyramid(
            levels, *args_k),
        "per_level_8_launches": per_level_runner(old_source, levels, orb),
        "yardstick_copy_same_bytes": lambda: dst.copy_(src),
        "yardstick_fill_output": lambda: dst.fill_(0.0),
    }
    new, old = runners["pyramid_1_launch"](), runners["per_level_8_launches"]()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(new, old))

    rows = {name: {"device_ms": [], "device_ms_back_to_back": [],
                   "eager_ms": []} for name in runners}
    order = list(runners)
    for names in (order, order[::-1]):
        for name in names:
            rows[name]["device_ms"].append(graph_ms(runners[name], args.reps))
            rows[name]["device_ms_back_to_back"].append(graph_ms(
                runners[name], args.reps // IN_A_ROW, calls=IN_A_ROW))
            rows[name]["eager_ms"].append(cuda_ms(runners[name], args.reps))
    for name, row in rows.items():
        print(f"{name:28s} device {min(row['device_ms']) * 1e3:7.2f} us "
              f"({min(row['device_ms_back_to_back']) * 1e3:6.2f} us each of "
              f"{IN_A_ROW} in one graph), eager "
              f"{min(row['eager_ms']) * 1e3:7.2f} us", flush=True)
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "reps": args.reps, "frame": [288, 384],
                      "levels": len(levels), "pixels": pixels,
                      "per_level_bitwise_equal": bitwise, "rows": rows}))
    return 0 if bitwise else 1


if __name__ == "__main__":
    raise SystemExit(main())
