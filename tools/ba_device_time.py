"""Device time of the tracker's two-frame BA on the card: the kernel
(``ops/ba_cuda``, one launch) against the plain body
(``ops/ba.ba_solve_plain``), each as a CUDA-graph replay, on the problems
of a benchmark window's first TRACKING frames, as the step poses them.

    python3 tools/ba_device_time.py [--workload tsukuba.track] [--seed N]
        [--problems 4]

The problems are collected as ``tools/ba_vs_reference.py`` collects them
(the cell's frames from ``--seed``, the op-by-op step). One line a
problem: points, the kernel's and the plain body's ms and iterations, the
plain body's graph nodes; then the medians. The card only.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import torch  # noqa: E402

from ba_vs_reference import collect  # noqa: E402
from mvslam_tpu_torch.ops import ba  # noqa: E402
from mvslam_tpu_torch.utils.timing import graph_ms  # noqa: E402
from slambench import cell as cells  # noqa: E402


def nodes(fn) -> int:
    """Kernel, copy and fill nodes of ``fn`` captured in a CUDA graph."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="tsukuba.track")
    ap.add_argument("--seed", type=int, default=1_900_000_019)
    ap.add_argument("--problems", type=int, default=4)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    _, rows = collect(cells.resolve(args.workload), args.seed,
                      args.problems, dev)
    k2_ms, plain_ms = [], []
    for i, prob, _, params, _, _ in rows:
        k2 = graph_ms(lambda: ba.ba_solve(prob, params), reps=200)
        plain = graph_ms(lambda: ba.ba_solve_plain(prob, params), reps=20)
        it_k2 = int(ba.ba_solve(prob, params).iterations)
        it_plain = int(ba.ba_solve_plain(prob, params).iterations)
        k2_ms.append(k2)
        plain_ms.append(plain)
        print(f"frame {i}: {prob.points0.shape[0]} points, kernel {k2:.4f} "
              f"ms ({it_k2} iterations), plain {plain:.3f} ms ({it_plain} "
              f"iterations, "
              f"{nodes(lambda: ba.ba_solve_plain(prob, params))} nodes)",
              flush=True)
    print(f"{torch.cuda.get_device_name(0)}: median kernel "
          f"{statistics.median(k2_ms):.4f} ms, plain "
          f"{statistics.median(plain_ms):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
