"""Readings the comparison's limits are set from, for one cell, in one
process on the card:

- the program's numbers on each of ``--seeds`` (the lower readings);
- on the same frames, the feature front's numbers of the plain reference
  computed in bfloat16, put in the program's place (the control of the
  feature numbers: TF32 does not reach that matmul-free front), and the
  geometry numbers with the faults of ``checks`` planted in the window's
  answers;
- on each of ``--control-seeds``, the program run with its own TF32 path
  switched on (``torch.backends.cuda.matmul.allow_tf32``, which the port
  turns off at import): the control of the numbers past the feature front.

    python3 slambench/readings.py --workload NAME --seconds S
        --seeds 1,2,3 [--control-seeds 4,5,6] [--out FILE.jsonl]

Each run prints one JSON line (seed, kind, numbers, the per-window gaps
behind the geometry numbers, end-to-end values and the median latency by
entering mode); ``--out`` keeps them too. A seed may repeat: its runs in
one process, set against runs of the same seed in separate processes,
show how much of the spread between runs is the process's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from slambench import cell as cells
    from slambench import run, stats

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = cells.resolve(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for kind, seed in ([("program", s) for s in seeds]
                           + [("tf32", s) for s in controls]):
            tf32 = kind == "tf32"
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            res = run.run_cell(cell, seed, args.seconds, False, "cuda",
                               control=not tf32)
            log = res["log"]
            line = {"cell": cell.name, "kind": kind, "seed": seed,
                    "correct": res["correct"], "attempted": res["attempted"],
                    "failed": res["failed"], "lost": res["lost"],
                    "numbers": dict(res["numbers"]),
                    "frames_per_s": stats.rate(log.frames, res["window_s"]),
                    "frame_ms_p90": 1e3 * stats.percentile(log.latency_s, 90)}
            line["gaps"] = {k: [float(f"{x:.5g}") for x in v]
                            for k, v in res["numbers"].gaps.items()}
            by_mode = {}
            for m, lat in zip(log.entry_mode, log.latency_s):
                by_mode.setdefault(str(m), []).append(1e3 * lat)
            line["median_ms_by_mode"] = {m: [len(v), stats.median(v)]
                                         for m, v in by_mode.items()}
            line["cpu_s"] = log.cpu_s
            if not tf32:
                line["upper"] = res["numbers"].control
                line["upper_gaps"] = {
                    k: [float(f"{x:.5g}") for x in v]
                    for k, v in res["numbers"].control_gaps.items()}
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            del res, log
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
