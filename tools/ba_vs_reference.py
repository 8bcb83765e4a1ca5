"""The tracker's two-frame BA problems of one benchmark window, solved by the
port on the card and by the plain reference (``slambench/reference_ba.py``,
float64), with the control that drops the Huber kernel.

    python3 tools/ba_vs_reference.py [--workload kitti.track] [--seed N]
        [--problems 60] [--out FILE.json]

The cell's frames are rendered as ``slambench/run.py`` renders them (the
whole mix from ``--seed``) and run from the first through the op-by-op
step (``vo_jit._make_vo_step_fns(..., cuda_graphs=False)``, bit for bit
the graphed step), tracker seed ``--seed``, until ``--problems`` frames
that entered in TRACKING ran their BA. ``counters.BATap`` keeps each such
frame's problem (the BA over ``ba_old + ba_new`` points) and its result.
Each problem is then solved again by the port with the tracker's settings
(float32 on the card; the result must equal the kept one bit for bit), by
the reference with the same iterations in float64 on the card, and by the
port without ``huber_delta`` (the control). Two more solves tell where a
gap comes from: the port in float64 with the tracker's settings (its
solver, not its precision), and the port in float32 and the reference
both given ``CONVERGED_ITERATIONS`` (the float32 solve's stopping short).
One line per problem, then the largest and the median gaps
(``reference_ba.Gaps``) of each solve.

Exits 1 unless every Huber solve lies within ``TOL_ALL``, the Huber
solves' median gaps over the frames whose BA had observations past the
delta lie within ``TOL_MEDIAN``, the control's median gaps over those
frames lie outside it, and every re-solve is the kept result. The card
only: the reference's dense system at 2,048 points is ~6,156 unknowns.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mvslam_tpu_torch.frontend import vo_jit  # noqa: E402
from mvslam_tpu_torch.ops import ba  # noqa: E402
from slambench import cell as cells  # noqa: E402
from slambench import counters, program, reference, reference_ba, scene  # noqa: E402,E501

#: The tolerances, from 180 problems of three kitti.track windows (seeds
#: 2190000023, 2970000019, 2466212074) on an H100, where the port's 10
#: float32 iterations stop short of the float64 reference on a few
#: problems late in a window (the map points' information ~5e6).
#: ``TOL_MEDIAN``, the median over the frames whose BA had observations
#: past the delta (50-52 of 60 a window), tells the kernel on from off:
#: the Huber solves' medians read at most 1.71e-7 rad, 4.16e-6 of the
#: baseline, 0.0207 sigma, 3.86e-5 of a point's depth and 1.86e-5 of the
#: cost; the control's at least 7.71e-5, 4.62e-3, 0.751, 4.95e-3 and
#: 0.0451. Each limit lies near the two readings' geometric mean, 6-50x
#: from either.
TOL_MEDIAN = reference_ba.Gaps(4e-6, 1.5e-4, 0.12, 4.5e-4, 1e-3)
#: ``TOL_ALL``, on every problem, bounds the float32 solve's stopping
#: short: the Huber solves read at most 2.06e-5 rad, 1.15e-3, 20.5 sigma,
#: 0.0104 and +55% of the cost, and the same solve without the kernel on
#: both sides 5.9e-5, 4.3e-4, 17.2, 0.022 and +100%; each limit is about
#: twice the larger. The control does not lie outside it on every problem
#: (where few observations pass the delta the two solves differ by less
#: than float32's stopping short).
TOL_ALL = reference_ba.Gaps(1.2e-4, 2.5e-3, 40.0, 0.05, 2.0)
#: the iterations of the solves that show what more iterations give
CONVERGED_ITERATIONS = 50


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _cast(x, dtype):
    """A problem (nested named tuples of tensors) in ``dtype``."""
    if isinstance(x, tuple):
        return type(x)(*(_cast(y, dtype) for y in x))
    return x.to(dtype) if torch.is_floating_point(x) else x


def collect(cell, seed: int, n: int, dev):
    """The params, and (frame, problem, result, BA params, robust share,
    success) of the first ``n`` TRACKING frames' BA."""
    tr = cell.traffic
    frames = torch.empty((tr.ts.shape[0], cell.camera.height,
                          cell.camera.width), dtype=torch.uint8,
                         pin_memory=dev.type == "cuda")
    scene.render_uint8(torch.Generator(device=dev).manual_seed(seed), tr.ts,
                       tr.yaws, cell.camera, tr.bg_slope, frames)
    trk = program.tracker(cell.config, cell.camera.K(), dev)
    p = trk.params
    step, _, _ = vo_jit._make_vo_step_fns(p, cuda_graphs=False)
    rows = []
    with counters.tapped() as tap:
        state = trk.init_state(seed)
        for i in range(tr.ts.shape[0]):
            entry = int(state.mode)
            tap.solved.clear()
            img = reference.to_image(frames[i].to(dev))
            state, out = step(state, img, trk.K_inv, trk.focal)
            if entry == vo_jit.MODE_TRACKING:
                (prob, params, res), = tap.solved
                rows.append((i, prob, res, params, float(
                    ba.huber_share(res.poses, res.points, prob,
                                   p.huber_delta)), bool(out.success)))
                if len(rows) >= n:
                    break
    return p, rows


def _fmt(g) -> str:
    return " ".join(f"{x:.3g}" for x in g)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="kitti.track")
    ap.add_argument("--seed", type=int, default=1_900_000_019)
    ap.add_argument("--problems", type=int, default=60)
    ap.add_argument("--out", default="",
                    help="also write the rows here, as JSON")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    cell = cells.resolve(args.workload)
    t0 = time.perf_counter()
    p, rows = collect(cell, args.seed, args.problems, dev)
    print(f"{len(rows)} BA problems of {args.workload} seed {args.seed} in "
          f"{time.perf_counter() - t0:.1f} s; huber_delta {p.huber_delta}",
          flush=True)
    kinds = ("huber", "control", "port_f64", "converged")
    print("frame success robust | " + " | ".join(
        f"{k}: " + " ".join(TOL_ALL._fields) for k in kinds)
        + " | iterations port ref | s", flush=True)
    out = []
    for i, prob, kept, params, robust, ok in rows:
        t1 = time.perf_counter()
        res = ba.ba_solve(prob, params)
        same = all(_bits_equal(a, b) for a, b in (
            (res.poses.R, kept.poses.R), (res.poses.t, kept.poses.t),
            (res.points, kept.points)))
        rp = reference_ba.from_port(prob)
        ref = reference_ba.solve(rp, p.huber_delta,
                                 max_iterations=params.max_iterations)
        info = reference_ba.point_information(rp, ref, p.huber_delta)

        def gap(r, against=ref):
            return reference_ba.gaps(r.poses.R, r.poses.t, r.points, against,
                                     rp, info, p.huber_delta)

        ctl = ba.ba_solve(prob, params._replace(huber_delta=None))
        f64 = ba.ba_solve(_cast(prob, torch.float64), params)
        more = params._replace(max_iterations=CONVERGED_ITERATIONS)
        ref_more = reference_ba.solve(rp, p.huber_delta,
                                      max_iterations=CONVERGED_ITERATIONS)
        g = dict(huber=gap(res), control=gap(ctl), port_f64=gap(f64),
                 converged=gap(ba.ba_solve(prob, more), ref_more))
        within = all(a <= b for a, b in zip(g["huber"], TOL_ALL))
        row = dict(frame=i, success=ok, robust=robust,
                   ref_robust=reference_ba.robust_share(
                       rp, ref.R, ref.t, ref.points, p.huber_delta),
                   within=within, same_bits=same,
                   iterations=[int(res.iterations), ref.iterations],
                   info_max=float(prob.point_prior_info.diagonal(
                       dim1=-2, dim2=-1).sum(-1).max()),
                   **{k: v._asdict() for k, v in g.items()})
        out.append(row)
        print(f"{i} {int(ok)} {robust:.4f} | "
              + " | ".join(_fmt(g[k]) for k in kinds)
              + f" | {int(res.iterations)} {ref.iterations} | "
              f"{time.perf_counter() - t1:.2f}"
              + ("" if same else " RE-SOLVE DIFFERS")
              + ("" if within else " OUTSIDE"), flush=True)
    fields = TOL_ALL._fields
    robust_rows = [r for r in out if r["robust"] > 0]
    for k in kinds:
        worst = {f: max(r[k][f] for r in out) for f in fields}
        med = {f: float(np.median([r[k][f] for r in robust_rows]))
               for f in fields} if robust_rows else {}
        print(f"{k}: largest {worst}; median where robust > 0 {med}")
    med_h = [float(np.median([r["huber"][f] for r in robust_rows]))
             for f in fields] if robust_rows else []
    med_c = [float(np.median([r["control"][f] for r in robust_rows]))
             for f in fields] if robust_rows else []
    typical = bool(med_h) and all(a <= b for a, b in zip(med_h, TOL_MEDIAN))
    ctl_out = [f for f, a, b in zip(fields, med_c, TOL_MEDIAN) if a > b]
    n_ctl = sum(any(a > b for a, b in zip(r["control"].values(), TOL_ALL))
                for r in robust_rows)
    print(f"TOL_ALL {TOL_ALL._asdict()}; TOL_MEDIAN {TOL_MEDIAN._asdict()}; "
          f"Huber solves within TOL_ALL: {sum(r['within'] for r in out)} of "
          f"{len(out)}; re-solves bit-equal: "
          f"{sum(r['same_bits'] for r in out)} of {len(out)}; frames with "
          f"robust > 0: {len(robust_rows)}; Huber medians within "
          f"TOL_MEDIAN: {typical}; control medians outside it on "
          f"{ctl_out}; control outside TOL_ALL on {n_ctl} of those frames; "
          f"robust share median "
          f"{np.median([r['robust'] for r in out]) if out else 0:.4f}, max "
          f"{max((r['robust'] for r in out), default=0):.4f}", flush=True)
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(
            workload=args.workload, seed=args.seed,
            tol_all=TOL_ALL._asdict(), tol_median=TOL_MEDIAN._asdict(),
            rows=out)))
    good = (all(r["within"] and r["same_bits"] for r in out) and typical
            and bool(ctl_out))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
