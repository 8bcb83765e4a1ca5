"""The comparison that decides ``correct``: what the timed window produced,
held against the plain reference once the window has closed.

- Feature front, on a sample of the window's frames drawn from the seed:
  the keypoints and descriptors the step stored in its state
  (``lf_xy``, ``lf_desc``, ``lf_mask``: the frame's own features on every
  branch), and K1's rank maps on the frames the tap kept, against
  ``reference.detect`` on the same 8-bit frame.
- State machine, on every frame: each pose's rotation is a rotation
  (``rot_ortho``); the frames tracked. Over each window of ``FIT_WINDOW``
  frames of a tracking segment (a frame that bootstrapped and the frames
  joined to it; the whole segment while shorter): the widest gap between
  a frame's rotation relative to the window's first and the scene's exact
  one, and between the camera centres and the true ones after a
  similarity fit (monocular scale and origin are free), over the window's
  true path length. The ``QUANTILE``-th percentile over all the window's
  fit windows is compared: a fault that spoils more than a tenth of them
  fails it.
- Map: on every frame that ends a fit window, the valid map points in the
  frame's camera, at that window's scale, put in the true frame through
  the frame's true pose, against the scene's two planes: each frame's
  median relative depth gap, and the ``QUANTILE``-th percentile over the
  frames.

Each number has its limit in ``LIMITS``; ``PERF.md`` gives the readings
each was set from. ``control`` adds the readings the limits' upper ends
come from, on the same frames: the feature front's reference computed in
bfloat16 put in the program's place, and the window's own answers with a
fault planted where they are produced (``FAULT_*``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from slambench import reference, scene

#: name -> (limit, direction): "max" numbers must not exceed it, "min"
#: numbers must reach it. Each limit lies between the largest reading of
#: sound runs and the smallest of the control or of a planted fault, on
#: the card at the cells' sizes (PERF.md section 2 gives both readings).
LIMITS = {
    "kp_miss": (0.02, "max"),
    "desc_diff": (0.02, "max"),
    "k1_corner_miss": (0.005, "max"),
    "k1_harris_rel": (1e-4, "max"),
    "rot_ortho": (2e-4, "max"),
    "tracked": (30, "min"),
    "rot_err": (0.06, "max"),
    "traj_err": (0.2, "max"),
    "map_err": (0.55, "max"),
}
TRACKING = 2              # the tracker's mode numbers
MIN_SEGMENT = 3           # frames a similarity fit needs
FIT_WINDOW = 10           # frames of one fit
QUANTILE = 90             # percentile over fit windows (map: frames)
FEATURE_SAMPLE = 8
#: the faults planted in the window's answers for the upper readings:
#: every FAULT_EVERY-th frame's position doubled, or its rotation turned
#: by FAULT_TURN rad about y; every map point at twice its depth
FAULT_EVERY = 7
FAULT_TURN = 0.1


class Truth(NamedTuple):
    """The scene's exact camera-to-world poses and planes."""

    R: np.ndarray           # (N, 3, 3)
    c: np.ndarray           # (N, 3) camera centres
    x_mid: float            # the background slant's pivot
    bg_slope: float
    extent: float           # the largest distance between two centres


class Numbers(dict):
    """name -> value of what was compared; ``control`` holds the upper
    readings when asked for, ``gaps`` the per-window (map: per-frame) gaps
    behind the percentiles, ``control_gaps`` the same under the faults."""

    control: dict
    gaps: dict
    control_gaps: dict

    def failed(self) -> list[str]:
        bad = []
        for name, value in self.items():
            limit, how = LIMITS[name]
            if not math.isfinite(value):
                bad.append(name)
            elif how == "max" and value > limit:
                bad.append(name)
            elif how == "min" and value < limit:
                bad.append(name)
        return bad

    def limits(self) -> dict:
        return {k: [v, ("<= " if LIMITS[k][1] == "max" else ">= ")
                    + repr(LIMITS[k][0])] for k, v in self.items()}


# ---- feature front ---------------------------------------------------------

def _level_of_slot(orb: reference.Orb, device) -> torch.Tensor:
    b = reference.level_budgets(orb)
    return torch.repeat_interleave(torch.arange(len(b), device=device),
                                   torch.as_tensor(b, device=device))


def _keys(xy, level, orb: reference.Orb) -> torch.Tensor:
    """(level, level-local x, y) of keypoints as one int64 key."""
    s = torch.as_tensor([orb.scale_factor ** lv
                         for lv in range(orb.num_levels)],
                        dtype=torch.float64, device=xy.device)[level]
    xl = torch.round(xy[:, 0].double() / s).long()
    yl = torch.round(xy[:, 1].double() / s).long()
    return (level * 8192 + yl) * 8192 + xl


def feature_gaps(xy, desc, mask, ref: reference.Features,
                 orb: reference.Orb) -> tuple[float, float]:
    """(share of keypoints in one set and not the other, over the
    reference's count; share of the common keypoints whose descriptors
    differ in any bit)."""
    kp = _keys(xy, _level_of_slot(orb, xy.device), orb)[mask]
    kr = _keys(ref.xy, ref.level, orb)[ref.mask]
    only_p = int((~torch.isin(kp, kr)).sum())
    only_r = int((~torch.isin(kr, kp)).sum())
    common = torch.isin(kp, kr)
    order_r = torch.argsort(kr)
    pos = torch.searchsorted(kr[order_r], kp[common])
    dr = ref.desc[ref.mask][order_r][pos]
    diff = (desc[mask][common] != dr).any(dim=1)
    return ((only_p + only_r) / max(int(kr.numel()), 1),
            int(diff.sum()) / max(int(common.sum()), 1))


def rank_gaps(prog_ranks, ref_ranks) -> tuple[float, float]:
    """(share of corners, over the reference's, in one rank map's set and
    not the other's; largest Harris gap on common corners over the level's
    largest |Harris|), over all levels."""
    miss, n_ref, rel = 0, 0, 0.0
    for p, r in zip(prog_ranks, ref_ranks):
        p, r = p.float(), r.float()
        fp, fr = torch.isfinite(p), torch.isfinite(r)
        miss += int((fp ^ fr).sum())
        n_ref += int(fr.sum())
        both = fp & fr
        if bool(both.any()):
            scale = float(torch.abs(r[fr]).max())
            gap = float(torch.abs(p[both] - r[both]).max())
            rel = max(rel, gap / max(scale, 1e-30))
    return miss / max(n_ref, 1), rel


# ---- geometry ---------------------------------------------------------------

def _angle(R) -> float:
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def segments(entry, success, n) -> list[list[int]]:
    """The window's tracking segments: a frame that bootstrapped, then the
    frames that entered TRACKING and succeeded, all in one world frame."""
    out = []
    for i in range(n):
        if not success[i]:
            continue
        if entry[i] == TRACKING and out and out[-1][-1] == i - 1:
            out[-1].append(i)
        elif entry[i] != TRACKING:
            out.append([i])
    return out


def similarity_fit(src: np.ndarray, dst: np.ndarray):
    """Umeyama: (s, R, t) minimising |dst - (s R src + t)|."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(b.T @ a / len(src))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max((a ** 2).sum() / len(src), 1e-300)
    return s, R, mu_d - s * R @ mu_s


def windows(segs) -> list[list[int]]:
    """Each segment's windows of FIT_WINDOW frames (one per frame they end
    at), or the whole segment while it is shorter."""
    out = []
    for sg in segs:
        if len(sg) < MIN_SEGMENT:
            continue
        if len(sg) < FIT_WINDOW:
            out.append(sg)
            continue
        out.extend(sg[k - FIT_WINDOW: k]
                   for k in range(FIT_WINDOW, len(sg) + 1))
    return out


def pose_gaps(wins, Rs, ts, truth: Truth):
    """Per window: (largest rotation gap, largest centre gap over the path
    length, fitted scale)."""
    rot, trj, scale = [], [], []
    for w in wins:
        rot.append(max(_angle((Rs[w[0]].T @ Rs[i]).T
                              @ (truth.R[w[0]].T @ truth.R[i])) for i in w))
        src, dst = ts[w], truth.c[w]
        s, Rf, tf = similarity_fit(src, dst)
        res = np.linalg.norm(dst - (s * src @ Rf.T + tf), axis=1)
        length = np.linalg.norm(np.diff(dst, axis=0), axis=1).sum()
        trj.append(float(res.max() / max(length, 1e-12)))
        scale.append(s)
    return rot, trj, scale


def map_gap(P: np.ndarray, R, t, scale: float, true_R, true_c,
            truth: Truth) -> float:
    """Median relative depth gap of world points ``P`` (the tracker's) to
    the scene's planes, through the frame's camera at ``scale``."""
    if len(P) == 0:
        return math.inf
    X = (scale * (P - t) @ R) @ true_R.T + true_c
    z_bg = scene.Z_BG + truth.bg_slope * (X[:, 0] - truth.x_mid)
    err = np.minimum(np.abs(X[:, 2] - z_bg) / z_bg,
                     np.abs(X[:, 2] - scene.Z_FG) / scene.Z_FG)
    return float(np.median(err))


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def high(v) -> float:
    """The ``QUANTILE``-th percentile of ``v`` (numpy's linear rule), or
    infinity for none."""
    return float(np.percentile(v, QUANTILE)) if len(v) else math.inf


# ---- the whole comparison -------------------------------------------------

def compare(log, frames_u8, truth: Truth, orb: reference.Orb, seed: int,
            device, control: bool = False) -> Numbers:
    """Every number of the comparison for the window in ``log``."""
    rng = np.random.default_rng([seed, 0x5EED])
    n = log.frames
    num = Numbers()
    num.control, num.gaps, num.control_gaps = {}, {}, {}
    poses = np.asarray(log.poses, np.float64).reshape(n, 12)
    Rs, ts = poses[:, :9].reshape(n, 3, 3), poses[:, 9:]

    # feature front
    done = [i for i in range(n) if log.feats[i] is not None]
    sample = sorted(rng.choice(done, min(FEATURE_SAMPLE, len(done)),
                               replace=False).tolist()) if done else []
    kp, dd, kpc, ddc = [], [], [], []
    for i in sample:
        img = reference.to_image(frames_u8[i].to(device))
        ref, _ = reference.detect(img, orb)
        a, b = feature_gaps(*log.feats[i], ref, orb)
        kp.append(a)
        dd.append(b)
        if control:
            low, _ = reference.detect(img, orb, torch.bfloat16)
            a, b = feature_gaps(low.xy, low.desc, low.mask, ref, orb)
            kpc.append(a)
            ddc.append(b)
    num["kp_miss"] = max(kp) if kp else math.inf
    num["desc_diff"] = max(dd) if dd else math.inf
    cm, hr, cmc, hrc = [], [], [], []
    for i, prog in sorted(log.rank_maps.items()):
        img = reference.to_image(frames_u8[i].to(device))
        _, ranks = reference.detect(img, orb)
        a, b = rank_gaps(prog, ranks)
        cm.append(a)
        hr.append(b)
        if control:
            _, low = reference.detect(img, orb, torch.bfloat16)
            a, b = rank_gaps(low, ranks)
            cmc.append(a)
            hrc.append(b)
    if cm:
        num["k1_corner_miss"] = max(cm)
        num["k1_harris_rel"] = max(hr)
    if control:
        num.control.update(kp_miss=max(kpc, default=math.inf),
                           desc_diff=max(ddc, default=math.inf))
        if cmc:
            num.control.update(k1_corner_miss=max(cmc),
                               k1_harris_rel=max(hrc))

    # state machine
    ok = np.isfinite(poses).all(1)
    num["rot_ortho"] = (float(np.abs(np.swapaxes(Rs[ok], 1, 2) @ Rs[ok]
                                     - np.eye(3)).max())
                        if ok.any() else math.inf)
    segs = segments(log.entry_mode, log.success, n)
    num["tracked"] = sum(len(sg) for sg in segs)
    wins = windows(segs)
    rot, trj, scale = pose_gaps(wins, Rs, ts, truth)
    num["rot_err"] = high(rot)
    num["traj_err"] = high(trj)
    num.gaps.update(rot_err=rot, traj_err=trj)
    if control:
        bad = np.arange(n) % FAULT_EVERY == FAULT_EVERY - 1
        Rb = np.where(bad[:, None, None], Rs @ _rot_y(FAULT_TURN), Rs)
        tb = np.where(bad[:, None], 2.0 * ts, ts)
        rot_b, _, _ = pose_gaps(wins, Rb, ts, truth)
        _, trj_b, _ = pose_gaps(wins, Rs, tb, truth)
        num.control.update(rot_err=high(rot_b), traj_err=high(trj_b))
        num.control_gaps.update(rot_err=rot_b, traj_err=trj_b)

    # map points of every frame that ends a fit window, at its scale
    scale_at = {w[-1]: s for w, s in zip(wins, scale)}
    med, med_b = [], []
    for i in sorted(scale_at):
        if log.maps[i] is None:
            continue
        pos, valid = log.maps[i]
        P = pos[valid].double().cpu().numpy()
        args = (Rs[i], ts[i], scale_at[i], truth.R[i], truth.c[i], truth)
        med.append(map_gap(P, *args))
        if control:
            med_b.append(map_gap(ts[i] + 2.0 * (P - ts[i]), *args))
    num["map_err"] = high(med)
    num.gaps["map_err"] = med
    if control:
        num.control["map_err"] = high(med_b)
        num.control_gaps["map_err"] = med_b
    return num
