"""Back-end integration: keyframe skeleton + loop closure + pose graph
(port of ``mvslam_tpu.backend.slam``), built against the fused tracker:

- **keyframe skeleton**: every ``keyframe_every``-th tracked frame's state
  snapshot (pose, descriptors, rays, landmark positions in the keyframe's
  OWN camera frame: storing them locally makes later loop measurements
  independent of accumulated world-frame drift);
- **odometry edges** between consecutive keyframes, information from the
  tracking BA's diagnostics (inlier count / mean error, a scaled-Fisher
  heuristic);
- **loop-closure detection**: one batched Hamming match of the new
  keyframe's descriptor set against every stored keyframe at once
  (``ops/matching``), candidates by Lowe-filtered match count;
- **geometric verification + metric relative pose**: P3P-RANSAC of the new
  keyframe's rays against the candidate's locally-stored landmarks, a
  drift-free ``T_new_in_old`` measurement (monocular scale rides on the
  landmarks, so the loop edge is metric), MUTUALLY verified (the reverse
  resection must compose to ~identity; plane-induced wrong-but-confident
  fits fail this) and POLISHED by an anchored two-frame BA whose point
  priors absorb per-landmark map noise (``_loop_refine_ba``), plus a
  measured relative-SCALE observation per edge (fwd/bwd |t| ratio);
- **pose-graph optimization** on the skeleton: the scale-drift-aware Sim3
  graph by default (``backend/sim3_graph``) or the SE3 graph
  (``backend/pose_graph``), both in float64 on the back-end's device, then
  trajectory correction re-anchoring every raw pose to the latest keyframe
  of its own tracking segment.

Where the data lives: the keyframe stores are device tensors preallocated
at ``(max_keyframes, K, ...)`` when the first keyframe arrives; a keyframe
writes its row in place and candidates are read as views. Keyframe poses,
loop edges and the graph's bookkeeping are host values. A frame that is
not a keyframe costs no synchronising host read (the tracker's
``out.success`` is already on the host, and raw poses are kept as device
tensors until they are asked for); a keyframe costs one read for its pose
and diagnostics, one for the candidate match counts, and up to three per
verified candidate.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from mvslam_tpu_torch.backend import pose_graph as pg
from mvslam_tpu_torch.backend import sim3_graph as sg
from mvslam_tpu_torch.backend.graph import Graph
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.ops import matching, pnp

Tensor = torch.Tensor


class BackendParams(NamedTuple):
    keyframe_every: int = 5          # tracked frames per keyframe
    min_loop_gap: int = 4            # keyframes; skips trivially-adjacent pairs
    min_loop_matches: int = 60       # Lowe-filtered descriptor matches
    min_loop_inliers: int = 40       # P3P-RANSAC inliers to accept an edge
    loop_hypotheses: int = 128
    loop_reproj_px: float = 1.5      # P3P inlier gate (pixels)
    # mutual-verification gates: forward/backward resections must compose
    # to identity within these bounds (translation as a fraction of |t|,
    # rotation in radians)
    loop_mutual_frac: float = 0.10
    loop_mutual_rot: float = 0.05
    max_match_distance: int = 64
    # information heuristic: sigma = base / sqrt(n_inliers) + frac * |t|.
    # Loop edges are DIRECT wide-baseline measurements while odometry
    # edges chain ~keyframe_every 2-frame steps of drift
    odo_sigma_t: float = 0.1
    odo_sigma_r: float = 0.15
    loop_sigma_t: float = 0.02
    loop_sigma_r: float = 0.025
    # RELATIVE translation error: resection/odometry translation error
    # grows with baseline (depth-normalized observations), so sigma_t
    # gains a |t|-proportional term; without it, medium-range loop
    # resections overpower honest local odometry and warp the
    # mid-trajectory
    odo_sigma_frac: float = 0.05
    loop_sigma_frac: float = 0.03
    # Sim3 scale-component sigmas: odometry allows ~2% scale drift per
    # keyframe step; a loop edge MEASURES relative scale (forward/backward
    # resection |t| ratio) to a few percent
    odo_sigma_s: float = 0.02
    loop_sigma_s: float = 0.03
    max_keyframes: int = 256


class Keyframe(NamedTuple):
    frame_idx: int                   # index in the input stream
    pose: SE3                        # tracker camera-to-world at capture
    #                                  (float64, on the host)
    num_inliers: int
    mean_error: float
    # tracking segment: a tracker reset re-bootstraps with a FRESH world
    # origin and monocular scale, so poses are only comparable within one
    # segment. Odometry edges and loop closures never span segments.
    segment: int = 0


def _loop_match_counts(desc_new: Tensor, mask_new: Tensor, desc_all: Tensor,
                       mask_all: Tensor, max_distance: int) -> Tensor:
    """Lowe-filtered match count of the new keyframe against every stored
    one, (C,) int32: one batched Hamming match."""
    m = matching.match_features(desc_new, mask_new, desc_all, mask_all,
                                max_distance=max_distance)
    return m.mask.sum(-1).to(torch.int32)


def _loop_refine_ba(desc_old, mask_old, rays_old, sigma_old, lm_old,
                    lm_mask_old, desc_new, mask_new, rays_new, sigma_new,
                    R0, t0, thr_sq, point_stddev, max_distance):
    """Polish a loop measurement with the anchored two-frame BA: old
    keyframe at identity (hard prior), new keyframe initialized at the
    P3P estimate, points initialized at the old keyframe's landmarks with
    isotropic priors so the solve can redistribute per-landmark noise
    instead of projecting it all into the pose. Observations are GATED by
    reprojection under the P3P initialization (``thr_sq``) in BOTH frames:
    descriptor matches across a wide baseline carry gross outliers that an
    ungated high-weight BA turns into divergence.
    Returns (R, t, n_obs_used, mean_error) of ``T_new_in_old``."""
    m = matching.match_features(desc_new, mask_new, desc_old, mask_old,
                                max_distance=max_distance)
    dtype, dev = rays_old.dtype, rays_old.device
    lm = lm_old[m.idx]
    ok = m.mask & lm_mask_old[m.idx]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    R0, t0 = R0.to(dtype), t0.to(dtype)
    e_new = pnp.reprojection_error_sq(SE3(R0, t0), lm, rays_new)
    e_old = pnp.reprojection_error_sq(SE3(eye3, zero3), lm, rays_old[m.idx])
    ok = ok & (e_new < thr_sq) & (e_old < thr_sq)
    obs = torch.stack([rays_old[m.idx][:, :2], rays_new[:, :2]])
    obs_mask = torch.stack([ok, ok])
    weight = torch.stack([1.0 / torch.clamp(sigma_old[m.idx], min=1e-6),
                          1.0 / torch.clamp(sigma_new, min=1e-6)])
    poses0 = SE3(torch.stack([eye3, R0]), torch.stack([zero3, t0]))
    pose_prior_info = torch.stack(
        [1e10 * torch.eye(6, dtype=dtype, device=dev),
         torch.zeros((6, 6), dtype=dtype, device=dev)])
    iso = eye3 / (point_stddev ** 2)
    point_info = torch.where(ok[:, None, None], iso, torch.zeros_like(iso))
    prob = ba_mod.BAProblem.create(
        poses0=poses0, points0=lm, obs=obs, obs_mask=obs_mask,
        obs_weight=weight, pose_prior=poses0,
        pose_prior_info=pose_prior_info, point_prior=lm,
        point_prior_info=point_info)
    res = ba_mod.ba_solve(
        prob, ba_mod.BAParams(max_iterations=15, compute_covariance=False))
    n_obs = torch.clamp(torch.sum(obs_mask), min=1)
    mean_err = 2.0 * res.error / n_obs.to(dtype)
    return (res.poses.R[1], res.poses.t[1], torch.sum(ok).to(torch.int32),
            mean_err)


def _loop_rel_pose(desc_new, mask_new, rays_new, desc_old, mask_old, lm_old,
                   lm_mask, thr_sq, num_hypotheses, max_distance,
                   generator: torch.Generator | None = None,
                   uniforms: Tensor | None = None):
    """Metric ``T_new_in_old`` by P3P-RANSAC against the old keyframe's
    locally-stored landmarks (+ pose-only GN polish on the inliers). The
    minimal sets come from ``uniforms`` (num_hypotheses, K) or
    ``generator``. Returns (R, t, inlier count)."""
    m = matching.match_features(desc_new, mask_new, desc_old, mask_old,
                                max_distance=max_distance)
    pts = lm_old[m.idx]
    ok = m.mask & lm_mask[m.idx]
    pose, inl = pnp.pnp_ransac_core(pts, rays_new, ok, num_hypotheses, thr_sq,
                                    generator=generator, uniforms=uniforms)
    pose = pnp.refine_pose_gn(pose, pts, rays_new, inl.to(pts.dtype))
    err = pnp.reprojection_error_sq(pose, pts, rays_new)
    inl = ok & (err < thr_sq)
    return pose.R, pose.t, torch.sum(inl).to(torch.int32)


def _read(*tensors: Tensor) -> list[np.ndarray]:
    """Several small tensors in ONE device-to-host copy, each back in its
    shape as float64."""
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in tensors]).cpu().numpy()
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(tuple(t.shape)))
        k += t.numel()
    return out


def _host_se3(R, t) -> SE3:
    return SE3(torch.as_tensor(np.asarray(R, np.float64)),
               torch.as_tensor(np.asarray(t, np.float64)))


_STORES = ("_desc", "_mask", "_rays", "_sigma", "_assoc", "_lm", "_lm_info",
           "_lm_mask")


class PoseGraphBackend:
    """Accumulator: feed tracked-frame snapshots, get an optimized keyframe
    skeleton + corrected trajectory. Its stores, its generator and its
    graph solves live on ``device`` (the card unless the caller names
    another); the ``state``/``out`` fed to it must be there too."""

    def __init__(self, params: BackendParams = BackendParams(),
                 focal: float = 350.0, seed: int = 0, device="cuda"):
        self.p = params
        self.focal = float(focal)
        self.device = torch.device(device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.keyframes: list[Keyframe] = []
        # (j, i, rel T_i_in_j, n_inliers, measured scale ratio s_i/s_j)
        self.loop_edges: list[tuple[int, int, SE3, int, float]] = []
        self._tracked_since_kf = 0
        self._segment = 0
        self._warned_full = False
        self.loop_debug: list[dict] = []   # per-candidate gate diagnostics
        self.last_result = None      # the solver's result of the last optimize()
        # keyframe stores on the device, (max_keyframes, K, ...), allocated
        # by the first keyframe; row k belongs to keyframe k
        self._desc = None            # (C, K, 8) int32 descriptor words
        self._mask = None            # (C, K) bool
        self._rays = None            # (C, K, 3) refined observation rays
        self._sigma = None           # (C, K) observation sigma (ideal plane)
        self._assoc = None           # (C, K) int32 feature -> map slot
        self._lm = None              # (C, K, 3) landmarks in kf-local frame
        self._lm_info = None         # (C, K, 3, 3) landmark info (kf-local)
        self._lm_mask = None         # (C, K) bool
        self._kf_segment = None      # (C,) int32 tracking segment of row k
        # (frame index, segment, R (3, 3), t (3,)) with device tensors
        self._raw_poses: list[tuple[int, int, Tensor, Tensor]] = []

    # -- feeding ------------------------------------------------------------
    def add_frame(self, frame_idx: int, state, out,
                  uniforms: Tensor | None = None) -> list[int]:
        """Record a tracked frame; returns indexes of keyframes whose loop
        edges were accepted this call (usually empty). ``state``/``out`` are
        the fused tracker's ``VoJitState`` / ``VoStepOut``. ``uniforms``
        (2, 2, loop_hypotheses, K) replaces the generator's RANSAC draws:
        [candidate, forward/backward]."""
        if not bool(out.success):
            # track loss: cadence resets, and if we had keyframes the NEXT
            # successful frame starts a new segment (new origin + scale)
            self._tracked_since_kf = 0
            if self.keyframes:
                self._segment = self.keyframes[-1].segment + 1
            return []
        self._raw_poses.append(
            (frame_idx, self._segment, out.pose_R, out.pose_t))
        self._tracked_since_kf += 1
        is_first = not self.keyframes
        if not is_first and self._tracked_since_kf < self.p.keyframe_every:
            return []
        self._tracked_since_kf = 0
        return self._add_keyframe(frame_idx, state, out, uniforms)

    def _add_keyframe(self, frame_idx: int, state, out,
                      uniforms: Tensor | None = None) -> list[int]:
        if len(self.keyframes) >= self.p.max_keyframes:
            if not self._warned_full:
                warnings.warn(
                    f"keyframe store is full ({self.p.max_keyframes}): "
                    f"frame {frame_idx} and later ones add no keyframe")
                self._warned_full = True
            return []
        pose = SE3(out.pose_R, out.pose_t)
        # landmarks observed by this frame, re-expressed in ITS camera frame
        assoc = state.lf_assoc.to(torch.int64)
        safe = torch.clamp(assoc, min=0)
        lm_world = state.map_pos[safe]
        lm_mask = (assoc >= 0) & state.map_valid[safe] & state.lf_mask
        lm_local = pose.inverse().apply(lm_world)
        # accumulated landmark information (map_info Hpp), rotated into the
        # keyframe's own axes: p_local = R^T (p_world - t) => H_local =
        # R^T H_world R (the recursive filter's anisotropy is preserved so
        # later consumers, the windowed BA priors, do not re-open depth the
        # filter already resolved)
        R = pose.R
        lm_info_local = torch.einsum("ji,kjl,lm->kim", R,
                                     state.map_info[safe], R)
        R_h, t_h, n_inl, mean_err = _read(out.pose_R, out.pose_t,
                                          out.num_inliers, out.mean_error)
        kf_i = len(self.keyframes)
        self.keyframes.append(Keyframe(
            frame_idx=frame_idx, pose=_host_se3(R_h, t_h),
            num_inliers=int(n_inl), mean_error=float(mean_err),
            segment=self._segment))
        accepted = self._detect_loops(kf_i, state, lm_local, lm_mask,
                                      uniforms)
        self._store(kf_i, state, lm_local, lm_info_local, lm_mask)
        return accepted

    def _store(self, kf_i: int, state, lm_local, lm_info_local,
               lm_mask) -> None:
        row = (state.lf_desc, state.lf_mask, state.lf_obs_rays,
               state.lf_obs_sigma, state.lf_assoc, lm_local, lm_info_local,
               lm_mask)
        if self._desc is None:
            for name, r in zip(_STORES, row):
                setattr(self, name, torch.zeros(
                    (self.p.max_keyframes,) + tuple(r.shape), dtype=r.dtype,
                    device=self.device))
            self._kf_segment = torch.zeros(
                self.p.max_keyframes, dtype=torch.int32, device=self.device)
        for name, r in zip(_STORES, row):
            getattr(self, name)[kf_i] = r
        # a fill kernel: assigning a Python number would copy it from the
        # host and synchronise
        self._kf_segment[kf_i].fill_(self._segment)

    # -- loop closure -------------------------------------------------------
    def _detect_loops(self, kf_i: int, state, lm_local, lm_mask,
                      uniforms: Tensor | None = None) -> list[int]:
        p = self.p
        last_ok = kf_i - p.min_loop_gap       # gap: the recent ones are out
        # never close loops across tracking segments (scale mismatch)
        if not any(k.segment == self._segment
                   for k in self.keyframes[:max(last_ok, 0)]):
            return []
        mask_all = self._mask[:last_ok] & (
            self._kf_segment[:last_ok] == self._segment)[:, None]
        counts = _loop_match_counts(
            state.lf_desc, state.lf_mask, self._desc[:last_ok], mask_all,
            p.max_match_distance).tolist()
        order = sorted(range(last_ok), key=lambda j: (-counts[j], j))
        thr_sq = (p.loop_reproj_px / self.focal) ** 2
        accepted = []
        for c, j in enumerate(order[:2]):             # top candidates only
            if counts[j] < p.min_loop_matches:
                break
            u_fwd, u_bwd = (None, None) if uniforms is None else uniforms[c]
            old = dict(desc=self._desc[j], mask=self._mask[j],
                       rays=self._rays[j], sigma=self._sigma[j],
                       lm=self._lm[j], lm_mask=self._lm_mask[j])
            # forward: new keyframe's rays vs old keyframe's landmarks
            R1, t1, n1 = _loop_rel_pose(
                state.lf_desc, state.lf_mask, state.lf_rays,
                old["desc"], old["mask"], old["lm"], old["lm_mask"],
                thr_sq, p.loop_hypotheses, p.max_match_distance,
                generator=self._generator, uniforms=u_fwd)
            n_inl = int(n1)
            if n_inl < p.min_loop_inliers:
                continue
            # MUTUAL verification: resection the other way (old rays vs the
            # new keyframe's landmarks) and require the two measurements to
            # compose to ~identity. Wide-baseline candidate pairs on the
            # near-planar background can produce confident-looking but
            # wrong P3P fits (plane-induced ambiguity); a wrong fit has no
            # reason to agree with its reverse.
            R2, t2, n2 = _loop_rel_pose(
                old["desc"], old["mask"], old["rays"],
                state.lf_desc, state.lf_mask, lm_local, lm_mask,
                thr_sq, p.loop_hypotheses, p.max_match_distance,
                generator=self._generator, uniforms=u_bwd)
            R1_h, t1_h, R2_h, t2_h, n2_h = _read(R1, t1, R2, t2, n2)
            if int(n2_h) < p.min_loop_inliers:
                continue
            T1 = _host_se3(R1_h, t1_h)
            gap = T1.compose(_host_se3(R2_h, t2_h)).log().numpy()
            t_norm = float(np.linalg.norm(t1_h))
            gap_t = float(np.linalg.norm(gap[:3]))
            gap_r = float(np.linalg.norm(gap[3:]))
            if (gap_t > max(p.loop_mutual_frac * t_norm, 0.05)
                    or gap_r > p.loop_mutual_rot):
                continue
            # measured relative scale: |t| of the forward resection is in
            # the OLD keyframe's local metric, the backward one in the
            # NEW's: their ratio observes s_new/s_old (the Sim3 edge's
            # scale component; see backend/sim3_graph.py)
            s_rel = float(np.linalg.norm(t2_h)) / max(t_norm, 1e-9)
            # edge VALUE: anchored two-frame BA polish of the P3P estimate
            # against the old keyframe's landmarks
            R5, t5, n5, ref_err = _read(*_loop_refine_ba(
                old["desc"], old["mask"], old["rays"], old["sigma"],
                old["lm"], old["lm_mask"],
                state.lf_desc, state.lf_mask, state.lf_rays,
                state.lf_obs_sigma, R1, t1, thr_sq, 0.05,
                p.max_match_distance))
            # keep the polish only if it stays consistent with the gated
            # P3P estimate and its residual is sane
            use_ba = bool(np.all(np.isfinite(R5)) and np.all(np.isfinite(t5))
                          and np.isfinite(ref_err))
            gap5 = np.full(6, np.inf)
            if use_ba:
                gap5 = _host_se3(R5, t5).inverse().compose(T1).log().numpy()
                use_ba = bool(
                    np.linalg.norm(gap5[:3]) <= 0.2 * max(t_norm, 1e-9)
                    and np.linalg.norm(gap5[3:]) <= 0.1
                    and float(ref_err) < 50.0)
            T_edge = _host_se3(R5, t5) if use_ba else T1
            self.loop_debug.append(dict(
                j=j, i=kf_i, use_ba=use_ba, n_ba=int(n5),
                ref_err=float(ref_err),
                gap_t=float(np.linalg.norm(gap5[:3])),
                gap_r=float(np.linalg.norm(gap5[3:])),
                t_norm=t_norm))
            self.loop_edges.append((j, kf_i, T_edge, n_inl, s_rel))
            accepted.append(j)
        return accepted

    # -- optimization -------------------------------------------------------
    def _sigmas(self, n_inl: int, loop: bool, t_norm: float) -> np.ndarray:
        """Translation-first se3 sigmas + the Sim3 scale sigma, (7,)."""
        p = self.p
        s = 1.0 / np.sqrt(max(n_inl, 1))
        base_t = p.loop_sigma_t if loop else p.odo_sigma_t
        base_r = p.loop_sigma_r if loop else p.odo_sigma_r
        frac = p.loop_sigma_frac if loop else p.odo_sigma_frac
        return np.concatenate([
            np.full(3, base_t * s + frac * t_norm),
            np.full(3, base_r * s),
            [p.loop_sigma_s if loop else p.odo_sigma_s]])

    def _info(self, n_inl: int, loop: bool = False,
              t_norm: float = 0.0) -> np.ndarray:
        return np.diag(1.0 / self._sigmas(n_inl, loop, t_norm)[:6] ** 2)

    def _edges(self):
        """The skeleton's edges and anchors: ([(src, dst, rel SE3, scale,
        n_inliers, is_loop)], [anchored node ids]). Odometry edges within
        segments; a segment break gets no edge (incomparable frames) but an
        anchor on the new segment's first keyframe, so its component stays
        observable."""
        if not self.keyframes:
            raise RuntimeError("no keyframes recorded")
        edges, anchors = [], [0]
        kfs = self.keyframes
        for a_i, (a, b) in enumerate(zip(kfs[:-1], kfs[1:])):
            if a.segment == b.segment:
                rel = a.pose.inverse().compose(b.pose)
                edges.append((a_i, a_i + 1, rel, 1.0, b.num_inliers, False))
            else:
                anchors.append(a_i + 1)
        for j, i, rel, n_inl, s_rel in self.loop_edges:
            edges.append((j, i, rel, s_rel, n_inl, True))
        return edges, anchors

    def build_graph(self):
        """Skeleton -> ``backend.graph.Graph``: node 0 anchored at the first
        keyframe pose, odometry + loop between-factor edges."""
        edges, anchors = self._edges()
        g = Graph(origin=self.keyframes[0].pose, device=self.device)
        ids = [g.origin_id] + [g.add_pose_node(k.pose)
                               for k in self.keyframes[1:]]
        for a in anchors[1:]:
            g.set_anchor(ids[a])
        for src, dst, rel, _s, n_inl, loop in edges:
            tn = float(torch.linalg.vector_norm(rel.t))
            cov = np.linalg.inv(self._info(n_inl, loop=loop, t_norm=tn))
            g.add_transformation_edge(ids[src], ids[dst], rel, cov)
        return g, ids

    def optimize(self, mesh=None, params=None, method: str = "sim3") -> SE3:
        """Optimize the skeleton; returns corrected keyframe poses (N,),
        float64 on the back-end's device.

        ``method="sim3"`` (default) runs the scale-drift-aware Sim3 graph
        (``backend/sim3_graph.py``): monocular odometry drifts in scale,
        which an SE3 graph cannot absorb (it trades endpoint error for
        mid-trajectory warp). ``method="se3"`` runs the SE3 graph.

        With a ``mesh`` (a ``DeviceMesh`` of ``parallel.make_mesh``), the
        edges are sharded over its data axis
        (``parallel.dist_pose_graph``). The call is then collective: every
        rank of the mesh calls it with the same skeleton, and all get the
        same poses.
        """
        from mvslam_tpu_torch.parallel import dist_pose_graph

        if method == "se3":
            g, _ = self.build_graph()
            data, params = g.to_data(), params or pg.PoseGraphParams()
            if mesh is None:
                res = pg.pose_graph_optimize(data, params)
            else:
                res = dist_pose_graph.distributed_pose_graph_optimize(
                    data, mesh, params)
        else:
            data, params = self._build_sim3_data(), params or sg.Sim3GraphParams()
            if mesh is None:
                res = sg.sim3_graph_optimize(data, params)
            else:
                res = dist_pose_graph.distributed_sim3_graph_optimize(
                    data, mesh, params)
        self.last_result = res
        # Sim3 -> SE3: the node scale models the tracker's local metric
        # distortion; the trajectory estimate is (R, t) directly
        n = len(self.keyframes)
        return SE3(res.poses.R[:n], res.poses.t[:n])

    def _build_sim3_data(self) -> sg.Sim3GraphData:
        """Keyframe skeleton -> float64 ``Sim3GraphData`` on the device
        (odometry edges within segments, measured-scale loop edges, anchors
        per segment)."""
        edges, anchors = self._edges()
        kfs = self.keyframes
        N = len(kfs)
        E = max(len(edges), 1)           # at least one (masked) edge slot
        dev = self.device

        def T(a, dtype=torch.float64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        src = np.zeros(E, np.int64)
        dst = np.zeros(E, np.int64)
        s_e = np.ones(E)
        R_e = np.tile(np.eye(3), (E, 1, 1))
        t_e = np.zeros((E, 3))
        info_e = np.tile(np.eye(7), (E, 1, 1))
        for k, (a, b, rel, s_rel, n_inl, loop) in enumerate(edges):
            src[k], dst[k] = a, b
            s_e[k], R_e[k], t_e[k] = s_rel, rel.R.numpy(), rel.t.numpy()
            tn = float(np.linalg.norm(t_e[k]))
            info_e[k] = np.diag(1.0 / self._sigmas(n_inl, loop, tn) ** 2)
        prior_info = np.zeros((N, 7, 7))
        for a in anchors:
            prior_info[a] = np.eye(7) / (pg.ORIGIN_STDDEV ** 2)
        poses = sg.Sim3(
            torch.ones(N, dtype=torch.float64, device=dev),
            T(np.stack([k.pose.R.numpy() for k in kfs])),
            T(np.stack([k.pose.t.numpy() for k in kfs])))
        return sg.Sim3GraphData(
            poses=poses,
            node_mask=torch.ones(N, dtype=torch.bool, device=dev),
            edge_src=T(src, torch.int64), edge_dst=T(dst, torch.int64),
            edge_rel=sg.Sim3(T(s_e), T(R_e), T(t_e)),
            edge_info=T(info_e),
            edge_mask=torch.arange(E, device=dev) < len(edges),
            prior_pose=poses,
            prior_info=T(prior_info))

    # -- sliding-window BA ----------------------------------------------------
    def windowed_refine(self, window: int = 5, point_cap: int = 1024,
                        ba_params=None):
        """Multi-frame BA over the LAST ``window`` keyframes.

        Landmarks = union of map slots observed in the window (up to
        ``point_cap``, most-observed first), observations = each
        keyframe's refined rays, weighted by stored sigmas. Gauge: first
        window pose anchored hard; the rest carry a weak regulator prior
        at their current estimates (sigma 0.1 / 0.05, so the window can
        actually move). The problem is assembled on the host from one read
        of the window's store rows; the solve runs on the device.

        Returns ``(kf_indexes, refined_poses (W,), mean_error)``.
        """
        # the window never spans a tracking segment break
        seg = self.keyframes[-1].segment
        seg_len = sum(1 for k in self.keyframes if k.segment == seg)
        W = min(window, seg_len)
        if W < 2:
            raise ValueError(
                "windowed refine needs >= 2 keyframes in the segment")
        lo = len(self.keyframes) - W
        assoc, lmm, rays, sigma, lm_local, lm_info = (
            getattr(self, name)[lo:lo + W].cpu().numpy()
            for name in ("_assoc", "_lm_mask", "_rays", "_sigma", "_lm",
                         "_lm_info"))
        poses = [self.keyframes[lo + w].pose for w in range(W)]
        # union of slots, most-observed first
        valid = (assoc >= 0) & lmm
        slots, counts = np.unique(assoc[valid], return_counts=True)
        slots = slots[np.argsort(-counts)][:point_cap]
        P = len(slots)
        slot_col = {int(s): i for i, s in enumerate(slots)}
        obs = np.zeros((W, P, 2), np.float32)
        obs_mask = np.zeros((W, P), bool)
        weight = np.ones((W, P), np.float32)
        pts0 = np.zeros((P, 3), np.float32)
        lw = np.zeros((W, P, 3), np.float32)
        li = np.zeros((W, P, 3, 3), np.float32)
        for w in range(W):
            Rw = poses[w].R.numpy()
            lm_world = lm_local[w] @ Rw.T + poses[w].t.numpy()
            # stored info is kf-local; rotate back to world axes
            info_world = np.einsum("ij,kjl,ml->kim", Rw, lm_info[w], Rw)
            for k in np.nonzero(valid[w])[0]:
                col = slot_col.get(int(assoc[w, k]))
                if col is None:
                    continue
                obs[w, col] = rays[w, k, :2]
                obs_mask[w, col] = True
                weight[w, col] = 1.0 / max(float(sigma[w, k]), 1e-6)
                lw[w, col] = lm_world[k]
                li[w, col] = info_world[k]
        # slot-identity gate: a map SLOT is recycled under LRU eviction, so
        # the same slot id at two keyframes may be two different physical
        # landmarks. Keep an observation only when that keyframe's own
        # world-position estimate agrees with the latest sighting within
        # 15% of depth (re-triangulated content fails by orders of
        # magnitude; honest re-refinements of one landmark pass easily).
        pinfo = np.zeros((P, 3, 3), np.float32)
        for col in range(P):
            ws = np.nonzero(obs_mask[:, col])[0]
            if len(ws) == 0:
                continue
            ref_w = int(ws[-1])
            ref = lw[ref_w, col]
            pts0[col] = ref
            # the latest sighting's ACCUMULATED landmark information (the
            # recursive filter's Hpp) anchors the point: without it the
            # window re-opens depth the filter already resolved and the
            # last keyframe regresses
            pinfo[col] = li[ref_w, col]
            cam = poses[ref_w].t.numpy()
            depth = max(float(np.linalg.norm(ref - cam)), 1e-6)
            for w in ws[:-1]:
                if np.linalg.norm(lw[w, col] - ref) > 0.15 * depth:
                    obs_mask[w, col] = False
        prior_info = np.zeros((W, 6, 6), np.float32)
        prior_info[0] = 1e10 * np.eye(6)
        prior_info[1:] = np.diag(np.concatenate([
            np.full(3, 1.0 / 0.1 ** 2), np.full(3, 1.0 / 0.05 ** 2)]))
        # keep >= 2 observations per landmark (single-view points are
        # unconstrained along the ray and only drag the solve)
        obs_mask &= (obs_mask.sum(0) >= 2)[None, :]

        def T(a):
            return torch.as_tensor(a, device=self.device)

        poses0 = SE3(
            T(np.stack([p.R.numpy() for p in poses]).astype(np.float32)),
            T(np.stack([p.t.numpy() for p in poses]).astype(np.float32)))
        prob = ba_mod.BAProblem.create(
            poses0=poses0, points0=T(pts0), obs=T(obs),
            obs_mask=T(obs_mask), obs_weight=T(weight), pose_prior=poses0,
            pose_prior_info=T(prior_info), point_prior=T(pts0),
            point_prior_info=T(pinfo))
        params = ba_params or ba_mod.BAParams(max_iterations=20,
                                              compute_covariance=False)
        res = ba_mod.ba_solve(prob, params)
        n_obs = max(int(obs_mask.sum()), 1)
        mean_err = 2.0 * float(res.error) / n_obs
        idxs = [self.keyframes[lo + w].frame_idx for w in range(W)]
        return idxs, res.poses, mean_err

    # -- trajectories ---------------------------------------------------------
    def raw_poses(self) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """Every tracked frame's raw pose, [(frame_idx, R (3, 3), t (3,))]
        as float64 numpy: one device-to-host copy for the whole list."""
        if not self._raw_poses:
            return []
        R, t = _read(torch.stack([r[2] for r in self._raw_poses]),
                     torch.stack([r[3] for r in self._raw_poses]))
        return [(r[0], R[k], t[k]) for k, r in enumerate(self._raw_poses)]

    def correct_trajectory(self, opt_poses: SE3):
        """Re-anchor every raw tracked pose to the most recent keyframe OF
        ITS OWN SEGMENT: ``T = T_kf_opt . (T_kf_raw^-1 . T_raw)``. A reset
        starts a segment with another origin and scale, so its frames take
        no correction from the segment before; until the new segment has a
        keyframe they pass through unchanged. Returns
        [(frame_idx, R (3,3), t (3,)) ...] as numpy."""
        opt_R, opt_t = _read(opt_poses.R, opt_poses.t)
        out = []
        ki = -1
        corr = None                       # (segment, R, t)
        for (idx, R, t), (_, seg, _, _) in zip(self.raw_poses(),
                                               self._raw_poses):
            while (ki + 1 < len(self.keyframes)
                   and self.keyframes[ki + 1].frame_idx <= idx):
                ki += 1
                kf = self.keyframes[ki]
                A = _host_se3(opt_R[ki], opt_t[ki]).compose(kf.pose.inverse())
                corr = (kf.segment, A.R.numpy(), A.t.numpy())
            if corr is None or corr[0] != seg:
                out.append((idx, R, t))
            else:
                out.append((idx, corr[1] @ R, corr[1] @ t + corr[2]))
        return out
