"""VisualOdometer: the host-orchestrated tracking state machine (port of
``mvslam_tpu.frontend.visual_odometer``).

States INITIALIZING / TRACKING; per frame:

- INITIALIZING: keep a sliding window of frames; try a two-view bootstrap
  of the newest frame against the queued frames, longest baseline first;
  accept the first pair passing the quality gates (enough inliers, small
  refined error, bounded rotation and out-of-plane translation); seed the
  map from its refined points.
- TRACKING: associate the new frame's features to the map (descriptor
  matching), P3P/PnP-RANSAC the camera pose, triangulate newly observed
  points against the previous frame, then a two-frame bundle adjustment
  with the previous frame anchored; accept on small error or ``reset()``
  back to INITIALIZING.

The map lives in world coordinates with per-point descriptors; PnP against
the map returns a metrically consistent pose, the world scale is set once
by the bootstrap baseline. Measurement sigmas are in ideal-camera units
(pixel sigma / focal); the gates use the mean standardized squared
residual.

Where this differs from the JAX package: there the map and everything
carried between frames are numpy arrays on the host, uploaded every frame.
Here they are tensors on the odometer's device, written in place. The host
reads only what decides control flow or a shape: per tracked frame one
transfer of (PnP success, inlier count, observed map points, fresh
triangulations) and one of (BA error, observation count); per candidate
pair of a bootstrap frame the pair's three (``ImagePair.reconstruct``,
``ImagePair.refine``, the pose gates). The dtypes of what is carried are
the JAX package's: refined rays and sigmas float64, map positions and
templates float32, the two-frame BA assembled in float64 (``1 / sigma``
included) and cast to the frame's dtype at the solver's door. Descriptor
words are int32 (the same bits as the JAX package's uint32). Writes through
an index that may repeat go through ``utils.indexing.set_rows``: the
highest source position wins, as in numpy.

Random draws: the JAX package seeds a fresh key with the step count for
every RANSAC; here a ``torch.Generator`` on the odometer's device is seeded
the same way, or ``add_frame(frame, uniforms=...)`` supplies the uniforms:
(sfm.num_hypotheses, K) on a bootstrap frame (every candidate base sees the
same draws, as every candidate sees the same key), (pnp.num_hypotheses, K)
on a tracked one.
"""

from __future__ import annotations

import enum
from typing import List, NamedTuple, Optional

import torch

from mvslam_tpu_torch.frontend.data_types import Frame
from mvslam_tpu_torch.frontend.image_pair import (
    KLT_SIGMA_PX, ImagePair, ImagePairParams, PairState,
)
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.ops import klt, matching, pnp, sfm
from mvslam_tpu_torch.utils.indexing import (
    allocate_slots, masked_take, set_rows,
)

Tensor = torch.Tensor


class VoState(enum.Enum):
    INITIALIZING = 0
    TRACKING = 1


class VoParams(NamedTuple):
    frame_queue_size: int = 10
    # bootstrap gates
    min_pair_inliers: int = 20
    max_pair_mean_error: float = 4.0        # mean standardized sq residual
    max_pair_rotation: float = 0.1          # rad
    max_pair_z_translation: float = 0.1     # |t_z| of the unit baseline
    # tracking gates
    min_track_inliers: int = 7
    pnp_reproj_px: float = 2.0              # PnP inlier gate, pixels
    max_track_mean_error: float = 9.0
    max_map_points: int = 1024
    ba_capacity: int = 512                  # points per track_refine solve
    map_point_stddev: float = 0.05          # regulator sigma on map points
    pair: ImagePairParams = ImagePairParams()
    pnp: pnp.PnpParams = pnp.PnpParams()
    ba: ba_mod.BAParams = ba_mod.BAParams(max_iterations=25)


class _Map:
    """Fixed-capacity world map on one device: positions, descriptors, KLT
    templates. Each point carries the image template of its *first*
    observation, so every later observation is refined against the same
    photometric anchor."""

    def __init__(self, capacity: int, device) -> None:
        self.capacity = capacity
        W = klt.WINDOW
        self.positions = torch.zeros((capacity, 3), dtype=torch.float32,
                                     device=device)
        self.desc = torch.zeros((capacity, 8), dtype=torch.int32,
                                device=device)
        self.templates = torch.zeros((capacity, W, W), dtype=torch.float32,
                                     device=device)
        self.valid = torch.zeros(capacity, dtype=torch.bool, device=device)
        self.last_seen = torch.full((capacity,), -1, dtype=torch.int64,
                                    device=device)

    def clear(self) -> None:
        self.valid.fill_(False)
        self.last_seen.fill_(-1)

    def count(self) -> int:
        return int(self.valid.sum())

    def allocate(self, n: int, now: int) -> Tensor:
        """Indices of n slots: free ones first (ascending), then valid ones
        from the least recently seen. Tie rule: among valid slots with an
        equal ``last_seen`` the lower index goes first (a stable sort; the
        JAX package's ``np.argsort`` leaves ties to the sort)."""
        return allocate_slots(self.valid, self.last_seen, n)

    def put(self, name: str, idx: Tensor, vals) -> None:
        """``getattr(self, name)[idx] = vals`` in place, with numpy's rule
        for repeated indices (the last write wins) on every device."""
        arr = getattr(self, name)
        arr.copy_(set_rows(arr, idx, vals))


class TrackResult(NamedTuple):
    success: bool
    pose: Optional[SE3]               # camera pose in the init frame
    num_inliers: int
    mean_error: float
    reason: str


class VisualOdometer:
    """``add_frame`` -> tracked/not, pose getters, tracked points,
    ``reset``; all state on ``device`` (the card unless the caller names
    another, e.g. ``"cpu"``). Frames must live on the same device."""

    def __init__(self, params: VoParams = VoParams(),
                 T_camera_to_body: SE3 | None = None, device="cuda") -> None:
        self.params = params
        self.device = torch.device(device)
        self.state = VoState.INITIALIZING
        self._frames: List[Frame] = []            # sliding init window
        self._map = _Map(params.max_map_points, self.device)
        self._last_frame: Optional[Frame] = None
        self._last_pose: Optional[SE3] = None     # camera-in-init-frame
        self._last_assoc: Optional[Tensor] = None      # (K,) feat -> map idx
        self._last_obs_rays: Optional[Tensor] = None   # (K, 3) float64
        self._last_obs_sigma: Optional[Tensor] = None  # (K,) float64
        self._last_templates: Optional[Tensor] = None  # (K, W, W)
        self._T_cam_body = T_camera_to_body
        self._step = 0
        self.frame_total = 0
        self.frame_tracked = 0
        #: candidate pairs reconstructed by the last bootstrap attempt
        self.pairs_tried = 0
        #: [(frame_id, capture_time, SE3 camera pose)] of successful frames
        self.trajectory: List[tuple] = []

    # -- public API -----------------------------------------------------------
    def add_frame(self, frame: Frame,
                  uniforms: Optional[Tensor] = None) -> TrackResult:
        self.frame_total += 1
        self._step += 1
        if self.state == VoState.INITIALIZING:
            res = self._initialize(frame, uniforms)
        else:
            res = self._track(frame, uniforms)
            if not res.success:
                self.reset(keep_frame=frame)
        if res.success:
            self.frame_tracked += 1
            self.trajectory.append(
                (frame.id, frame.capture_time, self._last_pose)
            )
        return res

    def reset(self, keep_frame: Optional[Frame] = None) -> None:
        """Back to INITIALIZING keeping only the newest frame."""
        self.state = VoState.INITIALIZING
        self._frames = [keep_frame] if keep_frame is not None else []
        self._map.clear()
        self._last_frame = None
        self._last_pose = None
        self._last_assoc = None
        self._last_obs_rays = None
        self._last_obs_sigma = None
        self._last_templates = None

    def get_camera_pose(self) -> Optional[SE3]:
        return self._last_pose

    def get_body_pose(self) -> Optional[SE3]:
        """Body pose via camera-extrinsics conjugation."""
        if self._last_pose is None:
            return None
        if self._T_cam_body is None:
            return self._last_pose
        return self._last_pose.compose(self._T_cam_body)

    def get_tracked_points(self) -> Tensor:
        return self.positions_of(self._map.valid)

    def positions_of(self, mask: Tensor) -> Tensor:
        return self._map.positions[mask]

    @property
    def num_tracked_points(self) -> int:
        return self._map.count()

    # -- initialization -------------------------------------------------------
    def _initialize(self, frame: Frame, uniforms=None) -> TrackResult:
        self._frames.append(frame)
        if len(self._frames) > self.params.frame_queue_size:
            self._frames.pop(0)
        self.pairs_tried = 0
        if len(self._frames) < 2:
            return TrackResult(False, None, 0, float("inf"), "need frames")
        # longest baseline first
        for base in self._frames[:-1]:
            self.pairs_tried += 1
            pair = ImagePair(base, frame, self.params.pair, seed=self._step,
                             uniforms=uniforms)
            if pair.state == PairState.INIT:
                continue
            pair.refine()
            ok, why = self._check_image_pair(pair)
            if not ok:
                continue
            self._seed_map(pair)
            self.state = VoState.TRACKING
            return TrackResult(
                True, self._last_pose, pair.match_inlier_count,
                pair.mean_error, "bootstrap",
            )
        return TrackResult(False, None, 0, float("inf"), "no valid pair")

    def _check_image_pair(self, pair: ImagePair) -> tuple[bool, str]:
        """The quality gates of a bootstrap pair; the pose is read on the
        host once (its 6-vector logarithm and its translation)."""
        p = self.params
        if pair.match_inlier_count < p.min_pair_inliers:
            return False, "inliers"
        if pair.mean_error > p.max_pair_mean_error:
            return False, "error"
        T = pair.T_pair_to_base
        host = torch.cat([T.log(), T.t]).tolist()
        w, t = host[3:6], host[6:9]
        if max(abs(v) for v in w) > p.max_pair_rotation:
            return False, "rotation"
        norm = sum(v * v for v in t) ** 0.5
        if abs(t[2]) / max(norm, 1e-9) > p.max_pair_z_translation:
            return False, "z-translation"
        return True, "ok"

    def _seed_map(self, pair: ImagePair) -> None:
        """World frame := the pair's base camera frame; map := refined
        points with base-frame templates; associations + refined pair-frame
        observations carried into tracking."""
        points, pmask = pair.points
        base_feats = pair.base.features
        K = pair.pair.features.capacity
        cap = min(K, self._map.capacity)
        # slot s <- the s-th masked base feature
        idxs, ok = masked_take(pmask, cap)
        slots = torch.where(ok, torch.arange(cap, device=self.device),
                            torch.full_like(idxs, self._map.capacity))
        m = self._map
        m.clear()
        m.put("positions", slots, points[idxs].to(torch.float32))
        m.put("desc", slots, base_feats.desc[idxs])
        base_templates = klt.extract_templates(pair.base.image_smooth,
                                               base_feats.xy)
        m.put("templates", slots, base_templates[idxs].to(torch.float32))
        m.put("valid", slots, True)
        m.put("last_seen", slots, self._step)
        # association + refined observations for the PAIR (newest) frame:
        # its feature j = match.idx[i] observed the map point of base
        # feature i. Two base features may match one pair feature: the
        # later slot wins, as in the JAX package's loop.
        j = torch.where(ok, pair.match.idx[idxs], torch.full_like(idxs, K))
        f64 = torch.float64
        self._last_assoc = set_rows(
            torch.full((K,), -1, dtype=torch.int64, device=self.device),
            j, slots)
        self._last_obs_rays = set_rows(pair.pair.rays.to(f64), j,
                                       pair._r2[idxs].to(f64))
        self._last_obs_sigma = set_rows(pair.pair.sigma.to(f64), j,
                                        pair.obs_sigma[idxs].to(f64))
        self._last_frame = pair.pair
        self._last_pose = pair.T_pair_to_base
        self._last_templates = klt.extract_templates(
            pair.pair.image_smooth, pair.pair.features.xy).to(torch.float32)
        self._frames = []

    # -- tracking -------------------------------------------------------------
    def _track(self, frame: Frame, uniforms=None) -> TrackResult:
        p = self.params
        # 1) associate features to the map by descriptor matching, then
        #    sub-pixel refine every observation against the map point's
        #    first-observation template (track-consistent measurements)
        m = matching.match_features(
            frame.features.desc, frame.features.mask, self._map.desc,
            self._map.valid, max_distance=p.pair.max_match_distance,
        )
        kr = klt.klt_track(
            self._map.templates[m.idx], frame.image_smooth,
            frame.features.xy, m.mask,
        )
        obs_rays = frame.camera.normalize_points(kr.xy)
        obs_sigma = torch.where(
            kr.valid, KLT_SIGMA_PX / frame.focal, frame.sigma
        )
        map_pts = self._map.positions[m.idx]
        # 2) PnP against the map (threshold given in pixels, applied in
        #    ideal units)
        pnp_params = p.pnp._replace(threshold=p.pnp_reproj_px / frame.focal)
        generator = None
        if uniforms is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self._step)
        pr = pnp.pnp_solve(
            map_pts.to(obs_rays.dtype), obs_rays, m.mask, pnp_params,
            generator=generator, uniforms=uniforms,
        )
        # 3) triangulate newly observed points against the previous frame.
        #    Launched before PnP's verdict is read, so that one transfer
        #    brings everything the host decides on; a failed PnP wastes it.
        tri = self._triangulate_new(frame, pr.pose, m)
        m_ok = m.mask & pr.inlier_mask
        success, n_inl, n_obs_feats, n_tri = torch.stack([
            pr.success.to(torch.int64), pr.num_inliers.to(torch.int64),
            m_ok.sum(), tri["mask"].sum()]).tolist()
        if not success or n_inl < p.min_track_inliers:
            return TrackResult(False, None, n_inl, float("inf"), "pnp")
        # 4) two-frame BA: last frame anchored, new frame free, observed map
        #    points regulated, new points free
        result = self._track_refine(frame, pr, m, m_ok, obs_rays, obs_sigma,
                                    tri, n_obs_feats, n_tri)
        if result is None:
            return TrackResult(False, None, n_inl, float("inf"), "refine")
        pose, mean_err, commit = result
        if mean_err > p.max_track_mean_error:
            return TrackResult(False, None, n_inl, mean_err, "error gate")
        commit()
        return TrackResult(True, pose, n_inl, mean_err, "tracked")

    def _triangulate_new(self, frame: Frame, pose_new: SE3, m):
        """Find last<->new feature matches without a map point, KLT-refine
        the new-frame end against last-frame templates, and triangulate in
        world coordinates."""
        last = self._last_frame
        lm = matching.match_features(
            last.features.desc, last.features.mask,
            frame.features.desc, frame.features.mask,
            max_distance=self.params.pair.max_match_distance,
        )
        # drop pairs whose new-frame feature is already associated to the
        # map (feature k is associated exactly when m.mask[k])
        lm_ok = lm.mask & ~m.mask[lm.idx]
        kr = klt.klt_track(
            self._last_templates, frame.image_smooth,
            frame.features.xy[lm.idx], lm_ok,
        )
        r_new = frame.camera.normalize_points(kr.xy)      # aligned to last i
        sig_new = torch.where(
            kr.valid, KLT_SIGMA_PX / frame.focal, frame.sigma[lm.idx],
        )
        rel = self._last_pose.inverse().compose(pose_new)   # new in last frame
        pts_last, pmask = sfm.sfm_triangulate(last.rays, r_new, lm_ok, rel)
        pts_world = self._last_pose.apply(pts_last)
        return dict(
            pts_world=pts_world, mask=pmask, lm_idx=lm.idx,
            r_new=r_new.to(torch.float64), sig_new=sig_new.to(torch.float64),
        )

    def _track_refine(self, frame: Frame, pr, m, m_ok, obs_rays, obs_sigma,
                      tri, n_obs_feats: int, n_tri: int):
        """Two-frame BA. All observations are KLT-refined: new-frame
        observations of map points against the map templates, last-frame
        observations carried over from when the last frame was tracked,
        and both ends of newly triangulated points against the last
        frame's templates. ``n_obs_feats`` and ``n_tri`` are the host's
        counts of ``m_ok`` and ``tri["mask"]``."""
        p = self.params
        dev, f64 = self.device, torch.float64
        dtype = frame.rays.dtype
        cap = p.ba_capacity
        K = frame.features.capacity
        M = self._map.capacity

        n_old = min(n_obs_feats, cap)
        n_new = min(n_tri, cap - n_old)
        if n_old < 3:
            return None
        # --- select observed map points ---
        obs_feats = masked_take(m_ok, cap)[0][:n_old]   # new-frame feature ids
        obs_slots = m.idx[obs_feats]                    # map slots
        # last-frame observations of those map points (two features on one
        # map slot: the higher feature id wins, as in numpy)
        la = self._last_assoc
        last_map_to_feat = set_rows(
            torch.full((M,), -1, dtype=torch.int64, device=dev),
            torch.where(la >= 0, la, torch.full_like(la, M)),
            torch.arange(K, device=dev))
        # --- select new points ---
        new_ids = masked_take(tri["mask"], cap)[0][:n_new]  # last-frame ids
        end = n_old + n_new

        # --- assemble BA problem arrays (capacity cap, masked), float64 ---
        pts0 = torch.zeros((cap, 3), dtype=f64, device=dev)
        pts0[:n_old] = self._map.positions[obs_slots]
        pts0[n_old:end] = tri["pts_world"][new_ids]
        obs = torch.zeros((2, cap, 2), dtype=f64, device=dev)
        obs_mask = torch.zeros((2, cap), dtype=torch.bool, device=dev)
        weight = torch.ones((2, cap), dtype=f64, device=dev)
        last = self._last_frame
        r_new_map = obs_rays.to(f64)                    # new-frame obs (KLT)
        s_new_map = obs_sigma.to(f64)
        # old points: observed by new frame (always) and last frame (if seen)
        obs[1, :n_old] = r_new_map[obs_feats, :2]
        obs_mask[1, :n_old] = True
        weight[1, :n_old] = 1.0 / s_new_map[obs_feats]
        lf = last_map_to_feat[obs_slots]
        seen = lf >= 0
        lf = torch.clamp(lf, min=0)
        obs[0, :n_old] = torch.where(seen[:, None],
                                     self._last_obs_rays[lf, :2], 0.0)
        obs_mask[0, :n_old] = seen
        weight[0, :n_old] = torch.where(seen, 1.0 / self._last_obs_sigma[lf],
                                        1.0)
        # new points: last-frame end is the template anchor (the feature
        # position itself), new-frame end is the KLT-refined track
        nf = tri["lm_idx"][new_ids]                     # new-frame feature ids
        sig_anchor = KLT_SIGMA_PX / last.focal
        obs[0, n_old:end] = last.rays.to(f64)[new_ids, :2]
        obs[1, n_old:end] = tri["r_new"][new_ids, :2]
        obs_mask[:, n_old:end] = True
        weight[0, n_old:end] = 1.0 / sig_anchor
        weight[1, n_old:end] = 1.0 / tri["sig_new"][new_ids]

        # priors: last pose anchored tight; map points regulated
        anchor_info = 1e10
        point_info = torch.zeros((cap, 3, 3), dtype=f64, device=dev)
        point_info[:n_old] = torch.eye(3, dtype=f64, device=dev) / (
            p.map_point_stddev ** 2)
        poses0 = SE3(
            torch.stack([self._last_pose.R.to(dtype), pr.pose.R]),
            torch.stack([self._last_pose.t.to(dtype), pr.pose.t]),
        )
        pose_prior_info = torch.stack([
            anchor_info * torch.eye(6, dtype=dtype, device=dev),
            torch.zeros((6, 6), dtype=dtype, device=dev),
        ])
        prob = ba_mod.BAProblem.create(
            poses0=poses0,
            points0=pts0.to(dtype),
            obs=obs.to(dtype),
            obs_mask=obs_mask,
            obs_weight=weight.to(dtype),
            pose_prior=poses0,
            pose_prior_info=pose_prior_info,
            point_prior=pts0.to(dtype),
            point_prior_info=point_info.to(dtype),
        )
        result = ba_mod.ba_solve(prob, p.ba)
        error, n_obs = torch.stack([result.error.to(f64),
                                    obs_mask.sum().to(f64)]).tolist()
        mean_err = 2.0 * error / max(int(n_obs), 1)
        pose = SE3(result.poses.R[1], result.poses.t[1])

        def commit():
            mp = self._map
            pts = result.points.to(torch.float32)
            # two features may observe one map slot: the later write wins
            mp.put("positions", obs_slots, pts[:n_old])
            mp.put("last_seen", obs_slots, self._step)
            # add new points: descriptors from the new frame, templates
            # anchored at their first (last-frame) observation
            slots = mp.allocate(n_new, self._step)
            mp.put("positions", slots, pts[n_old:end])
            mp.put("desc", slots, frame.features.desc[nf])
            mp.put("templates", slots, self._last_templates[new_ids])
            mp.put("valid", slots, True)
            mp.put("last_seen", slots, self._step)
            # association + refined observations for the new frame;
            # ``lm.idx`` is a nearest-neighbour index, not a bijection, so
            # ``nf`` may repeat
            assoc = torch.full((K,), -1, dtype=torch.int64, device=dev)
            assoc = set_rows(assoc, obs_feats, obs_slots)
            assoc = set_rows(assoc, nf, slots)
            obs_out = set_rows(frame.rays.to(f64), obs_feats,
                               r_new_map[obs_feats])
            sig_out = set_rows(frame.sigma.to(f64), obs_feats,
                               s_new_map[obs_feats])
            r_new = torch.cat([tri["r_new"][new_ids, :2],
                               torch.ones((n_new, 1), dtype=f64, device=dev)],
                              dim=-1)
            obs_out = set_rows(obs_out, nf, r_new)
            sig_out = set_rows(sig_out, nf, tri["sig_new"][new_ids])
            self._last_frame = frame
            self._last_pose = pose
            self._last_assoc = assoc
            self._last_obs_rays = obs_out
            self._last_obs_sigma = sig_out
            self._last_templates = klt.extract_templates(
                frame.image_smooth, frame.features.xy).to(torch.float32)

        return pose, mean_err, commit
