"""Fused visual odometry: ``step(state, image) -> (state, out)`` (port of
``mvslam_tpu.frontend.vo_jit``).

The whole per-frame pipeline — ORB pyramid, descriptor matching, KLT
refinement, RANSAC, triangulation, two-frame bundle adjustment, map update,
mode switching — over a fixed-shape tensor state. Three modes:

- 0 EMPTY: record the frame, wait for a second one;
- 1 INITIALIZING: two-view bootstrap against a ring of the last
  ``init_window`` frames, accepting the oldest (longest-baseline) slot that
  passes the quality gates, falling back to younger slots;
- 2 TRACKING: map association -> KLT -> PnP-RANSAC -> triangulate new
  points -> anchored two-frame BA -> gated commit, or reset to mode 1.

Control flow is on the host: one read of ``mode`` per frame selects the
branch (the JAX ``lax.switch``), the bootstrap fallback walk reads one
gate per ring slot tried, and accept/reject and commit/reset read one gate
each. Everything else stays on the device.

Randomness: the state carries a ``torch.Generator`` (the JAX state's PRNG
key); the step advances it in place. ``step(..., draws=...)`` supplies the
RANSAC uniforms instead — ``(init_window, ransac_hypotheses, K)`` when
INITIALIZING, ``(pnp_hypotheses, K)`` when TRACKING — which lets a test
feed the JAX tracker's own draws.

Capacities: K features/frame, M map points, BA over (BA_OLD + BA_NEW)
points per step — all fixed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.ops import (epipolar, klt, matching, pnp, ransac,
                                  sfm)
from mvslam_tpu_torch.ops.features import OrbParams, orb_detect

Tensor = torch.Tensor

MODE_EMPTY = 0
MODE_INITIALIZING = 1
MODE_TRACKING = 2


class VoJitParams(NamedTuple):
    """Static configuration (the JAX package's defaults and their reasons
    are documented in ``mvslam_tpu.frontend.vo_jit.VoJitParams``)."""

    orb: OrbParams = OrbParams()
    map_capacity: int = 1024
    ba_old: int = 384            # map points per BA
    ba_new: int = 128            # fresh triangulations per BA
    init_window: int = 4         # bootstrap ring of previous frames
    max_match_distance: int = 64
    ransac_hypotheses: int = 256
    max_error_sq: float = sfm.MAX_ERROR_SQ       # pixel-ish; / focal^2
    klt_sigma_px: float = 0.25
    min_pair_inliers: int = 20
    max_pair_mean_error: float = 9.0   # seeds VoJitState.gate_pair_err
    max_pair_rotation: float = 0.1
    max_pair_z_translation: float = 0.1
    min_track_inliers: int = 7
    pnp_reproj_px: float = 0.75
    max_track_mean_error: float = 9.0
    map_point_stddev: float = 0.05
    ba_iterations: int = 10
    pnp_hypotheses: int = 128
    use_klt: bool = True
    template_sigma_px: float = 0.02
    huber_delta: float | None = None
    tri_consistency_px: float = 16.0


class VoJitState(NamedTuple):
    """The whole tracker as fixed-shape tensors on one device."""

    mode: Tensor                # () int32
    step: Tensor                # () int32
    generator: torch.Generator  # RANSAC draws (the JAX state's PRNG key)
    pose_R: Tensor              # (3, 3) last camera-to-world
    pose_t: Tensor              # (3,)
    # map
    map_pos: Tensor             # (M, 3)
    map_desc: Tensor            # (M, 8) int32 descriptor words
    map_tmpl: Tensor            # (M, W, W)
    map_valid: Tensor           # (M,) bool
    map_seen: Tensor            # (M,) int32
    map_info: Tensor            # (M, 3, 3) landmark information
    # last frame
    lf_xy: Tensor               # (K, 2)
    lf_desc: Tensor             # (K, 8) int32
    lf_mask: Tensor             # (K,) bool
    lf_rays: Tensor             # (K, 3)
    lf_sigma: Tensor            # (K,)
    lf_tmpl: Tensor             # (K, W, W)
    lf_obs_rays: Tensor         # (K, 3) refined observations
    lf_obs_sigma: Tensor        # (K,)
    lf_assoc: Tensor            # (K,) int32 feature -> map slot (-1 none)
    # bootstrap ring: B previous frames
    rb_xy: Tensor               # (B, K, 2)
    rb_desc: Tensor             # (B, K, 8) int32
    rb_mask: Tensor             # (B, K) bool
    rb_rays: Tensor             # (B, K, 3)
    rb_sigma: Tensor            # (B, K)
    rb_tmpl: Tensor             # (B, K, W, W)
    rb_valid: Tensor            # (B,) bool
    rb_step: Tensor             # (B,) int32 — step when stored
    rb_pos: Tensor              # () int32 — next write slot (cyclic)
    # stats
    frame_total: Tensor         # () int32
    frame_tracked: Tensor       # () int32
    gate_pair_err: Tensor       # () refined-pair mean-error gate


class VoStepOut(NamedTuple):
    success: Tensor             # () bool
    mode: Tensor                # () int32 (after the step)
    pose_R: Tensor
    pose_t: Tensor
    num_inliers: Tensor         # () int32
    mean_error: Tensor          # ()
    pnp_t: Tensor               # (3,) pre-BA PnP translation
    init_tried: Tensor          # () int32 ring slots refined by do_init


def vo_init_state(params: VoJitParams = VoJitParams(), device=None,
                  dtype=torch.float32, seed: int = 0) -> VoJitState:
    """Empty tracker state on ``device``; ``seed`` seeds its generator."""
    K = params.orb.max_features
    M = params.map_capacity
    W = klt.WINDOW
    B = params.init_window
    dev = torch.device("cpu") if device is None else torch.device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    i32 = torch.int32
    return VoJitState(
        mode=full((), MODE_EMPTY, i32),
        step=full((), 0, i32),
        generator=torch.Generator(device=dev).manual_seed(seed),
        pose_R=torch.eye(3, dtype=dtype, device=dev),
        pose_t=z(3),
        map_pos=z(M, 3), map_desc=z(M, 8, dt=i32), map_tmpl=z(M, W, W),
        map_valid=z(M, dt=torch.bool), map_seen=full((M,), -1, i32),
        map_info=z(M, 3, 3),
        lf_xy=z(K, 2), lf_desc=z(K, 8, dt=i32), lf_mask=z(K, dt=torch.bool),
        lf_rays=z(K, 3), lf_sigma=full((K,), 1.0, dtype), lf_tmpl=z(K, W, W),
        lf_obs_rays=z(K, 3), lf_obs_sigma=full((K,), 1.0, dtype),
        lf_assoc=full((K,), -1, i32),
        rb_xy=z(B, K, 2), rb_desc=z(B, K, 8, dt=i32),
        rb_mask=z(B, K, dt=torch.bool), rb_rays=z(B, K, 3),
        rb_sigma=full((B, K), 1.0, dtype), rb_tmpl=z(B, K, W, W),
        rb_valid=z(B, dt=torch.bool), rb_step=full((B,), -1, i32),
        rb_pos=full((), 0, i32),
        frame_total=full((), 0, i32), frame_tracked=full((), 0, i32),
        gate_pair_err=full((), params.max_pair_mean_error, dtype),
    )


def _masked_take(mask: Tensor, cap: int) -> tuple[Tensor, Tensor]:
    """First ``cap`` true positions: (idx (cap,), valid (cap,))."""
    order = torch.sort((~mask).to(torch.int32), stable=True).indices
    idx = order[:cap]
    return idx, mask[idx]


def _allocate_slots(map_valid: Tensor, map_seen: Tensor, n: int) -> Tensor:
    """n slots: free ones first, then least-recently-seen."""
    keys = torch.where(map_valid, map_seen,
                       torch.full_like(map_seen, torch.iinfo(torch.int32).min))
    return torch.sort(keys, stable=True).indices[:n]


def _set_rows(dst: Tensor, idx: Tensor, vals) -> Tensor:
    """``dst.at[idx].set(vals, mode="drop")``: rows ``idx`` of a copy of
    ``dst`` set to ``vals``; out-of-range indices are dropped, and among
    duplicate indices the last write wins (the serial scatter order of the
    JAX package on the CPU), deterministically on every device."""
    n = dst.shape[0]
    idx = idx.to(torch.int64)
    tgt = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    src = torch.arange(idx.shape[0], device=dst.device)
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=dst.device)
    winner = winner.scatter_reduce(0, tgt, src, reduce="amax")[:n]
    vals = torch.as_tensor(vals, dtype=dst.dtype, device=dst.device).expand(
        (idx.shape[0],) + dst.shape[1:])
    picked = vals[torch.clamp(winner, min=0)]
    hit = (winner >= 0).view((n,) + (1,) * (dst.dim() - 1))
    return torch.where(hit, picked, dst)


class _FrameArrays(NamedTuple):
    xy: Tensor
    desc: Tensor
    mask: Tensor
    rays: Tensor
    sigma: Tensor
    tmpl: Tensor


def _store_frame(state: VoJitState, f: _FrameArrays, obs_rays=None,
                 obs_sigma=None, assoc=None) -> VoJitState:
    K = f.xy.shape[0]
    return state._replace(
        lf_xy=f.xy, lf_desc=f.desc, lf_mask=f.mask, lf_rays=f.rays,
        lf_sigma=f.sigma, lf_tmpl=f.tmpl,
        lf_obs_rays=f.rays if obs_rays is None else obs_rays,
        lf_obs_sigma=f.sigma if obs_sigma is None else obs_sigma,
        lf_assoc=(torch.full((K,), -1, dtype=torch.int32, device=f.xy.device)
                  if assoc is None else assoc),
    )


def _ring_push(state: VoJitState, f: _FrameArrays) -> VoJitState:
    """Store a frame in the bootstrap ring (cyclic, overwrites oldest);
    the write slot stays on the device."""
    i = state.rb_pos.view(1).to(torch.int64)

    def put(arr, val):
        return arr.index_copy(0, i, val[None].to(arr.dtype))

    return state._replace(
        rb_xy=put(state.rb_xy, f.xy),
        rb_desc=put(state.rb_desc, f.desc),
        rb_mask=put(state.rb_mask, f.mask),
        rb_rays=put(state.rb_rays, f.rays),
        rb_sigma=put(state.rb_sigma, f.sigma),
        rb_tmpl=put(state.rb_tmpl, f.tmpl),
        rb_valid=put(state.rb_valid, torch.ones_like(state.rb_valid[0])),
        rb_step=put(state.rb_step, state.step),
        rb_pos=(state.rb_pos + 1) % state.rb_valid.shape[0],
    )


def _ring_clear(state: VoJitState) -> VoJitState:
    return state._replace(
        rb_valid=torch.zeros_like(state.rb_valid),
        rb_step=torch.full_like(state.rb_step, -1),
        rb_pos=torch.zeros_like(state.rb_pos),
    )


def _to_rays(xy: Tensor, K_inv: Tensor) -> Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1) @ K_inv.T


def _make_vo_step_fns(params: VoJitParams = VoJitParams()):
    """Build (step, preprocess, combine) for ``(state, image, K_inv,
    focal)``; ``focal`` may be a float or a 0-dim tensor."""
    p = params
    K_feat = p.orb.max_features
    M = p.map_capacity
    ba_params = ba_mod.BAParams(max_iterations=p.ba_iterations,
                                compute_covariance=False,
                                compute_point_info=True,
                                huber_delta=p.huber_delta)

    # ---- shared per-frame preprocessing -----------------------------------
    def preprocess(image: Tensor, K_inv: Tensor, focal):
        feats = orb_detect(image, p.orb)
        rays = _to_rays(feats.xy, K_inv)
        smooth = klt.smooth_image(image)
        tmpl = klt.extract_templates(smooth, feats.xy)
        return _FrameArrays(feats.xy, feats.desc, feats.mask, rays,
                            feats.sigma / focal, tmpl), smooth

    def _out(state, success, mode, pose_R, pose_t, num_inliers, mean_error,
             pnp_t, init_tried) -> VoStepOut:
        dev = state.pose_t.device

        def scalar(v, dt):
            # host values become device scalars by a fill, not a copy
            if isinstance(v, Tensor):
                return v.to(dt)
            return torch.full((), v, dtype=dt, device=dev)

        return VoStepOut(
            success=scalar(success, torch.bool), mode=mode,
            pose_R=pose_R, pose_t=pose_t,
            num_inliers=scalar(num_inliers, torch.int32),
            mean_error=scalar(mean_error, state.pose_t.dtype),
            pnp_t=pnp_t, init_tried=scalar(init_tried, torch.int32),
        )

    # ---- mode 0: first frame ---------------------------------------------
    def do_empty(state, f, smooth, K_inv, focal, draws):
        new_state = _ring_push(_store_frame(state, f), f)._replace(
            mode=torch.full_like(state.mode, MODE_INITIALIZING))
        out = _out(state, False, new_state.mode, state.pose_R, state.pose_t,
                   0, math.inf, torch.zeros_like(state.pose_t), 0)
        return new_state, out

    # ---- mode 1: bootstrap vs the frame-ring window -----------------------
    def do_init(state, f, smooth, K_inv, focal, draws):
        """Two-view bootstrap against every ring slot, accepting the oldest
        slot that passes the quality gates (falling back to younger ones
        when the refined-error gate fails)."""
        dtype, dev = state.pose_t.dtype, state.pose_t.device
        B = p.init_window
        if draws is None:
            draws = torch.rand((B, p.ransac_hypotheses, K_feat),
                               generator=state.generator, device=dev)
        thr_sq = p.max_error_sq / (focal * focal)

        def try_slot(b):
            """Cheap per-slot candidate: match + KLT + RANSAC + pose
            recovery + the pre-refine quality gates."""
            rb_desc, rb_rays = state.rb_desc[b], state.rb_rays[b]
            m = matching.match_features(rb_desc, state.rb_mask[b], f.desc,
                                        f.mask, p.max_match_distance)
            if p.use_klt:
                kr = klt.klt_track(state.rb_tmpl[b], smooth, f.xy[m.idx],
                                   m.mask)
                xy2 = kr.xy
                # on KLT failure the observation is the matched new-frame
                # feature position, so the fallback sigma is that feature's
                obs_sigma = torch.where(kr.valid, p.klt_sigma_px / focal,
                                        f.sigma[m.idx])
                klt_valid = kr.valid
            else:
                xy2 = f.xy[m.idx]
                obs_sigma = f.sigma[m.idx]
                klt_valid = m.mask
            r2 = _to_rays(xy2, K_inv)
            rr = ransac.essential_ransac(
                rb_rays, r2, m.mask, num_hypotheses=p.ransac_hypotheses,
                threshold_sq=thr_sq, uniforms=draws[b])
            pose2in1, _, _ = sfm.recover_pose_and_points(
                rr.model, rb_rays, r2, rr.inlier_mask)
            w_rot = torch.amax(torch.abs(pose2in1.log()[3:]))
            t_norm = torch.clamp(torch.linalg.vector_norm(pose2in1.t),
                                 min=1e-9)
            tz = torch.abs(pose2in1.t[2]) / t_norm
            n_inl = rr.num_inliers
            ok = ((n_inl >= p.min_pair_inliers)
                  & (w_rot <= p.max_pair_rotation)
                  & (tz <= p.max_pair_z_translation)
                  & torch.all(torch.isfinite(pose2in1.t)))
            return dict(ok=ok, R=pose2in1.R, t=pose2in1.t,
                        inlier_mask=rr.inlier_mask, m_idx=m.idx, r2=r2,
                        obs_sigma=obs_sigma, klt_valid=klt_valid, n_inl=n_inl)

        slots = [try_slot(b) for b in range(B)]
        cand = {k: torch.stack([s[k] for s in slots]) for k in slots[0]}
        ok_b = cand["ok"] & state.rb_valid
        age = state.step - state.rb_step
        score = torch.where(ok_b, age, torch.full_like(age, -1))
        # slots ranked oldest-passing first (failing slots sort last)
        order = torch.sort(-score, stable=True).indices
        n_ok = torch.sum(ok_b)
        host = torch.cat([n_ok.view(1), order]).tolist()
        n_ok, order = host[0], host[1:]

        def refine_slot(b):
            """One Sampson polish + LM refine of ring slot ``b``; returns
            (passed the error gate, the enriched selection)."""
            s = {k: v[b] for k, v in cand.items()}
            rb_rays_b, rb_sigma_b = state.rb_rays[b], state.rb_sigma[b]
            r2, inl = s["r2"], s["inlier_mask"]
            pose2in1 = epipolar.refine_relative_pose_sampson(
                SE3(s["R"], s["t"]), rb_rays_b, r2, inl.to(dtype))
            points, point_mask = sfm.sfm_triangulate(rb_rays_b, r2, inl,
                                                     pose2in1)
            # base-frame observations are template centers (exact by
            # construction); new-frame ones carry the tracker's noise
            obs_sigma = s["obs_sigma"]
            if p.use_klt:
                sigma1 = torch.where(
                    s["klt_valid"],
                    torch.zeros_like(obs_sigma) + p.template_sigma_px / focal,
                    rb_sigma_b)
            else:
                sigma1 = rb_sigma_b
            ref = sfm.sfm_refine(
                rb_rays_b, r2, point_mask, pose2in1, points,
                obs_stddev=torch.stack([sigma1, obs_sigma]),
                gauge="scale_only", ba_params=ba_params)
            n_obs = torch.clamp(2 * torch.sum(point_mask), min=1)
            mean_err = 2.0 * ref.error / n_obs.to(dtype)
            T = ref.pose2in1
            passed = ((mean_err <= state.gate_pair_err.to(dtype))
                      & torch.all(torch.isfinite(T.t)))
            return passed, dict(s, R=T.R, t=T.t, points=ref.points,
                                point_info=ref.point_information,
                                point_mask=point_mask, mean_err=mean_err)

        # Walk the ranked slots until one passes the refined-error gate
        # (one host read per slot; typically one slot).
        b = order[0]
        sel = dict({k: v[b] for k, v in cand.items()},
                   points=torch.zeros((K_feat, 3), dtype=dtype, device=dev),
                   point_info=torch.zeros((K_feat, 3, 3), dtype=dtype,
                                          device=dev),
                   point_mask=torch.zeros(K_feat, dtype=torch.bool,
                                          device=dev),
                   mean_err=torch.full((), math.inf, dtype=dtype, device=dev))
        n_tried, any_ok = 0, False
        for i in range(n_ok):
            b = order[i]
            passed, sel = refine_slot(b)
            n_tried = i + 1
            if bool(passed):
                any_ok = True
                break

        if any_ok:
            point_mask = sel["point_mask"]
            # seed map: slot i <- base feature i (masked); the selected ring
            # frame becomes the world frame
            ar = torch.arange(K_feat, dtype=torch.int32, device=dev)

            def seeded(shape, dt, head, fill=0):
                out = torch.full(shape, fill, dtype=dt, device=dev)
                out[:K_feat] = head
                return out

            step_or_none = torch.where(point_mask, state.step,
                                       torch.full_like(ar, -1))
            map_info_head = torch.where(point_mask[:, None, None],
                                        sel["point_info"],
                                        torch.zeros_like(sel["point_info"]))
            # association for the new frame: feature m_idx[i] -> slot i
            write_to = torch.where(point_mask, sel["m_idx"],
                                   torch.full_like(sel["m_idx"], K_feat))
            assoc = _set_rows(torch.full((K_feat,), -1, dtype=torch.int32,
                                         device=dev),
                              write_to, torch.where(point_mask, ar,
                                                    torch.full_like(ar, -1)))
            has = (assoc >= 0)
            obs_rays = _set_rows(torch.zeros_like(f.rays), write_to,
                                 sel["r2"])
            obs_rays = torch.where(has[:, None], obs_rays, f.rays)
            obs_sig = _set_rows(torch.ones_like(f.sigma), write_to,
                                sel["obs_sigma"])
            obs_sig = torch.where(has, obs_sig, f.sigma)
            ns = _store_frame(state, f, obs_rays=obs_rays, obs_sigma=obs_sig,
                              assoc=assoc)._replace(
                mode=torch.full_like(state.mode, MODE_TRACKING),
                pose_R=sel["R"], pose_t=sel["t"],
                map_pos=seeded((M, 3), dtype, sel["points"]),
                map_desc=seeded((M, 8), torch.int32, state.rb_desc[b]),
                map_tmpl=seeded((M,) + state.rb_tmpl.shape[2:], dtype,
                                state.rb_tmpl[b]),
                map_valid=seeded((M,), torch.bool, point_mask, False),
                map_seen=seeded((M,), torch.int32, step_or_none, -1),
                map_info=seeded((M, 3, 3), dtype, map_info_head),
                frame_tracked=state.frame_tracked + 1,
            )
            new_state = _ring_clear(ns)
        else:
            # slide the window: the new frame joins the ring
            new_state = _ring_push(_store_frame(state, f), f)
        out = _out(state, any_ok, new_state.mode, new_state.pose_R,
                   new_state.pose_t, sel["n_inl"], sel["mean_err"], sel["t"],
                   n_tried)
        return new_state, out

    # ---- mode 2: tracking --------------------------------------------------
    def do_track(state, f, smooth, K_inv, focal, draws):
        dtype, dev = state.pose_t.dtype, state.pose_t.device
        # 1) associate to map + KLT against map templates
        m = matching.match_features(f.desc, f.mask, state.map_desc,
                                    state.map_valid, p.max_match_distance)
        if p.use_klt:
            kr = klt.klt_track(state.map_tmpl[m.idx], smooth, f.xy, m.mask)
            obs_xy = kr.xy
            obs_sigma = torch.where(kr.valid, p.klt_sigma_px / focal, f.sigma)
        else:
            obs_xy, obs_sigma = f.xy, f.sigma
        obs_rays = _to_rays(obs_xy, K_inv)
        map_pts = state.map_pos[m.idx]
        # 2) P3P-RANSAC
        thr = p.pnp_reproj_px / focal
        pose0, best_inl = pnp.pnp_ransac_core(
            map_pts, obs_rays, m.mask, p.pnp_hypotheses, thr * thr,
            generator=state.generator, uniforms=draws)
        n_inl = torch.sum(best_inl).to(torch.int32)

        # 3) triangulate new points vs previous frame
        lm = matching.match_features(state.lf_desc, state.lf_mask, f.desc,
                                     f.mask, p.max_match_distance)
        feat = torch.arange(K_feat, device=dev)
        new_assoc_of_new_feat = _set_rows(
            torch.full((K_feat,), -1, dtype=torch.int64, device=dev),
            torch.where(m.mask, feat, torch.full_like(feat, K_feat)), m.idx)
        lm_ok = lm.mask & (new_assoc_of_new_feat[lm.idx] < 0)
        if p.use_klt:
            kr2 = klt.klt_track(state.lf_tmpl, smooth, f.xy[lm.idx], lm_ok)
            xy_new = kr2.xy
            sig_new = torch.where(kr2.valid, p.klt_sigma_px / focal,
                                  f.sigma[lm.idx])
        else:
            xy_new, sig_new = f.xy[lm.idx], f.sigma[lm.idx]
        r_new = _to_rays(xy_new, K_inv)
        last_pose = SE3(state.pose_R, state.pose_t)
        rel = last_pose.inverse().compose(pose0)
        pts_last, tri_mask = sfm.sfm_triangulate(state.lf_rays, r_new, lm_ok,
                                                 rel)
        # consistency gate on fresh triangulations: reproject onto BOTH rays
        eye = SE3(torch.eye(3, dtype=dtype, device=dev),
                  torch.zeros(3, dtype=dtype, device=dev))
        e_last = pnp.reprojection_error_sq(eye, pts_last, state.lf_rays)
        e_new = pnp.reprojection_error_sq(rel, pts_last, r_new)
        tri_thr = (p.tri_consistency_px / focal) ** 2
        tri_mask = tri_mask & (e_last < tri_thr) & (e_new < tri_thr)
        pts_world = last_pose.apply(pts_last)

        # 4) two-frame BA with fixed capacities; fresh triangulations ranked
        # by their two-ray consistency residual
        old_idx, old_ok = _masked_take(m.mask & best_inl, p.ba_old)
        tri_score = torch.where(tri_mask, e_last + e_new,
                                torch.full_like(e_last, math.inf))
        new_idx = torch.sort(tri_score, stable=True).indices[: p.ba_new]
        new_ok = tri_mask[new_idx]
        obs_slots = m.idx[old_idx]                       # map slots
        # last-frame observation of those slots (reverse assoc)
        lf_map_to_feat = _set_rows(
            torch.full((M,), -1, dtype=torch.int64, device=dev),
            torch.where(state.lf_assoc >= 0, state.lf_assoc,
                        torch.full_like(state.lf_assoc, M)), feat)
        lf_feat = lf_map_to_feat[obs_slots]
        lf_seen = (lf_feat >= 0) & old_ok
        safe_lf = torch.clamp(lf_feat, min=0)
        nf = lm.idx[new_idx]                             # new-frame feature

        pts0 = torch.cat([state.map_pos[obs_slots], pts_world[new_idx]])
        obs = torch.stack([
            torch.cat([state.lf_obs_rays[safe_lf, :2],
                       state.lf_rays[new_idx, :2]]),
            torch.cat([obs_rays[old_idx, :2], r_new[new_idx, :2]]),
        ])
        obs_mask_ba = torch.stack([torch.cat([lf_seen, new_ok]),
                                   torch.cat([old_ok, new_ok])])
        # last-frame obs of new points = template centers (exact by
        # construction, see template_sigma_px)
        w_tmpl = (torch.zeros(p.ba_new, dtype=dtype, device=dev)
                  + focal / p.template_sigma_px)
        weight = torch.stack([
            torch.cat([1.0 / state.lf_obs_sigma[safe_lf], w_tmpl]),
            torch.cat([1.0 / obs_sigma[old_idx], 1.0 / sig_new[new_idx]]),
        ])
        # old points carry their recursive landmark information
        stored_info = state.map_info[obs_slots]
        has_info = torch.diagonal(stored_info, dim1=-2, dim2=-1).sum(-1) > 0
        iso = torch.eye(3, dtype=dtype, device=dev) / (p.map_point_stddev ** 2)
        old_info = torch.where(has_info[:, None, None], stored_info, iso)
        point_info = torch.cat([
            torch.where(old_ok[:, None, None], old_info,
                        torch.zeros_like(old_info)),
            torch.zeros((p.ba_new, 3, 3), dtype=dtype, device=dev)])
        poses0 = SE3(torch.stack([state.pose_R, pose0.R]),
                     torch.stack([state.pose_t, pose0.t]))
        pose_prior_info = torch.stack([
            1e10 * torch.eye(6, dtype=dtype, device=dev),
            torch.zeros((6, 6), dtype=dtype, device=dev)])
        prob = ba_mod.BAProblem.create(
            poses0=poses0, points0=pts0, obs=obs, obs_mask=obs_mask_ba,
            obs_weight=weight, pose_prior=poses0,
            pose_prior_info=pose_prior_info, point_prior=pts0,
            point_prior_info=point_info)
        result = ba_mod.ba_solve(prob, ba_params)
        n_obs = torch.clamp(torch.sum(obs_mask_ba), min=1)
        mean_err = 2.0 * result.error / n_obs.to(dtype)
        pose = SE3(result.poses.R[1], result.poses.t[1])
        ok = ((n_inl >= p.min_track_inliers)
              & (mean_err <= p.max_track_mean_error)
              & torch.all(torch.isfinite(pose.t)))
        if bool(ok):
            pts_ref = result.points
            info_ref = result.point_information
            w_old = torch.where(old_ok, obs_slots, torch.full_like(obs_slots, M))
            map_pos = _set_rows(state.map_pos, w_old, pts_ref[: p.ba_old])
            map_info = _set_rows(state.map_info, w_old, info_ref[: p.ba_old])
            map_seen = _set_rows(state.map_seen, w_old, state.step)
            slots_new = _allocate_slots(state.map_valid, map_seen, p.ba_new)
            w_new = torch.where(new_ok, slots_new,
                                torch.full_like(slots_new, M))
            map_pos = _set_rows(map_pos, w_new, pts_ref[p.ba_old:])
            map_desc = _set_rows(state.map_desc, w_new, f.desc[nf])
            map_tmpl = _set_rows(state.map_tmpl, w_new,
                                 state.lf_tmpl[new_idx])
            map_valid = _set_rows(state.map_valid, w_new, True)
            map_seen = _set_rows(map_seen, w_new, state.step)
            map_info = _set_rows(map_info, w_new, info_ref[p.ba_old:])
            # new-frame association + refined observations
            w_oldfeat = torch.where(old_ok, old_idx,
                                    torch.full_like(old_idx, K_feat))
            w_nf = torch.where(new_ok, nf, torch.full_like(nf, K_feat))
            assoc = torch.full((K_feat,), -1, dtype=torch.int32, device=dev)
            assoc = _set_rows(assoc, w_oldfeat, obs_slots)
            assoc = _set_rows(assoc, w_nf, slots_new)
            o_rays = _set_rows(f.rays, w_oldfeat, obs_rays[old_idx])
            o_rays = _set_rows(o_rays, w_nf, r_new[new_idx])
            o_sig = _set_rows(f.sigma, w_oldfeat, obs_sigma[old_idx])
            o_sig = _set_rows(o_sig, w_nf, sig_new[new_idx])
            new_state = _store_frame(
                state, f, obs_rays=o_rays, obs_sigma=o_sig, assoc=assoc
            )._replace(
                pose_R=pose.R, pose_t=pose.t,
                map_pos=map_pos, map_desc=map_desc, map_tmpl=map_tmpl,
                map_valid=map_valid, map_seen=map_seen, map_info=map_info,
                frame_tracked=state.frame_tracked + 1,
            )
        else:
            # back to INITIALIZING keeping the new frame (reference reset)
            ns = _store_frame(state, f)._replace(
                mode=torch.full_like(state.mode, MODE_INITIALIZING),
                map_valid=torch.zeros_like(state.map_valid),
                map_seen=torch.full_like(state.map_seen, -1),
                map_info=torch.zeros_like(state.map_info),
            )
            new_state = _ring_push(_ring_clear(ns), f)
        out = _out(state, ok, new_state.mode, new_state.pose_R,
                   new_state.pose_t, n_inl, mean_err, pose0.t, 0)
        return new_state, out

    branches = {MODE_EMPTY: do_empty, MODE_INITIALIZING: do_init,
                MODE_TRACKING: do_track}

    def combine_fn(state: VoJitState, f: _FrameArrays, smooth: Tensor,
                   K_inv: Tensor, focal, draws: Tensor | None = None):
        state = state._replace(step=state.step + 1,
                               frame_total=state.frame_total + 1)
        return branches[int(state.mode)](state, f, smooth, K_inv, focal, draws)

    def step_fn(state: VoJitState, image: Tensor, K_inv: Tensor, focal,
                draws: Tensor | None = None):
        f, smooth = preprocess(image, K_inv, focal)
        return combine_fn(state, f, smooth, K_inv, focal, draws)

    return step_fn, preprocess, combine_fn


def make_vo_step(params: VoJitParams = VoJitParams()):
    """Build ``step(state, image, K_inv, focal, draws=None)``."""
    step_fn, _, _ = _make_vo_step_fns(params)
    return step_fn


def make_vo_pipelined(params: VoJitParams = VoJitParams()):
    """Build ``(pre, combine)`` — the step split at its state-independent
    seam: ``pre(image, K_inv, focal) -> (frame_arrays, smooth)`` is the
    feature pipeline, ``combine(state, frame_arrays, smooth, K_inv, focal,
    draws=None) -> (state, out)`` the state machine."""
    _, preprocess, combine_fn = _make_vo_step_fns(params)
    return preprocess, combine_fn


def make_vo_replay(params: VoJitParams = VoJitParams()):
    """Build ``replay(state, images, K_inv, focal, draws=None) -> (state,
    outs)``: the step over a stacked (T, H, W) batch, outputs stacked per
    field. ``draws``, when given, is a sequence of per-frame draws."""
    step_fn, _, _ = _make_vo_step_fns(params)

    def replay(state: VoJitState, images: Tensor, K_inv: Tensor, focal,
               draws=None):
        outs = []
        for t in range(images.shape[0]):
            state, out = step_fn(state, images[t], K_inv, focal,
                                 None if draws is None else draws[t])
            outs.append(out)
        return state, VoStepOut(*(torch.stack(v) for v in zip(*outs)))

    return replay
