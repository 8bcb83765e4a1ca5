"""ImagePair: the two-view reconstruction unit with quality metrics (port
of ``mvslam_tpu.frontend.image_pair``).

A (base frame, pair frame) couple that matches features, reconstructs
relative pose + points (``reconstruct``), optionally bundle-adjusts
(``refine``), and can be upgraded to a newer pair frame when that yields at
least as many inliers and a lower refined error (``update``). State machine
INIT -> RECONSTRUCTED -> REFINED.

Quality metrics exposed for the VO gates: ``match_inlier_count``,
``match_inlier_ssd`` (sum of squared descriptor distances over inliers) and
the refined BA ``error``. Each stage reads its metrics on the host in one
transfer; every array stays on the frames' device.

Random draws: the JAX package seeds a key with ``seed``; here a
``torch.Generator`` on the frames' device is seeded the same way, or the
caller hands in ``uniforms`` (num_hypotheses, K) — the JAX package's own
draws, in a test.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from mvslam_tpu_torch.frontend.data_types import Frame
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import klt, matching, sfm

Tensor = torch.Tensor

#: effective measurement stddev (px) of a KLT-converged correspondence
KLT_SIGMA_PX = 0.25


class PairState(enum.Enum):
    INIT = 0
    RECONSTRUCTED = 1
    REFINED = 2


class ImagePairParams(NamedTuple):
    max_match_distance: int = 64
    lowe_ratio: float = matching.LOWE_RATIO
    sfm: sfm.SfmParams = sfm.SfmParams()
    gauge: str = "scale_only"
    use_klt: bool = True                 # sub-pixel refine matched positions


class ImagePair:
    """Two-view unit. Frames are immutable."""

    def __init__(
        self,
        base: Frame,
        pair: Frame,
        params: ImagePairParams = ImagePairParams(),
        seed: int = 0,
        auto_reconstruct: bool = True,
        uniforms: Optional[Tensor] = None,
    ) -> None:
        self.base = base
        self.pair = pair
        self.params = params
        self._seed = seed
        self._uniforms = uniforms
        self.state = PairState.INIT
        self.match: Optional[matching.MatchResult] = None
        self.result: Optional[sfm.SfmResult] = None
        self.refined: Optional[sfm.SfmRefineResult] = None
        self.match_inlier_count = 0
        self.match_inlier_ssd = float("inf")
        self.error = float("inf")
        self.mean_error = float("inf")
        if auto_reconstruct:
            self.reconstruct()

    # -- stages ---------------------------------------------------------------
    def reconstruct(self) -> bool:
        """Match + two-view solve."""
        f1, f2 = self.base.features, self.pair.features
        self.match = matching.match_features(
            f1.desc, f1.mask, f2.desc, f2.mask,
            max_distance=self.params.max_match_distance,
            ratio=self.params.lowe_ratio,
        )
        r1 = self.base.rays
        self.obs_sigma = self.base.sigma
        if (
            self.params.use_klt
            and self.base.image is not None
            and self.pair.image is not None
            and self.base.camera is not None
        ):
            # sub-pixel refine the pair-frame positions against base
            # templates; drop effective noise to ~KLT_SIGMA_PX
            tmpl = klt.extract_templates(self.base.image_smooth, f1.xy)
            kr = klt.klt_track(
                tmpl, self.pair.image_smooth, f2.xy[self.match.idx],
                self.match.mask
            )
            r2 = self.base.camera.normalize_points(kr.xy)
            self.obs_sigma = torch.where(
                kr.valid, KLT_SIGMA_PX / self.base.focal, self.base.sigma
            )
        else:
            r2 = self.pair.rays[self.match.idx]
        self._r2 = r2
        # the RANSAC threshold lives in squared pixel-ish units in the
        # params; convert to squared ideal-plane units with the focal
        sfm_params = self.params.sfm._replace(
            threshold_sq=self.params.sfm.threshold_sq / (self.base.focal**2)
        )
        generator = None
        if self._uniforms is None:
            generator = torch.Generator(device=r1.device).manual_seed(
                self._seed)
        self.result = sfm.sfm_solve(
            r1, self._r2, self.match.mask, sfm_params,
            generator=generator, uniforms=self._uniforms,
        )
        d = self.match.dist.to(torch.float32)
        ssd = torch.sum(torch.where(self.result.inlier_mask, d * d,
                                    torch.zeros_like(d)))
        ok, n_inl, ssd = torch.stack([
            self.result.success.to(torch.float32),
            self.result.num_inliers.to(torch.float32), ssd]).tolist()
        ok = bool(ok)
        if ok:
            self.state = PairState.RECONSTRUCTED
            self.match_inlier_count = int(n_inl)
            self.match_inlier_ssd = ssd
        return ok

    def refine(self) -> bool:
        """Two-view BA."""
        if self.state == PairState.INIT:
            return False
        r1 = self.base.rays
        self.refined = sfm.sfm_refine(
            r1, self._r2, self.result.point_mask,
            self.result.pose2in1, self.result.points,
            obs_stddev=self.obs_sigma, gauge=self.params.gauge,
        )
        error, n_pts, converged = torch.stack([
            self.refined.error.to(torch.float64),
            torch.sum(self.result.point_mask).to(torch.float64),
            self.refined.converged.to(torch.float64)]).tolist()
        self.error = error
        # scale-free quality: mean squared standardized residual per
        # observation (2 frames observe each masked point)
        n_obs = max(2 * int(n_pts), 1)
        self.mean_error = 2.0 * self.error / n_obs
        self.state = PairState.REFINED
        return bool(converged)

    def update(self, new_pair: Frame, seed: int = 0,
               uniforms: Optional[Tensor] = None) -> bool:
        """Try swapping in a newer pair frame; keep the swap when it has at
        least as many inliers and a lower refined error: this pair then
        takes over every attribute of the candidate. Returns True if
        swapped."""
        candidate = ImagePair(self.base, new_pair, self.params, seed,
                              uniforms=uniforms)
        if candidate.state == PairState.INIT:
            return False
        candidate.refine()
        if (
            candidate.match_inlier_count >= self.match_inlier_count
            and candidate.error <= self.error
        ):
            vars(self).update(vars(candidate))
            return True
        return False

    # -- outputs --------------------------------------------------------------
    @property
    def T_pair_to_base(self) -> Optional[SE3]:
        """Pose of the pair camera in the base frame (unit-scale baseline)."""
        if self.state == PairState.REFINED:
            return self.refined.pose2in1
        if self.state == PairState.RECONSTRUCTED:
            return self.result.pose2in1
        return None

    @property
    def points(self):
        if self.state == PairState.REFINED:
            return self.refined.points, self.result.point_mask
        if self.state == PairState.RECONSTRUCTED:
            return self.result.points, self.result.point_mask
        return None, None
