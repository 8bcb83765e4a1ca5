"""FrameManager: frame registry + FPS estimation (port of
``mvslam_tpu.frontend.frame_manager``).

``add_frame(time, image)`` runs feature extraction on the manager's device
and registers the frame; an id->frame map with erase/get/size; throughput
estimated by a 2-state (frame count, rate) Kalman filter (F = [[1, dt],
[0, 1]], H = [1, 0]). Construct instances freely;
``FrameManager.global_instance()`` exists for API parity.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from mvslam_tpu_torch.frontend.data_types import Frame, generate_frame_id
from mvslam_tpu_torch.math.kalman import (
    KFState, kf_init, kf_measurement_update, kf_process_update,
)
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.ops.features import OrbParams, orb_detect
from mvslam_tpu_torch.ops.klt import smooth_image


class FpsEstimator:
    """Kalman-filtered frames-per-second estimate. State = (frame count,
    rate).

    The filter's state is float64 CPU tensors by design: it filters the
    host's wall clock and hands back a Python float every frame, which on
    the card would be a dozen launches and a synchronising read per frame
    for bookkeeping. It is the one object of the front end that does not
    sit on the manager's device (``math.kalman`` itself follows its
    inputs' device).
    """

    def __init__(self, process_noise: float = 1e-4,
                 measurement_noise: float = 1e-2):
        self._state: Optional[KFState] = None
        self._last_time: Optional[float] = None
        self._count = 0
        self._q = process_noise
        self._r = measurement_noise

    def update(self, capture_time: float) -> float:
        f64 = torch.float64
        self._count += 1
        if self._state is None:
            self._state = kf_init(torch.tensor([1.0, 0.0], dtype=f64),
                                  torch.eye(2, dtype=f64) * 1e3)
            self._last_time = capture_time
            return 0.0
        dt = max(capture_time - self._last_time, 1e-6)
        self._last_time = capture_time
        F = torch.tensor([[1.0, dt], [0.0, 1.0]], dtype=f64)
        Q = self._q * torch.tensor([[dt * dt, 0.0], [0.0, 1.0]], dtype=f64)
        self._state, _ = kf_process_update(self._state, F, Q)
        H = torch.tensor([[1.0, 0.0]], dtype=f64)
        R = torch.tensor([[self._r]], dtype=f64)
        z = torch.tensor([float(self._count)], dtype=f64)
        self._state, _ = kf_measurement_update(self._state, H, z, R)
        return float(self._state.x[1])

    @property
    def fps(self) -> float:
        return 0.0 if self._state is None else float(self._state.x[1])


class FrameManager:
    """Owns all live frames, on ``device`` (the card unless the caller
    names another, e.g. ``"cpu"``)."""

    _global: "FrameManager | None" = None

    def __init__(self, camera: PinholeCamera | None = None,
                 orb_params: OrbParams = OrbParams(), device="cuda") -> None:
        self.device = torch.device(device)
        self._frames: Dict[int, Frame] = {}
        self._lock = threading.Lock()
        self._fps = FpsEstimator()
        self._orb_params = orb_params
        self.set_camera(camera if camera is not None
                        else PinholeCamera.create(device=self.device))

    @classmethod
    def global_instance(cls) -> "FrameManager":
        if cls._global is None:
            cls._global = FrameManager()
        return cls._global

    @property
    def camera(self) -> PinholeCamera:
        return self._camera

    def set_camera(self, camera: PinholeCamera) -> None:
        """Move the camera to the manager's device and read its focal
        lengths once, here, so that no frame has to."""
        self._camera = camera.to(self.device)
        K = self._camera.K
        self._fx, self._focal = torch.stack(
            [K[0, 0], torch.sqrt(K[0, 0] * K[1, 1])]).tolist()

    def add_frame(self, capture_time: float, image) -> Frame:
        """Extract features + register. ``image``: (H, W) float32 array or
        tensor in [0, 1]; it is moved to the manager's device."""
        image = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        feats = orb_detect(image, self._orb_params)
        rays = self._camera.normalize_points(feats.xy)
        # keypoint sigma (2^octave * 0.5 px) converted to ideal units by the
        # focal length, so BA weights are statistically correct
        frame = Frame(
            id=generate_frame_id(),
            capture_time=capture_time,
            features=feats,
            rays=rays,
            sigma=feats.sigma / self._fx,
            focal=self._focal,
            camera=self._camera,
            image=image,
            image_smooth=smooth_image(image),
        )
        with self._lock:
            self._frames[frame.id] = frame
            self._fps.update(capture_time)
        return frame

    def get_frame(self, frame_id: int) -> Frame:
        with self._lock:
            return self._frames[frame_id]

    def erase_frame(self, frame_id: int) -> None:
        with self._lock:
            self._frames.pop(frame_id, None)

    def size(self) -> int:
        with self._lock:
            return len(self._frames)

    def get_fps(self) -> float:
        return self._fps.fps
