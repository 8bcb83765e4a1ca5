"""CameraManager: THE camera of the rig (port of
``mvslam_tpu.frontend.camera_manager``): holds one :class:`PinholeCamera`
(default: identity-intrinsics ideal camera) on one device, with load/save
in the ``camera.config`` text format."""

from __future__ import annotations

import threading

import torch

from mvslam_tpu_torch.ops.camera import PinholeCamera


class CameraManager:
    _global: "CameraManager | None" = None

    def __init__(self, camera: PinholeCamera | None = None,
                 device="cuda") -> None:
        self._lock = threading.Lock()
        self.device = torch.device(device)
        if camera is None:
            camera = PinholeCamera.create(device=self.device)
        self._camera = camera.to(self.device)

    @classmethod
    def global_instance(cls) -> "CameraManager":
        if cls._global is None:
            cls._global = CameraManager()
        return cls._global

    def get_camera(self) -> PinholeCamera:
        with self._lock:
            return self._camera

    def set_camera(self, camera: PinholeCamera) -> None:
        with self._lock:
            self._camera = camera.to(self.device)

    def load_from_file(self, filename: str) -> PinholeCamera:
        self.set_camera(PinholeCamera.load_from_file(filename))
        return self.get_camera()

    def save_to_file(self, filename: str) -> None:
        self.get_camera().save_to_file(filename)
