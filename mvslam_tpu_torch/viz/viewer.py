"""Threaded visualizers (reference ``source/visualization/``; port of
``mvslam_tpu.viz.viewer``).

The reference runs two interactive viewers, each on its own render thread:

- ``Visualizer3d`` — PCL/VTK window drawing camera poses as RGB axis triads
  and per-cloud colored point clouds, mutex-guarded spinOnce loop
  (``visualizer-3d.cpp:159-292``);
- ``Visualizer2d`` — OpenCV highgui window with an Event-driven redraw
  queue drawing keypoint circles and stacked match pairs
  (``visualizer-2d.cpp:66-203``).

This build keeps the exact architecture — a dedicated render thread, a
mutex-guarded scene store, an event-driven redraw queue — but renders
headlessly: each redraw rasterizes the scene to a PNG under ``out_dir``
(continuously overwritten "window" + optional numbered history). That is
the "window" of a remote job: no display, artifacts land on disk.
Drawing primitives are shared with :mod:`mvslam_tpu_torch.viz.export`.

Poses, images and keypoints may be tensors on any device or arrays: each
setter copies them to host numpy arrays before it stores them, so the
render thread never touches a device. ``Visualizer3d`` draws with
matplotlib and ``Visualizer2d`` writes PNGs with PIL, both imported on the
render thread.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

import torch

from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.utils.sync import Event, Mutex
from mvslam_tpu_torch.viz.export import draw_keypoints, draw_matches


def _host(x, dtype=None) -> np.ndarray:
    """Tensor (any device) or array -> host numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _save_png(path: str, rgb: np.ndarray) -> None:
    from PIL import Image

    arr = (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)
    tmp = path + ".tmp"
    Image.fromarray(arr).save(tmp, format="PNG")
    os.replace(tmp, path)  # atomic: readers never see a torn frame


@dataclass
class Visualizer3dParams:
    """Reference ``visualizer-3d.cpp:179-191`` (cadence etc.)."""

    view_cadence_ms: int = 100
    axis_length: float = 0.5
    point_size: float = 2.0
    keep_history: bool = False


class Visualizer3d:
    """Camera poses + point clouds on a dedicated render thread.

    API parity with the reference (``visualizer-3d.hpp:14-53``):
    ``set_camera_pose(id, pose)``, ``set_point_cloud(id, points)``,
    ``is_window_closed()``, plus explicit ``close()`` (the reference
    closes with the window).
    """

    def __init__(self, out_dir: str,
                 params: Visualizer3dParams | None = None) -> None:
        self._params = params or Visualizer3dParams()
        self._out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._mutex = Mutex()
        self._dirty = Event()
        self._poses: Dict[int, SE3] = {}
        self._clouds: Dict[int, np.ndarray] = {}
        self._colors: Dict[int, tuple] = {}
        self._closed = False
        self._frame_no = 0
        self._thread = threading.Thread(
            target=self._run_viewer_thread, name="visualizer-3d", daemon=True
        )
        self._thread.start()

    # -- scene updates (any thread) -----------------------------------------
    def set_camera_pose(self, camera_id: int, pose: SE3) -> None:
        with self._mutex:
            self._poses[camera_id] = SE3(
                _host(pose.R, np.float64), _host(pose.t, np.float64)
            )
        self._dirty.trigger_all()

    def set_point_cloud(self, cloud_id: int, points,
                        color: Optional[tuple] = None) -> None:
        pts = _host(points, np.float64).reshape(-1, 3)
        with self._mutex:
            self._clouds[cloud_id] = pts
            if color is not None:
                self._colors[cloud_id] = color
            elif cloud_id not in self._colors:
                # per-cloud stable pseudo-random color (reference :262-292)
                rng = np.random.default_rng(cloud_id)
                self._colors[cloud_id] = tuple(rng.uniform(0.3, 1.0, 3))
        self._dirty.trigger_all()

    def is_window_closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        self._dirty.trigger_all()
        self._thread.join(timeout=10.0)

    @property
    def window_path(self) -> str:
        return os.path.join(self._out_dir, "view3d.png")

    # -- render thread -------------------------------------------------------
    def _run_viewer_thread(self) -> None:
        # reference: mutex-guarded spinOnce loop at view cadence (:159-177)
        while not self._closed:
            self._dirty.wait_timeout(self._params.view_cadence_ms)
            self._render_once()
        self._render_once()

    def _render_once(self) -> None:
        with self._mutex:
            poses = dict(self._poses)
            clouds = {k: v.copy() for k, v in self._clouds.items()}
            colors = dict(self._colors)
        if not poses and not clouds:
            return
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(6, 6), dpi=100)
        ax = fig.add_subplot(projection="3d")
        L = self._params.axis_length
        for cid, pose in poses.items():
            # camera pose as an RGB axis triad (reference :219-260)
            o = pose.t
            for axis, col in zip(pose.R.T, ("r", "g", "b")):
                ax.plot(*np.stack([o, o + L * axis]).T, color=col, lw=1.5)
            ax.text(*o, f"c{cid}", fontsize=7)
        for cid, pts in clouds.items():
            if len(pts):
                ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2],
                           s=self._params.point_size,
                           color=colors.get(cid, (0.6, 0.6, 0.6)))
        ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
        fig.tight_layout()
        tmp = self.window_path + ".tmp"
        fig.savefig(tmp, format="png")
        plt.close(fig)
        os.replace(tmp, self.window_path)
        if self._params.keep_history:
            self._frame_no += 1
            import shutil

            shutil.copyfile(
                self.window_path,
                os.path.join(self._out_dir, f"view3d_{self._frame_no:05d}.png"),
            )


@dataclass
class Visualizer2dParams:
    """Reference ``visualizer-2d.cpp:205-223``."""

    redraw_timeout_ms: int = 100
    keypoint_radius: int = 3


@dataclass
class _RedrawItem:
    kind: str
    payload: dict = field(default_factory=dict)


class Visualizer2d:
    """Keyframe / matched-pair 2D viewer on its own render thread.

    Event-driven redraw queue exactly as the reference
    (``visualizer-2d.cpp:157-203``): producers enqueue draw objects and
    trigger the event; the render thread drains the queue and rasterizes.
    """

    def __init__(self, out_dir: str,
                 params: Visualizer2dParams | None = None) -> None:
        self._params = params or Visualizer2dParams()
        self._out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._mutex = Mutex()
        self._event = Event()
        self._queue: list[_RedrawItem] = []
        self._closed = False
        self._count = 0
        self._thread = threading.Thread(
            target=self._run_viewer_thread, name="visualizer-2d", daemon=True
        )
        self._thread.start()

    def show_keyframe(self, image, keypoints_xy, mask=None) -> None:
        """Keypoints drawn as circles (reference :66-92)."""
        with self._mutex:
            self._queue.append(_RedrawItem("keyframe", dict(
                image=_host(image), xy=_host(keypoints_xy),
                mask=None if mask is None else _host(mask),
            )))
        self._event.trigger_all()

    def show_matched_pair(self, image1, xy1, image2, xy2, match_idx,
                          match_mask, inlier_mask=None) -> None:
        """Stacked pair, raw matches blue / inliers green (reference
        :95-155)."""
        with self._mutex:
            self._queue.append(_RedrawItem("pair", dict(
                image1=_host(image1), xy1=_host(xy1),
                image2=_host(image2), xy2=_host(xy2),
                match_idx=_host(match_idx),
                match_mask=_host(match_mask),
                inlier_mask=None if inlier_mask is None
                else _host(inlier_mask),
            )))
        self._event.trigger_all()

    def is_window_closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        self._event.trigger_all()
        self._thread.join(timeout=10.0)

    @property
    def window_path(self) -> str:
        return os.path.join(self._out_dir, "view2d.png")

    def _run_viewer_thread(self) -> None:
        # reference: condvar wait w/ timeout, then drain the queue (:157-203)
        while True:
            self._event.wait_timeout(self._params.redraw_timeout_ms)
            with self._mutex:
                items, self._queue = self._queue, []
            for item in items:
                self._render(item)
            if self._closed:
                with self._mutex:
                    items, self._queue = self._queue, []
                for item in items:
                    self._render(item)
                return

    def _render(self, item: _RedrawItem) -> None:
        pl = item.payload
        if item.kind == "keyframe":
            rgb = draw_keypoints(pl["image"], pl["xy"], pl["mask"],
                                 radius=self._params.keypoint_radius)
        else:
            rgb = draw_matches(pl["image1"], pl["xy1"], pl["image2"],
                               pl["xy2"], pl["match_idx"], pl["match_mask"],
                               pl["inlier_mask"])
        _save_png(self.window_path, rgb)
        self._count += 1
        _save_png(os.path.join(self._out_dir,
                               f"view2d_{self._count:05d}.png"), rgb)
