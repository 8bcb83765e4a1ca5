"""File exports of trajectories, clouds and overlays; the threaded
headless viewers."""

from mvslam_tpu_torch.viz.export import (  # noqa: F401
    draw_keypoints as draw_keypoints,
    draw_matches as draw_matches,
    load_trajectory_tum as load_trajectory_tum,
    save_point_cloud_ply as save_point_cloud_ply,
    save_scene_ply as save_scene_ply,
    save_trajectory_tum as save_trajectory_tum,
)
from mvslam_tpu_torch.viz.viewer import (  # noqa: F401
    Visualizer2d as Visualizer2d,
    Visualizer2dParams as Visualizer2dParams,
    Visualizer3d as Visualizer3d,
    Visualizer3dParams as Visualizer3dParams,
)
