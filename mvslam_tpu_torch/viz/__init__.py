"""File exports of trajectories, clouds and overlays."""

from mvslam_tpu_torch.viz.export import (  # noqa: F401
    draw_keypoints as draw_keypoints,
    draw_matches as draw_matches,
    load_trajectory_tum as load_trajectory_tum,
    save_point_cloud_ply as save_point_cloud_ply,
    save_scene_ply as save_scene_ply,
    save_trajectory_tum as save_trajectory_tum,
)
