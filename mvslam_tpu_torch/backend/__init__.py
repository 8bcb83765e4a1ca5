"""SLAM back-end: pose graphs, loop closure, the keyframe skeleton."""

from mvslam_tpu_torch.backend import pose_graph as pose_graph  # noqa: F401
from mvslam_tpu_torch.backend import sim3_graph as sim3_graph  # noqa: F401
from mvslam_tpu_torch.backend.graph import (  # noqa: F401
    Graph as Graph,
    GraphOptimizer as GraphOptimizer,
)
from mvslam_tpu_torch.backend.slam import (  # noqa: F401
    BackendParams as BackendParams,
    PoseGraphBackend as PoseGraphBackend,
)
