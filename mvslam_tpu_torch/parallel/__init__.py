"""The distributed layer on ``torch.distributed`` and the synthetic BA
problem generators."""

from mvslam_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS as DATA_AXIS,
    make_mesh as make_mesh,
    pad_to_multiple as pad_to_multiple,
)
from mvslam_tpu_torch.parallel.dist_ba import (  # noqa: F401
    distributed_ba_solve as distributed_ba_solve,
    pad_problem as pad_problem,
)
from mvslam_tpu_torch.parallel import synthetic as synthetic  # noqa: F401
from mvslam_tpu_torch.parallel.dist_pose_graph import (  # noqa: F401
    distributed_pose_graph_optimize as distributed_pose_graph_optimize,
)
