"""The front end: the fused tracker (``vo_jit``) and the host-orchestrated
one (``FrameManager`` -> ``VisualOdometer``)."""

from mvslam_tpu_torch.frontend.data_types import Frame as Frame  # noqa: F401
from mvslam_tpu_torch.frontend.data_types import generate_frame_id as generate_frame_id  # noqa: F401
from mvslam_tpu_torch.frontend.frame_manager import FrameManager as FrameManager  # noqa: F401
from mvslam_tpu_torch.frontend.frame_manager import FpsEstimator as FpsEstimator  # noqa: F401
from mvslam_tpu_torch.frontend.camera_manager import CameraManager as CameraManager  # noqa: F401
from mvslam_tpu_torch.frontend.image_pair import ImagePair as ImagePair  # noqa: F401
from mvslam_tpu_torch.frontend.image_pair import ImagePairParams as ImagePairParams  # noqa: F401
from mvslam_tpu_torch.frontend.visual_odometer import (  # noqa: F401
    TrackResult as TrackResult,
    VisualOdometer as VisualOdometer,
    VoParams as VoParams,
    VoState as VoState,
)
