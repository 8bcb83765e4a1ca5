"""mvslam_tpu_torch — the PyTorch/CUDA port of ``mvslam_tpu``.

Every module of the JAX package, mirrored path for path (its Pallas
kernel module becomes ``ops/features_cuda.py`` with a CUDA source):

- ``mvslam_tpu_torch.math``     — SO3/SE3 Lie groups, small-matrix linalg,
  Kalman filtering, signal processing, state estimates.
- ``mvslam_tpu_torch.ops``      — camera, ORB features (with the hand-written
  CUDA corner kernel ``csrc/fast_nms_harris.cu``), matching, KLT, RANSAC,
  epipolar geometry, homographies, triangulation, SfM, P3P/PnP, dense and
  sparse bundle adjustment, planar camera calibration and undistortion.
- ``mvslam_tpu_torch.frontend`` — the fused tracker ``vo_jit`` and the
  host-orchestrated front end (``FrameManager`` -> ``VisualOdometer``).
- ``mvslam_tpu_torch.backend``  — SE3 and Sim3 pose graphs, the host-side
  ``Graph``, the keyframe / loop-closure back-end ``PoseGraphBackend``.
- ``mvslam_tpu_torch.parallel`` — the distributed layer on
  ``torch.distributed`` (device meshes, landmark-sharded dense and sparse
  BA, edge-sharded pose graphs, multi-process ``(dcn, ici)`` meshes) and
  synthetic BA problem generators.
- ``mvslam_tpu_torch.apps``     — the command-line apps: ``visual_odometer``,
  ``reconstruct_scene``, ``calibrate_camera``, ``demos``, ``video_capture``.
- ``mvslam_tpu_torch.io``       — images, manifests, checkpoints, the native
  (libjpeg) prefetching loader built from ``csrc/loader.cpp``.
- ``mvslam_tpu_torch.viz``      — trajectory / point-cloud / overlay exports
  and the threaded headless viewers.
- ``mvslam_tpu_torch.convert``  — states, problems, the back-end's skeleton
  and calibration results to/from numpy dicts.
- ``mvslam_tpu_torch.utils``    — logging, synchronisation primitives,
  strings, directory listing, the host clock and timing on the card, the
  synthetic two-plane scene renderer, error codes.

The port imports ``torch`` and numpy only: never ``jax`` and never
``mvslam_tpu``. The JAX package's ``MVSLAM_PLATFORM`` variable (which picks
JAX's platform at import) has no counterpart: the port's entry points take
a ``device`` (``--device`` in the apps) and run on the card unless told
otherwise.
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM geometry is precision-critical (reduced-precision matmuls turn the
# epipolar/PnP math into ~1e-2 error); keep every float32 product and
# convolution in full float32, as the JAX package pins its matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from mvslam_tpu_torch import config as config  # noqa: F401, E402
from mvslam_tpu_torch.math import lie as lie  # noqa: F401, E402
from mvslam_tpu_torch.math import linalg as linalg  # noqa: F401, E402
from mvslam_tpu_torch.math.lie import SE3 as SE3  # noqa: F401, E402
from mvslam_tpu_torch.ops.camera import PinholeCamera as PinholeCamera  # noqa: F401, E402
