"""mvslam_tpu_torch — the PyTorch/CUDA port of ``mvslam_tpu``.

The fused visual-odometry tracker (``frontend/vo_jit.py``), the SLAM
back-end on top of it and every module they run, mirrored path for path
from the JAX package:

- ``mvslam_tpu_torch.math``     — SO3/SE3 Lie groups, small-matrix linalg.
- ``mvslam_tpu_torch.ops``      — camera, ORB features (with the hand-written
  CUDA corner kernel ``csrc/fast_nms_harris.cu``), matching, KLT, RANSAC,
  epipolar geometry, triangulation, SfM, P3P/PnP, dense and sparse bundle
  adjustment.
- ``mvslam_tpu_torch.frontend`` — the fused tracker ``vo_jit``.
- ``mvslam_tpu_torch.backend``  — SE3 and Sim3 pose graphs, the host-side
  ``Graph``, the keyframe / loop-closure back-end ``PoseGraphBackend``.
- ``mvslam_tpu_torch.parallel`` — synthetic BA problem generators.
- ``mvslam_tpu_torch.apps``     — the ``visual_odometer`` replay app.
- ``mvslam_tpu_torch.io``, ``mvslam_tpu_torch.viz`` — images, manifests,
  trajectory / point-cloud / overlay exports.
- ``mvslam_tpu_torch.convert``  — states, problems and the back-end's
  skeleton to/from numpy dicts.
- ``mvslam_tpu_torch.utils``    — the synthetic two-plane scene renderer,
  timing on the card, error codes.

The port imports ``torch`` and numpy only: never ``jax`` and never
``mvslam_tpu``.
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM geometry is precision-critical (reduced-precision matmuls turn the
# epipolar/PnP math into ~1e-2 error); keep every float32 product and
# convolution in full float32, as the JAX package pins its matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
