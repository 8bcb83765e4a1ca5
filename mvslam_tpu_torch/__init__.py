"""mvslam_tpu_torch — the PyTorch/CUDA port of ``mvslam_tpu``.

The fused visual-odometry tracker (``frontend/vo_jit.py``) and every module
it runs, mirrored path for path from the JAX package:

- ``mvslam_tpu_torch.math``     — SO3/SE3 Lie groups, small-matrix linalg.
- ``mvslam_tpu_torch.ops``      — camera, ORB features (with the hand-written
  CUDA corner kernel ``csrc/fast_nms_harris.cu``), matching, KLT, RANSAC,
  epipolar geometry, triangulation, SfM, P3P/PnP, bundle adjustment.
- ``mvslam_tpu_torch.frontend`` — the fused tracker ``vo_jit``.
- ``mvslam_tpu_torch.convert``  — tracker state to/from numpy dicts.
- ``mvslam_tpu_torch.utils``    — the synthetic two-plane scene renderer.

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
