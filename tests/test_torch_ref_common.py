"""Shared pieces of the reference reruns on the port
(``tests/test_torch_ref_*.py``, ``test_torch_rotation.py``,
``test_torch_tracker_branches.py``; this module holds no test): one working
type named once for both packages, torch counterparts of
``tests/helpers.py``'s sampler, projection and SE3 comparison, and the
one-thread fixture. The numpy inputs are made once and cast to the working
type for both packages, so both solve the same problem."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu_torch.math.lie import SE3, so3_from_rpy

from conftest import tol_for
from helpers import get_rig_points

DTYPES = ("float64", "float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny ops per case: with the suite's workers side by
    side, torch's intra-op pool only makes them fight for the cores (the
    tracker files ran 10x slower). A module that imports this fixture
    runs on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Dt:
    """A working type on both sides: ``t(a)`` a torch tensor, ``j(a)`` a
    JAX array, ``tol`` the reference's ``tol_for`` (1e-3 in float64, 5e-3
    in float32)."""

    def __init__(self, name: str):
        self.name = name
        self.torch = getattr(torch, name)
        self.jnp = getattr(jnp, name)
        self.np = np.dtype(name).type
        self.tol = tol_for(self.jnp)
        self.f64 = name == "float64"

    def t(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float64), dtype=self.torch)

    def j(self, a):
        return jnp.asarray(np.asarray(a, np.float64), self.jnp)

    def __repr__(self) -> str:
        return self.name


def rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """A float64 rotation from roll, pitch, yaw (``helpers.rig_rotation``)."""
    return so3_from_rpy(roll, pitch, yaw, dtype=torch.float64).numpy()


def rig(rig_type: str, rotation=None,
        translation=(0.3, -0.2, 6.0)) -> np.ndarray:
    """The reference's 8-point rig, float64 numpy
    (``helpers.get_rig_points``); the reruns place it as the reference
    does: rotated by rpy (0.1, -0.2, 0.3), 6 units in front of camera 1."""
    if rotation is None:
        rotation = rpy(0.1, -0.2, 0.3)
    return np.asarray(get_rig_points(rig_type, rotation=rotation,
                                     translation=translation,
                                     dtype=jnp.float64))


def se3(R, t, dt: Dt) -> SE3:
    return SE3(dt.t(R), dt.t(t))


def random_se3(rng: np.random.Generator, stddev: float, dt: Dt) -> SE3:
    """exp of an isotropic Gaussian twist: the draw of
    ``helpers.random_se3``, so the same ``rng`` gives the same pose."""
    return SE3.exp(dt.t(rng.normal(0.0, stddev, size=6)))


def check_similar_se3(T1: SE3, T2: SE3, tol: float) -> bool:
    """Componentwise ``|ln(T1) - ln(T2)| <= tol``
    (``helpers.check_similar_se3``)."""
    return bool(torch.all(torch.abs(T1.log() - T2.log()) <= tol))


def project_ideal(pose_cam_in_world: SE3, points: torch.Tensor):
    """Rays in an ideal camera whose camera-to-world pose is given."""
    p_cam = pose_cam_in_world.inverse().apply(points)
    return p_cam / p_cam[..., 2:3]


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))
