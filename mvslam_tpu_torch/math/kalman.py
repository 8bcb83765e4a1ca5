"""Batched linear Kalman filter (port of ``mvslam_tpu.math.kalman``).

Process update with or without a control input, measurement update with an
explicit ``S^-1`` gain, and the rollback that keeps the old state when an
update produced a non-finite value. Plain functions on tensors; filters
batch over leading dims (``x`` (..., N), ``P`` (..., N, N)), and device and
dtype follow the inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class KFState(NamedTuple):
    x: Tensor  # (..., N) state mean
    P: Tensor  # (..., N, N) state covariance


def kf_init(x0, P0) -> KFState:
    return KFState(torch.as_tensor(x0), torch.as_tensor(P0))


def _matvec(M: Tensor, v: Tensor) -> Tensor:
    return (M @ v[..., None])[..., 0]


def _rollback(new: KFState, old: KFState) -> tuple[KFState, Tensor]:
    """Keep ``new`` only where it is entirely finite, else keep ``old``:
    decided per filter of the batch (what ``vmap`` of the JAX package's
    function gives). Returns (state, ok (...,))."""
    ok = torch.isfinite(new.x).all(-1) & torch.isfinite(new.P).all(-1).all(-1)
    return KFState(torch.where(ok[..., None], new.x, old.x),
                   torch.where(ok[..., None, None], new.P, old.P)), ok


def kf_process_update(state: KFState, F: Tensor, Q: Tensor,
                      B: Optional[Tensor] = None,
                      u: Optional[Tensor] = None) -> tuple[KFState, Tensor]:
    """x' = F x (+ B u); P' = F P F^T + Q. Returns (state, ok)."""
    x = _matvec(F, state.x)
    if B is not None and u is not None:
        x = x + _matvec(B, u)
    P = F @ state.P @ F.transpose(-1, -2) + Q
    return _rollback(KFState(x, P), state)


def kf_measurement_update(state: KFState, H: Tensor, z: Tensor,
                          R: Tensor) -> tuple[KFState, Tensor]:
    """Measurement update with the gain ``K = P H^T S^-1``. A singular
    ``S`` gives a non-finite inverse, which the rollback catches; the
    inverse is taken unchecked so that nothing is read on the host."""
    Ht = H.transpose(-1, -2)
    y = z - _matvec(H, state.x)
    S = H @ state.P @ Ht + R
    K = state.P @ Ht @ torch.linalg.inv_ex(S).inverse
    x = state.x + _matvec(K, y)
    eye = torch.eye(state.P.shape[-1], dtype=state.P.dtype,
                    device=state.P.device)
    P = (eye - K @ H) @ state.P
    return _rollback(KFState(x, P), state)
