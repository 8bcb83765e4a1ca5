"""Distributed bundle adjustment: landmark-sharded Schur-complement LM
(port of ``mvslam_tpu.parallel.dist_ba``).

Landmarks (with their observations, priors, Jacobian blocks and 3x3
eliminations) are split in contiguous blocks over the ranks of a mesh
axis; poses and their priors are on every rank. Each LM iteration:

1. every rank builds its block's Jacobians and eliminates its own
   landmarks (no communication),
2. the reduced 6F x 6F camera system and gradient are summed over the
   axis's process group (O(F^2) floats per iteration, whatever the
   landmark count),
3. every rank solves the same camera system; landmark back-substitution
   stays local.

The compute core is :func:`mvslam_tpu_torch.ops.ba.ba_solve` with a
``group``: one rank and N ranks run the same code.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.parallel.mesh import (
    DATA_AXIS, all_gather_rows, pad_axis, pad_to_multiple, shard_of,
)
from mvslam_tpu_torch.parallel.multihost import local_batch_slice


def pad_problem(prob: ba_mod.BAProblem, multiple: int) -> ba_mod.BAProblem:
    """Pad the landmark axis to a multiple of the mesh size; padded rows are
    fully masked (zero obs weight, zero priors) so results are unchanged."""
    extra = pad_to_multiple(prob.points0.shape[0], multiple) - \
        prob.points0.shape[0]
    if extra == 0:
        return prob
    return prob._replace(
        points0=pad_axis(prob.points0, extra),
        obs=pad_axis(prob.obs, extra, 1),
        obs_mask=pad_axis(prob.obs_mask, extra, 1, False),
        obs_weight=pad_axis(prob.obs_weight, extra, 1),
        point_prior=pad_axis(prob.point_prior, extra),
        point_prior_info=pad_axis(prob.point_prior_info, extra),
    )


def landmark_block(prob: ba_mod.BAProblem, start: int,
                   size: int) -> ba_mod.BAProblem:
    """The problem restricted to landmarks ``start:start + size``."""
    s = slice(start, start + size)
    return prob._replace(
        points0=prob.points0[s], obs=prob.obs[:, s],
        obs_mask=prob.obs_mask[:, s], obs_weight=prob.obs_weight[:, s],
        point_prior=prob.point_prior[s],
        point_prior_info=prob.point_prior_info[s])


def distributed_ba_solve(
    prob: ba_mod.BAProblem,
    mesh: DeviceMesh,
    params: ba_mod.BAParams = ba_mod.BAParams(),
    axis: str = DATA_AXIS,
) -> ba_mod.BAResult:
    """Solve a BA problem with landmarks sharded over the mesh axis
    ``axis``. Collective: every rank of the mesh calls it with the same
    problem; each solves its contiguous block of the (padded) landmark
    axis, and every rank returns the whole result, sliced back to the
    problem's landmark count."""
    group, count, index = shard_of(mesh, (axis,))
    n = prob.points0.shape[0]
    prob = pad_problem(prob, count)
    start, per = local_batch_slice(prob.points0.shape[0], count, index)
    res = ba_mod.ba_solve(landmark_block(prob, start, per), params,
                          group=group)
    info = res.point_information
    return res._replace(
        points=all_gather_rows(res.points, group, count)[:n],
        point_covariance=all_gather_rows(res.point_covariance, group,
                                         count)[:n],
        point_information=None if info is None else all_gather_rows(
            info, group, count)[:n])
