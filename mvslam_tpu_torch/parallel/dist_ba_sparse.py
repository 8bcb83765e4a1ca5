"""Distributed sparse BA: keyframe-sequence partitioning over the mesh
(port of ``mvslam_tpu.parallel.dist_ba_sparse``).

A long keyframe sequence is partitioned in time. Landmarks are stored in
the order of their anchor keyframe (the synthetic generator emits them so,
as a map grows keyframe by keyframe), so equal contiguous blocks of the
landmark axis hand each rank one time block's landmarks and observations.
Poses are on every rank; keyframes seen from two blocks are coupled only
through the (F, 6) / (F, 6, 6) camera-system sums inside
:func:`mvslam_tpu_torch.ops.ba_sparse.sparse_ba_solve`: no halo exchange to
orchestrate. One rank and N ranks run the same code.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from mvslam_tpu_torch.ops import ba_sparse
from mvslam_tpu_torch.parallel.mesh import (
    DATA_AXIS, all_gather_rows, pad_axis, pad_to_multiple, shard_of,
)
from mvslam_tpu_torch.parallel.multihost import (
    DCN_AXIS, ICI_AXIS, local_batch_slice,
)


def pad_problem(prob: ba_sparse.SparseBAProblem,
                multiple: int) -> ba_sparse.SparseBAProblem:
    """Pad the landmark axis to a mesh multiple; padding rows are fully
    masked (zero weight and prior, frame index 0) so results are
    unchanged."""
    extra = pad_to_multiple(prob.points0.shape[0], multiple) - \
        prob.points0.shape[0]
    if extra == 0:
        return prob
    return prob._replace(
        points0=pad_axis(prob.points0, extra),
        obs_frame=pad_axis(prob.obs_frame, extra),
        obs=pad_axis(prob.obs, extra),
        obs_mask=pad_axis(prob.obs_mask, extra, value=False),
        obs_weight=pad_axis(prob.obs_weight, extra),
        point_prior=pad_axis(prob.point_prior, extra),
        point_prior_info=pad_axis(prob.point_prior_info, extra),
    )


def _solve_sharded(prob, mesh, params, axes):
    group, count, index = shard_of(mesh, axes)
    n = prob.points0.shape[0]
    prob = pad_problem(prob, count)
    start, per = local_batch_slice(prob.points0.shape[0], count, index)
    s = slice(start, start + per)
    local = prob._replace(
        points0=prob.points0[s], obs_frame=prob.obs_frame[s], obs=prob.obs[s],
        obs_mask=prob.obs_mask[s], obs_weight=prob.obs_weight[s],
        point_prior=prob.point_prior[s],
        point_prior_info=prob.point_prior_info[s])
    res = ba_sparse.sparse_ba_solve(local, params, group=group)
    return res._replace(points=all_gather_rows(res.points, group, count)[:n])


def distributed_sparse_ba_solve(
    prob: ba_sparse.SparseBAProblem,
    mesh: DeviceMesh,
    params: ba_sparse.SparseBAParams = ba_sparse.SparseBAParams(),
    axis: str = DATA_AXIS,
) -> ba_sparse.SparseBAResult:
    """Solve with landmarks (time blocks, see the module docstring) sharded
    over the mesh axis ``axis``. Collective: every rank of the mesh calls
    it with the same problem, and every rank returns the whole result."""
    return _solve_sharded(prob, mesh, params, (axis,))


def distributed_sparse_ba_solve_hybrid(
    prob: ba_sparse.SparseBAProblem,
    mesh: DeviceMesh,
    params: ba_sparse.SparseBAParams = ba_sparse.SparseBAParams(),
) -> ba_sparse.SparseBAResult:
    """Sparse BA over a 2-D ``(dcn, ici)`` hybrid mesh
    (:func:`mvslam_tpu_torch.parallel.multihost.make_hybrid_mesh`).

    Landmarks stay time-ordered, so splitting their axis over the flattened
    ``(dcn, ici)`` grid gives each host one coarse time window and each
    card within it one fine block. The camera-system sums run over the
    group of both axes (the world). Collective, like
    :func:`distributed_sparse_ba_solve`."""
    return _solve_sharded(prob, mesh, params, (DCN_AXIS, ICI_AXIS))
