"""Distributed pose-graph optimization: edge-sharded LM over the mesh
(port of ``mvslam_tpu.parallel.dist_pose_graph``).

Edges (between-factor measurements) are split in contiguous blocks over
the ranks of a mesh axis; nodes and priors are on every rank. Every rank
scatter-adds its edges into the dense system, one sum over the axis's
process group assembles it, and every rank solves the same system, so all
stay in lockstep. Same code as one rank (``pose_graph_optimize`` /
``sim3_graph_optimize`` with a ``group``).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from mvslam_tpu_torch.backend import pose_graph as pg
from mvslam_tpu_torch.backend import sim3_graph as sg
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.parallel.mesh import (
    DATA_AXIS, pad_axis, pad_to_multiple, shard_of,
)
from mvslam_tpu_torch.parallel.multihost import local_batch_slice


def _pad_edge_fields(data, multiple: int, rel_identity):
    extra = pad_to_multiple(data.edge_src.shape[0], multiple) - \
        data.edge_src.shape[0]
    if extra == 0:
        return data
    ident = rel_identity((extra,), dtype=data.poses.t.dtype,
                         device=data.poses.t.device)
    rel = type(data.edge_rel)(*(torch.cat([a, b]) for a, b
                                in zip(data.edge_rel, ident)))
    return data._replace(
        edge_src=pad_axis(data.edge_src, extra),
        edge_dst=pad_axis(data.edge_dst, extra),
        edge_rel=rel,
        edge_info=pad_axis(data.edge_info, extra),
        edge_mask=pad_axis(data.edge_mask, extra, value=False),
    )


def pad_edges(data: pg.PoseGraphData, multiple: int) -> pg.PoseGraphData:
    """Pad the edge axis to a multiple of the mesh size (masked identity
    edges from node 0 to node 0)."""
    return _pad_edge_fields(data, multiple, SE3.identity)


def pad_sim3_edges(data: sg.Sim3GraphData,
                   multiple: int) -> sg.Sim3GraphData:
    """Pad a ``Sim3GraphData`` edge axis to a multiple of the mesh size."""
    return _pad_edge_fields(data, multiple, sg.Sim3.identity)


def _solve_edge_sharded(data, mesh: DeviceMesh, axis: str, pad, solve):
    """Pad the edges to the axis's size, take this rank's contiguous block
    and solve it with the axis's group."""
    group, count, index = shard_of(mesh, (axis,))
    data = pad(data, count)
    start, per = local_batch_slice(data.edge_src.shape[0], count, index)
    s = slice(start, start + per)
    local = data._replace(
        edge_src=data.edge_src[s], edge_dst=data.edge_dst[s],
        edge_rel=type(data.edge_rel)(*(x[s] for x in data.edge_rel)),
        edge_info=data.edge_info[s], edge_mask=data.edge_mask[s])
    return solve(local, group)


def distributed_pose_graph_optimize(
    data: pg.PoseGraphData,
    mesh: DeviceMesh,
    params: pg.PoseGraphParams = pg.PoseGraphParams(),
    axis: str = DATA_AXIS,
) -> pg.PoseGraphResult:
    """Edge-sharded SE3 pose-graph LM. Collective: every rank of the mesh
    calls it with the same graph; all return the same result."""
    return _solve_edge_sharded(
        data, mesh, axis, pad_edges,
        lambda local, group: pg.pose_graph_optimize(local, params, group))


def distributed_sim3_graph_optimize(
    data: sg.Sim3GraphData,
    mesh: DeviceMesh,
    params: sg.Sim3GraphParams | None = None,
    axis: str = DATA_AXIS,
) -> sg.Sim3GraphResult:
    """Edge-sharded Sim3 pose-graph LM (the scale-drift-aware loop-closure
    solve), as :func:`distributed_pose_graph_optimize`."""
    params = params or sg.Sim3GraphParams()
    return _solve_edge_sharded(
        data, mesh, axis, pad_sim3_edges,
        lambda local, group: sg.sim3_graph_optimize(local, params, group))
