"""Host-side pose-graph API: ``Graph`` + ``GraphOptimizer`` (port of
``mvslam_tpu.backend.graph``).

A wrapper over the functional core in
``mvslam_tpu_torch.backend.pose_graph``:

- ``Graph(origin)``: origin node with a tight prior (sigma = 1e-4);
- ``add_pose_node(guess)`` -> node id;
- ``add_transformation_edge(src, dst, rel, covar)`` -> edge id
  (a between-factor);
- node/edge value getters and adjacency metadata;
- ``merge_from(other, anchor)`` imports another graph;
- ``GraphOptimizer(graph)`` works on a copy until ``update_graph()``
  writes values back.

Host mutation is plain Python (ids, dicts) over float64 numpy matrices;
``to_data`` builds the solver's tensors in the graph's dtype on its device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from mvslam_tpu_torch.backend import pose_graph as pg
from mvslam_tpu_torch.math.lie import SE3


def _matrix(pose: SE3) -> np.ndarray:
    return pose.matrix().detach().cpu().numpy().astype(np.float64)


class Graph:
    """Mutable pose graph; values leave it as tensors of ``dtype`` on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, origin: SE3 | None = None, dtype=torch.float64,
                 device="cuda") -> None:
        self._dtype = dtype
        self._device = torch.device(device)
        self._poses: List[np.ndarray] = []     # (4, 4) matrices, host side
        self._edges: List[Tuple[int, int]] = []
        self._edge_rel: List[np.ndarray] = []
        self._edge_info: List[np.ndarray] = []
        self._adjacency: Dict[int, List[int]] = {}
        self._origin_id = self._append_matrix(
            np.eye(4) if origin is None else _matrix(origin))
        self._anchors: List[int] = [self._origin_id]

    # -- mutation ------------------------------------------------------------
    def _append_matrix(self, M: np.ndarray) -> int:
        node_id = len(self._poses)
        self._poses.append(M)
        self._adjacency[node_id] = []
        return node_id

    def _append_edge(self, src: int, dst: int, rel: np.ndarray,
                     info: np.ndarray) -> int:
        edge_id = len(self._edges)
        self._edges.append((src, dst))
        self._edge_rel.append(rel)
        self._edge_info.append(info)
        self._adjacency[src].append(edge_id)
        self._adjacency[dst].append(edge_id)
        return edge_id

    def add_pose_node(self, guess: SE3) -> int:
        """Add a node with an initial-value guess."""
        return self._append_matrix(_matrix(guess))

    def add_transformation_edge(
        self, src: int, dst: int, rel: SE3, covar: np.ndarray | None = None
    ) -> int:
        """Add a between-factor edge; ``covar`` is the 6x6 measurement
        covariance (identity if omitted)."""
        if src >= len(self._poses) or dst >= len(self._poses):
            raise KeyError(f"unknown node in edge ({src}, {dst})")
        if covar is None:
            info = np.eye(6)
        else:
            info = np.linalg.inv(np.asarray(covar, dtype=np.float64))
        return self._append_edge(src, dst, _matrix(rel), info)

    def set_anchor(self, node_id: int) -> None:
        """Give ``node_id`` the same tight prior as the origin (fixes the
        gauge of additional disconnected components, e.g. tracking segments
        with no odometry edge between them)."""
        if node_id >= len(self._poses):
            raise KeyError(f"unknown node {node_id}")
        if node_id not in self._anchors:
            self._anchors.append(node_id)

    def merge_from(self, other: "Graph",
                   anchor: SE3 | None = None) -> Dict[int, int]:
        """Import another graph's nodes and edges. ``anchor`` re-expresses
        the other graph's poses in this graph's frame. Returns
        old-id -> new-id."""
        A = np.eye(4) if anchor is None else _matrix(anchor)
        remap = {old_id: self._append_matrix(A @ M)
                 for old_id, M in enumerate(other._poses)}
        for (s, d), rel, info in zip(other._edges, other._edge_rel,
                                     other._edge_info):
            self._append_edge(remap[s], remap[d], rel, info)
        return remap

    # -- access --------------------------------------------------------------
    @property
    def origin_id(self) -> int:
        return self._origin_id

    def node_count(self) -> int:
        return len(self._poses)

    def edge_count(self) -> int:
        return len(self._edges)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=self._dtype,
                            device=self._device)

    def get_pose_node_value(self, node_id: int) -> SE3:
        return SE3.from_matrix(self._tensor(self._poses[node_id]))

    def get_all_pose_node_values(self) -> SE3:
        return SE3.from_matrix(self._tensor(np.stack(self._poses)))

    def get_edge(self, edge_id: int) -> Tuple[int, int, SE3]:
        s, d = self._edges[edge_id]
        return s, d, SE3.from_matrix(self._tensor(self._edge_rel[edge_id]))

    def adjacent_edges(self, node_id: int) -> List[int]:
        return list(self._adjacency[node_id])

    # -- array export ---------------------------------------------------------
    def to_data(self) -> pg.PoseGraphData:
        """The solver's tensors: exactly the graph's nodes and edges, no
        padding (an edgeless graph gets one masked identity edge, so no
        tensor is empty)."""
        n = len(self._poses)
        e = len(self._edges)
        E = max(e, 1)
        poses = self.get_all_pose_node_values()
        src = np.zeros(E, np.int64)
        dst = np.zeros(E, np.int64)
        rel = np.tile(np.eye(4), (E, 1, 1))
        info = np.tile(np.eye(6), (E, 1, 1))
        if e:
            src[:e] = [s for s, _ in self._edges]
            dst[:e] = [d for _, d in self._edges]
            rel[:e] = np.stack(self._edge_rel)
            info[:e] = np.stack(self._edge_info)
        prior_info = np.zeros((n, 6, 6))
        for a in self._anchors:
            prior_info[a] = np.eye(6) / (pg.ORIGIN_STDDEV ** 2)
        dev = self._device
        return pg.PoseGraphData(
            poses=poses,
            node_mask=torch.ones(n, dtype=torch.bool, device=dev),
            edge_src=torch.tensor(src, device=dev),
            edge_dst=torch.tensor(dst, device=dev),
            edge_rel=SE3.from_matrix(self._tensor(rel)),
            edge_info=self._tensor(info),
            edge_mask=torch.arange(E, device=dev) < e,
            prior_pose=poses,
            prior_info=self._tensor(prior_info),
        )

    def _write_back(self, poses: SE3) -> None:
        M = _matrix(poses)
        for i in range(len(self._poses)):
            self._poses[i] = M[i]


class GraphOptimizer:
    """Optimizes a copy of the graph's values; ``update_graph`` writes
    them back."""

    def __init__(self, graph: Graph, params: pg.PoseGraphParams | None = None):
        self._graph = graph
        self._params = params or pg.PoseGraphParams()
        self._result: pg.PoseGraphResult | None = None

    def optimize(self) -> float:
        data = self._graph.to_data()
        self._result = pg.pose_graph_optimize(data, self._params)
        return float(self._result.error)

    @property
    def result(self) -> pg.PoseGraphResult | None:
        return self._result

    def _require_result(self) -> pg.PoseGraphResult:
        if self._result is None:
            raise RuntimeError("call optimize() first")
        return self._result

    def get_optimized_pose(self, node_id: int) -> SE3:
        res = self._require_result()
        return SE3(res.poses.R[node_id], res.poses.t[node_id])

    def update_graph(self) -> None:
        """Write optimized values back into the source graph."""
        res = self._require_result()
        n = self._graph.node_count()
        self._graph._write_back(SE3(res.poses.R[:n], res.poses.t[:n]))
