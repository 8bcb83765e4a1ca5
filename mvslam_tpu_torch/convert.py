"""Numpy dicts to and from the port's data: the tracker state (its
"weights"), a step's outputs, the BA and pose-graph problems, and the
back-end's skeleton. The parity tests carry the same data through the JAX
package and the port with these; a run on the card and one on the CPU share
their inputs the same way.

``state_from_numpy`` takes a dict of numpy arrays keyed by
``VoJitState`` field names (for example ``vo_jit_state._asdict()`` of the
JAX tracker with ``key`` dropped and every leaf passed through
``np.asarray``) and builds the port's state on ``device``. Descriptor
words that arrive as uint32 are reinterpreted as int32 (same bits), never
converted by value. ``state_to_numpy`` goes back, with uint32 words.
"""

from __future__ import annotations

import numpy as np
import torch

from mvslam_tpu_torch.backend.pose_graph import PoseGraphData
from mvslam_tpu_torch.backend.sim3_graph import Sim3, Sim3GraphData
from mvslam_tpu_torch.backend.slam import (
    _STORES, BackendParams, Keyframe, PoseGraphBackend, _host_se3,
)
from mvslam_tpu_torch.frontend.vo_jit import VoJitState, VoStepOut
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops.ba_sparse import SparseBAProblem

_DESC_FIELDS = ("map_desc", "lf_desc", "rb_desc")
_INT_FIELDS = ("mode", "step", "map_seen", "lf_assoc", "rb_step", "rb_pos",
               "frame_total", "frame_tracked")
_BOOL_FIELDS = ("map_valid", "lf_mask", "rb_mask", "rb_valid")


def state_from_numpy(d: dict, device="cuda", dtype=torch.float32,
                     seed: int = 0) -> VoJitState:
    """Port state on ``device`` (the card unless the caller names another)
    from a dict of numpy arrays (``key``/``generator`` are ignored; the new
    state's generator is seeded with ``seed``)."""
    dev = torch.device(device)
    fields = {}
    for name in VoJitState._fields:
        if name == "generator":
            fields[name] = torch.Generator(device=dev).manual_seed(seed)
            continue
        a = np.asarray(d[name])
        if name in _DESC_FIELDS:
            a = np.ascontiguousarray(a).view(np.int32)
            t = torch.from_numpy(a.copy())
        elif name in _INT_FIELDS:
            t = torch.from_numpy(a.astype(np.int32))
        elif name in _BOOL_FIELDS:
            t = torch.from_numpy(a.astype(bool))
        else:
            t = torch.from_numpy(np.asarray(a, np.float64)).to(dtype)
        fields[name] = t.to(dev)
    return VoJitState(**fields)


def state_to_numpy(state: VoJitState) -> dict:
    """Dict of numpy arrays (descriptor words as uint32), generator
    omitted."""
    out = {}
    for name, v in state._asdict().items():
        if name == "generator":
            continue
        a = v.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in _DESC_FIELDS else a
    return out


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """Array -> tensor on ``device``: floats in ``dtype`` (their own when
    None), integers as int64 (they index), bools as bools."""
    t = torch.from_numpy(np.array(a))
    if t.dtype.is_floating_point:
        t = t if dtype is None else t.to(dtype)
    elif t.dtype != torch.bool:
        t = t.to(torch.int64)
    return t.to(device)


def step_out_to_numpy(out: VoStepOut) -> dict:
    return {k: _numpy(v) for k, v in out._asdict().items()}


def step_out_from_numpy(d: dict, device="cuda",
                        dtype=torch.float32) -> VoStepOut:
    """A step's outputs on ``device`` (``success`` stays on the host, as
    the step leaves it)."""
    fields = {}
    for name in VoStepOut._fields:
        a = np.asarray(d[name])
        if name == "success":
            fields[name] = torch.tensor(bool(a))
        elif name in ("mode", "num_inliers", "init_tried"):
            fields[name] = torch.tensor(a.astype(np.int32), device=device)
        else:
            fields[name] = torch.tensor(a.astype(np.float64),
                                        device=device).to(dtype)
    return VoStepOut(**fields)


#: the transform-valued fields of each problem type
_NESTED = {
    SparseBAProblem: {"poses0": SE3, "pose_prior": SE3},
    PoseGraphData: {"poses": SE3, "edge_rel": SE3, "prior_pose": SE3},
    Sim3GraphData: {"poses": Sim3, "edge_rel": Sim3, "prior_pose": Sim3},
}


def problem_to_numpy(prob) -> dict:
    """A problem tuple (this package's or the JAX package's
    ``SparseBAProblem`` / ``PoseGraphData`` / ``Sim3GraphData``) as a flat
    dict of numpy arrays, transforms under dotted keys (``poses0.R``)."""
    out = {}
    for name, v in prob._asdict().items():
        if hasattr(v, "_asdict"):
            out.update({f"{name}.{k}": _numpy(x)
                        for k, x in v._asdict().items()})
        else:
            out[name] = _numpy(v)
    return out


def _problem_from_numpy(cls, d: dict, device, dtype):
    fields = {}
    for name in cls._fields:
        sub = _NESTED[cls].get(name)
        if sub is None:
            fields[name] = _tensor(d[name], device, dtype)
        else:
            fields[name] = sub(*(_tensor(d[f"{name}.{k}"], device, dtype)
                                 for k in sub._fields))
    return cls(**fields)


def sparse_ba_problem_from_numpy(d: dict, device="cuda",
                                 dtype=None) -> SparseBAProblem:
    return _problem_from_numpy(SparseBAProblem, d, device, dtype)


def pose_graph_data_from_numpy(d: dict, device="cuda",
                               dtype=None) -> PoseGraphData:
    return _problem_from_numpy(PoseGraphData, d, device, dtype)


def sim3_graph_data_from_numpy(d: dict, device="cuda",
                               dtype=None) -> Sim3GraphData:
    return _problem_from_numpy(Sim3GraphData, d, device, dtype)


def backend_to_numpy(backend) -> dict:
    """The back-end's skeleton (keyframes, the live rows of its stores,
    loop edges, raw poses, cadence) as a dict of numpy arrays. Also reads
    the JAX package's ``PoseGraphBackend``; that one records no segment per
    raw pose, so its raw poses are all taken as segment 0 (right for a run
    without a reset)."""
    kfs = backend.keyframes
    n = len(kfs)
    d = {
        "kf_frame_idx": np.array([k.frame_idx for k in kfs], np.int64),
        "kf_R": np.array([_numpy(k.pose.R) for k in kfs],
                         np.float64).reshape(n, 3, 3),
        "kf_t": np.array([_numpy(k.pose.t) for k in kfs],
                         np.float64).reshape(n, 3),
        "kf_num_inliers": np.array([k.num_inliers for k in kfs], np.int64),
        "kf_mean_error": np.array([k.mean_error for k in kfs], np.float64),
        "kf_segment": np.array([k.segment for k in kfs], np.int64),
        "tracked_since_kf": np.int64(backend._tracked_since_kf),
        "segment": np.int64(backend._segment),
    }
    le = backend.loop_edges
    d["loop_j"] = np.array([e[0] for e in le], np.int64)
    d["loop_i"] = np.array([e[1] for e in le], np.int64)
    d["loop_R"] = np.array([_numpy(e[2].R) for e in le],
                           np.float64).reshape(len(le), 3, 3)
    d["loop_t"] = np.array([_numpy(e[2].t) for e in le],
                           np.float64).reshape(len(le), 3)
    d["loop_inliers"] = np.array([e[3] for e in le], np.int64)
    d["loop_s_rel"] = np.array([e[4] for e in le], np.float64)
    for name in _STORES:
        store = getattr(backend, name)
        if store is not None:
            a = _numpy(store[:n])
            d[name] = a.view(np.uint32) if name == "_desc" else a
    raw = backend._raw_poses
    d["raw_frame_idx"] = np.array([r[0] for r in raw], np.int64)
    d["raw_segment"] = np.array([r[1] if len(r) == 4 else 0 for r in raw],
                                np.int64)
    d["raw_R"] = np.array([_numpy(r[-2]) for r in raw],
                          np.float32).reshape(len(raw), 3, 3)
    d["raw_t"] = np.array([_numpy(r[-1]) for r in raw],
                          np.float32).reshape(len(raw), 3)
    return d


def backend_from_numpy(d: dict, params: BackendParams = BackendParams(),
                       focal: float = 350.0, seed: int = 0,
                       device="cuda") -> PoseGraphBackend:
    """A ``PoseGraphBackend`` on ``device`` holding the skeleton of ``d``
    (a ``backend_to_numpy`` dict)."""
    b = PoseGraphBackend(params, focal=focal, seed=seed, device=device)
    n = len(d["kf_frame_idx"])
    if n > params.max_keyframes:
        raise ValueError(f"{n} keyframes exceed max_keyframes "
                         f"{params.max_keyframes}")
    b.keyframes = [
        Keyframe(int(d["kf_frame_idx"][k]),
                 _host_se3(d["kf_R"][k], d["kf_t"][k]),
                 int(d["kf_num_inliers"][k]), float(d["kf_mean_error"][k]),
                 int(d["kf_segment"][k]))
        for k in range(n)]
    b.loop_edges = [
        (int(d["loop_j"][k]), int(d["loop_i"][k]),
         _host_se3(d["loop_R"][k], d["loop_t"][k]),
         int(d["loop_inliers"][k]), float(d["loop_s_rel"][k]))
        for k in range(len(d["loop_j"]))]
    b._tracked_since_kf = int(d["tracked_since_kf"])
    b._segment = int(d["segment"])
    for name in _STORES:
        if name not in d:
            continue
        a = np.ascontiguousarray(d[name])
        if name == "_desc":
            a = a.view(np.int32)
        elif name == "_assoc":
            a = a.astype(np.int32)
        store = torch.zeros((params.max_keyframes,) + a.shape[1:],
                            dtype=torch.from_numpy(a[:0]).dtype,
                            device=b.device)
        store[:n] = torch.from_numpy(a.copy())
        setattr(b, name, store)
    if b._desc is not None:
        b._kf_segment = torch.zeros(params.max_keyframes, dtype=torch.int32,
                                    device=b.device)
        b._kf_segment[:n] = torch.from_numpy(
            np.asarray(d["kf_segment"], np.int32))
    b._raw_poses = [
        (int(i), int(s), torch.tensor(R, device=b.device),
         torch.tensor(t, device=b.device))
        for i, s, R, t in zip(d["raw_frame_idx"], d["raw_segment"],
                              d["raw_R"], d["raw_t"])]
    return b
