"""Numpy dicts to and from the port's data: the tracker state (its
"weights"), a step's outputs, the BA and pose-graph problems, the
back-end's skeleton, the host-orchestrated front end's feature sets,
frames and whole odometer, and calibration results. The parity tests carry the same data through the JAX
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
from mvslam_tpu_torch.frontend.data_types import Frame
from mvslam_tpu_torch.frontend.visual_odometer import VisualOdometer, VoState
from mvslam_tpu_torch.frontend.vo_jit import VoJitState, VoStepOut
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops.ba import BAProblem
from mvslam_tpu_torch.ops.ba_sparse import SparseBAProblem
from mvslam_tpu_torch.ops.calibration import CalibrationResult
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.ops.features import FeatureSet

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
    BAProblem: {"poses0": SE3, "pose_prior": SE3},
    SparseBAProblem: {"poses0": SE3, "pose_prior": SE3},
    PoseGraphData: {"poses": SE3, "edge_rel": SE3, "prior_pose": SE3},
    Sim3GraphData: {"poses": Sim3, "edge_rel": Sim3, "prior_pose": Sim3},
}


def problem_to_numpy(prob) -> dict:
    """A problem tuple (this package's or the JAX package's ``BAProblem`` /
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


def ba_problem_from_numpy(d: dict, device="cuda", dtype=None) -> BAProblem:
    return _problem_from_numpy(BAProblem, d, device, dtype)


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


# ---------------------------------------------------------------------------
# The host-orchestrated front end. Every ``*_to_numpy`` here also reads the
# JAX package's object of the same name (same attributes, numpy or JAX
# arrays); descriptor words leave as uint32 and arrive as int32, the same
# bits.
# ---------------------------------------------------------------------------

def _words_u32(v) -> np.ndarray:
    return np.ascontiguousarray(_numpy(v)).view(np.uint32)


def _words_i32(a, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(a).view(np.int32).copy()).to(device)


def feature_set_to_numpy(feats) -> dict:
    d = {k: _numpy(v) for k, v in feats._asdict().items()}
    d["desc"] = _words_u32(feats.desc)
    return d


def feature_set_from_numpy(d: dict, device="cuda",
                           dtype=torch.float32) -> FeatureSet:
    def flt(name):
        return torch.from_numpy(np.asarray(d[name], np.float64)).to(
            device, dtype)

    return FeatureSet(
        xy=flt("xy"), response=flt("response"), angle=flt("angle"),
        octave=torch.from_numpy(np.asarray(d["octave"], np.int32)).to(device),
        sigma=flt("sigma"), desc=_words_i32(d["desc"], device),
        mask=torch.from_numpy(np.asarray(d["mask"], bool)).to(device))


def frame_to_numpy(frame) -> dict:
    """A ``Frame`` as a dict: scalars, the feature set under ``feat_*``,
    rays and sigma, and camera and images where the frame has them."""
    d = {"id": frame.id, "capture_time": frame.capture_time,
         "focal": frame.focal, "rays": _numpy(frame.rays),
         "sigma": _numpy(frame.sigma)}
    d.update({f"feat_{k}": v
              for k, v in feature_set_to_numpy(frame.features).items()})
    if frame.camera is not None:
        d.update(camera_K=_numpy(frame.camera.K),
                 camera_R=_numpy(frame.camera.P.R),
                 camera_t=_numpy(frame.camera.P.t))
    for name in ("image", "image_smooth"):
        if getattr(frame, name) is not None:
            d[name] = _numpy(getattr(frame, name))
    return d


def frame_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> Frame:
    def flt(name):
        return None if name not in d else torch.from_numpy(
            np.asarray(d[name], np.float64)).to(device, dtype)

    camera = None
    if "camera_K" in d:
        camera = PinholeCamera(flt("camera_K"),
                               SE3(flt("camera_R"), flt("camera_t")))
    feats = feature_set_from_numpy(
        {k[len("feat_"):]: v for k, v in d.items() if k.startswith("feat_")},
        device, dtype)
    return Frame(id=int(d["id"]), capture_time=float(d["capture_time"]),
                 features=feats, rays=flt("rays"), sigma=flt("sigma"),
                 focal=float(d["focal"]), camera=camera, image=flt("image"),
                 image_smooth=flt("image_smooth"))


def _se3_f64(pose) -> tuple[np.ndarray, np.ndarray]:
    return (np.asarray(_numpy(pose.R), np.float64),
            np.asarray(_numpy(pose.t), np.float64))


def odometer_to_numpy(vo, window: bool = True) -> dict:
    """The whole state of a ``VisualOdometer``: counters and state name,
    the map, the trajectory, and when TRACKING the last frame with what is
    carried beside it (pose, association, refined observations,
    templates), under the checkpoint's names and dtypes; with ``window``
    the frames queued for the bootstrap (``"window"``: a list of
    ``frame_to_numpy`` dicts) as well."""
    m = vo._map
    traj = vo.trajectory
    poses = [_se3_f64(t[2]) for t in traj]
    d = {
        "state": vo.state.name, "step": vo._step,
        "frame_total": vo.frame_total, "frame_tracked": vo.frame_tracked,
        "map_positions": _numpy(m.positions), "map_desc": _words_u32(m.desc),
        "map_templates": _numpy(m.templates), "map_valid": _numpy(m.valid),
        "map_last_seen": _numpy(m.last_seen),
        "traj_ids": np.asarray([t[0] for t in traj], np.int64),
        "traj_times": np.asarray([t[1] for t in traj], np.float64),
        "traj_R": np.asarray([R for R, _ in poses],
                             np.float64).reshape(len(traj), 3, 3),
        "traj_t": np.asarray([t for _, t in poses],
                             np.float64).reshape(len(traj), 3),
    }
    if vo.state.name == "TRACKING":
        f = vo._last_frame
        R, t = _se3_f64(vo._last_pose)
        d.update(
            last_frame={"id": f.id, "capture_time": f.capture_time,
                        "focal": f.focal},
            last_pose_R=R, last_pose_t=t,
            last_assoc=_numpy(vo._last_assoc),
            last_obs_rays=_numpy(vo._last_obs_rays),
            last_obs_sigma=_numpy(vo._last_obs_sigma),
            last_templates=_numpy(vo._last_templates),
            frame_rays=_numpy(f.rays), frame_sigma=_numpy(f.sigma))
        d.update({f"feat_{k}": v
                  for k, v in feature_set_to_numpy(f.features).items()})
    if window:
        d["window"] = [frame_to_numpy(f) for f in vo._frames]
    return d


def odometer_from_numpy(d: dict, vo: VisualOdometer) -> VisualOdometer:
    """Put an ``odometer_to_numpy`` dict (of either package's odometer)
    into ``vo``, on ``vo``'s device; returns ``vo``. The restored last
    frame carries no image: the next frame's KLT runs against the map's
    and the last frame's templates, as live tracking does. A map of
    another capacity than ``vo``'s raises ``ValueError``."""
    dev = vo.device
    m = vo._map
    if tuple(np.shape(d["map_positions"])) != tuple(m.positions.shape):
        raise ValueError("checkpoint map capacity differs from params")
    vo.reset()
    vo._step = int(d["step"])
    vo.frame_total = int(d["frame_total"])
    vo.frame_tracked = int(d["frame_tracked"])
    m.positions.copy_(torch.from_numpy(np.asarray(d["map_positions"],
                                                  np.float32)))
    m.desc.copy_(_words_i32(d["map_desc"], dev))
    m.templates.copy_(torch.from_numpy(np.asarray(d["map_templates"],
                                                  np.float32)))
    m.valid.copy_(torch.from_numpy(np.asarray(d["map_valid"], bool)))
    m.last_seen.copy_(torch.from_numpy(np.asarray(d["map_last_seen"],
                                                  np.int64)))

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def f64(a):
        return torch.from_numpy(np.array(a, np.float64)).to(dev)

    vo.trajectory = [
        (int(i), float(t), SE3(f32(R), f32(tt)))
        for i, t, R, tt in zip(d["traj_ids"], d["traj_times"], d["traj_R"],
                               d["traj_t"])]
    if d["state"] == "TRACKING":
        feats = feature_set_from_numpy(
            {k[len("feat_"):]: v for k, v in d.items()
             if k.startswith("feat_")}, dev)
        fmeta = d["last_frame"]
        vo._last_frame = Frame(
            id=fmeta["id"], capture_time=fmeta["capture_time"],
            features=feats, rays=f32(d["frame_rays"]),
            sigma=f32(d["frame_sigma"]), focal=fmeta["focal"])
        vo._last_pose = SE3(f32(d["last_pose_R"]), f32(d["last_pose_t"]))
        vo._last_assoc = torch.from_numpy(
            np.array(d["last_assoc"], np.int64)).to(dev)
        vo._last_obs_rays = f64(d["last_obs_rays"])
        vo._last_obs_sigma = f64(d["last_obs_sigma"])
        vo._last_templates = f32(d["last_templates"])
        vo.state = VoState.TRACKING
    vo._frames = [frame_from_numpy(f, dev) for f in d.get("window", [])]
    return vo


def calibration_result_to_numpy(res) -> dict:
    """A ``CalibrationResult`` of either package -> numpy arrays: ``K``,
    ``extrinsics_R``, ``extrinsics_t``, ``rms_error``, ``per_view_error``
    and, when distortion was estimated, ``dist``."""
    d = {"K": _numpy(res.K), "extrinsics_R": _numpy(res.extrinsics.R),
         "extrinsics_t": _numpy(res.extrinsics.t),
         "rms_error": _numpy(res.rms_error),
         "per_view_error": _numpy(res.per_view_error)}
    if res.dist is not None:
        d["dist"] = _numpy(res.dist)
    return d


def calibration_result_from_numpy(d: dict, device="cuda",
                                  dtype=None) -> CalibrationResult:
    """The port's ``CalibrationResult`` on ``device`` from the dict of
    :func:`calibration_result_to_numpy` (floats keep their dtype when
    ``dtype`` is None)."""
    t = {k: _tensor(v, device, dtype) for k, v in d.items()}
    return CalibrationResult(
        K=t["K"], extrinsics=SE3(t["extrinsics_R"], t["extrinsics_t"]),
        rms_error=t["rms_error"], per_view_error=t["per_view_error"],
        dist=t.get("dist"))
