"""Fused visual odometry: ``step(state, image) -> (state, out)`` (port of
``mvslam_tpu.frontend.vo_jit``).

The whole per-frame pipeline — ORB pyramid, descriptor matching, KLT
refinement, RANSAC, triangulation, two-frame bundle adjustment, map update,
mode switching — over a fixed-shape tensor state. Three modes:

- 0 EMPTY: record the frame, wait for a second one;
- 1 INITIALIZING: two-view bootstrap against a ring of the last
  ``init_window`` frames, accepting the oldest (longest-baseline) slot that
  passes the quality gates, falling back to younger slots;
- 2 TRACKING: map association -> KLT -> PnP-RANSAC -> triangulate new
  points -> anchored two-frame BA -> gated commit, or reset to mode 1.

Control flow is on the host: one read of ``mode`` per frame selects the
branch (the JAX ``lax.switch``), the bootstrap reads its ranking of the
ring slots once and its fallback walk one gate per slot tried, and
accept/reject and commit/reset read one gate each. Everything else stays on the device.

The step runs as chains of stages over a namespace, each run by one
``_StageRunner``: the feature half after the corner kernel (the
per-keypoint ORB, then the KLT templates), the TRACKING branch's four
geometry stages (association, P3P-RANSAC on the frame's draw,
triangulation, BA), the bootstrap's candidates of every ring slot on the
frame's draw (with the IRLS refits' ``eigh`` calls as eager stages
between the others, since they read on the host) and its refine of one
ranked slot. Their shapes are fixed by the params and the image: on a
CUDA device a runner captures its chain as CUDA graphs once per step
function for each input shape and then replays it, one launch a stage,
with the frame's tensors copied into the graphs' input buffers first; on
the CPU the stages run op by op. The reads above sit between the chains;
the bootstrap's seed runs op by op.

Randomness: the state carries a ``torch.Generator`` (the JAX state's PRNG
key); the step advances it in place. ``step(..., draws=...)`` supplies the
RANSAC uniforms instead — ``(init_window, ransac_hypotheses, K)`` when
INITIALIZING, ``(pnp_hypotheses, K)`` when TRACKING — which lets a test
feed the JAX tracker's own draws.

Capacities: K features/frame, M map points, BA over (BA_OLD + BA_NEW)
points per step — all fixed.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from types import SimpleNamespace
from typing import NamedTuple

import torch

from mvslam_tpu_torch.math import linalg
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.ops import ba_cuda
from mvslam_tpu_torch.ops import (epipolar, klt, matching, pnp, ransac,
                                  sfm)
from mvslam_tpu_torch.ops.features import (OrbParams, corner_ranks,
                                           orb_detect, orb_keypoints,
                                           pyramid)
from mvslam_tpu_torch.utils.indexing import allocate_slots as _allocate_slots
from mvslam_tpu_torch.utils.indexing import masked_take as _masked_take
from mvslam_tpu_torch.utils.indexing import set_rows as _set_rows
from mvslam_tpu_torch.utils.timing import span

Tensor = torch.Tensor

MODE_EMPTY = 0
MODE_INITIALIZING = 1
MODE_TRACKING = 2

#: the step's spans (``utils.timing.span``: in a profiler's trace only), in
#: the order a frame opens them: the feature half, its span around its two
#: parts where they replay as CUDA graphs (on a CUDA device only), and its
#: two parts; the state half, which reads the mode and runs one branch;
#: TRACKING's span around its four geometry stages where they replay as
#: CUDA graphs (on a CUDA device only), and its six stages, with a mark
#: inside the BA's span where its stage holds the BA kernel
#: (``ops/ba_cuda``: launched in the call op by op, or while the stage was
#: captured where it replays); INITIALIZING's span around its slots and
#: refine walk where they replay as CUDA graphs (on a CUDA device only),
#: and its three parts; the first frame's
SPANS = (
    "vo_jit.pre", "vo_jit.pre.graphed", "vo_jit.pre.orb",
    "vo_jit.pre.templates",
    "vo_jit.combine",
    "vo_jit.track", "vo_jit.track.graphed", "vo_jit.track.associate",
    "vo_jit.track.pnp",
    "vo_jit.track.triangulate", "vo_jit.track.ba", "vo_jit.track.ba.fused",
    "vo_jit.track.gate",
    "vo_jit.track.commit",
    "vo_jit.init", "vo_jit.init.graphed", "vo_jit.init.slots",
    "vo_jit.init.refine", "vo_jit.init.seed",
    "vo_jit.empty",
)


class VoJitParams(NamedTuple):
    """Static configuration (the JAX package's defaults and their reasons
    are documented in ``mvslam_tpu.frontend.vo_jit.VoJitParams``)."""

    orb: OrbParams = OrbParams()
    map_capacity: int = 1024
    ba_old: int = 384            # map points per BA
    ba_new: int = 128            # fresh triangulations per BA
    init_window: int = 4         # bootstrap ring of previous frames
    max_match_distance: int = 64
    ransac_hypotheses: int = 256
    max_error_sq: float = sfm.MAX_ERROR_SQ       # pixel-ish; / focal^2
    klt_sigma_px: float = 0.25
    min_pair_inliers: int = 20
    max_pair_mean_error: float = 9.0   # seeds VoJitState.gate_pair_err
    max_pair_rotation: float = 0.1
    max_pair_z_translation: float = 0.1
    min_track_inliers: int = 7
    pnp_reproj_px: float = 0.75
    max_track_mean_error: float = 9.0
    map_point_stddev: float = 0.05
    ba_iterations: int = 10
    pnp_hypotheses: int = 128
    use_klt: bool = True
    template_sigma_px: float = 0.02
    huber_delta: float | None = None
    tri_consistency_px: float = 16.0


class VoJitState(NamedTuple):
    """The whole tracker as fixed-shape tensors on one device."""

    mode: Tensor                # () int32
    step: Tensor                # () int32
    generator: torch.Generator  # RANSAC draws (the JAX state's PRNG key)
    pose_R: Tensor              # (3, 3) last camera-to-world
    pose_t: Tensor              # (3,)
    # map
    map_pos: Tensor             # (M, 3)
    map_desc: Tensor            # (M, 8) int32 descriptor words
    map_tmpl: Tensor            # (M, W, W)
    map_valid: Tensor           # (M,) bool
    map_seen: Tensor            # (M,) int32
    map_info: Tensor            # (M, 3, 3) landmark information
    # last frame
    lf_xy: Tensor               # (K, 2)
    lf_desc: Tensor             # (K, 8) int32
    lf_mask: Tensor             # (K,) bool
    lf_rays: Tensor             # (K, 3)
    lf_sigma: Tensor            # (K,)
    lf_tmpl: Tensor             # (K, W, W)
    lf_obs_rays: Tensor         # (K, 3) refined observations
    lf_obs_sigma: Tensor        # (K,)
    lf_assoc: Tensor            # (K,) int32 feature -> map slot (-1 none)
    # bootstrap ring: B previous frames
    rb_xy: Tensor               # (B, K, 2)
    rb_desc: Tensor             # (B, K, 8) int32
    rb_mask: Tensor             # (B, K) bool
    rb_rays: Tensor             # (B, K, 3)
    rb_sigma: Tensor            # (B, K)
    rb_tmpl: Tensor             # (B, K, W, W)
    rb_valid: Tensor            # (B,) bool
    rb_step: Tensor             # (B,) int32 — step when stored
    rb_pos: Tensor              # () int32 — next write slot (cyclic)
    # stats
    frame_total: Tensor         # () int32
    frame_tracked: Tensor       # () int32
    gate_pair_err: Tensor       # () refined-pair mean-error gate


class VoStepOut(NamedTuple):
    # every branch of the step decides ``success`` on the host (the accept
    # gates are read there), so it is a CPU tensor: reading it costs a
    # caller no synchronisation
    success: Tensor             # () bool, on the CPU
    mode: Tensor                # () int32 (after the step)
    pose_R: Tensor
    pose_t: Tensor
    num_inliers: Tensor         # () int32
    mean_error: Tensor          # ()
    pnp_t: Tensor               # (3,) pre-BA PnP translation
    init_tried: Tensor          # () int32 ring slots refined by do_init


def vo_init_state(params: VoJitParams = VoJitParams(), device="cuda",
                  dtype=torch.float32, seed: int = 0) -> VoJitState:
    """Empty tracker state on ``device`` (the card unless the caller names
    another, e.g. ``"cpu"``); ``seed`` seeds its generator."""
    K = params.orb.max_features
    M = params.map_capacity
    W = klt.WINDOW
    B = params.init_window
    dev = torch.device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    i32 = torch.int32
    return VoJitState(
        mode=full((), MODE_EMPTY, i32),
        step=full((), 0, i32),
        generator=torch.Generator(device=dev).manual_seed(seed),
        pose_R=torch.eye(3, dtype=dtype, device=dev),
        pose_t=z(3),
        map_pos=z(M, 3), map_desc=z(M, 8, dt=i32), map_tmpl=z(M, W, W),
        map_valid=z(M, dt=torch.bool), map_seen=full((M,), -1, i32),
        map_info=z(M, 3, 3),
        lf_xy=z(K, 2), lf_desc=z(K, 8, dt=i32), lf_mask=z(K, dt=torch.bool),
        lf_rays=z(K, 3), lf_sigma=full((K,), 1.0, dtype), lf_tmpl=z(K, W, W),
        lf_obs_rays=z(K, 3), lf_obs_sigma=full((K,), 1.0, dtype),
        lf_assoc=full((K,), -1, i32),
        rb_xy=z(B, K, 2), rb_desc=z(B, K, 8, dt=i32),
        rb_mask=z(B, K, dt=torch.bool), rb_rays=z(B, K, 3),
        rb_sigma=full((B, K), 1.0, dtype), rb_tmpl=z(B, K, W, W),
        rb_valid=z(B, dt=torch.bool), rb_step=full((B,), -1, i32),
        rb_pos=full((), 0, i32),
        frame_total=full((), 0, i32), frame_tracked=full((), 0, i32),
        gate_pair_err=full((), params.max_pair_mean_error, dtype),
    )


class _FrameArrays(NamedTuple):
    xy: Tensor
    desc: Tensor
    mask: Tensor
    rays: Tensor
    sigma: Tensor
    tmpl: Tensor


def _store_frame(state: VoJitState, f: _FrameArrays, obs_rays=None,
                 obs_sigma=None, assoc=None) -> VoJitState:
    K = f.xy.shape[0]
    return state._replace(
        lf_xy=f.xy, lf_desc=f.desc, lf_mask=f.mask, lf_rays=f.rays,
        lf_sigma=f.sigma, lf_tmpl=f.tmpl,
        lf_obs_rays=f.rays if obs_rays is None else obs_rays,
        lf_obs_sigma=f.sigma if obs_sigma is None else obs_sigma,
        lf_assoc=(torch.full((K,), -1, dtype=torch.int32, device=f.xy.device)
                  if assoc is None else assoc),
    )


def _ring_push(state: VoJitState, f: _FrameArrays) -> VoJitState:
    """Store a frame in the bootstrap ring (cyclic, overwrites oldest);
    the write slot stays on the device."""
    i = state.rb_pos.view(1).to(torch.int64)

    def put(arr, val):
        return arr.index_copy(0, i, val[None].to(arr.dtype))

    return state._replace(
        rb_xy=put(state.rb_xy, f.xy),
        rb_desc=put(state.rb_desc, f.desc),
        rb_mask=put(state.rb_mask, f.mask),
        rb_rays=put(state.rb_rays, f.rays),
        rb_sigma=put(state.rb_sigma, f.sigma),
        rb_tmpl=put(state.rb_tmpl, f.tmpl),
        rb_valid=put(state.rb_valid, torch.ones_like(state.rb_valid[0])),
        rb_step=put(state.rb_step, state.step),
        rb_pos=(state.rb_pos + 1) % state.rb_valid.shape[0],
    )


def _ring_clear(state: VoJitState) -> VoJitState:
    return state._replace(
        rb_valid=torch.zeros_like(state.rb_valid),
        rb_step=torch.full_like(state.rb_step, -1),
        rb_pos=torch.zeros_like(state.rb_pos),
    )


def _to_rays(xy: Tensor, K_inv: Tensor) -> Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1) @ K_inv.T


def _tensors(t) -> tuple | None:
    """The tensors of a graph's input ``t``: a tensor, or a list or tuple
    of tensors; ``None`` for any other value."""
    if isinstance(t, Tensor):
        return (t,)
    if isinstance(t, (list, tuple)) and all(isinstance(x, Tensor)
                                            for x in t):
        return tuple(t)
    return None


def _graph_key(inputs: dict) -> tuple:
    """What graphs are captured for: the devices, dtypes and shapes of the
    inputs' tensors, and any other input's value."""
    def sig(t):
        ts = _tensors(t)
        if ts is None:
            return t
        return tuple((x.device, x.dtype, tuple(x.shape)) for x in ts)

    return tuple((k, sig(t)) for k, t in inputs.items())


def _buffers(values: dict) -> dict:
    """``values`` with its tensors, and lists or tuples of them (kept as
    tuples), cloned; other values as they are."""
    out = dict(values)
    for k, t in values.items():
        ts = _tensors(t)
        if ts is not None:
            out[k] = (ts[0].clone() if isinstance(t, Tensor)
                      else tuple(x.clone() for x in ts))
    return out


def _fill(v: SimpleNamespace, values: dict) -> None:
    """Copy the tensors of ``values`` into the buffers of ``v`` that have
    their names."""
    for k, t in values.items():
        ts = _tensors(t)
        if ts is not None:
            for dst, src in zip(_tensors(getattr(v, k)), ts):
                dst.copy_(src)


def _eager(fn):
    """Mark ``fn`` an eager stage of a ``_StageRunner``: one that runs op by
    op on every run, between the replays of the others, and returns only
    tensors (or lists or tuples of them)."""
    fn.eager = True
    return fn


class _StageRunner:
    """A chain of stages, run one at a time: ``start(inputs)``, then
    ``advance()`` once a stage. A stage is ``fn(v) -> {name: tensors}``
    over the namespace ``v`` of the chain's inputs and what every earlier
    stage added (a stage rebinds no name).

    Where the inputs are on a CUDA device and ``cuda_graphs`` is set, the
    stages replay as CUDA graphs, one a stage in one memory pool, captured
    on the first run for each ``_graph_key`` and kept in ``captures`` with
    their own ``v``: its inputs are buffers that the first advance fills,
    its outputs stay where the capture put them and the next run
    overwrites them, so a caller keeps them through ``own``. A stage marked
    ``_eager`` is not captured: it runs op by op on every run (for what a
    graph cannot hold, such as a call that reads on the host), and copies
    its outputs into buffers that the capture made, from which the next
    graph reads. Elsewhere the stages run op by op on a fresh ``v``."""

    def __init__(self, stages, cuda_graphs: bool):
        self.stages = tuple(stages)
        self.cuda_graphs = cuda_graphs
        #: ``_graph_key`` of the inputs -> ``SimpleNamespace(v, graphs)``,
        #: ``graphs[i]`` None for an eager stage
        self.captures: dict = {}

    def replays(self, device: torch.device) -> bool:
        """Whether a run on inputs on ``device`` replays CUDA graphs."""
        return self.cuda_graphs and device.type == "cuda"

    def prepare(self, inputs: dict):
        """The capture for inputs like ``inputs``, made now if a run on them
        replays and none is made yet; None where a run does not replay. Runs
        nothing else."""
        dev = next(ts[0].device for ts in map(_tensors, inputs.values())
                   if ts)
        if not self.replays(dev):
            return None
        key = _graph_key(inputs)
        cap = self.captures.get(key)
        if cap is None:
            with torch.cuda.device(dev):
                cap = self.captures[key] = self._capture(inputs)
        return cap

    def start(self, inputs: dict) -> "_StageRunner":
        self._next = 0
        cap = self.prepare(inputs)
        if cap is None:
            self.v, self._graphs = SimpleNamespace(**inputs), None
            return self
        # the first advance loads ``inputs``; nothing keeps them after that
        self.v, self._graphs, self._load = cap.v, cap.graphs, inputs
        return self

    def advance(self) -> None:
        i, self._next = self._next, self._next + 1
        fn = self.stages[i]
        if self._graphs is None:
            vars(self.v).update(fn(self.v))
            return
        if i == 0:
            _fill(self.v, self._load)
            self._load = None
        if self._graphs[i] is None:
            _fill(self.v, fn(self.v))
        else:
            self._graphs[i].replay()

    def own(self, t: Tensor) -> Tensor:
        """``t`` as the caller's own: a graph's output is copied."""
        return t if self._graphs is None else t.clone()

    def _capture(self, inputs: dict) -> SimpleNamespace:
        # tensors, and lists or tuples of them, become the buffers; other
        # values are constants of the graphs
        named = _buffers(inputs)
        eager = {}
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            # one eager pass first: handles and workspaces that are made on
            # first use are made outside the capture; copies of the eager
            # stages' outputs become their buffers
            warm = SimpleNamespace(**named)
            for i, fn in enumerate(self.stages):
                out = fn(warm)
                if getattr(fn, "eager", False):
                    eager[i] = _buffers(out)
                vars(warm).update(out)
            del warm
        v = SimpleNamespace(**named)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        for i, fn in enumerate(self.stages):
            graph = None
            if i in eager:
                out = eager[i]
            else:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    out = fn(v)
            vars(v).update(out)
            graphs.append(graph)
        # the eager stages' buffers are filled on the caller's stream
        torch.cuda.current_stream().wait_stream(stream)
        return SimpleNamespace(v=v, graphs=graphs)


def _make_vo_step_fns(params: VoJitParams = VoJitParams(),
                      cuda_graphs: bool = True):
    """Build (step, preprocess, combine) for ``(state, image, K_inv,
    focal)``; ``focal`` may be a float or a 0-dim tensor. Without
    ``cuda_graphs`` every chain of stages runs op by op on a CUDA device
    too. ``step.pre_graphs`` (the same dict as
    ``preprocess.pre_graphs``) and ``step.track_graphs`` (as
    ``combine.track_graphs``) hold the captured graphs by what they were
    captured for, and ``step.init_graphs`` (as ``combine.init_graphs``)
    the bootstrap's: ``{"slots": ..., "refine": ...}``, one such dict a
    chain."""
    p = params
    K_feat = p.orb.max_features
    M = p.map_capacity
    ba_params = ba_mod.BAParams(max_iterations=p.ba_iterations,
                                compute_covariance=False,
                                compute_point_info=True,
                                huber_delta=p.huber_delta)

    # ---- the feature half --------------------------------------------------
    # Two stages over ``v`` (the pyramid's ``levels``, the corner kernel's
    # ``ranks``, ``K_inv``, ``focal``), neither of which reads a value on
    # the host. Where they replay as CUDA graphs the pyramid and the
    # kernel's one call (``orb_detect``'s first two steps) run eagerly
    # ahead of them, so that the kernel's output is a fresh tensor each
    # frame; op by op the first stage is ``orb_detect`` whole, so that a
    # wrapper put on it sees every detection of the step.
    def keypoints(v):
        if v.ranks is None:
            return dict(feats=orb_detect(v.levels[0], p.orb))
        return dict(feats=orb_keypoints(v.levels, v.ranks, p.orb))

    def templates(v):
        f = v.feats
        rays = _to_rays(f.xy, v.K_inv)
        smooth = klt.smooth_image(v.levels[0])    # level 0 is the image
        tmpl = klt.extract_templates(smooth, f.xy)
        return dict(frame=_FrameArrays(f.xy, f.desc, f.mask, rays,
                                       f.sigma / v.focal, tmpl),
                    smooth=smooth)

    features = _StageRunner((keypoints, templates), cuda_graphs)

    def preprocess(image: Tensor, K_inv: Tensor, focal):
        replays = features.replays(image.device)
        with span("vo_jit.pre"), (span("vo_jit.pre.graphed") if replays
                                  else nullcontext()):
            with span("vo_jit.pre.orb"):
                levels = pyramid(image, p.orb) if replays else [image]
                run = features.start(dict(
                    levels=levels,
                    ranks=corner_ranks(levels, p.orb) if replays else None,
                    K_inv=K_inv, focal=focal))
                run.advance()
            with span("vo_jit.pre.templates"):
                run.advance()
                # what the step returns and stores is its own, not a
                # graph's output
                return (_FrameArrays(*map(run.own, run.v.frame)),
                        run.own(run.v.smooth))

    def _out(state, success, mode, pose_R, pose_t, num_inliers, mean_error,
             pnp_t, init_tried) -> VoStepOut:
        dev = state.pose_t.device

        def scalar(v, dt):
            # host values become device scalars by a fill, not a copy
            if isinstance(v, Tensor):
                return v.to(dt)
            return torch.full((), v, dtype=dt, device=dev)

        return VoStepOut(
            success=torch.tensor(success, dtype=torch.bool), mode=mode,
            pose_R=pose_R, pose_t=pose_t,
            num_inliers=scalar(num_inliers, torch.int32),
            mean_error=scalar(mean_error, state.pose_t.dtype),
            pnp_t=pnp_t, init_tried=scalar(init_tried, torch.int32),
        )

    # ---- mode 0: first frame ---------------------------------------------
    def do_empty(state, f, smooth, K_inv, focal, draws):
        new_state = _ring_push(_store_frame(state, f), f)._replace(
            mode=torch.full_like(state.mode, MODE_INITIALIZING))
        out = _out(state, False, new_state.mode, state.pose_R, state.pose_t,
                   0, math.inf, torch.zeros_like(state.pose_t), 0)
        return new_state, out

    # ---- mode 1: bootstrap vs the frame-ring window -----------------------
    # Two-view bootstrap against every ring slot, accepting the oldest slot
    # that passes the quality gates (falling back to younger ones when the
    # refined-error gate fails). Three parts: the slots' candidates, one
    # ``_StageRunner`` chain over every ring slot, then one host read of
    # the ranking; the refine walk, one replay of a one-stage chain and one
    # host read of its gate per slot tried; the seed, op by op. Both chains
    # replay as CUDA graphs where the geometry's do, but for their IRLS
    # refits' ``eigh`` calls: on the card ``torch.linalg.eigh`` checks its
    # result on the host, so they are the slot chain's eager stages, the
    # same one-slot calls ``ransac.essential_ransac`` makes (a batched call
    # may take another solver).
    B = p.init_window
    R = ransac.ESSENTIAL_REFITS
    #: a slot's candidate, as the slot chain stacks it and refine takes it
    CAND = ("ok", "R", "t", "inlier_mask", "m_idx", "r2", "obs_sigma",
            "klt_valid", "n_inl")

    def slot_hypotheses(v):
        """Per ring slot: matches, KLT against the slot's templates, rays,
        the RANSAC's best hypothesis and its first refit's Gram matrix."""
        thr_sq = p.max_error_sq / (v.focal * v.focal)
        out = dict(thr_sq=thr_sq, m_idx=[], m_mask=[], r2=[], obs_sigma=[],
                   klt_valid=[], E=[], inl=[], w0=[], gram0=[])
        for b in range(B):
            m = matching.match_features(v.rb_desc[b], v.rb_mask[b], v.desc,
                                        v.mask, p.max_match_distance)
            if p.use_klt:
                kr = klt.klt_track(v.rb_tmpl[b], v.smooth, v.xy[m.idx],
                                   m.mask)
                xy2 = kr.xy
                # on KLT failure the observation is the matched new-frame
                # feature position, so the fallback sigma is that feature's
                obs_sigma = torch.where(kr.valid, p.klt_sigma_px / v.focal,
                                        v.sigma[m.idx])
                klt_valid = kr.valid
            else:
                xy2 = v.xy[m.idx]
                obs_sigma = v.sigma[m.idx]
                klt_valid = m.mask
            r2 = _to_rays(xy2, v.K_inv)
            E, inl = ransac.essential_hypotheses(
                v.rb_rays[b], r2, m.mask, p.ransac_hypotheses, thr_sq,
                uniforms=v.uniforms[b])
            w, gram = ransac.refit_gram(E, inl, v.rb_rays[b], r2)
            for k, t in dict(m_idx=m.idx, m_mask=m.mask, r2=r2,
                             obs_sigma=obs_sigma, klt_valid=klt_valid, E=E,
                             inl=inl, w0=w, gram0=gram).items():
                out[k].append(t)
        return out

    def slot_eigh(k):
        @_eager
        def stage(v):
            """Refit ``k``'s eigenvectors, one ``eigh`` a slot."""
            return {f"V{k}": [linalg.eigh(g)[1]
                              for g in getattr(v, f"gram{k}")]}
        return stage

    def slot_refit(k):
        def stage(v):
            """Refit ``k`` after its ``eigh``, then the next refit's Gram
            matrix, or after the last the slots' candidates and ranking."""
            V, w = getattr(v, f"V{k}"), getattr(v, f"w{k}")
            fits = [ransac.refit_solve(V[b], w[b], v.rb_rays[b], v.r2[b],
                                       v.m_mask[b], v.thr_sq)
                    for b in range(B)]
            if k + 1 == R:
                return slot_ranking(v, fits)
            nxt = [ransac.refit_gram(E, inl, v.rb_rays[b], v.r2[b])
                   for b, (E, inl) in enumerate(fits)]
            return {f"w{k + 1}": [wg for wg, _ in nxt],
                    f"gram{k + 1}": [g for _, g in nxt]}
        return stage

    def slot_ranking(v, fits):
        """Per slot the kept fit, the pose and the pre-refine quality
        gates; the candidates stacked, and the slots ranked
        oldest-passing first (failing slots sort last)."""
        slots = []
        for b, (E_fit, inl_fit) in enumerate(fits):
            rb_rays, r2 = v.rb_rays[b], v.r2[b]
            rr = ransac.keep_refit(v.E[b], v.inl[b], E_fit, inl_fit, rb_rays,
                                   r2)
            pose2in1, _, _ = sfm.recover_pose_and_points(
                rr.model, rb_rays, r2, rr.inlier_mask)
            w_rot = torch.amax(torch.abs(pose2in1.log()[3:]))
            t_norm = torch.clamp(torch.linalg.vector_norm(pose2in1.t),
                                 min=1e-9)
            tz = torch.abs(pose2in1.t[2]) / t_norm
            n_inl = rr.num_inliers
            ok = ((n_inl >= p.min_pair_inliers)
                  & (w_rot <= p.max_pair_rotation)
                  & (tz <= p.max_pair_z_translation)
                  & torch.all(torch.isfinite(pose2in1.t)))
            slots.append(dict(ok=ok, R=pose2in1.R, t=pose2in1.t,
                              inlier_mask=rr.inlier_mask, m_idx=v.m_idx[b],
                              r2=r2, obs_sigma=v.obs_sigma[b],
                              klt_valid=v.klt_valid[b], n_inl=n_inl))
        cand = tuple(torch.stack([s[k] for s in slots]) for k in CAND)
        ok_b = cand[0] & v.rb_valid
        age = v.step - v.rb_step
        score = torch.where(ok_b, age, torch.full_like(age, -1))
        return dict(cand=cand, order=torch.sort(-score, stable=True).indices,
                    n_ok=torch.sum(ok_b))

    slot_stages = [slot_hypotheses]
    for k in range(R):
        slot_stages += [slot_eigh(k), slot_refit(k)]
    slot_chain = _StageRunner(slot_stages, cuda_graphs)

    def refine_slot(v):
        """One Sampson polish + LM refine of ring slot ``v.b`` (a 0-dim
        index on the device): whether it passed the error gate, and the
        enriched selection."""
        dtype = v.rb_rays.dtype
        s = {k: ransac.take_best(t, v.b) for k, t in zip(CAND, v.cand)}
        rb_rays_b = ransac.take_best(v.rb_rays, v.b)
        rb_sigma_b = ransac.take_best(v.rb_sigma, v.b)
        r2, inl = s["r2"], s["inlier_mask"]
        pose2in1 = epipolar.refine_relative_pose_sampson(
            SE3(s["R"], s["t"]), rb_rays_b, r2, inl.to(dtype))
        points, point_mask = sfm.sfm_triangulate(rb_rays_b, r2, inl,
                                                 pose2in1)
        # base-frame observations are template centers (exact by
        # construction); new-frame ones carry the tracker's noise
        obs_sigma = s["obs_sigma"]
        if p.use_klt:
            sigma1 = torch.where(
                s["klt_valid"],
                torch.zeros_like(obs_sigma) + p.template_sigma_px / v.focal,
                rb_sigma_b)
        else:
            sigma1 = rb_sigma_b
        ref = sfm.sfm_refine(
            rb_rays_b, r2, point_mask, pose2in1, points,
            obs_stddev=torch.stack([sigma1, obs_sigma]),
            gauge="scale_only", ba_params=ba_params)
        n_obs = torch.clamp(2 * torch.sum(point_mask), min=1)
        mean_err = 2.0 * ref.error / n_obs.to(dtype)
        T = ref.pose2in1
        passed = ((mean_err <= v.gate_pair_err.to(dtype))
                  & torch.all(torch.isfinite(T.t)))
        return dict(passed=passed, sel=dict(
            s, R=T.R, t=T.t, points=ref.points,
            point_info=ref.point_information, point_mask=point_mask,
            mean_err=mean_err))

    refine_chain = _StageRunner((refine_slot,), cuda_graphs)

    def init_slots(state, f, smooth, K_inv, focal, draws):
        """Every ring slot's candidate; the ranking read on the host once:
        (the chain's run, slots passing, slots in ranked order)."""
        run = slot_chain.start(dict(
            rb_desc=state.rb_desc, rb_mask=state.rb_mask,
            rb_tmpl=state.rb_tmpl, rb_rays=state.rb_rays,
            rb_valid=state.rb_valid, rb_step=state.rb_step, step=state.step,
            desc=f.desc, mask=f.mask, xy=f.xy, sigma=f.sigma, smooth=smooth,
            K_inv=K_inv, focal=focal, uniforms=draws))
        for _ in slot_stages:
            run.advance()
        n_ok, *order = torch.cat([run.v.n_ok.view(1), run.v.order]).tolist()
        return run, n_ok, order

    def init_refine(state, focal, slots, n_ok, order):
        """Walk the ranked slots until one passes the refined-error gate
        (one replay and one host read per slot; typically one slot):
        (slot, the selection as the step's own, slots tried, passed)."""
        cand = slots.v.cand

        def inputs(b):
            return dict(cand=cand, rb_rays=state.rb_rays,
                        rb_sigma=state.rb_sigma,
                        gate_pair_err=state.gate_pair_err, focal=focal, b=b)

        # captured on the first bootstrap whether a slot passes or not, so
        # that no later frame captures
        refine_chain.prepare(inputs(slots.v.order[0]))
        for i in range(n_ok):
            run = refine_chain.start(inputs(slots.v.order[i]))
            run.advance()
            if bool(run.v.passed):
                return (order[i], {k: run.own(t) for k, t in
                                   run.v.sel.items()}, i + 1, True)
        if n_ok:
            return (order[n_ok - 1], {k: run.own(t) for k, t in
                                      run.v.sel.items()}, n_ok, False)
        dev = state.pose_t.device
        kw = dict(dtype=state.pose_t.dtype, device=dev)
        return order[0], dict(
            {k: slots.own(t[order[0]]) for k, t in zip(CAND, cand)},
            points=torch.zeros((K_feat, 3), **kw),
            point_info=torch.zeros((K_feat, 3, 3), **kw),
            point_mask=torch.zeros(K_feat, dtype=torch.bool, device=dev),
            mean_err=torch.full((), math.inf, **kw)), 0, False

    def init_seed(state, f, b, sel):
        """Seed the map from the accepted slot ``b``."""
        dtype, dev = state.pose_t.dtype, state.pose_t.device
        point_mask = sel["point_mask"]
        # seed map: slot i <- base feature i (masked); the selected ring
        # frame becomes the world frame
        ar = torch.arange(K_feat, dtype=torch.int32, device=dev)

        def seeded(shape, dt, head, fill=0):
            out = torch.full(shape, fill, dtype=dt, device=dev)
            out[:K_feat] = head
            return out

        step_or_none = torch.where(point_mask, state.step,
                                   torch.full_like(ar, -1))
        map_info_head = torch.where(
            point_mask[:, None, None], sel["point_info"],
            torch.zeros_like(sel["point_info"]))
        # association for the new frame: feature m_idx[i] -> slot i
        write_to = torch.where(point_mask, sel["m_idx"],
                               torch.full_like(sel["m_idx"], K_feat))
        assoc = _set_rows(
            torch.full((K_feat,), -1, dtype=torch.int32, device=dev),
            write_to, torch.where(point_mask, ar, torch.full_like(ar, -1)))
        has = (assoc >= 0)
        obs_rays = _set_rows(torch.zeros_like(f.rays), write_to, sel["r2"])
        obs_rays = torch.where(has[:, None], obs_rays, f.rays)
        obs_sig = _set_rows(torch.ones_like(f.sigma), write_to,
                            sel["obs_sigma"])
        obs_sig = torch.where(has, obs_sig, f.sigma)
        ns = _store_frame(state, f, obs_rays=obs_rays, obs_sigma=obs_sig,
                          assoc=assoc)._replace(
            mode=torch.full_like(state.mode, MODE_TRACKING),
            pose_R=sel["R"], pose_t=sel["t"],
            map_pos=seeded((M, 3), dtype, sel["points"]),
            map_desc=seeded((M, 8), torch.int32, state.rb_desc[b]),
            map_tmpl=seeded((M,) + state.rb_tmpl.shape[2:], dtype,
                            state.rb_tmpl[b]),
            map_valid=seeded((M,), torch.bool, point_mask, False),
            map_seen=seeded((M,), torch.int32, step_or_none, -1),
            map_info=seeded((M, 3, 3), dtype, map_info_head),
            frame_tracked=state.frame_tracked + 1,
        )
        return _ring_clear(ns)

    def do_init(state, f, smooth, K_inv, focal, draws):
        dev = state.pose_t.device
        if draws is None:
            # the draws ``ransac.sample_minimal_sets`` makes, every slot's
            draws = torch.rand((B, p.ransac_hypotheses, K_feat),
                               generator=state.generator, device=dev)
        with (span("vo_jit.init.graphed") if slot_chain.replays(dev)
              else nullcontext()):
            with span("vo_jit.init.slots"):
                slots, n_ok, order = init_slots(state, f, smooth, K_inv,
                                                focal, draws)
            with span("vo_jit.init.refine"):
                b, sel, n_tried, any_ok = init_refine(state, focal, slots,
                                                      n_ok, order)
        with span("vo_jit.init.seed"):
            if any_ok:
                ns = init_seed(state, f, b, sel)
            else:
                # slide the window: the new frame joins the ring
                ns = _ring_push(_store_frame(state, f), f)
        out = _out(state, any_ok, ns.mode, ns.pose_R, ns.pose_t,
                   sel["n_inl"], sel["mean_err"], sel["t"], n_tried)
        return ns, out

    # ---- mode 2: tracking --------------------------------------------------
    # The four geometry stages read the frame, the state and the camera
    # through ``v`` (inputs named as the state's and the frame's fields)
    # and return what they add to it; none reads a value on the host.
    def associate(v):
        # 1) associate to map + KLT against map templates
        m = matching.match_features(v.desc, v.mask, v.map_desc, v.map_valid,
                                    p.max_match_distance)
        if p.use_klt:
            kr = klt.klt_track(v.map_tmpl[m.idx], v.smooth, v.xy, m.mask)
            obs_xy = kr.xy
            obs_sigma = torch.where(kr.valid, p.klt_sigma_px / v.focal,
                                    v.sigma)
        else:
            obs_xy, obs_sigma = v.xy, v.sigma
        return dict(m_idx=m.idx, m_mask=m.mask, obs_sigma=obs_sigma,
                    obs_rays=_to_rays(obs_xy, v.K_inv),
                    map_pts=v.map_pos[m.idx])

    def p3p_ransac(v):
        # 2) P3P-RANSAC on the draws ``v.uniforms``
        thr = p.pnp_reproj_px / v.focal
        pose0, best_inl = pnp.pnp_ransac_core(
            v.map_pts, v.obs_rays, v.m_mask, p.pnp_hypotheses, thr * thr,
            uniforms=v.uniforms)
        return dict(pose0=pose0, best_inl=best_inl,
                    n_inl=torch.sum(best_inl).to(torch.int32))

    def triangulate(v):
        # 3) triangulate new points vs previous frame
        dtype, dev = v.pose_t.dtype, v.pose_t.device
        lm = matching.match_features(v.lf_desc, v.lf_mask, v.desc, v.mask,
                                     p.max_match_distance)
        feat = torch.arange(K_feat, device=dev)
        new_assoc_of_new_feat = _set_rows(
            torch.full((K_feat,), -1, dtype=torch.int64, device=dev),
            torch.where(v.m_mask, feat, torch.full_like(feat, K_feat)),
            v.m_idx)
        lm_ok = lm.mask & (new_assoc_of_new_feat[lm.idx] < 0)
        if p.use_klt:
            kr2 = klt.klt_track(v.lf_tmpl, v.smooth, v.xy[lm.idx], lm_ok)
            xy_new = kr2.xy
            sig_new = torch.where(kr2.valid, p.klt_sigma_px / v.focal,
                                  v.sigma[lm.idx])
        else:
            xy_new, sig_new = v.xy[lm.idx], v.sigma[lm.idx]
        r_new = _to_rays(xy_new, v.K_inv)
        last_pose = SE3(v.pose_R, v.pose_t)
        rel = last_pose.inverse().compose(v.pose0)
        pts_last, tri_mask = sfm.sfm_triangulate(v.lf_rays, r_new, lm_ok,
                                                 rel)
        # consistency gate on fresh triangulations: reproject onto BOTH rays
        eye = SE3(torch.eye(3, dtype=dtype, device=dev),
                  torch.zeros(3, dtype=dtype, device=dev))
        e_last = pnp.reprojection_error_sq(eye, pts_last, v.lf_rays)
        e_new = pnp.reprojection_error_sq(rel, pts_last, r_new)
        tri_thr = (p.tri_consistency_px / v.focal) ** 2
        tri_mask = tri_mask & (e_last < tri_thr) & (e_new < tri_thr)
        return dict(lm_idx=lm.idx, feat=feat, r_new=r_new, sig_new=sig_new,
                    tri_mask=tri_mask, e_last=e_last, e_new=e_new,
                    pts_world=last_pose.apply(pts_last))

    def bundle_adjust(v):
        # 4) two-frame BA with fixed capacities; fresh triangulations ranked
        # by their two-ray consistency residual
        dtype, dev = v.pose_t.dtype, v.pose_t.device
        old_idx, old_ok = _masked_take(v.m_mask & v.best_inl, p.ba_old)
        tri_score = torch.where(v.tri_mask, v.e_last + v.e_new,
                                torch.full_like(v.e_last, math.inf))
        new_idx = torch.sort(tri_score, stable=True).indices[: p.ba_new]
        new_ok = v.tri_mask[new_idx]
        obs_slots = v.m_idx[old_idx]                     # map slots
        # last-frame observation of those slots (reverse assoc)
        lf_map_to_feat = _set_rows(
            torch.full((M,), -1, dtype=torch.int64, device=dev),
            torch.where(v.lf_assoc >= 0, v.lf_assoc,
                        torch.full_like(v.lf_assoc, M)), v.feat)
        lf_feat = lf_map_to_feat[obs_slots]
        lf_seen = (lf_feat >= 0) & old_ok
        safe_lf = torch.clamp(lf_feat, min=0)
        nf = v.lm_idx[new_idx]                           # new-frame feature

        pts0 = torch.cat([v.map_pos[obs_slots], v.pts_world[new_idx]])
        obs = torch.stack([
            torch.cat([v.lf_obs_rays[safe_lf, :2], v.lf_rays[new_idx, :2]]),
            torch.cat([v.obs_rays[old_idx, :2], v.r_new[new_idx, :2]]),
        ])
        obs_mask_ba = torch.stack([torch.cat([lf_seen, new_ok]),
                                   torch.cat([old_ok, new_ok])])
        # last-frame obs of new points = template centers (exact by
        # construction, see template_sigma_px)
        w_tmpl = (torch.zeros(p.ba_new, dtype=dtype, device=dev)
                  + v.focal / p.template_sigma_px)
        weight = torch.stack([
            torch.cat([1.0 / v.lf_obs_sigma[safe_lf], w_tmpl]),
            torch.cat([1.0 / v.obs_sigma[old_idx], 1.0 / v.sig_new[new_idx]]),
        ])
        # old points carry their recursive landmark information
        stored_info = v.map_info[obs_slots]
        has_info = torch.diagonal(stored_info, dim1=-2, dim2=-1).sum(-1) > 0
        iso = (torch.eye(3, dtype=dtype, device=dev)
               / (p.map_point_stddev ** 2))
        old_info = torch.where(has_info[:, None, None], stored_info, iso)
        point_info = torch.cat([
            torch.where(old_ok[:, None, None], old_info,
                        torch.zeros_like(old_info)),
            torch.zeros((p.ba_new, 3, 3), dtype=dtype, device=dev)])
        poses0 = SE3(torch.stack([v.pose_R, v.pose0.R]),
                     torch.stack([v.pose_t, v.pose0.t]))
        pose_prior_info = torch.stack([
            1e10 * torch.eye(6, dtype=dtype, device=dev),
            torch.zeros((6, 6), dtype=dtype, device=dev)])
        prob = ba_mod.BAProblem.create(
            poses0=poses0, points0=pts0, obs=obs, obs_mask=obs_mask_ba,
            obs_weight=weight, pose_prior=poses0,
            pose_prior_info=pose_prior_info, point_prior=pts0,
            point_prior_info=point_info)
        launches = ba_cuda.two_frame_solve.launches
        result = ba_mod.ba_solve(prob, ba_params)
        # a constant of the stage's graph where it replays
        fused = ba_cuda.two_frame_solve.launches != launches
        return dict(old_idx=old_idx, old_ok=old_ok, new_idx=new_idx,
                    new_ok=new_ok, obs_slots=obs_slots, nf=nf,
                    obs_mask_ba=obs_mask_ba, result=result, ba_fused=fused)

    geometry = _StageRunner((associate, p3p_ransac, triangulate,
                             bundle_adjust), cuda_graphs)

    def do_track(state, f, smooth, K_inv, focal, draws):
        dtype, dev = state.pose_t.dtype, state.pose_t.device
        if draws is None:
            # the draw ``ransac.sample_minimal_sets`` makes
            draws = torch.rand((p.pnp_hypotheses, K_feat),
                               generator=state.generator, device=dev)
        run = geometry.start(dict(
            xy=f.xy, desc=f.desc, mask=f.mask, sigma=f.sigma, smooth=smooth,
            map_desc=state.map_desc, map_valid=state.map_valid,
            map_tmpl=state.map_tmpl, map_pos=state.map_pos,
            map_info=state.map_info, lf_desc=state.lf_desc,
            lf_mask=state.lf_mask, lf_tmpl=state.lf_tmpl,
            lf_rays=state.lf_rays, lf_assoc=state.lf_assoc,
            lf_obs_rays=state.lf_obs_rays, lf_obs_sigma=state.lf_obs_sigma,
            pose_R=state.pose_R, pose_t=state.pose_t, K_inv=K_inv,
            focal=focal, uniforms=draws))
        with (span("vo_jit.track.graphed") if geometry.replays(dev)
              else nullcontext()):
            for name in ("vo_jit.track.associate", "vo_jit.track.pnp",
                         "vo_jit.track.triangulate"):
                with span(name):
                    run.advance()
            with span("vo_jit.track.ba"):
                run.advance()
                if run.v.ba_fused:
                    with span("vo_jit.track.ba.fused"):
                        pass
        # what outlives the frame is the step's own, not a graph's output
        v, own = run.v, run.own
        result = v.result
        with span("vo_jit.track.gate"):
            n_obs = torch.clamp(torch.sum(v.obs_mask_ba), min=1)
            mean_err = 2.0 * result.error / n_obs.to(dtype)
            pose = SE3(own(result.poses.R[1]), own(result.poses.t[1]))
            ok = ((v.n_inl >= p.min_track_inliers)
                  & (mean_err <= p.max_track_mean_error)
                  & torch.all(torch.isfinite(pose.t)))
            ok = bool(ok)
        with span("vo_jit.track.commit"):
            if ok:
                old_idx, old_ok, obs_slots = v.old_idx, v.old_ok, v.obs_slots
                new_idx, new_ok, nf = v.new_idx, v.new_ok, v.nf
                pts_ref = result.points
                info_ref = result.point_information
                w_old = torch.where(old_ok, obs_slots,
                                    torch.full_like(obs_slots, M))
                map_pos = _set_rows(state.map_pos, w_old, pts_ref[: p.ba_old])
                map_info = _set_rows(state.map_info, w_old,
                                     info_ref[: p.ba_old])
                map_seen = _set_rows(state.map_seen, w_old, state.step)
                slots_new = _allocate_slots(state.map_valid, map_seen,
                                            p.ba_new)
                w_new = torch.where(new_ok, slots_new,
                                    torch.full_like(slots_new, M))
                map_pos = _set_rows(map_pos, w_new, pts_ref[p.ba_old:])
                map_desc = _set_rows(state.map_desc, w_new, f.desc[nf])
                map_tmpl = _set_rows(state.map_tmpl, w_new,
                                     state.lf_tmpl[new_idx])
                map_valid = _set_rows(state.map_valid, w_new, True)
                map_seen = _set_rows(map_seen, w_new, state.step)
                map_info = _set_rows(map_info, w_new, info_ref[p.ba_old:])
                # new-frame association + refined observations
                w_oldfeat = torch.where(old_ok, old_idx,
                                        torch.full_like(old_idx, K_feat))
                w_nf = torch.where(new_ok, nf, torch.full_like(nf, K_feat))
                assoc = torch.full((K_feat,), -1, dtype=torch.int32,
                                   device=dev)
                assoc = _set_rows(assoc, w_oldfeat, obs_slots)
                assoc = _set_rows(assoc, w_nf, slots_new)
                o_rays = _set_rows(f.rays, w_oldfeat, v.obs_rays[old_idx])
                o_rays = _set_rows(o_rays, w_nf, v.r_new[new_idx])
                o_sig = _set_rows(f.sigma, w_oldfeat, v.obs_sigma[old_idx])
                o_sig = _set_rows(o_sig, w_nf, v.sig_new[new_idx])
                new_state = _store_frame(
                    state, f, obs_rays=o_rays, obs_sigma=o_sig, assoc=assoc
                )._replace(
                    pose_R=pose.R, pose_t=pose.t,
                    map_pos=map_pos, map_desc=map_desc, map_tmpl=map_tmpl,
                    map_valid=map_valid, map_seen=map_seen, map_info=map_info,
                    frame_tracked=state.frame_tracked + 1,
                )
            else:
                # back to INITIALIZING keeping the new frame (reference reset)
                ns = _store_frame(state, f)._replace(
                    mode=torch.full_like(state.mode, MODE_INITIALIZING),
                    map_valid=torch.zeros_like(state.map_valid),
                    map_seen=torch.full_like(state.map_seen, -1),
                    map_info=torch.zeros_like(state.map_info),
                )
                new_state = _ring_push(_ring_clear(ns), f)
        out = _out(state, ok, new_state.mode, new_state.pose_R,
                   new_state.pose_t, own(v.n_inl), mean_err, own(v.pose0.t),
                   0)
        return new_state, out

    branches = {MODE_EMPTY: (do_empty, "vo_jit.empty"),
                MODE_INITIALIZING: (do_init, "vo_jit.init"),
                MODE_TRACKING: (do_track, "vo_jit.track")}

    def combine_fn(state: VoJitState, f: _FrameArrays, smooth: Tensor,
                   K_inv: Tensor, focal, draws: Tensor | None = None):
        with span("vo_jit.combine"):
            state = state._replace(step=state.step + 1,
                                   frame_total=state.frame_total + 1)
            branch, name = branches[int(state.mode)]
            with span(name):
                return branch(state, f, smooth, K_inv, focal, draws)

    def step_fn(state: VoJitState, image: Tensor, K_inv: Tensor, focal,
                draws: Tensor | None = None):
        f, smooth = preprocess(image, K_inv, focal)
        return combine_fn(state, f, smooth, K_inv, focal, draws)

    step_fn.pre_graphs = preprocess.pre_graphs = features.captures
    step_fn.track_graphs = combine_fn.track_graphs = geometry.captures
    step_fn.init_graphs = combine_fn.init_graphs = dict(
        slots=slot_chain.captures, refine=refine_chain.captures)
    return step_fn, preprocess, combine_fn


def make_vo_step(params: VoJitParams = VoJitParams()):
    """Build ``step(state, image, K_inv, focal, draws=None)``."""
    step_fn, _, _ = _make_vo_step_fns(params)
    return step_fn


def make_vo_pipelined(params: VoJitParams = VoJitParams()):
    """Build ``(pre, combine)`` — the step split at its state-independent
    seam: ``pre(image, K_inv, focal) -> (frame_arrays, smooth)`` is the
    feature pipeline, ``combine(state, frame_arrays, smooth, K_inv, focal,
    draws=None) -> (state, out)`` the state machine."""
    _, preprocess, combine_fn = _make_vo_step_fns(params)
    return preprocess, combine_fn


def make_vo_replay(params: VoJitParams = VoJitParams()):
    """Build ``replay(state, images, K_inv, focal, draws=None) -> (state,
    outs)``: the step over a stacked (T, H, W) batch, outputs stacked per
    field. ``draws``, when given, is a sequence of per-frame draws."""
    step_fn, _, _ = _make_vo_step_fns(params)

    def replay(state: VoJitState, images: Tensor, K_inv: Tensor, focal,
               draws=None):
        outs = []
        for t in range(images.shape[0]):
            state, out = step_fn(state, images[t], K_inv, focal,
                                 None if draws is None else draws[t])
            outs.append(out)
        return state, VoStepOut(*(torch.stack(v) for v in zip(*outs)))

    return replay
