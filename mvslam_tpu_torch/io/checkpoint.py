"""Checkpoint / resume of the visual-odometer state (port of
``mvslam_tpu.io.checkpoint``).

The full tracking state round-trips: the map (positions, descriptors, KLT
templates, bookkeeping), the last frame's feature set + refined
observations, the current pose, and the trajectory. Format: a single
``.npz`` with a JSON-encoded meta entry (schema-versioned), under the JAX
package's field names and dtypes (descriptor words uint32), so a file
written by either package loads in the other. As there, the frames queued
for a bootstrap are not saved: an INITIALIZING odometer resumes with an
empty window.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from mvslam_tpu_torch import convert
from mvslam_tpu_torch.frontend.visual_odometer import VisualOdometer
from mvslam_tpu_torch.frontend.vo_jit import VoJitState

SCHEMA_VERSION = 1

_META = ("state", "step", "frame_total", "frame_tracked", "last_frame")


def save_checkpoint(vo: VisualOdometer, path: str) -> None:
    """Serialize a tracking (or initializing) VO to ``path`` (.npz)."""
    d = convert.odometer_to_numpy(vo, window=False)
    meta = {"schema": SCHEMA_VERSION}
    meta.update({k: d.pop(k) for k in _META if k in d})
    np.savez_compressed(path, meta=json.dumps(meta), **d)


def load_checkpoint(path: str, vo: VisualOdometer) -> VisualOdometer:
    """Restore state into ``vo`` (constructed with the desired params), on
    ``vo``'s device; returns ``vo``. The restored last frame carries no
    image: the next tracked frame's KLT runs against the checkpointed
    map/frame templates, which is what live tracking does too."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if meta["schema"] != SCHEMA_VERSION:
        raise ValueError(f"unsupported checkpoint schema {meta['schema']}")
    d = {k: z[k] for k in z.files if k != "meta"}
    d.update({k: meta[k] for k in _META if k in meta})
    return convert.odometer_from_numpy(d, vo)


# ---------------------------------------------------------------------------
# Fused (vo_jit) tracker state: one flat tuple of fixed-shape tensors, so
# checkpointing is a field->array dump.
# ---------------------------------------------------------------------------

JIT_SCHEMA_VERSION = 2   # v2: + gate_pair_err gate scalar in the state


def save_vo_jit_state(state: VoJitState, path: str) -> None:
    """Serialize a :class:`~mvslam_tpu_torch.frontend.vo_jit.VoJitState`
    (.npz), every field under its name as ``convert.state_to_numpy`` gives
    it (the JAX package's names and dtypes).

    What cannot be carried across packages is the stream of RANSAC draws:
    the JAX state holds a threefry ``key``, this one a ``torch.Generator``.
    The file holds the generator's own state (``generator_state``, for
    this package on the same kind of device) and, under ``key``, the
    threefry key of the generator's *initial seed*: the JAX package loads
    that and draws from the seed's start, not from where this tracker
    stood."""
    arrays = convert.state_to_numpy(state)
    seed = state.generator.initial_seed()
    arrays["key"] = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    arrays["generator_state"] = state.generator.get_state().numpy()
    meta = {"schema": JIT_SCHEMA_VERSION,
            "generator_device": state.generator.device.type}
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_vo_jit_state(path: str, template: VoJitState,
                      seed: int | None = None) -> VoJitState:
    """Restore a state saved by :func:`save_vo_jit_state` of either
    package, on ``template``'s device.

    ``template``: a state from ``vo_init_state`` with the same params —
    shapes are validated against it so a capacity mismatch raises
    ``ValueError`` instead of mistracking. The generator continues where
    the saved one stood when the file holds its state for the template's
    kind of device. Otherwise (a file of the JAX package, or one written
    on the other kind of device) the stream cannot be carried over and
    nothing is guessed: the caller names the ``seed`` of a fresh
    generator, or the load raises ``ValueError``."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if meta["schema"] != JIT_SCHEMA_VERSION:
        raise ValueError(
            f"unsupported vo_jit checkpoint schema {meta['schema']}")
    dev = template.pose_t.device
    arrays = {}
    for name, ref in template._asdict().items():
        if name == "generator":
            continue
        arr = z[name]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint field {name!r} shape {arr.shape} != params "
                f"shape {tuple(ref.shape)}")
        arrays[name] = arr
    same_kind = meta.get("generator_device") == dev.type
    if seed is None and not same_kind:
        raise ValueError(
            "the file holds no torch.Generator state for a "
            f"{dev.type!r} device (it was written by the JAX package or on "
            "another kind of device): pass seed= to start a fresh stream")
    state = convert.state_from_numpy(arrays, device=dev,
                                     dtype=template.pose_t.dtype,
                                     seed=0 if seed is None else seed)
    if seed is None:
        state.generator.set_state(torch.from_numpy(z["generator_state"]))
    return state
