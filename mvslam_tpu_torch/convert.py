"""Tracker state to and from numpy dicts — the tracker's "weights".

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

from mvslam_tpu_torch.frontend.vo_jit import VoJitState

_DESC_FIELDS = ("map_desc", "lf_desc", "rb_desc")
_INT_FIELDS = ("mode", "step", "map_seen", "lf_assoc", "rb_step", "rb_pos",
               "frame_total", "frame_tracked")
_BOOL_FIELDS = ("map_valid", "lf_mask", "rb_mask", "rb_valid")


def state_from_numpy(d: dict, device=None, dtype=torch.float32,
                     seed: int = 0) -> VoJitState:
    """Port state from a dict of numpy arrays (``key``/``generator`` are
    ignored; the new state's generator is seeded with ``seed``)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
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
