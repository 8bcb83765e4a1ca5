"""Index bookkeeping on the device, shared by the two trackers: the first
true positions of a mask, map-slot allocation, and row writes through an
index that may repeat.

numpy's ``a[idx] = v`` keeps the last write among repeated indices;
``tensor[idx] = v`` on CUDA leaves the winner to the hardware.
:func:`set_rows` makes "the highest source position wins" explicit and so
gives numpy's result on every device.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def masked_take(mask: Tensor, cap: int) -> tuple[Tensor, Tensor]:
    """First ``cap`` true positions in ascending order, padded with false
    positions: (idx (cap,), valid (cap,))."""
    order = torch.sort((~mask).to(torch.int32), stable=True).indices
    idx = order[:cap]
    return idx, mask[idx]


def allocate_slots(map_valid: Tensor, map_seen: Tensor, n: int) -> Tensor:
    """n map slots: free ones first (ascending index), then valid ones from
    the least recently seen; equal ``map_seen`` keeps the lower index first
    (a stable sort)."""
    keys = torch.where(map_valid, map_seen,
                       torch.full_like(map_seen,
                                       torch.iinfo(map_seen.dtype).min))
    return torch.sort(keys, stable=True).indices[:n]


def set_rows(dst: Tensor, idx: Tensor, vals) -> Tensor:
    """``dst.at[idx].set(vals, mode="drop")``: rows ``idx`` of a copy of
    ``dst`` set to ``vals``; out-of-range indices are dropped, and among
    duplicate indices the last write wins (numpy's ``a[idx] = v`` and the
    serial scatter order of the JAX package on the CPU), deterministically
    on every device: a ``scatter_reduce`` with ``amax`` over the source
    position picks each row's winner, then one gather."""
    n = dst.shape[0]
    idx = idx.to(torch.int64)
    tgt = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    src = torch.arange(idx.shape[0], device=dst.device)
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=dst.device)
    winner = winner.scatter_reduce(0, tgt, src, reduce="amax")[:n]
    if isinstance(vals, (bool, int, float)):
        # a fill, not an upload: a host scalar copied to the card
        # synchronises
        vals = torch.full((), vals, dtype=dst.dtype, device=dst.device)
    vals = torch.as_tensor(vals, dtype=dst.dtype, device=dst.device).expand(
        (idx.shape[0],) + dst.shape[1:])
    picked = vals[torch.clamp(winner, min=0)]
    hit = (winner >= 0).view((n,) + (1,) * (dst.dim() - 1))
    return torch.where(hit, picked, dst)
