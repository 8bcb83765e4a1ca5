"""Multi-host (multi-process) runtime: ``(dcn, ici)`` meshes (port of
``mvslam_tpu.parallel.multihost``).

- :func:`initialize` joins the ``torch.distributed`` default process group
  of a job launched as N processes (``torchrun`` sets ``WORLD_SIZE``,
  ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``); with one process it does
  nothing.
- :func:`make_hybrid_mesh` builds a 2-D ``(dcn, ici)`` ``DeviceMesh``,
  slow axis outermost: each ``ici`` row is one contiguous block of ranks
  (one host's cards under torchrun's numbering), so the bandwidth-hungry
  sums of the landmark-sharded Schur reduction stay within a host, and the
  ``dcn`` axis (between hosts) carries the time windows of the
  sequence-partitioned solves.

==========  =========================================================
axis        what shards over it
==========  =========================================================
``dcn``     keyframe-sequence windows (time partitioning, halo poses)
``ici``     landmarks / observations / pose-graph edges (summed)
==========  =========================================================
"""

from __future__ import annotations

import os

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mvslam_tpu_torch.parallel.mesh import ensure_process_group

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device_type: str = "cuda") -> bool:
    """Join (or form) the default process group of a multi-process job;
    True when a group of more than one rank is active after the call.

    Arguments default to torchrun's environment (``WORLD_SIZE``, ``RANK``;
    ``init_method`` defaults to ``env://``, which reads ``MASTER_ADDR`` and
    ``MASTER_PORT``). With a world size of at most 1 nothing is
    initialised and it returns False. NCCL for ``cuda``, else gloo.
    """
    world = world_size if world_size is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=init_method or "env://", world_size=world,
            rank=rank if rank is not None else int(os.environ["RANK"]))
    return dist.get_world_size() > 1


def make_hybrid_mesh(device_type: str = "cuda",
                     dcn_size: int | None = None) -> DeviceMesh:
    """2-D ``(dcn, ici)`` mesh over the world, slow axis outermost: row
    ``i`` holds ranks ``i * ici .. (i + 1) * ici - 1``.

    ``dcn_size`` defaults to the number of hosts, ``world //
    LOCAL_WORLD_SIZE`` (torchrun's ranks per host; one host when unset),
    and must divide the world size. With one process this is a (1, 1)
    mesh over a one-rank group formed in the process.
    """
    ensure_process_group(device_type)
    world = dist.get_world_size()
    if dcn_size is None:
        dcn_size = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dcn_size < 1 or world % dcn_size != 0:
        raise ValueError(
            f"world size {world} not divisible by dcn axis {dcn_size}")
    return init_device_mesh(device_type, (dcn_size, world // dcn_size),
                            mesh_dim_names=(DCN_AXIS, ICI_AXIS))


def local_batch_slice(global_n: int, axis_size: int, axis_index: int
                      ) -> tuple[int, int]:
    """(start, size) of this shard's contiguous slice of a length-
    ``global_n`` axis padded to a multiple of ``axis_size``."""
    per = -(-global_n // axis_size)
    return axis_index * per, per
