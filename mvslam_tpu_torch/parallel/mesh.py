"""Device mesh and sharding helpers (port of ``mvslam_tpu.parallel.mesh``).

JAX's ``shard_map`` over a ``Mesh`` becomes ``torch.distributed``: one
process (rank) per shard, a 1-D ``DeviceMesh`` whose ``data`` axis shards
landmarks, observations or pose-graph edges, and sums over the axis's
process group (``ops.ba.psum``) doing all cross-shard coupling. NCCL serves
CUDA tensors and gloo the CPU.

A caller that has not initialised a process group gets a one-rank group
through a store in its own process (no network), so single-process callers
never branch, as in JAX's single-process path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"


def ensure_process_group(device_type: str = "cuda") -> None:
    """The default process group, formed as one rank through an in-process
    store when none is initialised (NCCL for ``cuda``, else gloo)."""
    if dist.is_initialized():
        return
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(device_type: str = "cuda", axis: str = DATA_AXIS) -> DeviceMesh:
    """1-D mesh over every rank of the default process group (a one-rank
    group is formed if none is)."""
    ensure_process_group(device_type)
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def replicated(mesh: DeviceMesh) -> list:
    """Every rank holds the whole tensor (JAX ``P()``)."""
    return [Replicate()] * mesh.ndim


def sharded_leading(mesh: DeviceMesh, axis: str = DATA_AXIS) -> list:
    """The leading axis split over the mesh axis ``axis`` (JAX ``P(axis)``)."""
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_axis(x: torch.Tensor, extra: int, dim: int = 0,
             value=0) -> torch.Tensor:
    """``x`` with ``extra`` entries of ``value`` appended along ``dim``."""
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def shard_of(mesh: DeviceMesh, axes: tuple[str, ...]):
    """(process group, shard count, this rank's shard index) of the mesh
    axes ``axes`` taken together, slowest first. One axis: that axis's
    group. Several: they must span the whole mesh and the mesh the whole
    world; the group is then the default one."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a DeviceMesh, got {type(mesh).__name__}")
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    count, index = 1, 0
    for a in axes:
        size = mesh.size(names.index(a))
        count, index = count * size, index * size + coord[names.index(a)]
    if len(axes) == 1:
        return mesh.get_group(axes[0]), count, index
    if sorted(axes) != sorted(names) or count != dist.get_world_size():
        raise ValueError(f"axes {axes} of a mesh {dict(zip(names, mesh.shape))}"
                         f" do not span the world of {dist.get_world_size()}")
    return dist.group.WORLD, count, index


def all_gather_rows(x: torch.Tensor, group, count: int) -> torch.Tensor:
    """Every rank's block of rows, concatenated in rank order of ``group``
    (the blocks are of equal size)."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(count)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
