"""The (data, model) mesh of ranks (``persia_tpu/parallel/mesh.py``).

The JAX package lays devices out in a 2-D ``Mesh`` inside one program.
Here every rank is a process of a ``torch.distributed`` world, and the
mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over those
ranks with the dim names ``("data", "model")``:

- ``data``: synchronous data parallelism of the dense tower (the
  reference's DDP all-reduce);
- ``model``: the axis context parallelism shards a sequence over (and,
  in the JAX package, device tables' rows).

The JAX package places a global array with ``batch_sharding`` /
``replicated`` / ``shard_batch_pytree``; in a process-per-rank program
every rank holds the global batch and takes its own rows
(:func:`shard_rows`), with the JAX rule that a leading dimension which
does not divide the data axis stays replicated.
"""

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from persia_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device: DeviceLike = None) -> DeviceMesh:
    """A (data, model) mesh over every rank of the initialized world,
    ranks laid out row-major as the JAX ``make_mesh`` reshapes devices.

    The default shape puts every rank on the data axis (pure data
    parallelism, the reference's topology). On CUDA, rank r takes
    ``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK`` defaults to the
    global rank); ``device="cpu"`` keeps the ranks on the CPU. Every rank
    of the world calls this, with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed world; call "
            "persia_tpu_torch.distributed.DistributedOption(...).initialize()"
            " first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """``mesh.shape[axis]`` of a JAX mesh."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh: DeviceMesh, axis: str):
    """This rank's process group along ``axis``."""
    return mesh.get_group(axis)


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def leader_rank(mesh: DeviceMesh) -> int:
    """The global rank at the mesh's origin: the sparse leader of a
    ``TrainCtx`` over the mesh."""
    return int(mesh.mesh.reshape(-1)[0])


def is_leader(mesh: DeviceMesh) -> bool:
    return dist.get_rank() == leader_rank(mesh)


def shard_rows(x, mesh: DeviceMesh, axis: str = DATA_AXIS):
    """This rank's rows of a batch-major ``x`` along ``axis`` (a view).
    A scalar, or a leading dimension that does not divide the axis,
    stays replicated: ``x`` itself (``shard_batch_pytree``'s rule)."""
    n = axis_size(mesh, axis)
    if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.shape[0] % n:
        return x
    rows = x.shape[0] // n
    i = axis_index(mesh, axis)
    return x[i * rows:(i + 1) * rows]
