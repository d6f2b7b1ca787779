"""Dense distributed options (``persia_tpu/distributed.py``).

The JAX package describes a job by a mesh and brings up multi-host JAX
with ``jax.distributed.initialize``. Here every rank is a process:
:meth:`DistributedOption.initialize` brings up ``torch.distributed``
once (from torchrun's environment, ``MASTER_ADDR`` / ``MASTER_PORT`` /
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, or from explicit arguments;
a single process without either is a world of one) and returns the
(data, model) mesh over the world's ranks.

The backend is NCCL for CUDA and gloo for the CPU, or whichever the
caller names; nothing falls back to gloo when NCCL refuses. ``timeout``
reaches ``init_process_group``, so that a dead peer makes a rank fail
instead of hang.
"""

import datetime
import os
import socket
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch.distributed as dist

from persia_tpu_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class DistributedOption:
    """How the ranks of a data-parallel job meet, and their mesh.

    Args:
        mesh_shape: (data, model) rank grid; None puts every rank on the
            data axis (the reference's DDP topology).
        grad_reduce_dtype: the dense gradients' reduction on the DDP step:
            None (f32), "bf16" (cast, mean, back to f32) or "int8_ef"
            (int8 with error feedback). Passed to ``TrainCtx`` by
            :meth:`train_ctx_kwargs`.
        backend: "nccl" or "gloo"; None means NCCL on CUDA and gloo on
            the CPU.
        device: the ranks' device type (default CUDA; "cpu" for gloo on
            the CPU).
        init_method / world_size / rank: an explicit rendezvous
            (``tcp://host:port``); None reads torchrun's environment.
        timeout: seconds a collective may wait for a peer.
    """

    mesh_shape: Optional[Tuple[int, int]] = None
    grad_reduce_dtype: Optional[str] = None
    backend: Optional[str] = None
    device: DeviceLike = None
    init_method: Optional[str] = None
    world_size: Optional[int] = None
    rank: Optional[int] = None
    timeout: float = 600.0
    _mesh: object = field(default=None, init=False, repr=False)

    def _rendezvous(self):
        """(init_method, world_size, rank) for ``init_process_group``."""
        if self.init_method is not None:
            if self.world_size is None or self.rank is None:
                raise ValueError("an explicit init_method needs world_size "
                                 "and rank")
            return self.init_method, self.world_size, self.rank
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            return "env://", -1, -1  # torchrun's environment
        if self.world_size not in (None, 1):
            raise ValueError(
                f"a world of {self.world_size} ranks needs init_method or "
                f"torchrun's MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE")
        return f"tcp://127.0.0.1:{free_port()}", 1, 0

    def initialize(self):
        """Bring up ``torch.distributed`` if it is not up yet; returns the
        mesh (the same one on every later call)."""
        if self._mesh is not None:
            return self._mesh
        from persia_tpu_torch.parallel.mesh import make_mesh

        dev = resolve_device(self.device)
        backend = self.backend or ("nccl" if dev.type == "cuda" else "gloo")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("the NCCL backend needs CUDA devices")
        if not dist.is_initialized():
            init_method, world, rank = self._rendezvous()
            dist.init_process_group(
                backend, init_method=init_method, world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=self.timeout))
        elif str(dist.get_backend()) != backend:
            raise RuntimeError(f"torch.distributed is already up with "
                               f"{dist.get_backend()}, not {backend}")
        self._mesh = make_mesh(self.mesh_shape, device=dev)
        return self._mesh

    def train_ctx_kwargs(self) -> dict:
        """``TrainCtx(..., **option.train_ctx_kwargs())`` wires both the
        mesh and the gradient-reduction dtype."""
        return {"mesh": self.initialize(),
                "grad_reduce_dtype": self.grad_reduce_dtype}


def get_default_distributed_option() -> DistributedOption:
    """Data parallelism over every rank of the world, the reference's
    default."""
    return DistributedOption()
