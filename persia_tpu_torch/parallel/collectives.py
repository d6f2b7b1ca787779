"""Collectives over a process group, with autograd where the JAX code
differentiates through them.

The JAX package takes these from ``lax`` inside ``shard_map``: ``pmean``,
``all_to_all(tiled=True)``, ``all_gather``, ``ppermute``, and the gather
back to a replicated value that ``shard_map``'s ``out_specs`` implies.
Here each is a plain function over a ``torch.distributed`` group:

- :func:`pmean`, :func:`pmean_`, :func:`pmax_` and :func:`broadcast_`
  (no autograd; the DDP step reduces gradients after the backward);
- :func:`all_gather` (no autograd; masks and int8 codes);
- :func:`all_to_all`, whose backward is the inverse ``all_to_all``;
- :func:`ppermute`, a ring shift, whose backward is the reverse shift;
- :func:`scatter_to_shards` / :func:`gather_from_shards`, the two ends
  of a sharded region inside an SPMD program. Every rank of the group
  runs the code outside the region identically (``shard_map`` runs it
  once), so the backward of the gather takes this rank's block of the
  gradient, not its sum over the group (which would be P times too
  large), and the backward of the scatter all-gathers the blocks' grads
  so that every rank holds the whole, equal gradient again.

gloo's point-to-point ops read a CUDA tensor's pointer as host memory, so
for gloo a ring shift of device tensors is staged through host memory, in
one function (:func:`_p2p_exchange`); NCCL never stages. Every call is
counted by (op, backend), staged shifts as ``"ppermute/gloo-host"``
(:data:`calls`), so a run can show which paths it took.
"""

from collections import Counter
from typing import Iterable

import torch
import torch.distributed as dist

calls: Counter = Counter()


def _count(op: str, group) -> str:
    backend = str(dist.get_backend(group))
    calls[f"{op}/{backend}"] += 1
    return backend


def size(group=None) -> int:
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group)


def global_rank(group, group_rank: int) -> int:
    return dist.get_process_group_ranks(group)[group_rank]


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group (``lax.pmean``), a new tensor."""
    out = x.detach().clone()
    pmean_([out], group)
    return out


def pmean_(tensors: Iterable[torch.Tensor], group=None):
    """Each tensor replaced in place by its mean over the group."""
    n = size(group)
    for t in tensors:
        _count("all_reduce", group)
        dist.all_reduce(t, group=group)
        t.div_(n)


def pmax_(tensors: Iterable[torch.Tensor], group=None):
    """Each tensor replaced in place by its elementwise max over the
    group."""
    for t in tensors:
        _count("all_reduce", group)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)


def broadcast_(tensors: Iterable[torch.Tensor], src: int, group=None):
    """Each tensor overwritten by global rank ``src``'s."""
    for t in tensors:
        _count("broadcast", group)
        dist.broadcast(t, src=src, group=group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(tiled=True)``)."""
    _count("all_gather", group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over {n} ranks")
    _count("all_to_all", group)
    inp = torch.stack(x.chunk(n, dim=split_dim))  # (n, ...) contiguous
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.concat_dim, ctx.split_dim),
                None, None, None)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)``: ``x`` split into P blocks along ``split_dim``, block j
    sent to rank j, the received blocks concatenated along ``concat_dim``
    in source order. Differentiable."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _p2p_exchange(send: torch.Tensor, recv: torch.Tensor, dst: int,
                  src: int, group):
    """Send ``send`` to global rank ``dst`` while receiving ``recv`` from
    ``src``. gloo reads the buffers as host memory, so for gloo a device
    tensor goes through a host copy, here and nowhere else."""
    backend = str(dist.get_backend(group))
    staged = backend == "gloo" and send.is_cuda
    calls[f"ppermute/{'gloo-host' if staged else backend}"] += 1
    s, r = (send.cpu(), torch.empty(recv.shape, dtype=recv.dtype)) \
        if staged else (send, recv)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, s, dst, group),
                                     dist.P2POp(dist.irecv, r, src, group)]):
        w.wait()
    if staged:
        recv.copy_(r)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n, me = size(group), rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    _p2p_exchange(x, out, global_rank(group, (me + shift) % n),
                  global_rank(group, (me - shift) % n), group)
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The ring shift ``lax.ppermute(x, perm=[(j, (j + shift) % P)])``:
    rank j's ``x`` lands on rank j + shift. Differentiable (the backward
    shifts the gradient back); a tensor that needs no gradient (a mask)
    is shifted without autograd."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Shift.apply(x, group, shift)
    return _shift(x, group, shift)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks")
    return x.chunk(n, dim=dim)[rank(group)]


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


def scatter_to_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a value every rank holds alike
    (``shard_map``'s sharded ``in_specs``). Differentiable: the backward
    all-gathers the blocks' gradients."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Scatter.apply(x, group, dim)
    return _block(x, group, dim).contiguous()


def gather_from_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of every rank concatenated along ``dim`` into the value
    every rank then holds alike (``shard_map``'s ``out_specs``).
    Differentiable: the backward takes this rank's block of the
    gradient."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Gather.apply(x, group, dim)
    return all_gather(x, group, dim)

