"""Device-resident hashed embedding tables (``persia_tpu/parallel/
device_embedding.py``): the sparse half of device mode.

The sign space is hashed into a fixed-vocab table that lives in the
card's memory and trains with the dense tower's optimizer; no parameter
server is involved. The pooled lookup is the embedding-bag kernel K1
(:mod:`persia_tpu_torch.ops.embedding_bag`): the collection pools all
its slots of one embedding dim, hash and mask included, in one launch
(:func:`~persia_tpu_torch.ops.embedding_bag.embedding_bag_slots`), and a
lone :class:`DeviceEmbeddingBag` takes K1's single-table entry. Tables
are single-device in this slice: the JAX package shards them over a
mesh's ``model`` axis, which waits for ROADMAP queue A item 3.
"""

from typing import Any, Dict, List, Sequence

import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.ops.embedding_bag import (
    SLOT_DTYPES,
    embedding_bag,
    embedding_bag_reference,
    embedding_bag_slots,
    hash_ids,
)

BAG_IMPLS = ("kernel", "reference")


class DeviceEmbeddingBag(nn.Module):
    """One hashed (vocab_size, dim) f32 table with sum or mean pooling.

    ``forward(hashed_ids, mask)`` takes (bs, sfs) ids in [0, vocab_size)
    and the (bs, sfs) validity mask, and returns the pooled (bs, dim)
    embedding in ``compute_dtype``. ``bag_impl="kernel"`` pools through
    K1 (its plain version on the CPU); ``"reference"`` runs the plain
    version on any device, so that a plain tower can be held against the
    kernel tower on the card.
    """

    def __init__(self, vocab_size: int, dim: int, pooling: str = "sum",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 bag_impl: str = "kernel", device: DeviceLike = None):
        super().__init__()
        if pooling not in ("sum", "mean"):
            raise ValueError(f"pooling must be 'sum' or 'mean', got "
                             f"{pooling!r}")
        if bag_impl not in BAG_IMPLS:
            raise ValueError(f"bag_impl must be one of {BAG_IMPLS}, got "
                             f"{bag_impl!r}")
        self.pooling = pooling
        self.compute_dtype = compute_dtype
        self.bag_impl = bag_impl
        # drawn by weights.init_device_mode (flax's uniform(scale=0.01))
        self.table = nn.Parameter(torch.zeros(
            (vocab_size, dim), dtype=torch.float32,
            device=resolve_device(device)))

    def forward(self, hashed_ids: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        weights = mask.to(torch.float32)
        bag = embedding_bag if self.bag_impl == "kernel" else \
            embedding_bag_reference
        pooled = bag(self.table, hashed_ids, weights)
        if self.pooling == "mean":
            pooled = pooled / mask.sum(dim=1, keepdim=True).clamp_min(1)
        return pooled.to(self.compute_dtype)


class DeviceEmbeddingCollection(nn.Module):
    """All slots' tables, giving the tower's list of embeddings.

    ``slot_specs`` is a sequence of (name, vocab_size, dim); the child of
    slot ``name`` is ``bag_{name}``. ``forward`` takes a dict name ->
    (bs, sfs) integer id tensor where ids <= 0 are padding: ``mask = ids >
    0`` and ``hashed = ((ids % (vocab - 1)) + 1) * mask`` in int32, so
    row 0 is only ever read with weight 0. With ``bag_impl="kernel"`` the
    slots of each embedding dim go through one K1 call (hash fused in;
    its plain version on the CPU) and the outputs are views of its (bs,
    slots, dim) result; ``"reference"`` runs the plain per-slot path on
    any device.
    """

    def __init__(self, slot_specs: Sequence[Any],
                 compute_dtype: torch.dtype = torch.bfloat16,
                 bag_impl: str = "kernel", device: DeviceLike = None):
        super().__init__()
        self.slot_specs = [tuple(s) for s in slot_specs]
        self.compute_dtype = compute_dtype
        self.bag_impl = bag_impl
        for name, vocab, dim in self.slot_specs:
            if vocab < 2:
                raise ValueError(f"slot {name}: vocab {vocab} leaves no row "
                                 f"beside the padding row 0")
            self.add_module(f"bag_{name}", DeviceEmbeddingBag(
                vocab, dim, compute_dtype=compute_dtype, bag_impl=bag_impl,
                device=device))
        # slot positions grouped by embedding dim, in order of appearance,
        # with their names and bags (a plain list: the children stay the
        # registered bag_{name} modules)
        groups: Dict[int, List[int]] = {}
        for i, (_, _, dim) in enumerate(self.slot_specs):
            groups.setdefault(dim, []).append(i)
        self._groups = [
            (group, [self.slot_specs[i][0] for i in group],
             [getattr(self, f"bag_{self.slot_specs[i][0]}") for i in group])
            for group in groups.values()]

    def forward(self, id_tensors: Dict[str, torch.Tensor]
                ) -> List[torch.Tensor]:
        if self.bag_impl == "reference":
            return [getattr(self, f"bag_{name}")(
                *hash_ids(id_tensors[name], vocab))
                for name, vocab, _ in self.slot_specs]
        dtype = self.compute_dtype
        kernel_dtype = dtype if dtype in SLOT_DTYPES else torch.float32
        out: List[torch.Tensor] = [None] * len(self.slot_specs)
        for group, names, bags in self._groups:
            pooled = embedding_bag_slots([bag.table for bag in bags],
                                         [id_tensors[n] for n in names],
                                         kernel_dtype)
            if kernel_dtype != dtype:
                pooled = pooled.to(dtype)
            for i, emb in zip(group, pooled.unbind(1)):
                out[i] = emb
        return out
