"""Device-resident hashed embedding tables (``persia_tpu/parallel/
device_embedding.py``): the sparse half of device mode.

The sign space is hashed into a fixed-vocab table that lives in the
card's memory and trains with the dense tower's optimizer; no parameter
server is involved. The pooled lookup is the embedding-bag kernel K1
(:mod:`persia_tpu_torch.ops.embedding_bag`): the collection pools all
its slots of one embedding dim, hash and mask included, in one launch
(:func:`~persia_tpu_torch.ops.embedding_bag.embedding_bag_slots`), and a
lone :class:`DeviceEmbeddingBag` takes K1's single-table entry.

Over a mesh whose ``model`` axis has m > 1 ranks (``shard_``, which
``make_device_mode_trainer(mesh=)`` calls), every table is row-sharded
as the JAX package declares it (``nn.with_partitioning(..., (MODEL_AXIS,
None))``): a rank holds only its contiguous ``V / m`` rows
(``parallel/mesh.table_window``), the same rows on every rank of the
data axis. A lookup pools this rank's rows through K1's shard window
(ids hashed over the global vocab, rows outside the window left out) into
an f32 partial, sums the partials over the model axis
(``collectives.sum_partials``, whose backward is the identity) and only
then casts to ``compute_dtype``, so that bf16 is rounded once, as in the
unsharded lookup. A model axis of 1 keeps the unsharded path.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

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
from persia_tpu_torch.parallel.collectives import sum_partials

BAG_IMPLS = ("kernel", "reference")


class DeviceEmbeddingBag(nn.Module):
    """One hashed (vocab_size, dim) f32 table with sum or mean pooling.

    ``forward(hashed_ids, mask)`` takes (bs, sfs) ids in [0, vocab_size)
    and the (bs, sfs) validity mask, and returns the pooled (bs, dim)
    embedding in ``compute_dtype``. ``bag_impl="kernel"`` pools through
    K1 (its plain version on the CPU); ``"reference"`` runs the plain
    version on any device, so that a plain tower can be held against the
    kernel tower on the card.

    After :meth:`shard_` the table holds only the global rows from ``lo``
    on of the ``vocab_size``-row table, ``window = (lo, vocab_size)`` (K1's
    shard window), and ``forward`` sums the partial pools over the model
    axis's ``group`` before the mean and the cast.
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
        self.vocab_size = vocab_size
        # (lo, vocab_size) and the model axis's group, once sharded
        self.window: Optional[Tuple[int, int]] = None
        self.group = None
        # drawn by weights.init_device_mode (flax's uniform(scale=0.01))
        self.table = nn.Parameter(torch.zeros(
            (vocab_size, dim), dtype=torch.float32,
            device=resolve_device(device)))

    def shard_(self, lo: int, n: int, group) -> "DeviceEmbeddingBag":
        """Keep only the global rows ``[lo, lo + n)`` of the table (a new
        parameter: build the optimizer after this) and sum the partial
        pools over ``group``."""
        if self.window is not None:
            raise RuntimeError("this table is sharded already")
        self.table = nn.Parameter(self.table.detach()[lo:lo + n].clone())
        self.window, self.group = (lo, self.vocab_size), group
        return self

    def forward(self, hashed_ids: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
        weights = mask.to(torch.float32)
        bag = embedding_bag if self.bag_impl == "kernel" else \
            embedding_bag_reference
        pooled = bag(self.table, hashed_ids, weights, self.window)
        if self.group is not None:
            pooled = sum_partials(pooled, self.group)
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
    any device. :meth:`shard_` row-shards every table over a mesh's
    model axis (the module docstring).
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

    def shard_(self, mesh) -> "DeviceEmbeddingCollection":
        """Row-shard every table over ``mesh``'s model axis: each keeps
        this rank's rows (``table_window``; a vocab that does not divide the
        axis raises ``ValueError`` naming its slot, on every rank alike and
        before any table changes). A model axis of 1 changes nothing.
        Every rank of the mesh calls this."""
        from persia_tpu_torch.parallel.mesh import (
            MODEL_AXIS,
            axis_group,
            axis_size,
            table_window,
        )

        if axis_size(mesh, MODEL_AXIS) == 1:
            return self
        windows = [table_window(mesh, vocab, f"slot {name}")
                   for name, vocab, _ in self.slot_specs]
        group = axis_group(mesh, MODEL_AXIS)
        for (name, _, _), (lo, n) in zip(self.slot_specs, windows):
            getattr(self, f"bag_{name}").shard_(lo, n, group)
        return self

    def forward(self, id_tensors: Dict[str, torch.Tensor]
                ) -> List[torch.Tensor]:
        if self.bag_impl == "reference":
            return [getattr(self, f"bag_{name}")(
                *hash_ids(id_tensors[name], vocab))
                for name, vocab, _ in self.slot_specs]
        dtype = self.compute_dtype
        out: List[torch.Tensor] = [None] * len(self.slot_specs)
        for group, names, bags in self._groups:
            model_group = bags[0].group  # shard_ shards every table or none
            # the shards' partials stay f32 until their sum: bf16 rounds once
            kernel_dtype = (dtype if dtype in SLOT_DTYPES and model_group is
                            None else torch.float32)
            pooled = embedding_bag_slots(
                [bag.table for bag in bags], [id_tensors[n] for n in names],
                kernel_dtype,
                None if model_group is None else [bag.window for bag in bags])
            if model_group is not None:
                pooled = sum_partials(pooled, model_group)
            if kernel_dtype != dtype:
                pooled = pooled.to(dtype)
            for i, emb in zip(group, pooled.unbind(1)):
                out[i] = emb
        return out
