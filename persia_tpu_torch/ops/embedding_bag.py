"""Embedding bag: the CUDA kernel K1 and its plain versions.

K1 (``csrc/embedding_bag.cu``) replaces the Pallas TPU kernel
``_packed_bag_kernel`` of ``persia_tpu/ops/embedding_bag.py`` (driven by
``pallas_embedding_bag_packed``), the hot op of device-mode sparse
training::

    out[b, :] = sum_s weights[b, s] * table[clip(ids[b, s]), :]

over a (V, D) f32 table, (B, S) integer ids and (B, S) weights (0 for
padding), giving (B, D) f32. The TPU kernel's 128-lane packing of the
table is TPU tiling only; here the table stays (V, D).

Out-of-range ids. They never occur on the device-mode path (ids are
hashed into [1, V - 1] and padding is masked to 0), but the JAX package's
two versions disagree on them: ``jnp.take`` (``xla_embedding_bag``) fills
NaN for an id >= V and wraps -1 to row V - 1, while the Pallas kernel
clips to [0, ceil(V/P)·P - 1] of its packed table, so an id >= V reads a
zero padding row when P = 128/D does not divide V, and -1 reads row 0.
The port clips every id to [0, V - 1], in the kernel and in the plain
version alike. That equals the Pallas kernel whenever P divides V, as it
does for every device-mode table (V = 2^20). The backward adds at the
clipped rows too, where the JAX package's ``_bwd`` scatters at the raw
ids (``.at[].add`` wraps -1 to row V - 1 and drops ids >= V).

Two entries share the kernel:

- :func:`embedding_bag_fwd`, the Pallas kernel's function on one table
  (clipped ids, any weights, f32 out), and :func:`embedding_bag`, its
  ``torch.autograd.Function`` whose backward is the JAX package's
  ``_bwd`` (XLA there, not Pallas; PyTorch ops here): a dense ``d_table``
  built by ``index_add_`` at the clipped ids, and ``d_weights`` only when
  the weights require grad;
- :func:`embedding_bag_slots_fwd`, device mode's whole collection in one
  launch: every slot's table and raw ids, with the collection's hash and
  mask (``DeviceEmbeddingCollection``) fused in, giving (B, slots, D) in
  bf16 (or f32) and the int32 rows read; :func:`embedding_bag_slots` is
  its ``torch.autograd.Function``, whose backward scatters at those rows.

Each wrapper runs its plain version for CPU tensors, launches the kernel
for CUDA tensors or raises, and counts the kernel's launches.
"""

import ctypes
from array import array
from typing import List, Optional, Sequence, Tuple

import torch

from persia_tpu_torch.ops import _build

KERNEL = "embedding_bag"  # K1; also the name of its CUDA source
# slots one launch pools (MAX_SLOTS of csrc/embedding_bag.cu: their
# descriptors travel in the kernel's 4 KB of parameters); more are split
# into several launches
MAX_SLOTS = 64
_DESC_WORDS = 7  # int64 words of one slot's descriptor
_P, _I = ctypes.c_void_p, ctypes.c_int
# persia_embedding_bag_slots(desc, n_slots, batch, dim, out, rows,
# out_cols, slot0, out_bf16, hash); the launcher appends the stream
_ARGS = [_P, _I, _I, _I, _P, _P, _I, _I, _I, _I]


def launch_count() -> int:
    """K1's launches since the last reset; the plain version never
    counts."""
    return _build.launch_count(KERNEL)


def reset_launch_count():
    _build.reset_launch_counts([KERNEL])


def clip_ids(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The port's rule for out-of-range ids: clip to [0, vocab - 1]."""
    return ids.clamp(0, vocab - 1)


def embedding_bag_reference(table: torch.Tensor, ids: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """K1's plain version: gather, weighted sum over the bag, f32
    (``xla_embedding_bag`` with K1's clipping rule)."""
    gathered = table.float()[clip_ids(ids, table.shape[0]).long()]
    return (gathered * weights.float()[..., None]).sum(dim=1)


def _check(table, ids, weights):
    if table.dim() != 2 or ids.dim() != 2 or weights.shape != ids.shape:
        raise ValueError(
            f"expected table (V, D), ids (B, S) and weights (B, S), got "
            f"{tuple(table.shape)}, {tuple(ids.shape)}, "
            f"{tuple(weights.shape)}")
    if table.shape[0] == 0:
        raise ValueError("the table has no rows")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise TypeError(f"ids must be integers, got {ids.dtype}")
    devices = {t.device for t in (table, ids, weights)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")


def _launch(device, desc: array, n_slots: int, batch: int, dim: int,
            out: torch.Tensor, rows: Optional[torch.Tensor], out_cols: int,
            slot0: int, hash_ids: bool):
    _build.launcher(KERNEL, KERNEL, "persia_embedding_bag_slots", _ARGS)(
        device, desc.buffer_info()[0], n_slots, batch, dim, out.data_ptr(),
        None if rows is None else rows.data_ptr(), out_cols, slot0,
        int(out.dtype == torch.bfloat16), int(hash_ids))


def _kernel_ids(ids: torch.Tensor) -> torch.Tensor:
    """ids as the kernel reads them: int32 or int64, contiguous."""
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    return ids.contiguous()


def embedding_bag_fwd(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """K1's wrapper on one table: (B, D) f32. The plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (an f32 contiguous table;
    int32 or int64 ids and f32 weights are read as they are)."""
    _check(table, ids, weights)
    if table.device.type == "cpu":
        return embedding_bag_reference(table, ids, weights)
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise TypeError("K1 takes a contiguous f32 table")
    vocab, dim = table.shape
    batch, bag = ids.shape
    if max(vocab, batch, bag, dim) > 2**31 - 1:
        raise ValueError("a dimension does not fit in int32")
    out = torch.empty((batch, dim), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    ids = _kernel_ids(ids)  # referenced until launched
    if weights.dtype != torch.float32:
        weights = weights.to(torch.float32)
    weights = weights.contiguous()
    desc = array("q", (table.data_ptr(), ids.data_ptr(), weights.data_ptr(),
                       0, vocab, bag, ids.element_size()))
    _launch(table.device, desc, 1, batch, dim, out, None, 1, 0, False)
    return out


class _EmbeddingBag(torch.autograd.Function):
    """Forward K1; backward the JAX package's ``_bwd`` at the clipped
    ids. The ids get no gradient."""

    @staticmethod
    def forward(ctx, table, ids, weights):
        ctx.save_for_backward(table, ids, weights)
        return embedding_bag_fwd(table, ids, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        rows = clip_ids(ids, table.shape[0]).long()
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            contrib = g[:, None, :] * weights.to(g.dtype)[..., None]
            d_table = torch.zeros_like(table).index_add_(
                0, rows.reshape(-1),
                contrib.reshape(-1, table.shape[1]).to(table.dtype))
        if ctx.needs_input_grad[2]:
            d_weights = torch.einsum("bsd,bd->bs", table[rows].to(g.dtype),
                                     g).to(weights.dtype)
        return d_table, None, d_weights


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Pooled lookup, differentiable in ``table`` and ``weights``: (B, D)
    f32 through K1 on the card, its plain version on the CPU."""
    return _EmbeddingBag.apply(table, ids, weights)


# --- device mode: every slot of the collection in one launch ----------------

SLOT_DTYPES = (torch.bfloat16, torch.float32)  # outputs the kernel writes


def hash_ids(ids: torch.Tensor, vocab: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The collection's hash and mask (``persia_tpu/parallel/
    device_embedding.py:72-73``): ``mask = ids > 0`` and ``rows = ((ids %
    (vocab - 1)) + 1) * mask`` in int32, so padding (0 or negative) reads
    row 0 and every row is in [0, vocab - 1]."""
    mask = ids > 0
    return ((ids % (vocab - 1)) + 1).to(torch.int32) * mask, mask


def slot_rows(rows: torch.Tensor, batch: int, bags: Sequence[int]
              ) -> List[torch.Tensor]:
    """The (B, bag) int32 views of each slot in the flat rows buffer of
    :func:`embedding_bag_slots_fwd` (slot-major)."""
    out, at = [], 0
    for bag in bags:
        out.append(rows[at:at + batch * bag].view(batch, bag))
        at += batch * bag
    return out


def embedding_bag_slots_reference(tables: Sequence[torch.Tensor],
                                  ids: Sequence[torch.Tensor],
                                  out_dtype: torch.dtype = torch.bfloat16
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The multi-slot entry's plain version: per slot the hash
    (:func:`hash_ids`), :func:`embedding_bag_reference` with the mask as
    weights, and the cast to ``out_dtype``. Returns ((B, slots, D)
    ``out_dtype``, the flat int32 rows, slot-major)."""
    pooled, rows = [], []
    for table, slot_ids in zip(tables, ids):
        r, mask = hash_ids(slot_ids, table.shape[0])
        pooled.append(embedding_bag_reference(table, r, mask.float())
                      .to(out_dtype))
        rows.append(r.reshape(-1))
    return torch.stack(pooled, dim=1), torch.cat(rows)


_ID_SIZES = {torch.int32: 4, torch.int64: 8}  # the ids the kernel reads


def _check_slot(table, slot_ids, dim, batch, index) -> Tuple[int, int, int]:
    """One slot's checks: a (V >= 2, dim) table and (batch, S) integer ids
    on device ``index`` (``get_device()``: -1 for the CPU). Returns (V, S,
    the element size of the ids the kernel reads: 4, 8, or 0 for ids it
    needs as int64)."""
    try:
        vocab, table_dim = table.shape
        slot_batch, bag = slot_ids.shape
    except ValueError:
        raise ValueError(f"expected a (V, D) table and (B, S) ids, got "
                         f"{tuple(table.shape)} and "
                         f"{tuple(slot_ids.shape)}") from None
    if table_dim != dim or slot_batch != batch:
        raise ValueError(f"expected tables of one D ({dim}) and ids of one "
                         f"B ({batch}), got {tuple(table.shape)} and "
                         f"{tuple(slot_ids.shape)}")
    if vocab < 2:
        raise ValueError("a hashed table needs a row beside the padding "
                         "row 0")
    size = _ID_SIZES.get(slot_ids.dtype, 0)
    if not size and (slot_ids.dtype.is_floating_point
                     or slot_ids.dtype == torch.bool):
        raise TypeError(f"ids must be integers, got {slot_ids.dtype}")
    if table.get_device() != index or slot_ids.get_device() != index:
        raise ValueError("inputs on several devices")
    return vocab, bag, size


def _check_slots(tables, ids, out_dtype):
    if len(tables) == 0 or len(tables) != len(ids):
        raise ValueError(f"expected one ids tensor per table and at least "
                         f"one, got {len(tables)} tables and {len(ids)} ids")
    if out_dtype not in SLOT_DTYPES:
        raise TypeError(f"the pooled output is bf16 or f32, got {out_dtype}")
    device = tables[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def embedding_bag_slots_fwd(tables: Sequence[torch.Tensor],
                            ids: Sequence[torch.Tensor],
                            out_dtype: torch.dtype = torch.bfloat16
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's multi-slot wrapper: the raw (B, S_i) ids of every slot through
    the collection's hash into its (V_i, D) f32 table. Returns ((B, slots,
    D) ``out_dtype``, the flat int32 rows read, slot-major). The plain
    version for CPU tensors; for CUDA tensors one launch per
    :data:`MAX_SLOTS` slots."""
    _check_slots(tables, ids, out_dtype)
    device = tables[0].device
    dim, batch = tables[0].shape[-1], ids[0].shape[0]
    index = tables[0].get_device()
    if device.type == "cpu":
        for table, slot_ids in zip(tables, ids):
            _check_slot(table, slot_ids, dim, batch, index)
        return embedding_bag_slots_reference(tables, ids, out_dtype)
    # one pass checks each slot and packs its descriptor (the wrapper's
    # host time grows with the slots: keep it lean)
    words, keep, total = [], [], 0
    for table, slot_ids in zip(tables, ids):
        vocab, bag, size = _check_slot(table, slot_ids, dim, batch, index)
        if table.dtype != torch.float32 or not table.is_contiguous():
            raise TypeError("K1 takes contiguous f32 tables")
        if not size:
            slot_ids, size = slot_ids.to(torch.int64), 8
        if not slot_ids.is_contiguous():
            slot_ids = slot_ids.contiguous()
        keep.append(slot_ids)  # referenced until launched
        words += (table.data_ptr(), slot_ids.data_ptr(), 0, batch * total,
                  vocab, bag, size)
        total += bag
    n = len(tables)
    if max(batch, dim, batch * total, *words[4::_DESC_WORDS]) > 2**31 - 1:
        raise ValueError("a dimension does not fit in int32")
    out = torch.empty((batch, n, dim), dtype=out_dtype, device=device)
    rows = torch.empty(batch * total, dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out, rows
    for start in range(0, n, MAX_SLOTS):
        part = array("q", words[start * _DESC_WORDS:
                                (start + MAX_SLOTS) * _DESC_WORDS])
        _launch(device, part, min(MAX_SLOTS, n - start), batch, dim, out,
                rows, n, start, True)
    return out, rows


class _SlotBags(torch.autograd.Function):
    """Forward :func:`embedding_bag_slots_fwd`; backward the JAX package's
    scatter-add at the rows the forward read (no hash recomputed): the
    cotangent times the mask for every slot in one op, then per slot a
    dense ``d_table`` by ``zeros`` and ``index_add_``. The ids get no
    gradient."""

    @staticmethod
    def forward(ctx, out_dtype, ids, *tables):
        pooled, rows = embedding_bag_slots_fwd(tables, ids, out_dtype)
        ctx.save_for_backward(rows)
        ctx.batch = ids[0].shape[0]
        ctx.bags = [i.shape[1] for i in ids]
        ctx.table_shapes = [t.shape for t in tables]
        return pooled

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        batch, bags = ctx.batch, ctx.bags
        dim = g.shape[2]
        # the rows are slot-major (slot, b, s): the (slot, b) row of the
        # cotangent repeated S times, times the mask, is every slot's
        # contribution at once (JAX's cotangent of gathered * mask, exact in
        # f32). An int repeat when the bags agree needs no tensor on the card
        reps = (bags[0] if len(set(bags)) == 1 else torch.tensor(
            bags, device=g.device).repeat_interleave(batch))
        contrib = torch.empty((rows.numel(), dim), dtype=torch.float32,
                              device=g.device)
        torch.mul(g.transpose(0, 1).reshape(-1, dim).repeat_interleave(
            reps, dim=0, output_size=rows.numel()), (rows > 0).unsqueeze(-1),
            out=contrib)
        sizes = [batch * bag for bag in bags]
        d_tables = [
            torch.zeros(shape, dtype=torch.float32, device=g.device)
            .index_add_(0, r, c) if ctx.needs_input_grad[2 + i] else None
            for i, (shape, r, c) in enumerate(zip(
                ctx.table_shapes, rows.split(sizes), contrib.split(sizes)))]
        return (None, None, *d_tables)


def embedding_bag_slots(tables: Sequence[torch.Tensor],
                        ids: Sequence[torch.Tensor],
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """Device mode's pooled lookup of every slot, differentiable in the
    tables: (B, slots, D) ``out_dtype`` through one K1 launch on the card
    (per :data:`MAX_SLOTS` slots), its plain version on the CPU."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _SlotBags.apply(out_dtype, tuple(ids), *tables)
    return embedding_bag_slots_fwd(tables, ids, out_dtype)[0]
