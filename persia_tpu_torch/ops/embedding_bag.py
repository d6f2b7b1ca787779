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
  its ``torch.autograd.Function``, whose backward gives each table's
  gradient as those rows and their contributions (a sparse tensor whose
  dense form is the JAX package's scatter-add).

Shard windows. Every entry takes a ``window`` (``windows`` a slot):
``(lo, vocab)`` says the table holds the global rows ``[lo, lo + n)`` of
a ``vocab``-row table, ``n`` its own row count (device mode's tables
row-sharded over a mesh's model axis, ``parallel/mesh.table_window``).
Ids clip or hash over the global ``vocab``; a row outside the window
contributes nothing, a row inside reads local row ``row - lo``, and the
result is this shard's f32 partial sum, which the caller sums over the
shards. The rows buffer records each id's local row, or -1 outside the
window; a padding id reads global row 0 with weight 0, so it is local
row 0 on the shard holding row 0 and -1 elsewhere, and the backward
masks it by the window's ``lo`` (:func:`_first_real_row`), not by
``rows > 0`` (local row 0 of another shard is the real row ``lo``).
No window (``None``) is the whole table, ``(0, n)``: the unsharded call.

Each wrapper runs its plain version for CPU tensors, launches the kernel
for CUDA tensors or raises, and counts the kernel's launches.
"""

import ctypes
from array import array
from typing import List, Optional, Sequence, Tuple

import torch

from persia_tpu_torch import tracing
from persia_tpu_torch.ops import _build

KERNEL = "embedding_bag"  # K1; also the name of its CUDA source
# slots one launch pools (MAX_SLOTS of csrc/embedding_bag.cu: their
# descriptors travel in the kernel's 4 KB of parameters); more are split
# into several launches
MAX_SLOTS = 64
_DESC_WORDS = 9  # int64 words of one slot's descriptor
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


Window = Optional[Tuple[int, int]]  # (lo, global vocab); None: whole table


def _window(table: torch.Tensor, window: Window) -> Tuple[int, int]:
    """``(lo, vocab)`` of ``table`` under ``window``, checked: the table's
    rows lie inside the global vocab."""
    n = table.shape[0]
    if window is None:
        return 0, n
    lo, vocab = int(window[0]), int(window[1])
    if lo < 0 or lo + n > vocab:
        raise ValueError(f"window (lo={lo}, vocab={vocab}) does not hold a "
                         f"table of {n} rows")
    return lo, vocab


def local_rows(rows: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Global rows as a window's local rows: ``rows - lo`` inside
    ``[lo, lo + n)``, -1 outside (int32)."""
    local = (rows - lo).to(torch.int32)
    return torch.where((local >= 0) & (local < n), local, -1)


def _first_real_row(lo: int) -> int:
    """The least local row that the backward scatters into: 1 on the
    shard that holds the padding row 0 (``lo`` 0), else 0."""
    return 1 if lo == 0 else 0


def embedding_bag_reference(table: torch.Tensor, ids: torch.Tensor,
                            weights: torch.Tensor, window: Window = None
                            ) -> torch.Tensor:
    """K1's plain version: gather, weighted sum over the bag, f32
    (``xla_embedding_bag`` with K1's clipping rule); under ``window`` the
    sum over the ids whose clipped row lies in it."""
    lo, vocab = _window(table, window)
    rows = clip_ids(ids, vocab).long()
    weights = weights.float()
    if window is not None:
        rows = local_rows(rows, lo, table.shape[0]).long()
        weights = torch.where(rows >= 0, weights, 0.0)
        rows = rows.clamp_min(0)
    gathered = table.float()[rows]
    return (gathered * weights[..., None]).sum(dim=1)


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
                      weights: torch.Tensor, window: Window = None
                      ) -> torch.Tensor:
    """K1's wrapper on one table (or one shard's ``window`` of it): (B,
    D) f32. The plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (an f32 contiguous table; int32 or int64 ids and f32 weights
    are read as they are)."""
    _check(table, ids, weights)
    lo, vocab = _window(table, window)
    if table.device.type == "cpu":
        return embedding_bag_reference(table, ids, weights, window)
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise TypeError("K1 takes a contiguous f32 table")
    n, dim = table.shape
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
                       0, vocab, bag, ids.element_size(), lo, n))
    _launch(table.device, desc, 1, batch, dim, out, None, 1, 0, False)
    return out


class _EmbeddingBag(torch.autograd.Function):
    """Forward K1; backward the JAX package's ``_bwd`` at the clipped
    ids (under a window: only at the ids inside it, so ``d_table`` is the
    shard's gradient and ``d_weights`` its part of the weights'). The ids
    get no gradient."""

    @staticmethod
    def forward(ctx, table, ids, weights, window):
        ctx.save_for_backward(table, ids, weights)
        ctx.window = window
        return embedding_bag_fwd(table, ids, weights, window)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        lo, vocab = _window(table, ctx.window)
        rows = clip_ids(ids, vocab).long()
        w, inside = weights.to(g.dtype), None
        if ctx.window is not None:
            rows = local_rows(rows, lo, table.shape[0]).long()
            inside = rows >= 0
            w = torch.where(inside, w, 0.0)
            rows = rows.clamp_min(0)
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            contrib = g[:, None, :] * w[..., None]
            d_table = torch.zeros_like(table).index_add_(
                0, rows.reshape(-1),
                contrib.reshape(-1, table.shape[1]).to(table.dtype))
        if ctx.needs_input_grad[2]:
            d_weights = torch.einsum("bsd,bd->bs", table[rows].to(g.dtype),
                                     g)
            if inside is not None:
                d_weights = torch.where(inside, d_weights, 0.0)
            d_weights = d_weights.to(weights.dtype)
        return d_table, None, d_weights, None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, window: Window = None
                  ) -> torch.Tensor:
    """Pooled lookup, differentiable in ``table`` and ``weights``: (B, D)
    f32 through K1 on the card, its plain version on the CPU."""
    return _EmbeddingBag.apply(table, ids, weights, window)


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


def _slot_windows(tables, windows) -> List[Tuple[int, int]]:
    """Each table's checked ``(lo, vocab)``. One call's windows all start
    at row 0 or none does (a rank's shards of row-sharded tables share
    their place on the model axis), so that its padding row is on every
    table of the call or on none (:func:`_first_real_row`)."""
    if windows is None:
        return [(0, t.shape[0]) for t in tables]
    if len(windows) != len(tables):
        raise ValueError(f"expected one window per table, got "
                         f"{len(windows)} for {len(tables)}")
    wins = [_window(t, w) for t, w in zip(tables, windows)]
    if len({lo == 0 for lo, _ in wins}) > 1:
        raise ValueError("the windows of one call must all start at row 0, "
                         "or none of them")
    return wins


def embedding_bag_slots_reference(tables: Sequence[torch.Tensor],
                                  ids: Sequence[torch.Tensor],
                                  out_dtype: torch.dtype = torch.bfloat16,
                                  windows: Optional[Sequence[Window]] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The multi-slot entry's plain version: per slot the hash
    (:func:`hash_ids`, over the window's global vocab), the window's local
    rows, :func:`embedding_bag_reference` with the mask as weights (0
    outside the window), and the cast to ``out_dtype``. Returns ((B,
    slots, D) ``out_dtype``, the flat int32 local rows, -1 outside the
    window, slot-major)."""
    pooled, rows = [], []
    for table, slot_ids, (lo, vocab) in zip(tables, ids,
                                            _slot_windows(tables, windows)):
        r, mask = hash_ids(slot_ids, vocab)
        if (lo, vocab) != (0, table.shape[0]):
            r = local_rows(r, lo, table.shape[0])
            mask = mask & (r >= 0)
        pooled.append(embedding_bag_reference(table, r.clamp_min(0),
                                              mask.float()).to(out_dtype))
        rows.append(r.reshape(-1))
    return torch.stack(pooled, dim=1), torch.cat(rows)


_ID_SIZES = {torch.int32: 4, torch.int64: 8}  # the ids the kernel reads


def _check_slot(table, slot_ids, dim, batch, index, vocab
                ) -> Tuple[int, int]:
    """One slot's checks: a (rows, dim) table of a vocab >= 2 and (batch,
    S) integer ids on device ``index`` (``get_device()``: -1 for the
    CPU). Returns (S, the element size of the ids the kernel reads: 4, 8,
    or 0 for ids it needs as int64)."""
    try:
        _, table_dim = table.shape
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
    return bag, size


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
                            out_dtype: torch.dtype = torch.bfloat16,
                            windows: Optional[Sequence[Window]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's multi-slot wrapper: the raw (B, S_i) ids of every slot through
    the collection's hash into its (V_i, D) f32 table, or into the rows of
    its shard ``windows[i]`` (then the output is the shard's partial sum:
    pass f32 and cast after the sum over the shards). Returns ((B, slots,
    D) ``out_dtype``, the flat int32 local rows read, -1 outside the
    window, slot-major). The plain version for CPU tensors; for CUDA
    tensors one launch per :data:`MAX_SLOTS` slots."""
    _check_slots(tables, ids, out_dtype)
    device = tables[0].device
    dim, batch = tables[0].shape[-1], ids[0].shape[0]
    index = tables[0].get_device()
    wins = _slot_windows(tables, windows)
    if device.type == "cpu":
        for table, slot_ids, (_, vocab) in zip(tables, ids, wins):
            _check_slot(table, slot_ids, dim, batch, index, vocab)
        return embedding_bag_slots_reference(tables, ids, out_dtype, windows)
    # one pass checks each slot and packs its descriptor (the wrapper's
    # host time grows with the slots: keep it lean)
    words, keep, total = [], [], 0
    for table, slot_ids, (lo, vocab) in zip(tables, ids, wins):
        bag, size = _check_slot(table, slot_ids, dim, batch, index, vocab)
        if table.dtype != torch.float32 or not table.is_contiguous():
            raise TypeError("K1 takes contiguous f32 tables")
        if not size:
            slot_ids, size = slot_ids.to(torch.int64), 8
        if not slot_ids.is_contiguous():
            slot_ids = slot_ids.contiguous()
        keep.append(slot_ids)  # referenced until launched
        words += (table.data_ptr(), slot_ids.data_ptr(), 0, batch * total,
                  vocab, bag, size, lo, table.shape[0])
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
    scatter-add at the rows the forward read (no hash recomputed), left
    as rows: the cotangent times the mask for every slot in one op, then
    per slot an uncoalesced ``torch.sparse_coo_tensor`` of the table's
    (the shard's, under a window) shape whose entries are the slot's rows
    and their contributions, one an id, views of that one op's output (no
    copy, no sort, no size read back from the card). Its dense form
    (``to_dense()``) is the JAX package's dense ``d_table``; ``OptaxAdagrad``
    updates only its rows (:mod:`persia_tpu_torch.ops.rowwise_adagrad`).
    The mask keeps the rows from the first real one on
    (:func:`_first_real_row`: ``rows > 0`` on the shard that holds the
    padding row, ``rows >= 0`` on the others); a padding id or a row
    outside the window (-1) is an entry of zeros at row 0. The ids get no
    gradient. The backward is the
    span ``k1/table_grad``, a child of the span the forward ran under
    (saved with the rows: autograd may run the backward on a thread of
    its own), and no span when the forward ran under none."""

    @staticmethod
    def forward(ctx, out_dtype, windows, ids, *tables):
        pooled, rows = embedding_bag_slots_fwd(tables, ids, out_dtype,
                                               windows)
        ctx.save_for_backward(rows)
        ctx.span_ctx = tracing.current_context()
        ctx.batch = ids[0].shape[0]
        ctx.bags = [i.shape[1] for i in ids]
        ctx.table_shapes = [t.shape for t in tables]
        wins = _slot_windows(tables, windows)
        ctx.first = _first_real_row(wins[0][0])
        ctx.sharded = any(w != (0, t.shape[0]) for w, t in zip(wins, tables))
        return pooled

    @staticmethod
    def backward(ctx, g):
        with tracing.span("k1/table_grad", ctx=ctx.span_ctx):
            return _SlotBags._table_grads(ctx, g)

    @staticmethod
    def _table_grads(ctx, g):
        (rows,) = ctx.saved_tensors
        batch, bags = ctx.batch, ctx.bags
        dim = g.shape[2]
        # the rows are slot-major (slot, b, s): the (slot, b) row of the
        # cotangent repeated S times, times the mask, is every slot's
        # contribution at once (JAX's cotangent of gathered * mask, exact in
        # f32). An int repeat when the bags agree needs no tensor on the card
        reps = (bags[0] if len(set(bags)) == 1 else torch.tensor(
            bags, device=g.device).repeat_interleave(batch))
        sizes = [batch * bag for bag in bags]
        contrib = torch.empty((rows.numel(), dim), dtype=torch.float32,
                              device=g.device)
        torch.mul(g.transpose(0, 1).reshape(-1, dim).repeat_interleave(
            reps, dim=0, output_size=rows.numel()),
            (rows >= ctx.first).unsqueeze(-1), out=contrib)
        rows = rows.long()
        if ctx.sharded:  # rows outside a window (-1) add their zeros at 0
            rows.clamp_min_(0)
        # the sizes are the tables' own: no check reads the rows back
        d_tables = [
            torch.sparse_coo_tensor(r.unsqueeze(0), c, shape,
                                    check_invariants=False)
            if ctx.needs_input_grad[3 + i] else None
            for i, (shape, r, c) in enumerate(zip(
                ctx.table_shapes, rows.split(sizes), contrib.split(sizes)))]
        return (None, None, None, *d_tables)


def embedding_bag_slots(tables: Sequence[torch.Tensor],
                        ids: Sequence[torch.Tensor],
                        out_dtype: torch.dtype = torch.bfloat16,
                        windows: Optional[Sequence[Window]] = None
                        ) -> torch.Tensor:
    """Device mode's pooled lookup of every slot, differentiable in the
    tables: (B, slots, D) ``out_dtype`` through one K1 launch on the card
    (per :data:`MAX_SLOTS` slots), its plain version on the CPU; under
    ``windows`` each shard's partial sum."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _SlotBags.apply(out_dtype, windows, tuple(ids), *tables)
    return embedding_bag_slots_fwd(tables, ids, out_dtype, windows)[0]
