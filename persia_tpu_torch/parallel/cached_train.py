"""The device cache's train steps (``persia_tpu/parallel/cached_train.py``).

One step does, on the device: import this batch's miss rows into their
slots (reading back the rows they evict first, for the host's write-back
to the PS), gather the batch's rows, the dense forward, backward and
optimizer step, and the sparse Adagrad update of the cached rows in
place. Only miss rows and slot indices cross the host <-> device wire.

The JAX package compiles this as one program over donated arrays; here it
is eager PyTorch and the cache tensors are updated in place. The gathered
rows are a detached leaf with ``requires_grad``, so autograd gives the
dense gradients and the embedding gradient; the sparse update runs under
``no_grad``. Gathers and scatters are ``index_select``, ``index_add_``
and ``index_copy_``, as the JAX steps are XLA gathers and scatters (no
hand-written kernel). On CUDA ``index_add_`` sums with atomics, so the
dedup-sum and the bags' segment-sum are not bit-reproducible there.

The sparse update mirrors the PS's non-shared Adagrad
(:class:`persia_tpu_torch.ps.optim.SparseAdagrad`): the step uses the
accumulator from before this batch's gradient, duplicate signs of a
batch contribute one summed gradient (the middleware's dedup and sum),
rows without a gradient keep their accumulator, and the weight bound
clamps after the update.

The JAX module's GSPMD row sharding of the cache over a mesh
(``_row_sharding``, ``_constrain_rows``) is a single controller's layout
over many devices; the port has no such mode (a rank is a process) and
leaves it out.
"""

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.parallel.train import bce_loss


def init_cache_arrays(capacity: int, dim: int, acc_init: float,
                      device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(capacity + 1, dim) f32 value and accumulator tensors on
    ``device``; row ``capacity`` is the dummy slot that padded entries
    target (written, never read)."""
    device = resolve_device(device)
    vals = torch.zeros((capacity + 1, dim), dtype=torch.float32,
                       device=device)
    acc = torch.full((capacity + 1, dim), float(acc_init),
                     dtype=torch.float32, device=device)
    return vals, acc


def _import_cold(cache_vals: torch.Tensor, cache_acc: torch.Tensor,
                 cold_idx: torch.Tensor, cold_vals: torch.Tensor,
                 cold_acc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read the rows being evicted BEFORE their slots are reused, as new
    tensors (the cache changes in place at every step), then write this
    batch's miss rows into their slots (pads all target the dummy row
    with the same values). Returns (evicted_vals, evicted_acc)."""
    evicted_vals = cache_vals.index_select(0, cold_idx)
    evicted_acc = cache_acc.index_select(0, cold_idx)
    cache_vals.index_copy_(0, cold_idx, cold_vals)
    cache_acc.index_copy_(0, cold_idx, cold_acc)
    return evicted_vals, evicted_acc


def _sparse_adagrad_update(cache_vals: torch.Tensor, cache_acc: torch.Tensor,
                           unique_slots: torch.Tensor, inverse: torch.Tensor,
                           pos_grad: torch.Tensor, dummy: int, dim: int,
                           lr: float, eps: float, g_square_momentum: float,
                           weight_bound: float):
    """Sparse Adagrad on the cache in place, touching only this batch's
    rows and allocating only batch-sized buffers: per-position gradients
    dedup-sum through ``inverse`` into an (L, D) buffer (never a dense
    (capacity, D) one), one optimizer row per distinct sign, written
    back by ``index_copy_``. Pad rows carry zero gradients and write the
    dummy row's unchanged value; untouched rows are neither read nor
    written. The step reads the accumulator from before this batch's
    gradient; the weight bound clamps after the update."""
    valid = (unique_slots != dummy)[:, None]
    gsum_u = torch.zeros((inverse.shape[0], dim), dtype=torch.float32,
                         device=pos_grad.device).index_add_(0, inverse,
                                                            pos_grad)
    acc_u = cache_acc.index_select(0, unique_slots)
    new_val_u = (cache_vals.index_select(0, unique_slots)
                 - lr * gsum_u * torch.rsqrt(acc_u + eps))
    if weight_bound > 0:
        new_val_u = new_val_u.clamp(-weight_bound, weight_bound)
    new_acc_u = torch.where(
        valid, acc_u * g_square_momentum + gsum_u * gsum_u, acc_u)
    cache_vals.index_copy_(0, unique_slots, new_val_u)
    cache_acc.index_copy_(0, unique_slots, new_acc_u)


def _long(*idx: torch.Tensor):
    """Index tensors as int64, which every indexing op takes (the host
    ships int32, as the JAX steps take it)."""
    return tuple(t.long() for t in idx)


def _forward_backward(model: nn.Module, optimizer: torch.optim.Optimizer,
                      loss_fn: Callable, non_id_tensors, label,
                      gathered: torch.Tensor, emb_values_of: Callable):
    """The dense forward, backward and optimizer step, differentiating
    through ``gathered`` too (a leaf; ``emb_values_of`` maps it to the
    model's per-slot inputs, so any scaling reaches its gradient). Returns
    (loss, pred, gathered's gradient)."""
    gathered = gathered.detach().requires_grad_()
    model.train()
    optimizer.zero_grad(set_to_none=True)
    pred = model(non_id_tensors, emb_values_of(gathered))
    loss = loss_fn(pred, label)
    loss.backward()
    optimizer.step()
    grad = (gathered.grad if gathered.grad is not None
            else torch.zeros_like(gathered))
    return loss.detach(), pred.detach(), grad


def make_cached_train_step(model: nn.Module,
                           optimizer: torch.optim.Optimizer, num_slots: int,
                           dim: int, lr: float, eps: float,
                           g_square_momentum: float,
                           loss_fn: Callable = bce_loss,
                           weight_bound: float = 0.0,
                           capacity: int = 0) -> Callable:
    """``step(cache_vals, cache_acc, non_id, slot_idx, cold_idx, cold_vals,
    cold_acc, inverse, unique_slots, label) -> (loss, pred, evicted_vals,
    evicted_acc)``, the cache tensors updated in place:

    - slot_idx: (B, S) int — cache slot per (sample, slot) position;
    - cold_idx: (M,) int — slots receiving this batch's miss rows
      (padded entries point at the dummy slot);
    - cold_vals / cold_acc: (M, D) — the miss rows and their Adagrad
      state, from the PS or the victim buffer;
    - inverse: (B*S,) int — position -> index among the batch's distinct
      signs;
    - unique_slots: (B*S,) int — distinct index -> slot, the tail past the
      distinct count padded with the dummy slot;
    - evicted_vals / evicted_acc: (M, D) — what ``cold_idx``'s slots held
      before the import; the host writes them back to the PS.

    The single-id path: a pure gather feeds the model (see
    :func:`make_cached_bag_train_step` for bags)."""

    def step(cache_vals, cache_acc, non_id_tensors, slot_idx, cold_idx,
             cold_vals, cold_acc, inverse, unique_slots, label):
        slot_idx, cold_idx, inverse, unique_slots = _long(
            slot_idx, cold_idx, inverse, unique_slots)
        with torch.no_grad():
            evicted_vals, evicted_acc = _import_cold(
                cache_vals, cache_acc, cold_idx, cold_vals, cold_acc)
            gathered = cache_vals.index_select(
                0, slot_idx.reshape(-1)).reshape(slot_idx.shape[0],
                                                 num_slots, dim)
        loss, pred, emb_grad = _forward_backward(
            model, optimizer, loss_fn, non_id_tensors, label, gathered,
            lambda g: [g[:, i, :] for i in range(num_slots)])
        dummy = capacity if capacity else cache_vals.shape[0] - 1
        with torch.no_grad():
            _sparse_adagrad_update(
                cache_vals, cache_acc, unique_slots, inverse,
                emb_grad.reshape(-1, dim), dummy, dim, lr, eps,
                g_square_momentum, weight_bound)
        return loss, pred, evicted_vals, evicted_acc

    return step


def make_cached_bag_train_step(model: nn.Module,
                               optimizer: torch.optim.Optimizer,
                               num_slots: int, dim: int, lr: float,
                               eps: float, g_square_momentum: float,
                               loss_fn: Callable = bce_loss,
                               weight_bound: float = 0.0,
                               capacity: int = 0) -> Callable:
    """The multi-id (bag) variant of :func:`make_cached_train_step`.

    Every slot is a summed bag of any length; the host flattens all
    (sample, slot) bags into one position list (length L, bucket-padded
    to Lpad) with a segment id a position. On the device:

    - rows are gathered a position and segment-summed into the
      per-(sample, slot) bags, the middleware's segment sum;
    - ``scale`` (B, S) applies ``sqrt_scaling`` (1/sqrt(bag size)) inside
      the loss, so autograd routes the same scaling into the gradients
      (the middleware's gradient aggregation);
    - the bag gradients are read back a position through the segment map
      and dedup-summed a distinct sign through ``inverse``: a sign twice
      in one bag contributes twice.

    ``step(cache_vals, cache_acc, non_id, flat_slot_idx (Lpad,), seg
    (Lpad,), scale (B, S), cold_idx, cold_vals, cold_acc, inverse (Lpad,),
    unique_slots (Lpad,), label)`` -> as the single-id step. Pad
    positions carry ``seg == B*S`` (a trash bag row) and the dummy slot,
    inert in both directions."""

    def step(cache_vals, cache_acc, non_id_tensors, flat_slot_idx, seg,
             scale, cold_idx, cold_vals, cold_acc, inverse, unique_slots,
             label):
        batch = label.shape[0]
        flat_slot_idx, seg, cold_idx, inverse, unique_slots = _long(
            flat_slot_idx, seg, cold_idx, inverse, unique_slots)
        with torch.no_grad():
            evicted_vals, evicted_acc = _import_cold(
                cache_vals, cache_acc, cold_idx, cold_vals, cold_acc)
            rows = cache_vals.index_select(0, flat_slot_idx)  # (Lpad, D)
            bags = torch.zeros((batch * num_slots + 1, dim),
                               dtype=torch.float32,
                               device=rows.device).index_add_(0, seg, rows)
            gathered = bags[:batch * num_slots].reshape(batch, num_slots,
                                                        dim)

        def emb_values_of(g):
            scaled = g * scale[:, :, None]
            return [scaled[:, i, :] for i in range(num_slots)]

        loss, pred, bag_grad = _forward_backward(
            model, optimizer, loss_fn, non_id_tensors, label, gathered,
            emb_values_of)
        dummy = capacity if capacity else cache_vals.shape[0] - 1
        with torch.no_grad():
            # pad positions (seg == B*S) read the zero trash row
            gpad = torch.cat([bag_grad.reshape(-1, dim),
                              bag_grad.new_zeros((1, dim))])
            pos_grad = gpad.index_select(0, seg)  # (Lpad, D)
            _sparse_adagrad_update(
                cache_vals, cache_acc, unique_slots, inverse, pos_grad,
                dummy, dim, lr, eps, g_square_momentum, weight_bound)
        return loss, pred, evicted_vals, evicted_acc

    return step


def make_cached_eval_step(model: nn.Module, num_slots: int) -> Callable:
    """``step(cache_vals, non_id, slot_idx) -> pred``: a gather and an
    eval-mode forward for signs all resident in the cache."""

    def step(cache_vals, non_id_tensors, slot_idx):
        slot_idx, = _long(slot_idx)
        model.eval()
        with torch.inference_mode():
            gathered = cache_vals.index_select(
                0, slot_idx.reshape(-1)).reshape(slot_idx.shape[0],
                                                 num_slots, -1)
            return model(non_id_tensors,
                         [gathered[:, i, :] for i in range(num_slots)])

    return step


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """A count padded up to the first bucket that holds it (beyond the
    last, to a multiple of it): the JAX steps compile once a bucket, and
    the port keeps the same padded shapes, so the two packages' inputs
    are byte-equal."""
    for b in buckets:
        if n <= b:
            return b
    return int(np.ceil(n / buckets[-1]) * buckets[-1])
