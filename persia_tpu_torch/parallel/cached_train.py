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

Over a mesh of ranks (``mesh=``) the cache is sharded as the JAX
module's GSPMD cache is (``_row_sharding``, ``P(("data", "model"))``):
every rank holds one contiguous block of the rows
(:func:`~persia_tpu_torch.parallel.mesh.cache_window`) and one row more,
its sink, where writes aimed at another rank's rows land (a sink row is
never read unmasked). Every rank steps the same global batch on the same
host plan. A rank reads only its own rows and contributes exact zeros
elsewhere, so the sum over the world (``collectives.sum_partials``) of
the rows a position is exact (one non-zero term) and equal on every
rank; bags are then summed locally, in the one-rank order. The dense
tower trains the rank's data-axis shard
(:func:`~persia_tpu_torch.parallel.mesh.shard_rows`, gradients averaged
over the data axis in f32). The gathered rows enter it through
``collectives.scatter_to_shards``, whose backward all-gathers the
cotangent; divided by the data-axis size it is the gradient of the
global batch's mean loss on every rank, and each rank updates its own
rows with it, so every row has one writer. As in JAX the result is the
unmeshed run's, not the hybrid DDP path's W-times embedding gradients,
for a tower without batch norm. A batch norm normalises with the shard's
statistics and its running buffers are averaged over the data axis after
the step, as in the uncached mesh step (not ``SyncBatchNorm``); JAX's
GSPMD step takes the global batch's statistics, so over a data axis
above 1 such a tower trains close to, not as, the unmeshed run. A batch
that does not divide the data axis runs whole on every rank.
"""

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.parallel import collectives as coll
from persia_tpu_torch.parallel.train import bce_loss


def init_cache_arrays(capacity: int, dim: int, acc_init: float,
                      device: DeviceLike = None, mesh=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(capacity + 1, dim) f32 value and accumulator tensors on
    ``device``; row ``capacity`` is the dummy slot that padded entries
    target (written, never read). Over a ``mesh`` this rank's block of
    the padded rows and its sink row: (n + 1, dim), ``(lo, n) =
    cache_window(mesh, capacity)``."""
    device = resolve_device(device)
    rows = capacity + 1
    if mesh is not None:
        from persia_tpu_torch.parallel.mesh import cache_window

        rows = cache_window(mesh, capacity)[1] + 1
    vals = torch.zeros((rows, dim), dtype=torch.float32, device=device)
    acc = torch.full((rows, dim), float(acc_init), dtype=torch.float32,
                     device=device)
    return vals, acc


class _Rows:
    """How a step addresses the cache tensors: the whole cache (one
    rank), or this rank's block ``(lo, n)`` of a cache sharded over the
    mesh's ranks, whose row ``n`` is the sink."""

    def __init__(self, mesh=None, capacity: int = 0):
        self.window = None
        if mesh is not None:
            from persia_tpu_torch.parallel.mesh import cache_window

            if not capacity:
                raise ValueError("a cache over a mesh needs its capacity")
            self.window = cache_window(mesh, capacity)

    def local(self, slots: torch.Tensor):
        """(the local rows of ``slots``, the sink where another rank owns
        the slot; the ownership mask, None for the whole cache)."""
        if self.window is None:
            return slots, None
        lo, n = self.window
        loc = slots - lo
        owned = (loc >= 0) & (loc < n)
        return torch.where(owned, loc, n), owned

    def read(self, t: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
        """``t``'s rows of ``slots``; exact zeros where another rank owns
        the slot."""
        rows, owned = self.local(slots)
        out = t.index_select(0, rows)
        if owned is None:
            return out
        return torch.where(owned[:, None], out, out.new_zeros(()))

    def gather(self, t: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
        """The rows of ``slots``, every rank's part summed over the world
        (exact: one rank owns each slot), on every rank."""
        out = self.read(t, slots)
        return out if self.window is None else coll.sum_partials(out, None)


class _DataAxis:
    """The dense tower's data parallelism over the mesh's data axis."""

    def __init__(self, model: nn.Module, mesh):
        from persia_tpu_torch.parallel.mesh import (
            DATA_AXIS,
            axis_group,
            axis_size,
        )
        from persia_tpu_torch.parallel.train import _dense_params

        self.mesh = mesh
        self.group = axis_group(mesh, DATA_AXIS)
        self.size = axis_size(mesh, DATA_AXIS)
        self.params = _dense_params(model)
        # batch norm's running buffers
        self.stats = [b for b in model.buffers() if b.is_floating_point()]

    def splits(self, rows: int) -> bool:
        return self.size > 1 and rows % self.size == 0


def _import_cold(rows: _Rows, cache_vals: torch.Tensor,
                 cache_acc: torch.Tensor, cold_idx: torch.Tensor,
                 cold_vals: torch.Tensor, cold_acc: torch.Tensor,
                 read_evicted: bool = True):
    """Read the rows being evicted BEFORE their slots are reused, as new
    tensors (the cache changes in place at every step), then write this
    batch's miss rows into their slots (pads all target the dummy row
    with the same values). Returns (evicted_vals, evicted_acc); over a
    mesh each rank's reads summed over the world, or (None, None) without
    ``read_evicted``."""
    evicted = (None, None)
    if read_evicted:
        evicted = tuple(rows.gather(t, cold_idx)
                        for t in (cache_vals, cache_acc))
    dst, _ = rows.local(cold_idx)
    cache_vals.index_copy_(0, dst, cold_vals)
    cache_acc.index_copy_(0, dst, cold_acc)
    return evicted


def _sparse_adagrad_update(rows: _Rows, cache_vals: torch.Tensor,
                           cache_acc: torch.Tensor,
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
    gradient; the weight bound clamps after the update. Over a mesh each
    rank updates the rows it owns (the others' land in its sink)."""
    valid = (unique_slots != dummy)[:, None]
    gsum_u = torch.zeros((inverse.shape[0], dim), dtype=torch.float32,
                         device=pos_grad.device).index_add_(0, inverse,
                                                            pos_grad)
    local, _ = rows.local(unique_slots)
    acc_u = cache_acc.index_select(0, local)
    new_val_u = (cache_vals.index_select(0, local)
                 - lr * gsum_u * torch.rsqrt(acc_u + eps))
    if weight_bound > 0:
        new_val_u = new_val_u.clamp(-weight_bound, weight_bound)
    new_acc_u = torch.where(
        valid, acc_u * g_square_momentum + gsum_u * gsum_u, acc_u)
    cache_vals.index_copy_(0, local, new_val_u)
    cache_acc.index_copy_(0, local, new_acc_u)


def _long(*idx: torch.Tensor):
    """Index tensors as int64, which every indexing op takes (the host
    ships int32, as the JAX steps take it)."""
    return tuple(t.long() for t in idx)


def _forward_backward(model: nn.Module, optimizer: torch.optim.Optimizer,
                      loss_fn: Callable, non_id_tensors, label,
                      gathered: torch.Tensor, emb_values_of: Callable,
                      data: Optional[_DataAxis] = None):
    """The dense forward, backward and optimizer step, differentiating
    through ``gathered`` too (a leaf; ``emb_values_of(g, local)`` maps it
    to the model's per-slot inputs, so any scaling reaches its gradient;
    ``local`` takes a batch-major tensor's rows of this rank). Over a
    mesh (``data``) the tower trains this rank's data-axis shard when the
    batch divides the axis, and the dense gradients are averaged over the
    axis; so are the loss and batch norm's running buffers, which took the
    shard's statistics. Returns (the global batch's loss, its predictions, gathered's
    gradient of that loss)."""
    from persia_tpu_torch.parallel.mesh import shard_rows

    gathered = gathered.detach().requires_grad_()
    model.train()
    optimizer.zero_grad(set_to_none=True)
    split = data is not None and data.splits(label.shape[0])
    inp, local = gathered, (lambda t: t)
    if split:
        non_id_tensors = [shard_rows(x, data.mesh) for x in non_id_tensors]
        label = shard_rows(label, data.mesh)
        inp = coll.scatter_to_shards(gathered, data.group, 0)

        def local(t):
            return shard_rows(t, data.mesh)

    pred = model(non_id_tensors, emb_values_of(inp, local))
    loss = loss_fn(pred, label)
    loss.backward()
    if data is not None and data.size > 1:
        from persia_tpu_torch.parallel.train import reduce_dense_grads

        reduce_dense_grads(data.params, data.group, data.size)
    optimizer.step()
    grad = (gathered.grad if gathered.grad is not None
            else torch.zeros_like(gathered))
    loss, pred = loss.detach(), pred.detach()
    if split:
        grad = grad / data.size
        # the loss and the running buffers in one reduction, as the
        # uncached mesh step shares them
        shared = torch.cat([loss.reshape(1).float()]
                           + [b.reshape(-1).float() for b in data.stats])
        coll.pmean_([shared], data.group)
        loss, pos = shared[0].to(loss.dtype), 1
        with torch.no_grad():
            for b in data.stats:
                b.copy_(shared[pos:pos + b.numel()].view_as(b))
                pos += b.numel()
        pred = coll.all_gather(pred, data.group, 0)
    return loss, pred, grad


def _mesh_parts(model, mesh, capacity):
    return _Rows(mesh, capacity), (None if mesh is None
                                   else _DataAxis(model, mesh))


def make_cached_train_step(model: nn.Module,
                           optimizer: torch.optim.Optimizer, num_slots: int,
                           dim: int, lr: float, eps: float,
                           g_square_momentum: float,
                           loss_fn: Callable = bce_loss,
                           weight_bound: float = 0.0,
                           capacity: int = 0, mesh=None) -> Callable:
    """``step(cache_vals, cache_acc, non_id, slot_idx, cold_idx, cold_vals,
    cold_acc, inverse, unique_slots, label, read_evicted=True) -> (loss,
    pred, evicted_vals, evicted_acc)``, the cache tensors updated in
    place:

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
      before the import; the host writes them back to the PS. Without
      ``read_evicted`` (no real eviction) they are not read: None.

    The single-id path: a pure gather feeds the model (see
    :func:`make_cached_bag_train_step` for bags). Over a ``mesh`` the
    cache tensors are this rank's block (module docstring) and every rank
    calls the step with the same inputs; ``capacity`` is then required."""
    rows, data = _mesh_parts(model, mesh, capacity)

    def step(cache_vals, cache_acc, non_id_tensors, slot_idx, cold_idx,
             cold_vals, cold_acc, inverse, unique_slots, label,
             read_evicted=True):
        slot_idx, cold_idx, inverse, unique_slots = _long(
            slot_idx, cold_idx, inverse, unique_slots)
        with torch.no_grad():
            evicted_vals, evicted_acc = _import_cold(
                rows, cache_vals, cache_acc, cold_idx, cold_vals, cold_acc,
                read_evicted)
            gathered = rows.gather(
                cache_vals, slot_idx.reshape(-1)).reshape(slot_idx.shape[0],
                                                          num_slots, dim)
        loss, pred, emb_grad = _forward_backward(
            model, optimizer, loss_fn, non_id_tensors, label, gathered,
            lambda g, local: [g[:, i, :] for i in range(num_slots)], data)
        dummy = capacity if capacity else cache_vals.shape[0] - 1
        with torch.no_grad():
            _sparse_adagrad_update(
                rows, cache_vals, cache_acc, unique_slots, inverse,
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
                               capacity: int = 0, mesh=None) -> Callable:
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
    unique_slots (Lpad,), label, read_evicted=True)`` -> as the single-id
    step. Pad positions carry ``seg == B*S`` (a trash bag row) and the
    dummy slot, inert in both directions. Over a ``mesh`` as the
    single-id step."""
    rows, data = _mesh_parts(model, mesh, capacity)

    def step(cache_vals, cache_acc, non_id_tensors, flat_slot_idx, seg,
             scale, cold_idx, cold_vals, cold_acc, inverse, unique_slots,
             label, read_evicted=True):
        batch = label.shape[0]
        flat_slot_idx, seg, cold_idx, inverse, unique_slots = _long(
            flat_slot_idx, seg, cold_idx, inverse, unique_slots)
        with torch.no_grad():
            evicted_vals, evicted_acc = _import_cold(
                rows, cache_vals, cache_acc, cold_idx, cold_vals, cold_acc,
                read_evicted)
            pos_rows = rows.gather(cache_vals, flat_slot_idx)  # (Lpad, D)
            bags = torch.zeros((batch * num_slots + 1, dim),
                               dtype=torch.float32,
                               device=pos_rows.device).index_add_(
                                   0, seg, pos_rows)
            gathered = bags[:batch * num_slots].reshape(batch, num_slots,
                                                        dim)

        def emb_values_of(g, local):
            scaled = g * local(scale)[:, :, None]
            return [scaled[:, i, :] for i in range(num_slots)]

        loss, pred, bag_grad = _forward_backward(
            model, optimizer, loss_fn, non_id_tensors, label, gathered,
            emb_values_of, data)
        dummy = capacity if capacity else cache_vals.shape[0] - 1
        with torch.no_grad():
            # pad positions (seg == B*S) read the zero trash row
            gpad = torch.cat([bag_grad.reshape(-1, dim),
                              bag_grad.new_zeros((1, dim))])
            pos_grad = gpad.index_select(0, seg)  # (Lpad, D)
            _sparse_adagrad_update(
                rows, cache_vals, cache_acc, unique_slots, inverse, pos_grad,
                dummy, dim, lr, eps, g_square_momentum, weight_bound)
        return loss, pred, evicted_vals, evicted_acc

    return step


def make_cached_eval_step(model: nn.Module, num_slots: int, mesh=None,
                          capacity: int = 0) -> Callable:
    """``step(cache_vals, non_id, slot_idx) -> pred``: a gather and an
    eval-mode forward for signs all resident in the cache; over a
    ``mesh`` the partial gather summed over the world, then the whole
    batch on every rank."""
    rows = _Rows(mesh, capacity)

    def step(cache_vals, non_id_tensors, slot_idx):
        slot_idx, = _long(slot_idx)
        model.eval()
        with torch.inference_mode():
            gathered = rows.gather(
                cache_vals, slot_idx.reshape(-1)).reshape(slot_idx.shape[0],
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
