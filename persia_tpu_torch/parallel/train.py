"""The hybrid train step and the eval step (``persia_tpu/parallel/train.py``).

The JAX package compiles one program per step; PyTorch runs eagerly, so
the train step here is forward -> loss -> autograd backward -> dense
optimizer step, with the gradients of the embedding inputs taken as
ordinary outputs that the host routes back to the parameter servers.

It matches ``make_packed_train_step``: the embedding values of every slot
cross to the device as ONE flat array in the wire dtype (bf16 by default,
rounded to nearest even on the host) and become f32 there; their
gradients come back as ONE flat array in the wire dtype, which the host
unpacks to f32 per slot. Raw-slot index tensors travel beside it.

:func:`make_packed_train_step_ddp` is the explicit data-parallel step
over a mesh's data axis: every rank trains its own rows of the batch,
the dense gradients are averaged over the axis in f32, in bf16, or as
int8 codes with error feedback (:func:`_ef_int8_mean`), and the
embedding gradients leave batch-major, one block of rows a rank.
"""

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from persia_tpu_torch.parallel import collectives as coll

WIRE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def bce_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on sigmoid outputs, clipped at 1e-7 as the JAX
    package does (``nn.BCELoss`` clamps its logs at -100 instead)."""
    pred = pred.clamp(1e-7, 1.0 - 1e-7)
    return -torch.mean(label * torch.log(pred)
                       + (1.0 - label) * torch.log(1.0 - pred))


def split_embedding_inputs(embedding_inputs: Sequence[Any]
                           ) -> Tuple[List[Any], List[Optional[Any]]]:
    """Split mixed [array | (array, index)] inputs into float values and
    optional index tensors (None for summed slots)."""
    values, indices = [], []
    for e in embedding_inputs:
        if isinstance(e, (tuple, list)):
            values.append(e[0])
            indices.append(e[1])
        else:
            values.append(e)
            indices.append(None)
    return values, indices


def _rebuild_embedding_inputs(emb_values, emb_indices) -> List[Any]:
    return [v if idx is None else (v, idx)
            for v, idx in zip(emb_values, emb_indices)]


def pack_embedding_values(emb_values: Sequence[np.ndarray],
                          wire_dtype: torch.dtype) -> torch.Tensor:
    """Host-side pack for the single upload: every slot's values
    flattened, concatenated and cast to the wire dtype (a CPU tensor;
    torch's f32 -> bf16 cast rounds to nearest even, as ml_dtypes does)."""
    flat = np.concatenate(
        [np.ascontiguousarray(v, dtype=np.float32).ravel()
         for v in emb_values])
    return torch.from_numpy(flat).to(wire_dtype)


def unpack_embedding_grads(flat: torch.Tensor,
                           emb_shapes: Sequence[Tuple[int, ...]]
                           ) -> List[np.ndarray]:
    """Host-side unpack of the single gradient download: per-slot f32."""
    flat = flat.float().numpy()
    out, pos = [], 0
    for shape in emb_shapes:
        n = int(np.prod(shape))
        out.append(flat[pos:pos + n].reshape(shape))
        pos += n
    return out


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    emb_shapes: Sequence[Tuple[int, ...]],
                    loss_fn: Callable = bce_loss,
                    wire_dtype: torch.dtype = torch.bfloat16,
                    reduce_grads: Optional[Callable] = None) -> Callable:
    """``step(non_id, flat_emb, emb_indices, label) -> (loss, flat_grads,
    pred)``: the packed train step, ``loss_fn(pred, label)`` its loss.
    ``flat_emb`` is the wire array on the model's device; ``flat_grads``
    is the embedding gradients' wire array there. The dense parameters
    are updated in place by ``optimizer``; the model runs in train mode,
    so its batch-norm buffers take the batch's statistics during the
    forward (the JAX step's mutated ``batch_stats``). ``reduce_grads()``,
    when given, runs between the backward and the optimizer step."""
    sizes = [int(np.prod(s)) for s in emb_shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()

    def step(non_id_tensors, flat_emb, emb_indices, label):
        # each slot's values become an f32 leaf of its own (a copy, also
        # for an f32 wire) whose .grad is the embedding gradient
        emb_values = [
            flat_emb[offsets[i]:offsets[i + 1]].reshape(emb_shapes[i])
            .to(torch.float32, copy=True).requires_grad_()
            for i in range(len(emb_shapes))]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        pred = model(non_id_tensors,
                     _rebuild_embedding_inputs(emb_values, emb_indices))
        loss = loss_fn(pred, label)
        loss.backward()
        if reduce_grads is not None:
            reduce_grads()
        optimizer.step()
        # a slot the model does not read has zero gradient, as in JAX
        flat_grads = torch.cat(
            [(v.grad if v.grad is not None else torch.zeros_like(v))
             .reshape(-1) for v in emb_values]).to(wire_dtype)
        return loss.detach(), flat_grads, pred.detach()

    return step


def make_eval_step(model: nn.Module) -> Callable:
    """``step(non_id_tensors, emb_values, emb_indices) -> pred``: an
    eval-mode forward with autograd off."""

    def step(non_id_tensors, emb_values, emb_indices):
        model.eval()
        with torch.inference_mode():
            return model(non_id_tensors,
                         _rebuild_embedding_inputs(emb_values, emb_indices))

    return step


def pack_embedding_values_batch_major(emb_values: Sequence[np.ndarray],
                                      wire_dtype: torch.dtype
                                      ) -> torch.Tensor:
    """(batch, dim_i) summed-slot values -> one (batch, sum dims) CPU
    tensor in the wire dtype: the DDP step's wire, whose rows split over
    the data axis."""
    flat = np.concatenate([np.ascontiguousarray(v, dtype=np.float32)
                           for v in emb_values], axis=1)
    return torch.from_numpy(flat).to(wire_dtype)


def unpack_embedding_grads_batch_major(flat: torch.Tensor,
                                       slot_dims: Sequence[int]
                                       ) -> List[np.ndarray]:
    """(batch, sum dims) gradient wire -> per-slot (batch, dim_i) f32."""
    flat = flat.float().numpy()
    bounds = np.concatenate([[0], np.cumsum(slot_dims)]).astype(int)
    return [np.ascontiguousarray(flat[:, a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


# int8_ef quantization bucket: one f32 scale per this many elements (the
# scales are ~0.4% of the wire; one outlier layer no longer crushes every
# other layer's resolution)
_EF_BUCKET = 1024


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of ``x`` -> (int8 codes, f32 scale a row): the scale is the
    row's largest magnitude / 127 (at least 1e-30), codes round half to
    even and clip to [-127, 127]."""
    scale = torch.clamp_min(x.abs().amax(dim=1) / 127.0, 1e-30)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def _ef_int8_mean(p: torch.Tensor, group, world: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-phase int8-compressed mean of the f32 vector ``p`` (this
    rank's gradient plus its carried residual) over ``group``, as the JAX
    package computes it:

    1. ``p`` zero-padded to a multiple of ``world * _EF_BUCKET``, split
       into buckets of 1024 with one scale each, quantized to int8;
    2. ``all_to_all`` of the codes and of the scales: each rank receives
       every rank's copy of its own shard, dequantizes and averages in
       f32;
    3. the shard's mean requantized per bucket and ``all_gather``-ed back
       with its scales.

    Returns (mean, new residual), both f32 of p's shape. The residual is
    the stage-1 rounding error plus, on this rank's own shard, ``world``
    times the stage-2 error (error feedback re-injects both)."""
    n = p.shape[0]
    pad = (-n) % (world * _EF_BUCKET)
    flat = F.pad(p.float(), (0, pad))
    chunk = flat.shape[0] // world  # shard length, a multiple of the bucket
    nb_per = chunk // _EF_BUCKET
    buckets = flat.reshape(world * nb_per, _EF_BUCKET)
    q, scale = _quantize(buckets)
    err1 = (buckets - q.float() * scale[:, None]).reshape(-1)
    # recv[s] is rank s's int8 copy of this rank's shard, srecv[s] its
    # scales
    recv = coll.all_to_all(q.reshape(world, chunk), group, 0, 0)
    srecv = coll.all_to_all(scale.reshape(world, nb_per), group, 0, 0)
    deq = (recv.reshape(world, nb_per, _EF_BUCKET).float()
           * srecv[:, :, None])
    mb = (deq.sum(dim=0).reshape(chunk) / world).reshape(nb_per, _EF_BUCKET)
    q2, s2 = _quantize(mb)
    err2 = (mb - q2.float() * s2[:, None]).reshape(chunk) * world
    me = coll.rank(group)
    new_err = err1.clone()
    new_err[me * chunk:(me + 1) * chunk] += err2
    q2g = coll.all_gather(q2, group, 0)  # (world * nb_per, _EF_BUCKET)
    s2g = coll.all_gather(s2, group, 0)  # (world * nb_per,)
    mean = (q2g.float() * s2g[:, None]).reshape(-1)[:n]
    return mean, new_err[:n]


def _dense_params(model: nn.Module) -> List[torch.Tensor]:
    return [p for p in model.parameters() if p.requires_grad]


def init_ef_state(model: nn.Module, mesh) -> torch.Tensor:
    """The zero error-feedback residual of ``grad_reduce_dtype="int8_ef"``
    for this rank: one f32 vector of the dense parameter count on the
    mesh's device. Each data replica keeps its own (its own quantization
    error); it is never averaged."""
    from persia_tpu_torch.parallel.mesh import mesh_device

    n = sum(p.numel() for p in _dense_params(model))
    return torch.zeros(n, dtype=torch.float32, device=mesh_device(mesh))


GRAD_REDUCE_DTYPES = {None: None, "bf16": torch.bfloat16,
                      "int8_ef": "int8_ef"}


def grad_reduce_mode(grad_reduce_dtype):
    """The reduction ``grad_reduce_dtype`` names: a key of
    :data:`GRAD_REDUCE_DTYPES` (``TrainCtx``'s names) or one of its values
    (the step's, as the JAX step takes a dtype); anything else raises."""
    if grad_reduce_dtype in GRAD_REDUCE_DTYPES:
        return GRAD_REDUCE_DTYPES[grad_reduce_dtype]
    if grad_reduce_dtype is torch.bfloat16:
        return grad_reduce_dtype
    raise ValueError(f"grad_reduce_dtype must be one of "
                     f"{list(GRAD_REDUCE_DTYPES)} (or torch.bfloat16), got "
                     f"{grad_reduce_dtype!r}")


def reduce_dense_grads(params: Sequence[torch.Tensor], group, world: int,
                       grad_reduce_dtype=None,
                       ef_state: Optional[torch.Tensor] = None,
                       per_tensor: bool = False) -> Optional[torch.Tensor]:
    """Every parameter's ``.grad`` replaced by its mean over ``group``
    (``lax.pmean``) in one flat reduction: in f32, through a bf16 cast
    (cast, mean in bf16, back to f32) or by :func:`_ef_int8_mean` with the
    residual ``ef_state``. A parameter without a gradient counts as zeros.
    ``per_tensor`` averages each gradient in place in f32, one reduction a
    tensor and no flat copy (device mode's tables, gigabytes at bench
    width). Returns the new residual for int8_ef, else None."""
    if per_tensor:
        if grad_reduce_dtype is not None:
            raise ValueError("per_tensor reduces in f32 only")
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        coll.pmean_([p.grad for p in params], group)
        return None
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    new_ef = None
    if grad_reduce_dtype == "int8_ef":
        flat, new_ef = _ef_int8_mean(flat + ef_state, group, world)
    elif grad_reduce_dtype is not None:
        low = flat.to(grad_reduce_dtype)
        coll.pmean_([low], group)
        flat = low.float()
    else:
        coll.pmean_([flat], group)
    pos = 0
    for p in params:
        n = p.numel()
        p.grad = flat[pos:pos + n].view_as(p).to(p.dtype)
        pos += n
    return new_ef


def make_packed_train_step_ddp(model: nn.Module,
                               optimizer: torch.optim.Optimizer,
                               slot_dims: Sequence[int], mesh,
                               loss_fn: Callable = bce_loss,
                               wire_dtype: torch.dtype = torch.bfloat16,
                               grad_reduce_dtype=None) -> Callable:
    """The explicit data-parallel step over the mesh's data axis.

    ``step(non_id, flat_emb, label[, ef_state]) -> (loss, flat_grads,
    pred[, ef_state])`` takes THIS rank's rows: ``flat_emb`` the (rows,
    sum(slot_dims)) batch-major wire (every slot summed), ``non_id`` and
    ``label`` the same rows. Each rank's loss is the mean over its own
    rows. The dense gradients are averaged over the axis (f32,
    ``torch.bfloat16``, or ``"int8_ef"``, which takes and returns the
    residual from :func:`init_ef_state`), the loss is averaged, and batch
    norm's running buffers, which took this rank's batch statistics, are
    averaged over the axis after the forward (not ``SyncBatchNorm``).
    ``flat_grads`` are this rank's rows of the embedding gradients in the
    wire dtype: each is the gradient of its own rows' mean, so they are
    ``world`` times the single-device step's, as the JAX step's are.
    ``pred`` is this rank's rows."""
    from persia_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        axis_group,
        axis_size,
    )

    grad_reduce_dtype = grad_reduce_mode(grad_reduce_dtype)
    group = axis_group(mesh, DATA_AXIS)
    world = axis_size(mesh, DATA_AXIS)
    bounds = np.concatenate([[0], np.cumsum(slot_dims)]).astype(int).tolist()
    ef_mode = grad_reduce_dtype == "int8_ef"
    params = _dense_params(model)
    stats = [b for b in model.buffers() if b.is_floating_point()]

    def step(non_id_tensors, flat_emb, label, ef_state=None):
        emb_values = [
            flat_emb[:, bounds[i]:bounds[i + 1]]
            .to(torch.float32, copy=True).requires_grad_()
            for i in range(len(slot_dims))]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        pred = model(non_id_tensors, emb_values)
        loss = loss_fn(pred, label)
        loss.backward()
        new_ef = reduce_dense_grads(params, group, world, grad_reduce_dtype,
                                    ef_state)
        # the loss and the batch norms' running buffers in one reduction
        shared = torch.cat([loss.detach().reshape(1).float()]
                           + [b.reshape(-1).float() for b in stats])
        coll.pmean_([shared], group)
        pos = 1
        with torch.no_grad():
            for b in stats:
                b.copy_(shared[pos:pos + b.numel()].view_as(b))
                pos += b.numel()
        optimizer.step()
        flat_grads = torch.cat(
            [(v.grad if v.grad is not None else torch.zeros_like(v))
             for v in emb_values], dim=1).to(wire_dtype)
        out = (shared[0], flat_grads, pred.detach())
        return out + (new_ef,) if ef_mode else out

    return step
