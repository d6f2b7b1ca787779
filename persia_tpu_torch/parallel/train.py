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
"""

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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
                    wire_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``step(non_id, flat_emb, emb_indices, label) -> (loss, flat_grads,
    pred)``: the packed train step, ``loss_fn(pred, label)`` its loss.
    ``flat_emb`` is the wire array on the model's device; ``flat_grads``
    is the embedding gradients' wire array there. The dense parameters
    are updated in place by ``optimizer``; the model runs in train mode,
    so its batch-norm buffers take the batch's statistics during the
    forward (the JAX step's mutated ``batch_stats``)."""
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
