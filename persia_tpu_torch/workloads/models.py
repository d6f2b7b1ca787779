"""Dense towers of the workload-zoo scenarios
(``persia_tpu/workloads/models.py``).

They share the port's calling convention, ``model(non_id_tensors,
embedding_tensors)``, and run on the same ``TrainCtx`` path as every
other tower; the zoo adds model shapes (mixed embedding dims,
worker-pooled session slots, multi-task heads), not a training path.
flax infers input widths; these modules take ``num_dense`` (the non-id
tensors' total width) and ``slot_dims`` (each embedding input's dim, in
the batch's feature order).
"""

from typing import Any, Sequence

import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.models.common import MLP, _pooled_fields, dense
from persia_tpu_torch.parallel.train import bce_loss


def _pooled(non_id_tensors, embedding_tensors, dt) -> torch.Tensor:
    """The non-id tensors and every embedding input as (bs, dim) in
    ``dt``, concatenated; a raw (emb, index) pair is mean-pooled on the
    device (the zoo's schemas pool on the worker)."""
    parts = [t.to(dt) for t in non_id_tensors]
    parts += [e.to(dt) for e in _pooled_fields(embedding_tensors)]
    return torch.cat(parts, dim=1)


class ZooDLRM(nn.Module):
    """DLRM over a mixed-dim schema: a field whose dim is not ``proj_dim``
    goes through its own ``Dense`` first (flax's name ``field_proj_{i}``,
    ``i`` the field's index), then the pairwise dots of DLRM. flax's
    names: ``MLP_0`` (bottom), the projections, ``MLP_1`` (top)."""

    def __init__(self, num_dense: int, slot_dims: Sequence[int],
                 proj_dim: int = 16, bottom_mlp: Sequence[int] = (64, 32),
                 top_mlp: Sequence[int] = (128, 64),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.slot_dims = tuple(slot_dims)
        self.proj_dim = proj_dim
        self.MLP_0 = MLP(num_dense, (*bottom_mlp, proj_dim),
                         compute_dtype=compute_dtype, device=device)
        for i, d in enumerate(self.slot_dims):
            if d != proj_dim:
                self.add_module(f"field_proj_{i}",
                                nn.Linear(d, proj_dim, device=device))
        f = len(self.slot_dims) + 1
        self.MLP_1 = MLP(proj_dim + f * (f - 1) // 2, (*top_mlp, 1),
                         final_activation=False, compute_dtype=compute_dtype,
                         device=device)
        iu, ju = torch.triu_indices(f, f, offset=1, device=device)
        self.register_buffer("_iu", iu, persistent=False)
        self.register_buffer("_ju", ju, persistent=False)

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                embedding_tensors: Sequence[Any]) -> torch.Tensor:
        dt = self.compute_dtype
        bottom = self.MLP_0(non_id_tensors[0].to(dt))
        fields = []
        for i, x in enumerate(_pooled_fields(embedding_tensors)):
            x = x.to(dt)
            if x.shape[-1] != self.proj_dim:
                x = dense(getattr(self, f"field_proj_{i}"), x, dt)
            fields.append(x)
        t = torch.stack([bottom, *fields], dim=1)  # (bs, F+1, proj_dim)
        dots = torch.bmm(t, t.transpose(1, 2))
        top_in = torch.cat([bottom, dots[:, self._iu, self._ju]], dim=1)
        return torch.sigmoid(self.MLP_1(top_in).float())


class PooledSessionNet(nn.Module):
    """One MLP over the dense features and the worker-pooled slots
    (flax's name ``MLP_0``)."""

    def __init__(self, num_dense: int, slot_dims: Sequence[int],
                 mlp: Sequence[int] = (128, 64),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.MLP_0 = MLP(num_dense + sum(slot_dims), (*mlp, 1),
                         final_activation=False, compute_dtype=compute_dtype,
                         device=device)

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                embedding_tensors: Sequence[Any]) -> torch.Tensor:
        x = _pooled(non_id_tensors, embedding_tensors, self.compute_dtype)
        return torch.sigmoid(self.MLP_0(x).float())


class MultiTaskDNN(nn.Module):
    """A shared trunk (``MLP_0``) and one head per task (``head_{t}``),
    the predictions concatenated to (bs, num_tasks): the labels travel
    as one (bs, num_tasks) array through the single-label train path."""

    def __init__(self, num_dense: int, slot_dims: Sequence[int],
                 num_tasks: int = 2, bottom_mlp: Sequence[int] = (128, 64),
                 head_mlp: Sequence[int] = (32,),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.num_tasks = num_tasks
        self.MLP_0 = MLP(num_dense + sum(slot_dims), tuple(bottom_mlp),
                         compute_dtype=compute_dtype, device=device)
        for t in range(num_tasks):
            self.add_module(f"head_{t}", MLP(
                tuple(bottom_mlp)[-1], (*head_mlp, 1), final_activation=False,
                compute_dtype=compute_dtype, device=device))

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                embedding_tensors: Sequence[Any]) -> torch.Tensor:
        trunk = self.MLP_0(_pooled(non_id_tensors, embedding_tensors,
                                   self.compute_dtype))
        out = torch.cat([getattr(self, f"head_{t}")(trunk)
                         for t in range(self.num_tasks)], dim=1)
        return torch.sigmoid(out.float())


# Mean BCE over every task column, clipped at 1e-7 (the JAX package's
# ``multitask_bce`` is ``bce_loss``'s expression): the gradient reaching a
# shared embedding is the sum of the per-task gradients over num_tasks.
multitask_bce = bce_loss
