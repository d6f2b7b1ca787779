"""DLRM dense tower (``persia_tpu/models/dlrm.py``): bottom MLP, pairwise
dot interactions, top MLP.

flax infers layer widths from the first input; a torch module is built
with them, so the constructor takes ``num_dense`` (the dense features'
width) and ``num_fields`` (the embedding slots). The interaction stacks
the bottom MLP's output with the F field embeddings, takes every pairwise
dot product with one batched matmul and keeps the strict upper triangle
in row-major order (``jnp.triu_indices(F + 1, k=1)``), so the top MLP
reads ``embedding_dim + (F + 1) F / 2`` features. Batch norm stays off,
as in the JAX DLRM.

The fields are whatever the caller pools: the device tables' bags in
device mode, the worker's summed (bs, dim) slots on the hybrid
``TrainCtx`` path.
"""

from typing import Any, Sequence

import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.models.common import MLP, stack_field_embeddings


class DLRM(nn.Module):
    """Children ``MLP_0`` (bottom) and ``MLP_1`` (top), flax's names."""

    def __init__(self, num_dense: int, num_fields: int,
                 embedding_dim: int = 16,
                 bottom_mlp: Sequence[int] = (64, 32),
                 top_mlp: Sequence[int] = (256, 128),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.MLP_0 = MLP(num_dense, (*bottom_mlp, embedding_dim),
                         compute_dtype=compute_dtype, device=device)
        f = num_fields + 1  # the bottom MLP's output joins the fields
        self.MLP_1 = MLP(embedding_dim + f * (f - 1) // 2, (*top_mlp, 1),
                         final_activation=False, compute_dtype=compute_dtype,
                         device=device)
        iu, ju = torch.triu_indices(f, f, offset=1, device=device)
        self.register_buffer("_iu", iu, persistent=False)
        self.register_buffer("_ju", ju, persistent=False)

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                embedding_tensors: Sequence[Any]) -> torch.Tensor:
        dt = self.compute_dtype
        bottom = self.MLP_0(non_id_tensors[0].to(dt))
        fields = stack_field_embeddings(embedding_tensors).to(dt)
        t = torch.cat([bottom[:, None, :], fields], dim=1)  # (bs, F+1, d)
        dots = torch.bmm(t, t.transpose(1, 2))
        top_in = torch.cat([bottom, dots[:, self._iu, self._ju]], dim=1)
        return torch.sigmoid(self.MLP_1(top_in).float())
