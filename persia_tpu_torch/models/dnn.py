"""The adult-income DNN tower (``persia_tpu/models/dnn.py``).

A sparse branch (the flattened embeddings through ``Dense`` and a batch
norm) and a dense branch (the dense features through ``Dense`` and a
batch norm) meet in a concatenation, then three linear layers and a
sigmoid. As in the JAX tower, each batch norm reads its ``Dense``'s
compute-dtype output cast to f32, the concatenation is f32 and is cast
back to the compute dtype, and no activation sits between the layers.

flax infers the input widths; a torch module is built with them:
``num_dense`` (the dense features' width) and ``slot_dims`` (each
embedding input's dim, in the batch's feature order). flax's auto-names
follow the order of creation: ``Dense_0`` (sparse), ``BatchNorm_0``,
``Dense_1`` (dense), ``BatchNorm_1``, ``Dense_2..4``.
"""

from typing import Any, Sequence

import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.models.common import (
    FlaxBatchNorm,
    dense,
    flatten_embeddings,
)


class DNN(nn.Module):
    def __init__(self, num_dense: int, slot_dims: Sequence[int],
                 dense_mlp_output_size: int = 16,
                 sparse_mlp_output_size: int = 128,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.Dense_0 = nn.Linear(sum(slot_dims), sparse_mlp_output_size,
                                 device=device)
        self.BatchNorm_0 = FlaxBatchNorm(sparse_mlp_output_size,
                                         device=device)
        self.Dense_1 = nn.Linear(num_dense, dense_mlp_output_size,
                                 device=device)
        self.BatchNorm_1 = FlaxBatchNorm(dense_mlp_output_size,
                                         device=device)
        widths = (sparse_mlp_output_size + dense_mlp_output_size, 256, 128, 1)
        for i in range(3):
            self.add_module(f"Dense_{i + 2}",
                            nn.Linear(widths[i], widths[i + 1],
                                      device=device))

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                embedding_tensors: Sequence[Any]) -> torch.Tensor:
        dt = self.compute_dtype
        dense_x = non_id_tensors[0].to(dt)
        sparse = dense(self.Dense_0, flatten_embeddings(embedding_tensors), dt)
        sparse = self.BatchNorm_0(sparse.float())
        dense_x = self.BatchNorm_1(dense(self.Dense_1, dense_x, dt).float())
        x = torch.cat([sparse, dense_x], dim=1).to(dt)
        for i in range(2, 5):
            x = dense(getattr(self, f"Dense_{i}"), x, dt)
        return torch.sigmoid(x.float())
