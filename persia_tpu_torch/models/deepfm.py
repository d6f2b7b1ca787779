"""DeepFM: factorization-machine interaction and a deep tower
(``persia_tpu/models/deepfm.py``).

The logit is the sum of a first-order term (one ``Dense`` over the
flattened field stack, plus one over the dense features when there are
any), the second-order FM term ``0.5 ((sum v)^2 - sum v^2)`` over the
(bs, F, d) field stack, and a deep MLP's head; each is computed in the
compute dtype and the three add in f32.

The constructor takes ``num_dense`` (the non-id tensors' total width; 0
when the batches carry none), ``num_fields`` and ``embedding_dim``.
flax's names: ``Dense_0`` (first order over the fields), ``Dense_1``
(first order over the dense features, only when ``num_dense > 0``),
``MLP_0``, then the deep head, ``Dense_2`` with dense features and
``Dense_1`` without.
"""

from typing import Any, Sequence

import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.models.common import MLP, dense, stack_field_embeddings


class DeepFM(nn.Module):
    def __init__(self, num_dense: int, num_fields: int,
                 embedding_dim: int = 16,
                 deep_mlp: Sequence[int] = (256, 128),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.num_dense = num_dense
        flat = num_fields * embedding_dim
        self.Dense_0 = nn.Linear(flat, 1, device=device)
        if num_dense:
            self.Dense_1 = nn.Linear(num_dense, 1, device=device)
        self.MLP_0 = MLP(flat + num_dense, deep_mlp,
                         compute_dtype=compute_dtype, device=device)
        self._head = f"Dense_{2 if num_dense else 1}"
        self.add_module(self._head,
                        nn.Linear(tuple(deep_mlp)[-1], 1, device=device))

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                embedding_tensors: Sequence[Any]) -> torch.Tensor:
        dt = self.compute_dtype
        fields = stack_field_embeddings(embedding_tensors).to(dt)
        bs = fields.shape[0]
        flat = fields.reshape(bs, -1)
        first = dense(self.Dense_0, flat, dt)
        deep_in = flat
        if non_id_tensors:  # as the JAX tower: dense features if given
            if not self.num_dense:
                raise ValueError("DeepFM(num_dense=0) was given dense "
                                 "features")
            dense_x = torch.cat([t.to(dt) for t in non_id_tensors], dim=1)
            first = first + dense(self.Dense_1, dense_x, dt)
            deep_in = torch.cat([flat, dense_x], dim=1)
        sum_v = fields.sum(dim=1)
        second = 0.5 * (sum_v * sum_v - (fields * fields).sum(dim=1))
        second = second.sum(dim=1, keepdim=True)
        deep = dense(getattr(self, self._head), self.MLP_0(deep_in), dt)
        return torch.sigmoid(first.float() + second.float() + deep.float())
