"""Wide & Deep (``persia_tpu/models/wide_deep.py``): one linear layer
(wide) and an MLP with its own head (deep) over the dense features and
the flattened embeddings; the two logits add in the compute dtype.

The constructor takes ``num_dense`` (the non-id tensors' total width)
and ``slot_dims`` (each embedding input's dim). flax's names are the
explicit ``wide`` and ``deep_head`` beside the automatic ``MLP_0``.
"""

from typing import Any, Sequence

import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.models.common import MLP, dense, flatten_embeddings


class WideAndDeep(nn.Module):
    def __init__(self, num_dense: int, slot_dims: Sequence[int],
                 deep_mlp: Sequence[int] = (256, 128, 64),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        width = num_dense + sum(slot_dims)
        self.wide = nn.Linear(width, 1, device=device)
        self.MLP_0 = MLP(width, deep_mlp, compute_dtype=compute_dtype,
                         device=device)
        self.deep_head = nn.Linear(tuple(deep_mlp)[-1], 1, device=device)

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                embedding_tensors: Sequence[Any]) -> torch.Tensor:
        dt = self.compute_dtype
        parts = [t.to(dt) for t in non_id_tensors]
        parts.append(flatten_embeddings(embedding_tensors).to(dt))
        x = torch.cat(parts, dim=1)
        wide = dense(self.wide, x, dt)
        deep = dense(self.deep_head, self.MLP_0(x), dt)
        return torch.sigmoid((wide + deep).float())
