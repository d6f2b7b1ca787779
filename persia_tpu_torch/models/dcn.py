"""DCN-v2, deep and cross network (``persia_tpu/models/dcn.py``).

Cross layers compute ``x_{l+1} = x0 * (W_l x_l + b_l) + x_l`` beside a
deep MLP over ``x0``; both meet in a final ``Dense``. ``x0`` is the dense
features followed by the flattened embeddings, so the constructor takes
``num_dense`` (the non-id tensors' total width) and ``slot_dims`` (each
embedding input's dim). flax's names: ``CrossLayer_i/Dense_0``,
``MLP_0`` and the top ``Dense_0``.
"""

from typing import Any, Sequence

import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.models.common import MLP, dense, flatten_embeddings


class CrossLayer(nn.Module):
    def __init__(self, width: int, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Dense_0 = nn.Linear(width, width, device=device)

    def forward(self, x0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x0 * dense(self.Dense_0, x, self.compute_dtype) + x


class DCNv2(nn.Module):
    def __init__(self, num_dense: int, slot_dims: Sequence[int],
                 num_cross_layers: int = 3,
                 deep_mlp: Sequence[int] = (256, 128),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.num_cross_layers = num_cross_layers
        width = num_dense + sum(slot_dims)
        for i in range(num_cross_layers):
            self.add_module(f"CrossLayer_{i}",
                            CrossLayer(width, compute_dtype, device=device))
        self.MLP_0 = MLP(width, deep_mlp, compute_dtype=compute_dtype,
                         device=device)
        self.Dense_0 = nn.Linear(width + tuple(deep_mlp)[-1], 1,
                                 device=device)

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                embedding_tensors: Sequence[Any]) -> torch.Tensor:
        dt = self.compute_dtype
        parts = [t.to(dt) for t in non_id_tensors]
        parts.append(flatten_embeddings(embedding_tensors).to(dt))
        x0 = torch.cat(parts, dim=1)
        x = x0
        for i in range(self.num_cross_layers):
            x = getattr(self, f"CrossLayer_{i}")(x0, x)
        combined = torch.cat([x, self.MLP_0(x0)], dim=1)
        return torch.sigmoid(dense(self.Dense_0, combined, dt).float())
