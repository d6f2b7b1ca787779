"""Shared building blocks of the dense towers (``persia_tpu/models/common.py``).

Dtype policy, as in the JAX package: parameters and batch-norm statistics
stay float32; the products run in ``compute_dtype`` (bfloat16 by default),
with weights cast at use. Raw (sequence) slots arrive as a fixed-capacity
distinct tensor plus an index tensor and are gathered on the device.

Submodules carry flax's auto-names (``Dense_0``, ``BatchNorm_0``, ...), so
:mod:`persia_tpu_torch.weights` maps a flax parameter tree onto them
name by name.
"""

from typing import Any, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def gather_raw_embedding(embeddings: torch.Tensor, index: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(capacity, dim) rows + (bs, sfs) index -> (bs, sfs, dim) tensor and
    its (bs, sfs) validity mask. Row 0 is zeros, so padded positions
    contribute zero without masking."""
    return embeddings[index.long()], index > 0


def _pooled_fields(embedding_tensors: Sequence[Any]) -> List[torch.Tensor]:
    """Each input as (bs, dim): a raw (emb, index) pair is gathered and
    mean-pooled over valid positions."""
    parts = []
    for e in embedding_tensors:
        if isinstance(e, (tuple, list)):
            gathered, mask = gather_raw_embedding(*e)
            denom = mask.sum(dim=1, keepdim=True).clamp_min(1)
            parts.append(gathered.sum(dim=1) / denom)
        else:
            parts.append(e)
    return parts


def flatten_embeddings(embedding_tensors: Sequence[Any]) -> torch.Tensor:
    """Concatenate model-ready embedding inputs along features; a raw
    (emb, index) pair is gathered and mean-pooled over valid positions."""
    return torch.cat(_pooled_fields(embedding_tensors), dim=1)


def stack_field_embeddings(embedding_tensors: Sequence[Any]
                           ) -> torch.Tensor:
    """(bs, F, dim) field stack for interaction layers (DLRM). All fields
    must share one dim; raw slots are mean-pooled first."""
    return torch.stack(_pooled_fields(embedding_tensors), dim=1)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` over f32 params: inputs, kernel and
    bias all cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class FlaxBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` of a (batch, features) input: ``scale`` /
    ``bias`` and the running ``mean`` / ``var`` the JAX package keeps in
    ``batch_stats``.

    Not ``nn.BatchNorm1d``: torch's momentum weighs the batch where
    flax's weighs the running value, and torch keeps the unbiased
    variance. As flax (``flax.linen.normalization._compute_stats``) does:

    - the batch statistics are f32: ``mean = E[x]`` and the "fast"
      variance ``var = max(0, E[x^2] - E[x]^2)``;
    - ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``, with the
      batch's statistics in training and the running ones in eval;
    - in training, ``ra = momentum * ra + (1 - momentum) * batch`` for
      the mean and that same biased variance, in place, outside autograd.

    The train-mode forward is plain tensor ops, so autograd gives flax's
    gradient through the batch statistics (``torch.maximum`` splits a tie
    at 0 evenly, as ``jnp.maximum`` does).
    """

    MOMENTUM = 0.99  # flax's default, which every tower keeps

    def __init__(self, features: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def reset_parameters(self):
        """flax's init: scale 1, bias 0, running mean 0 and var 1."""
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(dim=0)
            var = torch.maximum(torch.zeros_like(mean),
                                (x * x).mean(dim=0) - mean * mean)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * mul + self.bias


class MLP(nn.Module):
    """Dense stack with optional batch-norm and relu activations."""

    def __init__(self, in_features: int, features: Sequence[int],
                 use_batch_norm: bool = False, final_activation: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.features = tuple(features)
        self.use_batch_norm = use_batch_norm
        self.final_activation = final_activation
        self.compute_dtype = compute_dtype
        prev = in_features
        for i, width in enumerate(self.features):
            self.add_module(f"Dense_{i}",
                            nn.Linear(prev, width, device=device))
            if use_batch_norm and self._activated(i):
                self.add_module(f"BatchNorm_{i}",
                                FlaxBatchNorm(width, device=device))
            prev = width

    def _activated(self, i: int) -> bool:
        return i < len(self.features) - 1 or self.final_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        for i in range(len(self.features)):
            x = dense(getattr(self, f"Dense_{i}"), x, dt)
            if self._activated(i):
                if self.use_batch_norm:
                    x = getattr(self, f"BatchNorm_{i}")(x.float()).to(dt)
                x = F.relu(x)
        return x
