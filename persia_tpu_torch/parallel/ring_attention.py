"""Attention reference of ``persia_tpu/parallel/ring_attention.py``.

Only :func:`reference_attention` is ported so far: the O(T^2) path behind
the sequence tower's ``attn_impl="reference"`` setting. Ring attention,
local flash attention and Ulysses wait for a later slice (ROADMAP.md).
"""

import math
from typing import Optional

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(d)) v over (B, H, T, Dh). ``kv_mask``: optional
    (B, T_k) bool of valid keys; their scores are -inf and a fully masked
    query row yields 0."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    neg = torch.tensor(float("-inf"), dtype=s.dtype, device=s.device)
    if causal:
        # position i attends to keys <= i; with t_q != t_k this is the
        # rectangular slice of the square relation
        q_pos = torch.arange(q.shape[2], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where((q_pos >= k_pos)[None, None], s, neg)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :].bool(), s, neg)
    p = torch.softmax(s, dim=-1)
    if kv_mask is not None:
        p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows -> 0
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
