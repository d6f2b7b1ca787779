"""Sequence tower: self-attention over user-history (raw) slots
(``persia_tpu/models/seq.py``).

Raw slots become sequences: gather -> multi-head self-attention -> masked
mean pool; summed slots and dense features concatenate as usual; MLP head.

With a ``mesh`` whose ``seq_axis`` has more than one rank, the attention
is context-parallel over that axis (``context_parallel``): ``"ring"``
(:func:`~persia_tpu_torch.parallel.ring_attention.ring_self_attention`,
any head count, always in f32) or ``"ulysses"``
(:func:`~persia_tpu_torch.parallel.ulysses.ulysses_self_attention`, heads
divisible by the axis; on the ``"flash"`` path in the compute dtype, else
in f32), as the JAX package's rules are. Every rank of the axis runs the
tower on the same inputs; the mesh adds no parameter.

``attn_impl`` keeps the JAX field: ``"flash"`` runs
:func:`persia_tpu_torch.ops.flash_attention.flash_attention_masked` in the
compute dtype (kernel K2 forward; in training K2 with its logsumexp and
K3/K4 backward), ``"reference"`` the dense O(T^2) attention in f32 under
autograd.
The JAX package's ``"pallas"`` and ``"xla"`` map onto them
(:data:`persia_tpu_torch.weights.JAX_ATTN_IMPL`).
"""

from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn

from persia_tpu_torch.device import resolve_device
from persia_tpu_torch.models.common import MLP, dense, gather_raw_embedding

ATTN_IMPLS = ("reference", "flash")
CONTEXT_PARALLEL = ("ring", "ulysses")


def _check_attn_impl(attn_impl: str):
    if attn_impl not in ATTN_IMPLS:
        # a typo here must not silently fall through to the dense path
        raise ValueError(
            f"attn_impl must be one of {ATTN_IMPLS} (the JAX package's "
            f"'pallas'/'xla' map onto 'flash'/'reference'), got "
            f"{attn_impl!r}")


def _check_context_parallel(context_parallel: str):
    if context_parallel not in CONTEXT_PARALLEL:
        raise ValueError(
            f"context_parallel must be 'ring' or 'ulysses', got "
            f"{context_parallel!r}")


class SequenceSelfAttention(nn.Module):
    """Multi-head self-attention over (bs, t, d) with a (bs, t) key mask.
    Submodules: q, k, v and output projections ``Dense_0..3``."""

    def __init__(self, d: int, num_heads: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "reference", causal: bool = False,
                 mesh: Optional[Any] = None, context_parallel: str = "ring",
                 seq_axis: str = "model", device=None):
        super().__init__()
        _check_attn_impl(attn_impl)
        _check_context_parallel(context_parallel)
        self.num_heads = num_heads
        self.mesh = mesh
        self.context_parallel = context_parallel
        self.seq_axis = seq_axis
        self.dh = max(1, d // num_heads)
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.causal = causal
        inner = num_heads * self.dh
        for i in range(3):
            self.add_module(f"Dense_{i}", nn.Linear(d, inner, device=device))
        self.Dense_3 = nn.Linear(inner, d, device=device)

    @property
    def context_parallel_active(self) -> bool:
        """Whether the attention runs over more than one rank."""
        if self.mesh is None:
            return False
        from persia_tpu_torch.parallel.mesh import axis_size

        return axis_size(self.mesh, self.seq_axis) > 1

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        from persia_tpu_torch.ops.flash_attention import flash_attention_masked
        from persia_tpu_torch.parallel.ring_attention import (
            reference_attention,
        )

        bs, t, _ = x.shape
        dt = self.compute_dtype

        def heads(y):  # (bs, t, h*dh) -> (bs, h, t, dh), contiguous
            return (y.reshape(bs, t, self.num_heads, self.dh)
                    .permute(0, 2, 1, 3).contiguous())

        q = heads(dense(self.Dense_0, x, dt))
        k = heads(dense(self.Dense_1, x, dt))
        v = heads(dense(self.Dense_2, x, dt))
        # padded positions are masked at SCORE level (kv_mask)
        if self.context_parallel_active:
            out = self._context_parallel(q, k, v, mask)
        elif self.attn_impl == "flash":
            # the compute dtype goes in; the kernel accumulates in f32
            out = flash_attention_masked(q, k, v, kv_mask=mask,
                                         causal=self.causal)
        else:
            out = reference_attention(q.float(), k.float(), v.float(),
                                      causal=self.causal, kv_mask=mask)
        out = out.permute(0, 2, 1, 3).reshape(bs, t, self.num_heads * self.dh)
        return dense(self.Dense_3, out, dt)

    def _context_parallel(self, q, k, v, mask):
        from persia_tpu_torch.parallel.ring_attention import (
            ring_self_attention,
        )
        from persia_tpu_torch.parallel.ulysses import ulysses_self_attention

        if self.context_parallel == "ulysses":
            # the flash path keeps the compute dtype (the kernels
            # accumulate in f32); the chunked one runs in f32
            flash = self.attn_impl == "flash"
            x = [t if flash else t.float() for t in (q, k, v)]
            return ulysses_self_attention(
                *x, self.mesh, seq_axis=self.seq_axis, causal=self.causal,
                kv_mask=mask, impl="flash" if flash else "local")
        # the ring carries o/m/l around the ring itself: f32, no kernel
        return ring_self_attention(q.float(), k.float(), v.float(), self.mesh,
                                   seq_axis=self.seq_axis, causal=self.causal,
                                   kv_mask=mask)


class SequenceTower(nn.Module):
    """Dense tower with attention-pooled sequence slots.

    ``slots`` lists the model's embedding inputs in batch order as
    ``(dim, raw)`` pairs; each raw slot gets its own attention block
    (``SequenceSelfAttention_i``). Then ``MLP_0`` and the one-logit
    ``Dense_0`` head; the output is a sigmoid in f32. Parameters are
    created on ``device`` (default CUDA, which raises without a card).
    """

    def __init__(self, num_dense: int, slots: Sequence[Tuple[int, bool]],
                 mlp: Sequence[int] = (256, 128), num_heads: int = 2,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "reference", mesh: Optional[Any] = None,
                 context_parallel: str = "ring", seq_axis: str = "model",
                 device=None):
        super().__init__()
        _check_attn_impl(attn_impl)
        _check_context_parallel(context_parallel)
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.slots = [(int(d), bool(raw)) for d, raw in slots]
        n_raw = 0
        for dim, raw in self.slots:
            if raw:
                self.add_module(
                    f"SequenceSelfAttention_{n_raw}",
                    SequenceSelfAttention(
                        dim, num_heads, compute_dtype, attn_impl, mesh=mesh,
                        context_parallel=context_parallel,
                        seq_axis=seq_axis, device=device))
                n_raw += 1
        self.n_raw = n_raw
        in_features = num_dense + sum(d for d, _ in self.slots)
        self.MLP_0 = MLP(in_features, mlp, compute_dtype=compute_dtype,
                         device=device)
        self.Dense_0 = nn.Linear(self.MLP_0.features[-1], 1, device=device)

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                embedding_tensors: Sequence[Any]) -> torch.Tensor:
        dt = self.compute_dtype
        parts = [t.to(dt) for t in non_id_tensors]
        i_raw = 0
        for e in embedding_tensors:
            if isinstance(e, (tuple, list)):
                x, mask = gather_raw_embedding(*e)
                attended = getattr(self, f"SequenceSelfAttention_{i_raw}")(
                    x, mask)
                i_raw += 1
                denom = mask.sum(dim=1, keepdim=True).clamp_min(1).to(dt)
                pooled = (attended * mask[..., None].to(dt)).sum(dim=1)
                parts.append(pooled / denom)
            else:
                parts.append(e.to(dt))
        x = self.MLP_0(torch.cat(parts, dim=1))
        return torch.sigmoid(dense(self.Dense_0, x, dt).float())
