"""Ulysses all-to-all sequence parallelism (``persia_tpu/parallel/ulysses.py``).

The complement of ring attention: one ``all_to_all`` re-partitions q, k
and v from sequence blocks to head groups, so every rank runs ordinary
attention over the whole sequence for H/P heads, and a second
``all_to_all`` restores the sequence blocks (the DeepSpeed-Ulysses
formulation). It needs ``heads % P == 0``.

The per-rank attention is ``impl``:

- ``"local"`` (the JAX ``"xla"``): :func:`local_flash_attention`, the
  chunked online softmax in f32;
- ``"flash"`` (the JAX ``"pallas"``):
  :func:`persia_tpu_torch.ops.flash_attention.flash_attention_masked`,
  kernel K2 in the forward and K3 / K4 in the backward on the card (their
  plain versions on the CPU), in the inputs' dtype.
"""

from typing import Optional

import torch

from persia_tpu_torch.parallel import collectives as coll
from persia_tpu_torch.parallel.ring_attention import (
    local_flash_attention,
    seq_sharded,
)

IMPLS = ("local", "flash")


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, causal: bool = False, chunk_size: int = 512,
                      kv_mask: Optional[torch.Tensor] = None,
                      impl: str = "local") -> torch.Tensor:
    """q/k/v (B, H, T_local, Dh) with the sequence sharded over ``group``
    (H must divide by its size); kv_mask optional (B, T_local) of this
    rank's valid keys. all_to_all to (B, H/P, T, Dh), attention over the
    head group, all_to_all back to (B, H, T_local, Dh). Differentiable."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    n = coll.size(group)
    heads = q.shape[1]
    if heads % n:
        raise ValueError(
            f"ulysses needs heads ({heads}) divisible by the sequence axis "
            f"size ({n}); use ring attention otherwise")
    if kv_mask is None:
        kv_mask = torch.ones((q.shape[0], k.shape[2]), dtype=torch.bool,
                             device=q.device)
    # the key mask has no head axis: every rank needs the whole of it
    full_mask = coll.all_gather(kv_mask.to(torch.uint8), group, dim=1).bool()
    q, k, v = (coll.all_to_all(x, group, split_dim=1, concat_dim=2)
               for x in (q, k, v))
    if impl == "flash":
        from persia_tpu_torch.ops.flash_attention import (
            flash_attention_masked,
        )

        out = flash_attention_masked(q, k, v, kv_mask=full_mask,
                                     causal=causal)
    else:
        out = local_flash_attention(q, k, v, causal=causal,
                                    chunk_size=chunk_size, kv_mask=full_mask)
    return coll.all_to_all(out, group, split_dim=2, concat_dim=1)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh, seq_axis: str = "model",
                           causal: bool = False, chunk_size: int = 512,
                           kv_mask: Optional[torch.Tensor] = None,
                           impl: str = "local") -> torch.Tensor:
    """Ulysses with T sharded over the mesh's ``seq_axis``; in and out the
    whole (B, H, T, Dh) tensors every rank of the axis holds (a drop-in
    for :func:`~persia_tpu_torch.parallel.ring_attention.ring_self_attention`)."""
    if kv_mask is None:
        kv_mask = torch.ones((q.shape[0], k.shape[2]), dtype=torch.bool,
                             device=q.device)

    def inner(q, k, v, m, group):
        return ulysses_attention(q, k, v, group, causal=causal,
                                 chunk_size=chunk_size, kv_mask=m, impl=impl)

    return seq_sharded(inner, mesh, seq_axis)(q, k, v, kv_mask)
