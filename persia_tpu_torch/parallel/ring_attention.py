"""Attention over a sharded sequence (``persia_tpu/parallel/ring_attention.py``).

- :func:`reference_attention`: the O(T^2) path behind the sequence
  tower's ``attn_impl="reference"``.
- :func:`ring_attention`: blockwise attention over a sequence sharded on
  a process group. Each of the P steps combines the local query block
  with the K/V block it holds by the online-softmax (flash) update, then
  passes K/V and their key mask on around the ring
  (:func:`~persia_tpu_torch.parallel.collectives.ppermute`); no rank
  ever holds the whole sequence.
- :func:`local_flash_attention`: the same update over ``chunk_size``
  blocks of one rank's keys, O(T·chunk) score memory.
- :func:`seq_sharded` / :func:`ring_self_attention`: ``shard_map``'s
  part in an SPMD program. Every rank of the sequence axis holds the
  whole (B, H, T, Dh) inputs, takes its T block, runs the sharded
  function and gathers the blocks back.

These are plain PyTorch in f32, as the JAX package's are XLA code: no
kernel lies behind them. Keys are masked at score level (-inf before the
softmax); a fully masked query row gives 0.
"""

import math
from typing import Callable, Optional

import torch

from persia_tpu_torch.parallel import collectives as coll


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


def _flash_update(o, m, l, s, v_blk):
    """One online-softmax accumulation over a score block ``s`` that is
    already -inf-masked, guarding rows with no visible key yet (``m``
    stays -inf until the first finite score). Shared by the ring and the
    local chunked scan."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    finite = torch.isfinite(m_new)
    safe_m = torch.where(finite, m_new, torch.zeros_like(m_new))
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                             torch.zeros_like(m))
    l = l * correction + p.sum(dim=-1)
    o = o * correction[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p, v_blk.float())
    return o, m_new, l


def _scores(q32, k_blk, scale, q_pos, k_pos, causal, m_blk):
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k_blk.float()) * scale
    if causal:
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :])[None, None],
                          float("-inf"))
    return s.masked_fill(~m_blk.bool()[:, None, None, :], float("-inf"))


def _init_carry(q):
    b, h, t_q, dh = q.shape
    return (torch.zeros((b, h, t_q, dh), dtype=torch.float32, device=q.device),
            torch.full((b, h, t_q), float("-inf"), device=q.device),
            torch.zeros((b, h, t_q), device=q.device))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blockwise attention over a sequence sharded on ``group``.

    q, k, v: (B, H, T_local, Dh), this rank's sequence block; kv_mask:
    optional (B, T_local) bool for this rank's keys (it rotates around
    the ring with K/V). With ``group=None`` this is flash attention on the
    local block. Differentiable; the output has q's dtype."""
    n = coll.size(group) if group is not None else 1
    me = coll.rank(group) if group is not None else 0
    b, _, t_q, dh = q.shape
    t_k = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    q32 = q.float()
    m_blk = (kv_mask if kv_mask is not None
             else torch.ones((b, t_k), dtype=torch.bool, device=q.device))
    m_blk = m_blk.to(torch.uint8)  # bool is not a type every backend moves
    q_pos = me * t_q + torch.arange(t_q, device=q.device)
    o, m, l = _init_carry(q)
    k_blk, v_blk = k, v
    for i in range(n):
        # the block held now started on rank (me - i) % n
        src = (me - i) % n
        k_pos = src * t_k + torch.arange(t_k, device=q.device)
        s = _scores(q32, k_blk, scale, q_pos, k_pos, causal, m_blk)
        o, m, l = _flash_update(o, m, l, s, v_blk)
        if i + 1 < n:  # the last block need not travel on
            k_blk = coll.ppermute(k_blk, group)
            v_blk = coll.ppermute(v_blk, group)
            m_blk = coll.ppermute(m_blk, group)
    l = torch.clamp_min(l, 1e-20)
    return (o / l[..., None]).to(q.dtype)


def local_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, chunk_size: int = 512,
                          kv_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """One rank's blockwise (flash) attention, O(T·chunk) score memory:
    K/V stream through in ``chunk_size`` blocks with the update
    :func:`ring_attention` uses across ranks. The padding of the last
    chunk is masked as invalid keys."""
    b, _, t_q, dh = q.shape
    t_k = k.shape[2]
    if t_k <= chunk_size:
        return ring_attention(q, k, v, group=None, causal=causal,
                              kv_mask=kv_mask)
    mask = (kv_mask if kv_mask is not None
            else torch.ones((b, t_k), dtype=torch.bool, device=q.device))
    n_chunks = -(-t_k // chunk_size)
    pad = n_chunks * chunk_size - t_k
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask.bool(), (0, pad))  # invalid
    scale = 1.0 / math.sqrt(dh)
    q32 = q.float()
    q_pos = torch.arange(t_q, device=q.device)
    o, m, l = _init_carry(q)
    for ci in range(n_chunks):
        sl = slice(ci * chunk_size, (ci + 1) * chunk_size)
        k_pos = ci * chunk_size + torch.arange(chunk_size, device=q.device)
        s = _scores(q32, k[:, :, sl], scale, q_pos, k_pos, causal,
                    mask[:, sl])
        o, m, l = _flash_update(o, m, l, s, v[:, :, sl])
    l = torch.clamp_min(l, 1e-20)
    return (o / l[..., None]).to(q.dtype)


def seq_sharded(inner: Callable, mesh, seq_axis: str) -> Callable:
    """``shard_map``'s part for context-parallel attention: the returned
    ``f(q, k, v, kv_mask)`` takes the whole (B, H, T, Dh) q/k/v and (B, T)
    mask that every rank of ``seq_axis`` holds alike, runs
    ``inner(q_blk, k_blk, v_blk, mask_blk, group)`` on this rank's T
    block, and returns the blocks gathered back into the whole output.
    T must divide by the axis size."""
    from persia_tpu_torch.parallel.mesh import axis_group

    group = axis_group(mesh, seq_axis)

    def run(q, k, v, kv_mask):
        blocks = [coll.scatter_to_shards(x, group, 2) for x in (q, k, v)]
        m_blk = coll.scatter_to_shards(kv_mask, group, 1)
        return coll.gather_from_shards(inner(*blocks, m_blk, group), group, 2)

    return run


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh, seq_axis: str = "model", causal: bool = False,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Ring attention with T sharded over the mesh's ``seq_axis``; in and
    out the whole (B, H, T, Dh) tensors every rank of the axis holds."""
    if kv_mask is None:
        kv_mask = torch.ones((q.shape[0], k.shape[2]), dtype=torch.bool,
                             device=q.device)

    def inner(q, k, v, m, group):
        return ring_attention(q, k, v, group=group, causal=causal, kv_mask=m)

    return seq_sharded(inner, mesh, seq_axis)(q, k, v, kv_mask)
