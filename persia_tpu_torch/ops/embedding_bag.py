"""Embedding bag: the CUDA kernel K1 and its plain version.

K1 (``csrc/embedding_bag.cu``) replaces the Pallas TPU kernel
``_packed_bag_kernel`` of ``persia_tpu/ops/embedding_bag.py`` (driven by
``pallas_embedding_bag_packed``), the hot op of device-mode sparse
training::

    out[b, :] = sum_s weights[b, s] * table[clip(ids[b, s]), :]

over a (V, D) f32 table, (B, S) integer ids and (B, S) weights (0 for
padding), giving (B, D) f32. The TPU kernel's 128-lane packing of the
table is TPU tiling only; here the table stays (V, D).

Out-of-range ids. They never occur on the device-mode path (ids are
hashed into [1, V - 1] and padding is masked to 0), but the JAX package's
two versions disagree on them: ``jnp.take`` (``xla_embedding_bag``) fills
NaN for an id >= V and wraps -1 to row V - 1, while the Pallas kernel
clips to [0, ceil(V/P)·P - 1] of its packed table, so an id >= V reads a
zero padding row when P = 128/D does not divide V, and -1 reads row 0.
The port clips every id to [0, V - 1], in the kernel and in the plain
version alike. That equals the Pallas kernel whenever P divides V, as it
does for every device-mode table (V = 2^20).

:func:`embedding_bag_fwd` is K1's wrapper: the plain version for CPU
tensors, the kernel for CUDA tensors, or it raises; it counts the
kernel's launches. :func:`embedding_bag` is the differentiable entry, a
``torch.autograd.Function`` whose forward is K1 and whose backward is the
JAX package's ``_bwd`` (XLA there, not Pallas; PyTorch ops here): a dense
``d_table`` built by ``index_add_`` at the clipped ids, and ``d_weights``
only when the weights require grad.
"""

import ctypes

import torch

from persia_tpu_torch.ops import _build

KERNEL = "embedding_bag"  # K1; also the name of its CUDA source


def launch_count() -> int:
    """K1's launches since the last reset; the plain version never
    counts."""
    return _build.launch_count(KERNEL)


def reset_launch_count():
    _build.reset_launch_counts([KERNEL])


def clip_ids(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The port's rule for out-of-range ids: clip to [0, vocab - 1]."""
    return ids.clamp(0, vocab - 1)


def embedding_bag_reference(table: torch.Tensor, ids: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """K1's plain version: gather, weighted sum over the bag, f32
    (``xla_embedding_bag`` with K1's clipping rule)."""
    gathered = table.float()[clip_ids(ids, table.shape[0]).long()]
    return (gathered * weights.float()[..., None]).sum(dim=1)


def _check(table, ids, weights):
    if table.dim() != 2 or ids.dim() != 2 or weights.shape != ids.shape:
        raise ValueError(
            f"expected table (V, D), ids (B, S) and weights (B, S), got "
            f"{tuple(table.shape)}, {tuple(ids.shape)}, "
            f"{tuple(weights.shape)}")
    if table.shape[0] == 0:
        raise ValueError("the table has no rows")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise TypeError(f"ids must be integers, got {ids.dtype}")
    devices = {t.device for t in (table, ids, weights)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4


def embedding_bag_fwd(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """K1's wrapper: (B, D) f32. The plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (an f32 contiguous table; ids are made
    int32 and weights f32 once here)."""
    _check(table, ids, weights)
    if table.device.type == "cpu":
        return embedding_bag_reference(table, ids, weights)
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise TypeError("K1 takes a contiguous f32 table")
    vocab, dim = table.shape
    batch, bag = ids.shape
    if max(vocab, batch, bag, dim) > 2**31 - 1:
        raise ValueError("a dimension does not fit in int32")
    out = torch.empty((batch, dim), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    if bag == 0:
        return out.zero_()
    ids32 = ids.to(torch.int32).contiguous()  # referenced until launched
    w32 = weights.to(torch.float32).contiguous()
    _build.launch(KERNEL, KERNEL, "persia_embedding_bag", _ARGS,
                  table.device, table.data_ptr(), ids32.data_ptr(),
                  w32.data_ptr(), out.data_ptr(), batch, bag, dim, vocab)
    return out


class _EmbeddingBag(torch.autograd.Function):
    """Forward K1; backward the JAX package's ``_bwd`` at the clipped
    ids. The ids get no gradient."""

    @staticmethod
    def forward(ctx, table, ids, weights):
        ctx.save_for_backward(table, ids, weights)
        return embedding_bag_fwd(table, ids, weights)

    @staticmethod
    def backward(ctx, g):
        table, ids, weights = ctx.saved_tensors
        rows = clip_ids(ids, table.shape[0]).long()
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            contrib = g[:, None, :] * weights.to(g.dtype)[..., None]
            d_table = torch.zeros_like(table).index_add_(
                0, rows.reshape(-1),
                contrib.reshape(-1, table.shape[1]).to(table.dtype))
        if ctx.needs_input_grad[2]:
            d_weights = torch.einsum("bsd,bd->bs", table[rows].to(g.dtype),
                                     g).to(weights.dtype)
        return d_table, None, d_weights


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Pooled lookup, differentiable in ``table`` and ``weights``: (B, D)
    f32 through K1 on the card, its plain version on the CPU."""
    return _EmbeddingBag.apply(table, ids, weights)
