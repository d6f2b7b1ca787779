"""Row-wise Adagrad: ``optax.adagrad``'s update of the rows that a sparse
(row) gradient holds, by the CUDA kernel ``csrc/rowwise_adagrad.cu``.

A row gradient is an uncoalesced ``torch.sparse_coo_tensor`` of a (V, D)
table: one (row, D-vector) entry per id that the forward pooled, many
entries on one row (device mode's table gradients, K1's backward in
:mod:`persia_tpu_torch.ops.embedding_bag`). Its dense form is the JAX
package's scatter-add. Per distinct row, with ``g`` the sum of the row's
vectors and ``s`` its accumulator::

    s <- s + g * g
    p <- p + (-lr) * (rsqrt(s + eps) * g)

elementwise in f32, the operations of ``OptaxAdagrad``'s dense foreach
passes. A row without an entry gets exactly no change there (``s + 0``,
``p - lr * 0 * ...``), so updating the touched rows alone is the same
function; untouched rows and their accumulators keep every bit.

:func:`rowwise_adagrad` updates a list of tables: their plain version for
CPU tensors, the kernel for CUDA tensors (or it raises). On the card the
tables of one width go together: one launch writes every id's key
(``keys``), ``torch.sort`` sorts the keys stably, and one launch of the
update (several kernels, one a level of its segmented sum) sums and
applies each row's gradient, so the sums run in an order fixed by the ids
alone. :func:`launch_count` counts the update's launches (one a step of
device mode); the keys' launches count apart (``KEYS``).
"""

import ctypes
from array import array
from typing import List, Sequence

import torch

from persia_tpu_torch.ops import _build

KERNEL = "rowwise_adagrad"  # the update; also the name of its CUDA source
KEYS = "rowwise_adagrad_keys"  # the keys' launches, counted apart
# tables one launch takes (MAX_TABLES of csrc/rowwise_adagrad.cu: their
# descriptors travel in the kernel's 4 KB of parameters)
MAX_TABLES = 64
CHUNK = 32  # CHUNK of csrc/rowwise_adagrad.cu: items a team sums a level
_DESC_WORDS = 7  # int64 words of one table's descriptor
_MAX_KEYS = 2**31 - 1  # keys are int32; the last one marks a dropped id
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# persia_rowwise_adagrad_keys(desc, n_tables, dim, n, total, keys)
_KEYS_ARGS = [_P, _I, _I, _L, _I, _P]
# persia_rowwise_adagrad_update(desc, n_tables, dim, lr, eps, total, n,
# skeys, perm, scratch_keys, scratch_vals, cap_a, cap_b)
_UPDATE_ARGS = [_P, _I, _I, _F, _F, _I, _L, _P, _P, _P, _P, _L, _L]


def launch_count() -> int:
    """The update's launches since the last reset; the plain version never
    counts."""
    return _build.launch_count(KERNEL)


def reset_launch_count():
    _build.reset_launch_counts([KERNEL, KEYS])


def rowwise_adagrad_reference(params: Sequence[torch.Tensor],
                              grads: Sequence[torch.Tensor],
                              sums: Sequence[torch.Tensor], lr: float,
                              eps: float) -> int:
    """The plain version, in place: per table the coalesced gradient (the
    distinct rows, each row's entries summed in the entries' order by
    ``index_add_``, the order of the dense scatter-add), then the update
    of those rows by indexed ops. Returns the entries taken."""
    n = 0
    for p, g, s in zip(params, grads, sums):
        n += g._nnz()
        rows, at = torch.unique(g._indices()[0], return_inverse=True)
        v = g._values()
        v = torch.zeros((rows.numel(), *v.shape[1:]), dtype=v.dtype,
                        device=v.device).index_add_(0, at, v)
        s.index_add_(0, rows, v * v)
        upd = s.index_select(0, rows).add_(eps).rsqrt_().mul_(v)
        p.index_add_(0, rows, upd, alpha=-lr)
    return n


def _check(p: torch.Tensor, g: torch.Tensor, s: torch.Tensor):
    if not g.is_sparse or g.sparse_dim() != 1 or g.shape != p.shape \
            or s.shape != p.shape or p.dim() != 2:
        raise ValueError(f"expected a (V, D) table, its accumulator and a "
                         f"row gradient of it (sparse, one sparse dim), got "
                         f"{tuple(p.shape)}, {tuple(s.shape)} and "
                         f"{tuple(g.shape)}")
    if p.dtype != torch.float32 or s.dtype != torch.float32 \
            or g.dtype != torch.float32:
        raise TypeError("the row-wise kernel takes f32 tables, accumulators "
                        "and gradients")
    if not (p.is_contiguous() and s.is_contiguous()):
        raise TypeError("the row-wise kernel takes contiguous tables and "
                        "accumulators")


def _launch_group(params, grads, sums, lr: float, eps: float) -> int:
    """One width's tables (at most MAX_TABLES) on the card: keys, sort,
    update. Returns the entries taken."""
    device, dim = params[0].device, params[0].shape[1]
    words: List[int] = []
    keep = []  # referenced until launched
    n = total = 0
    for p, g, s in zip(params, grads, sums):
        _check(p, g, s)
        idx, v = g._indices(), g._values()
        if not idx.is_contiguous():
            idx = idx.contiguous()
        if not v.is_contiguous():
            v = v.contiguous()
        keep += (idx, v)
        words += (p.data_ptr(), s.data_ptr(), v.data_ptr(), idx.data_ptr(),
                  n, total, p.shape[0])
        n += v.shape[0]
        total += p.shape[0]
    if total >= _MAX_KEYS:
        raise ValueError(f"{total} rows in one call do not fit int32 keys")
    if n == 0:
        return 0
    desc = array("q", words)
    keys = torch.empty(n, dtype=torch.int32, device=device)
    _build.launcher(KEYS, KERNEL, "persia_rowwise_adagrad_keys", _KEYS_ARGS)(
        device, desc.buffer_info()[0], len(params), dim, n, total,
        keys.data_ptr())
    skeys, perm = torch.sort(keys, stable=True)
    teams = -(-n // CHUNK)
    cap_a = 2 * teams if teams > 1 else 0
    cap_b = 2 * -(-cap_a // CHUNK) if teams > 1 else 0
    scratch_keys = torch.empty(cap_a + cap_b, dtype=torch.int32,
                               device=device)
    scratch_vals = torch.empty((cap_a + cap_b) * dim, dtype=torch.float32,
                               device=device)
    _build.launcher(KERNEL, KERNEL, "persia_rowwise_adagrad_update",
                    _UPDATE_ARGS)(
        device, desc.buffer_info()[0], len(params), dim, lr, eps, total, n,
        skeys.data_ptr(), perm.data_ptr(), scratch_keys.data_ptr(),
        scratch_vals.data_ptr(), cap_a, cap_b)
    return n


def rowwise_adagrad(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    sums: Sequence[torch.Tensor], lr: float,
                    eps: float) -> int:
    """Update each (V, D) table of ``params`` and its accumulator in
    ``sums`` in place by its row gradient in ``grads`` (a sparse COO
    tensor of the table's shape, coalesced or not). The plain version for
    CPU tensors; for CUDA tensors (f32, contiguous) the kernel, one call
    per width and :data:`MAX_TABLES` tables. Returns the entries taken."""
    if not params:
        return 0
    device = params[0].device
    if device.type == "cpu":
        return rowwise_adagrad_reference(params, grads, sums, lr, eps)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    by_dim = {}
    for p, g, s in zip(params, grads, sums):
        if p.device != device or g.device != device or s.device != device:
            raise ValueError("tables on several devices")
        by_dim.setdefault(p.shape[-1], []).append((p, g, s))
    n = 0
    for group in by_dim.values():
        for at in range(0, len(group), MAX_TABLES):
            n += _launch_group(*zip(*group[at:at + MAX_TABLES]), lr, eps)
    return n
