"""The middleware's C++ kernels (``persia_tpu/worker/mw_native.py``).

The ``ptmw_*`` entries of ``native/src/mw_kernels.h``, in the native
library that :func:`persia_tpu_torch.ps.native.load_native_lib` builds;
this module binds their signatures at first use. Kernels:
dedup, the summed-slot postprocess and its gradient, the shard order, and
the row gather, scatter and scatter-add. Each is bit-identical to its
numpy twin in :mod:`persia_tpu_torch.worker.middleware`, which calls them
through ``_mw_native()``.
"""

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from persia_tpu_torch.ps.native import bind_symbols, load_native_lib

_i32, _i64, _u32, _u64, _f32 = (ctypes.c_int32, ctypes.c_int64,
                                ctypes.c_uint32, ctypes.c_uint64,
                                ctypes.c_float)
_P = ctypes.POINTER
# symbol -> (restype, argtypes)
_SIGNATURES = {
    "ptmw_dedup": (_i64, [_P(_u64), _i64, _P(_u64), _P(_i32)]),
    "ptmw_sum_post": (None, [_P(_f32), _P(_i32), _P(_i32), _i32, _i32,
                             _P(_f32), _P(_f32)]),
    "ptmw_sum_grad": (None, [_P(_f32), _P(_i32), _P(_i32), _i64, _i64, _i32,
                             _f32, _P(_f32), _P(_f32)]),
    "ptmw_shard_order": (None, [_P(_u64), _i64, _u32, _P(_i32), _P(_u32)]),
    "ptmw_gather_rows": (None, [_P(_f32), _P(_i32), _i64, _i32, _f32, _i32,
                                _P(_f32)]),
    "ptmw_scatter_rows": (None, [_P(_f32), _P(_i32), _i64, _i32,
                                 _P(_f32)]),
    "ptmw_scatter_add_rows": (None, [_P(_f32), _P(_i32), _i64, _i32,
                                     _P(_f32)]),
}

_lock = threading.Lock()
_bound: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The native library with the ``ptmw_*`` entries bound."""
    global _bound
    if _bound is None:
        with _lock:
            if _bound is None:
                lib = load_native_lib()
                bind_symbols(lib, _SIGNATURES)
                _bound = lib
    return _bound


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        _lib()
    except (OSError, RuntimeError):  # the build, the load, a symbol
        return False
    return True


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_index(idx: np.ndarray, n: int, what: str):
    """The kernels read and write through these indices unchecked."""
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"{what} index out of [0, {n})")


def _check_rows(a: np.ndarray, n: int, dim: int, what: str):
    if a.shape != (n, dim):
        raise ValueError(f"{what} has shape {a.shape}, not {(n, dim)}")


def _check_dst(dst: np.ndarray, dim: int):
    if dst.dtype != np.float32 or not dst.flags.c_contiguous \
            or dst.ndim != 2 or dst.shape[1] != dim:
        raise ValueError("dst must be a C-contiguous (rows, dim) float32 "
                         "array")


def _opt_f32(scale: Optional[np.ndarray], n: int):
    """An optional per-sample scale of ``n`` values: (array, pointer)."""
    if scale is None:
        return None, None
    scale = np.ascontiguousarray(scale, dtype=np.float32)
    if scale.shape != (n,):
        raise ValueError(f"scale has shape {scale.shape}, not ({n},)")
    return scale, _p(scale, ctypes.c_float)


def dedup(signs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(signs, return_inverse=True)``: sorted distinct signs
    and each element's index among them (int32)."""
    lib = _lib()
    signs = np.ascontiguousarray(signs, dtype=np.uint64)
    nnz = len(signs)
    distinct = np.empty(nnz, dtype=np.uint64)
    inverse = np.empty(nnz, dtype=np.int32)
    d = lib.ptmw_dedup(_p(signs, ctypes.c_uint64), nnz,
                       _p(distinct, ctypes.c_uint64),
                       _p(inverse, ctypes.c_int32))
    return distinct[:d].copy(), inverse


def sum_post(emb: np.ndarray, elem_distinct: np.ndarray, counts: np.ndarray,
             bs: int, dim: int, scale: Optional[np.ndarray]) -> np.ndarray:
    """Each sample's sum of its elements' rows, times ``scale`` per
    sample when given: (bs, dim)."""
    lib = _lib()
    emb = np.ascontiguousarray(emb, dtype=np.float32)
    elem_distinct = np.ascontiguousarray(elem_distinct, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    if len(counts) != bs or int(counts.sum()) != len(elem_distinct):
        raise ValueError("counts must hold bs sample sizes summing to nnz")
    _check_index(elem_distinct, len(emb), "elem_distinct")
    _check_rows(emb, len(emb), dim, "emb")
    out = np.empty((bs, dim), dtype=np.float32)
    scale, sp = _opt_f32(scale, bs)
    lib.ptmw_sum_post(_p(emb, ctypes.c_float),
                      _p(elem_distinct, ctypes.c_int32),
                      _p(counts, ctypes.c_int32), bs, dim, sp,
                      _p(out, ctypes.c_float))
    return out


def sum_grad(grad: np.ndarray, elem_sample: np.ndarray,
             elem_distinct: np.ndarray, num_distinct: int, dim: int,
             inv_loss_scale: float,
             scale: Optional[np.ndarray]) -> np.ndarray:
    """The transpose of :func:`sum_post`: per distinct sign, the sum of
    its elements' sample gradients (non-finite values zeroed, times
    ``inv_loss_scale`` and the sample's ``scale``)."""
    lib = _lib()
    grad = np.ascontiguousarray(grad, dtype=np.float32)
    elem_sample = np.ascontiguousarray(elem_sample, dtype=np.int32)
    elem_distinct = np.ascontiguousarray(elem_distinct, dtype=np.int32)
    if len(elem_sample) != len(elem_distinct):
        raise ValueError("elem_sample and elem_distinct differ in length")
    _check_index(elem_sample, len(grad), "elem_sample")
    _check_index(elem_distinct, num_distinct, "elem_distinct")
    _check_rows(grad, len(grad), dim, "grad")
    out = np.empty((num_distinct, dim), dtype=np.float32)
    scale, sp = _opt_f32(scale, len(grad))
    lib.ptmw_sum_grad(_p(grad, ctypes.c_float),
                      _p(elem_sample, ctypes.c_int32),
                      _p(elem_distinct, ctypes.c_int32), len(elem_sample),
                      num_distinct, dim, inv_loss_scale, sp,
                      _p(out, ctypes.c_float))
    return out


def shard_order(signs: np.ndarray, replica: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Counting sort of sign indices by ``farmhash64(sign) % replica``:
    (order int32 (n,), starts uint32 (replica + 1,)); shard s holds
    ``signs[order[starts[s]:starts[s + 1]]]``, in ascending index order."""
    lib = _lib()
    signs = np.ascontiguousarray(signs, dtype=np.uint64)
    order = np.empty(len(signs), dtype=np.int32)
    starts = np.empty(replica + 1, dtype=np.uint32)
    lib.ptmw_shard_order(_p(signs, ctypes.c_uint64), len(signs), replica,
                         _p(order, ctypes.c_int32),
                         _p(starts, ctypes.c_uint32))
    return order, starts


def gather_rows(src: np.ndarray, idx: np.ndarray, dim: int,
                filter_scale: float = 1.0,
                filter_nonfinite: bool = False) -> np.ndarray:
    """``src[idx]``; with ``filter_nonfinite`` non-finite values read 0
    and every value is multiplied by ``filter_scale``."""
    lib = _lib()
    src = np.ascontiguousarray(src, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    _check_index(idx, len(src), "idx")
    _check_rows(src, len(src), dim, "src")
    out = np.empty((len(idx), dim), dtype=np.float32)
    lib.ptmw_gather_rows(_p(src, ctypes.c_float), _p(idx, ctypes.c_int32),
                         len(idx), dim, filter_scale,
                         1 if filter_nonfinite else 0,
                         _p(out, ctypes.c_float))
    return out


def scatter_rows(dst: np.ndarray, idx: np.ndarray, src: np.ndarray,
                 dim: int):
    """``dst[idx] = src`` in place (``dst`` C-contiguous f32)."""
    lib = _lib()
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    src = np.ascontiguousarray(src, dtype=np.float32)
    _check_dst(dst, dim)
    _check_index(idx, len(dst), "idx")
    _check_rows(src, len(idx), dim, "src")
    lib.ptmw_scatter_rows(_p(dst, ctypes.c_float), _p(idx, ctypes.c_int32),
                          len(idx), dim, _p(src, ctypes.c_float))


def scatter_add_rows(dst: np.ndarray, idx: np.ndarray, src: np.ndarray,
                     dim: int):
    """``np.add.at(dst, idx, src)`` in place, in element order."""
    lib = _lib()
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    src = np.ascontiguousarray(src, dtype=np.float32)
    _check_dst(dst, dim)
    _check_index(idx, len(dst), "idx")
    _check_rows(src, len(idx), dim, "src")
    lib.ptmw_scatter_add_rows(_p(dst, ctypes.c_float),
                              _p(idx, ctypes.c_int32), len(idx), dim,
                              _p(src, ctypes.c_float))
