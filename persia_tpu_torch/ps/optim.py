"""Server-side sparse optimizers applied inline on parameter-server
entries, and the storage precision of a row.

A copy of ``persia_tpu/ps/optim.py``: the same numpy expressions in the
same order, so an update here is bit-identical to the JAX package's.
Every update is batched: ``update(entries, grads, ...)`` operates in place
on an ``(n, dim + space)`` f32 matrix of entries laid out ``[embedding |
optimizer state]``. :class:`RowPrecision` stores the embedding slice in
fp32, fp16 or bf16; bf16 is kept as uint16 bit patterns (no
``ml_dtypes``), rounded and widened exactly as ``ml_dtypes`` does.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

ROW_DTYPES = ("fp32", "fp16", "bf16")


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (uint16), round to nearest even from the
    f32 bits. A NaN becomes the quiet NaN 0x7FC0 with its sign, as
    ``ml_dtypes.bfloat16`` gives; infinities, subnormals and overflow past
    the largest finite bf16 (to inf) follow from the rounding."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    out = ((u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))))
           >> np.uint32(16)).astype(np.uint16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    if nan.any():
        out[nan] = ((u[nan] >> np.uint32(16)) & np.uint32(0x8000)) \
            | np.uint32(0x7FC0)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) -> f32, exactly (a 16-bit shift)."""
    return (np.asarray(bits, dtype=np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


class RowPrecision:
    """Per-table storage precision of the EMBEDDING slice of a PS entry:
    widen on read, narrow on write.

    Under ``fp16``/``bf16`` the embedding slice is stored in half
    precision while the appended optimizer state stays f32 (half-precision
    accumulators freeze the effective learning rate). The stored form is
    one contiguous uint8 buffer ``[emb as half | state as f32]``; ``fp32``
    keeps the single f32 array. All optimizer math runs on widened f32
    matrices, so the only loss is the final narrow of the embedding slice.

    ``np_dtype`` is the STORAGE dtype of one embedding element: float32,
    float16, or uint16 holding bf16 bit patterns. :meth:`to_f32` and
    :meth:`from_f32` convert between it and f32."""

    def __init__(self, name: str = "fp32"):
        if name not in ROW_DTYPES:
            raise ValueError(
                f"unknown row_dtype {name!r} (expected one of {ROW_DTYPES})")
        self.name = name
        self.np_dtype = {
            "fp32": np.dtype(np.float32),
            "fp16": np.dtype(np.float16),
            "bf16": np.dtype(np.uint16),
        }[name]
        self.itemsize = self.np_dtype.itemsize
        self.is_fp32 = name == "fp32"
        # (dim, space) -> structured dtype viewing one stored row as
        # [emb half | state f32] without copies
        self._struct_cache: Dict[Tuple[int, int], np.dtype] = {}

    # --- element conversion ----------------------------------------------

    def to_f32(self, stored: np.ndarray) -> np.ndarray:
        """Stored embedding elements -> f32 (exact)."""
        if self.name == "bf16":
            return bf16_bits_to_f32(stored)
        return np.asarray(stored).astype(np.float32, copy=False)

    def from_f32(self, x: np.ndarray) -> np.ndarray:
        """f32 -> stored embedding elements (round to nearest even)."""
        if self.name == "bf16":
            return f32_to_bf16_bits(x)
        return np.asarray(x, dtype=np.float32).astype(self.np_dtype,
                                                      copy=False)

    def _row_struct(self, dim: int, space: int) -> np.dtype:
        dt = self._struct_cache.get((dim, space))
        if dt is None:
            fields = [("e", self.np_dtype, (dim,))]
            if space:
                fields.append(("s", np.float32, (space,)))
            dt = self._struct_cache[(dim, space)] = np.dtype(fields)
        return dt

    # --- byte math ---------------------------------------------------------

    def emb_nbytes(self, dim: int) -> int:
        return dim * self.itemsize

    def entry_nbytes(self, dim: int, space: int) -> int:
        """Stored DATA bytes of one entry (embedding + optimizer state)."""
        return dim * self.itemsize + space * 4

    def stored_len(self, dim: int, space: int) -> int:
        """``len()`` of the stored array of an entry of this shape: f32
        elements under fp32, raw bytes under half precision."""
        if self.is_fp32:
            return dim + space
        return self.entry_nbytes(dim, space)

    def state_len_of(self, vec: np.ndarray, dim: int) -> Optional[int]:
        """Optimizer-state f32 slots of a stored vec, or None if the byte
        length cannot belong to a ``dim``-wide entry."""
        if self.is_fp32:
            return len(vec) - dim if len(vec) >= dim else None
        extra = len(vec) - dim * self.itemsize
        if extra < 0 or extra % 4:
            return None
        return extra // 4

    # --- narrow on write ---------------------------------------------------

    def pack(self, full: np.ndarray, dim: int) -> np.ndarray:
        """f32 ``[emb | state]`` -> the stored form (fresh buffer)."""
        if self.is_fp32:
            return np.ascontiguousarray(full, dtype=np.float32)
        emb = self.from_f32(np.ascontiguousarray(full[:dim]))
        state = np.ascontiguousarray(full[dim:], dtype=np.float32)
        buf = np.empty(emb.nbytes + state.nbytes, np.uint8)
        buf[: emb.nbytes] = emb.view(np.uint8)
        if state.nbytes:
            buf[emb.nbytes:] = state.view(np.uint8)
        return buf

    def pack_into(self, full: np.ndarray, vec: np.ndarray, dim: int):
        """Narrow ``full`` (f32 [emb|state]) into the existing stored
        buffer ``vec`` in place."""
        if self.is_fp32:
            vec[:] = full
            return
        emb = self.from_f32(np.ascontiguousarray(full[:dim]))
        vec[: emb.nbytes] = emb.view(np.uint8)
        state = np.ascontiguousarray(full[dim:], dtype=np.float32)
        if state.nbytes:
            vec[emb.nbytes:] = state.view(np.uint8)

    # --- widen on read -----------------------------------------------------

    def emb_f32(self, vec: np.ndarray, dim: int) -> np.ndarray:
        """The embedding slice of a stored vec, widened to f32."""
        if self.is_fp32:
            return vec[:dim]
        return self.to_f32(np.ascontiguousarray(
            vec[: dim * self.itemsize]).view(self.np_dtype))

    def unpack(self, vec: np.ndarray, dim: int) -> np.ndarray:
        """Stored vec -> a fresh f32 ``[emb | state]`` array."""
        if self.is_fp32:
            return np.array(vec, dtype=np.float32)
        esz = dim * self.itemsize
        out = np.empty(dim + (len(vec) - esz) // 4, np.float32)
        self.unpack_into(vec, dim, out)
        return out

    def unpack_raw(self, raw: np.ndarray, dim: int) -> np.ndarray:
        """A logical record's uint8 bytes ``[emb | state f32]`` (the form
        the spill tier and PSD v2 keep) -> a fresh f32 ``[emb | state]``."""
        if self.is_fp32:
            return raw.view(np.float32).copy()
        return self.unpack(raw, dim)

    def unpack_into(self, vec: np.ndarray, dim: int, out: np.ndarray):
        if self.is_fp32:
            out[:] = vec
            return
        esz = dim * self.itemsize
        out[:dim] = self.emb_f32(vec, dim)
        if len(vec) > esz:
            out[dim:] = np.ascontiguousarray(vec[esz:]).view(np.float32)

    def unpack_matrix(self, vecs: List[np.ndarray], dim: int,
                      width: int) -> np.ndarray:
        """Widen uniform-shape stored vecs into one (n, width) f32 matrix
        for the batched optimizer call."""
        if self.is_fp32:
            return np.stack(vecs).astype(np.float32, copy=False)
        n = len(vecs)
        space = width - dim
        rec = np.stack(vecs).view(self._row_struct(dim, space))  # (n, 1)
        mat = np.empty((n, width), np.float32)
        mat[:, :dim] = self.to_f32(rec["e"].reshape(n, dim))
        if space:
            mat[:, dim:] = rec["s"].reshape(n, space)
        return mat

    def narrow_matrix(self, mat: np.ndarray, dim: int) -> np.ndarray:
        """f32 (n, dim+space) -> the stored byte layout as one
        (n, stored_len) uint8 matrix."""
        n, width = mat.shape
        space = width - dim
        stored = np.empty((n, self.entry_nbytes(dim, space)), np.uint8)
        rec = stored.view(self._row_struct(dim, space))
        rec["e"].reshape(n, dim)[...] = self.from_f32(mat[:, :dim])
        if space:
            rec["s"].reshape(n, space)[...] = mat[:, dim:]
        return stored

    def pack_matrix_into(self, mat: np.ndarray,
                         vecs: List[np.ndarray], dim: int):
        """Narrow the updated f32 matrix back into the stored per-entry
        buffers, one assignment per row."""
        if self.is_fp32:
            for row, vec in zip(mat, vecs):
                vec[:] = row
            return
        stored = self.narrow_matrix(mat, dim)
        for i, vec in enumerate(vecs):
            vec[:] = stored[i]


class SparseOptimizer:
    """Interface of a server-side optimizer."""

    def require_space(self, dim: int) -> int:
        """Extra f32 slots appended to each entry for optimizer state."""
        return 0

    def state_initialization(self, entries: np.ndarray, dim: int) -> None:
        """Initialize the state slice ``entries[:, dim:]`` in place."""

    def batch_level_state(self, signs: np.ndarray) -> Optional[np.ndarray]:
        """Per-sign state computed once per update batch (Adam beta powers)."""
        return None

    def update(self, entries: np.ndarray, grads: np.ndarray, dim: int,
               batch_level_state: Optional[np.ndarray] = None) -> None:
        """Apply one optimizer step to every row of ``entries`` in place."""
        raise NotImplementedError

    def update_lr(self, lr: float) -> None:
        pass

    def to_config(self) -> dict:
        """The config :meth:`from_config` builds this optimizer from."""
        raise NotImplementedError

    @staticmethod
    def from_config(config: dict,
                    feature_index_prefix_bit: int = 0) -> "SparseOptimizer":
        kind = config["type"]
        kwargs = {k: v for k, v in config.items() if k != "type"}
        if kind == "sgd":
            return SparseSGD(**kwargs)
        if kind == "adagrad":
            return SparseAdagrad(**kwargs)
        if kind == "adam":
            return SparseAdam(
                feature_index_prefix_bit=feature_index_prefix_bit, **kwargs)
        raise ValueError(f"unknown sparse optimizer type {kind!r}")


class SparseSGD(SparseOptimizer):
    """Decayed SGD: ``emb -= lr * (grad + wd * emb)``."""

    def __init__(self, lr: float, wd: float = 0.0):
        self.lr = float(lr)
        self.wd = float(wd)

    def update(self, entries, grads, dim, batch_level_state=None):
        emb = entries[:, :dim]
        emb -= self.lr * (grads + self.wd * emb)

    def update_lr(self, lr: float) -> None:
        self.lr = lr

    def to_config(self) -> dict:
        return {"type": "sgd", "lr": self.lr, "wd": self.wd}


class SparseAdagrad(SparseOptimizer):
    """Decayed Adagrad, optionally with one accumulator shared across the
    vector.

    Non-shared: ``emb -= lr * grad / sqrt(acc + eps); acc = acc*g2m + grad²``.
    Shared: the step uses the accumulator from before this batch's
    gradient is accumulated.
    """

    def __init__(self, lr: float = 1e-2, wd: float = 0.0,
                 g_square_momentum: float = 1.0,
                 initialization: float = 1e-2, eps: float = 1e-10,
                 vectorwise_shared: bool = False):
        self.lr = float(lr)
        self.wd = float(wd)
        self.g_square_momentum = float(g_square_momentum)
        self.initialization = float(initialization)
        self.eps = float(eps)
        self.vectorwise_shared = bool(vectorwise_shared)

    def require_space(self, dim: int) -> int:
        return 1 if self.vectorwise_shared else dim

    def state_initialization(self, entries, dim):
        entries[:, dim:] = self.initialization

    def update(self, entries, grads, dim, batch_level_state=None):
        emb = entries[:, :dim]
        if self.vectorwise_shared:
            acc = entries[:, dim]  # (n,)
            scale = self.lr / np.sqrt(acc + self.eps)
            emb -= scale[:, None] * grads
            g2 = np.mean(grads * grads, axis=1)
            entries[:, dim] = acc * self.g_square_momentum + g2
        else:
            acc = entries[:, dim:]
            emb -= self.lr * grads / np.sqrt(acc + self.eps)
            acc *= self.g_square_momentum
            acc += grads * grads

    def update_lr(self, lr: float) -> None:
        self.lr = lr

    def to_config(self) -> dict:
        return {"type": "adagrad", "lr": self.lr, "wd": self.wd,
                "g_square_momentum": self.g_square_momentum,
                "initialization": self.initialization, "eps": self.eps,
                "vectorwise_shared": self.vectorwise_shared}


class SparseAdam(SparseOptimizer):
    """Adam with per-feature-group accumulated beta powers.

    The bias-correction powers are tracked per feature group (the sign's
    index-prefix bits) and advanced once per update batch per group; they
    start at β and are advanced before first use, so the first step
    corrects with β².
    """

    def __init__(self, lr: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 feature_index_prefix_bit: int = 0):
        self.lr = float(lr)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.eps = float(eps)
        self.feature_index_prefix_bit = int(feature_index_prefix_bit)
        # group prefix -> accumulated (beta1^t, beta2^t), f32
        self._accum: Dict[int, Tuple[np.float32, np.float32]] = {}

    def require_space(self, dim: int) -> int:
        return dim * 2

    def batch_level_state(self, signs: np.ndarray) -> np.ndarray:
        if self.feature_index_prefix_bit > 0:
            mask = ~((1 << (64 - self.feature_index_prefix_bit)) - 1) & (
                (1 << 64) - 1)
        else:
            mask = 0
        masked = (signs.astype(np.uint64) & np.uint64(mask)).tolist()
        out = np.empty((len(masked), 2), dtype=np.float32)
        stepped: Dict[int, Tuple[np.float32, np.float32]] = {}
        b1 = np.float32(self.beta1)
        b2 = np.float32(self.beta2)
        for i, g in enumerate(masked):
            if g in stepped:
                out[i] = stepped[g]
                continue
            p1, p2 = self._accum.get(g, (b1, b2))
            p1 = np.float32(p1 * b1)
            p2 = np.float32(p2 * b2)
            self._accum[g] = (p1, p2)
            stepped[g] = (p1, p2)
            out[i] = (p1, p2)
        return out

    def update(self, entries, grads, dim, batch_level_state=None):
        if batch_level_state is None:
            raise ValueError("SparseAdam.update requires batch_level_state")
        emb = entries[:, :dim]
        m = entries[:, dim:2 * dim]
        v = entries[:, 2 * dim:3 * dim]
        b1p = batch_level_state[:, 0][:, None]
        b2p = batch_level_state[:, 1][:, None]
        m *= self.beta1
        m += (1.0 - self.beta1) * grads
        v *= self.beta2
        v += (1.0 - self.beta2) * grads * grads
        m_hat = m / (1.0 - b1p)
        v_hat = v / (1.0 - b2p)
        emb -= self.lr * m_hat / (self.eps + np.sqrt(v_hat))

    def update_lr(self, lr: float) -> None:
        self.lr = lr

    def to_config(self) -> dict:
        return {"type": "adam", "lr": self.lr, "beta1": self.beta1,
                "beta2": self.beta2, "eps": self.eps}


def apply_weight_bound(emb: np.ndarray, bound: float) -> None:
    """Clamp embeddings to [-bound, bound] in place."""
    np.clip(emb, -bound, bound, out=emb)
