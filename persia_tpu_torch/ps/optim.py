"""Server-side sparse optimizers applied inline on parameter-server entries.

A copy of ``persia_tpu/ps/optim.py`` for fp32 rows: the same numpy
expressions in the same order, so an update here is bit-identical to the
JAX package's. Every update is batched: ``update(entries, grads, ...)``
operates in place on an ``(n, dim + space)`` matrix of entries laid out
``[embedding | optimizer state]``. Half-precision rows (``RowPrecision``)
are not ported yet.
"""

from typing import Dict, Optional, Tuple

import numpy as np


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


def apply_weight_bound(emb: np.ndarray, bound: float) -> None:
    """Clamp embeddings to [-bound, bound] in place."""
    np.clip(emb, -bound, bound, out=emb)
