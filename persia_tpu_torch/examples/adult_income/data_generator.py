"""Synthetic adult-income-style dataset (``examples/adult_income/data_generator.py``).

An equivalent of the UCI adult-income task, generated deterministically:
8 categorical slots + 5 dense features, with the label a noisy logistic
function of hidden per-category weights, so the model can only reach a
high AUC by learning the embeddings through the sparse path. The bytes
equal the JAX example's for the same arguments.
"""

from typing import Iterator, Tuple

import numpy as np

from persia_tpu_torch.data.batch import (
    IDTypeFeatureWithSingleID,
    Label,
    NonIDTypeFeature,
    PersiaBatch,
)

NUM_SLOTS = 8
NUM_DENSE = 5
VOCAB_PER_SLOT = 64


def _hidden_weights(seed: int = 7):
    rng = np.random.default_rng(seed)
    cat_w = rng.normal(0.0, 1.0, size=(NUM_SLOTS, VOCAB_PER_SLOT))
    dense_w = rng.normal(0.0, 0.5, size=NUM_DENSE)
    return cat_w, dense_w


def generate(
    num_samples: int, seed: int = 0, noise: float = 0.25
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (categorical ids (n, NUM_SLOTS) u64, dense (n, NUM_DENSE) f32,
    labels (n, 1) f32)."""
    rng = np.random.default_rng(seed)
    cat_w, dense_w = _hidden_weights()
    ids = rng.integers(0, VOCAB_PER_SLOT, size=(num_samples, NUM_SLOTS))
    dense = rng.normal(size=(num_samples, NUM_DENSE)).astype(np.float32)
    logits = cat_w[np.arange(NUM_SLOTS)[None, :], ids].sum(axis=1)
    logits += dense @ dense_w
    logits += rng.normal(0.0, noise * logits.std(), size=num_samples)
    prob = 1.0 / (1.0 + np.exp(-2.5 * logits / logits.std()))
    labels = (rng.random(num_samples) < prob).astype(np.float32)[:, None]
    # offset ids per slot so slots occupy distinct sign ranges
    signs = (ids + np.arange(NUM_SLOTS)[None, :] * VOCAB_PER_SLOT).astype(np.uint64)
    return signs, dense, labels


def batches(
    num_samples: int, batch_size: int, seed: int = 0, requires_grad: bool = True
) -> Iterator[PersiaBatch]:
    signs, dense, labels = generate(num_samples, seed=seed)
    for start in range(0, num_samples, batch_size):
        end = min(start + batch_size, num_samples)
        id_feats = [
            IDTypeFeatureWithSingleID(
                f"slot_{s}", np.ascontiguousarray(signs[start:end, s])
            )
            for s in range(NUM_SLOTS)
        ]
        yield PersiaBatch(
            id_feats,
            non_id_type_features=[NonIDTypeFeature(dense[start:end])],
            labels=[Label(labels[start:end])],
            requires_grad=requires_grad,
            batch_id=start // batch_size,
        )


def load_npz(path: str):
    """Load the reference's preprocessed dataset format once.

    The ``train.npz``/``test.npz`` layout the reference's
    ``data_preprocess.py`` emits (keys: target, continuous_data,
    categorical_data, categorical_columns), so real UCI adult-income
    files prepared for the reference load here too.

    Returns (names, categorical u64 (n, C), dense f32 (n, D),
    labels f32 (n, 1)). Note the per-column codes start at 0 for every
    column — the schema must namespace slots via
    ``feature_index_prefix_bit`` (the reference config uses 12) or
    different columns collide on the same embedding rows."""
    with np.load(path) as data:
        target = data["target"].astype(np.float32)
        dense = data["continuous_data"].astype(np.float32)
        cats = data["categorical_data"].astype(np.uint64)
        names = [str(c) for c in data["categorical_columns"]]
    if len(target) == 0:
        raise ValueError(f"{path}: dataset is empty")
    return names, cats, dense, target.reshape(len(target), 1)


def array_batches(
    names, cats, dense, labels, batch_size: int = 128,
    requires_grad: bool = True,
) -> Iterator[PersiaBatch]:
    """Batches over preloaded arrays (one load, many epochs)."""
    n = len(labels)
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        id_feats = [
            IDTypeFeatureWithSingleID(
                name, np.ascontiguousarray(cats[start:end, i])
            )
            for i, name in enumerate(names)
        ]
        yield PersiaBatch(
            id_feats,
            non_id_type_features=[NonIDTypeFeature(dense[start:end])],
            labels=[Label(labels[start:end])],
            requires_grad=requires_grad,
            batch_id=start // batch_size,
        )


def npz_batches(
    path: str, batch_size: int = 128, requires_grad: bool = True
) -> Iterator[PersiaBatch]:
    """One-shot convenience: :func:`load_npz` + :func:`array_batches`."""
    return array_batches(*load_npz(path), batch_size=batch_size,
                         requires_grad=requires_grad)
