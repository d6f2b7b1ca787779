"""Criteo click logs for the Criteo job (``examples/criteo/criteo_data.py``).

The Kaggle DAC / Criteo-1TB TSV format: each line is ``label \\t I1..I13 \\t
C1..C26`` (an int may be empty; a categorical is 8 hex digits or empty).
:func:`criteo_batches` streams a plain or ``.gz`` file as PersiaBatches,
bit for bit as the JAX example does: dense features ``log1p(max(x, 0))``,
each categorical token parsed to a u64 (its hex value, or its first 8
UTF-8 bytes little-endian when it is not hex) and mixed with FarmHash64
into the sign space, ``| 1`` so that a present token never gets sign 0; an
empty token is sign 0. The columns are kept apart by the schema's
``feature_index_prefix_bit``. :func:`write_synthetic_tsv` writes a small
file of the format from a seed, byte for byte as the JAX example's.

The synthetic streams of the JAX example, draw for draw:
``learnable_batches`` (labels from fixed hidden per-id weights and a dense
term, so a tower can learn them) and ``synthetic_batches`` (uniform
signs, noise labels). Both live in the port's workload zoo
(:mod:`persia_tpu_torch.workloads.generator`); this module keeps the
example's names.
"""

import gzip
from typing import Iterator, Optional

import numpy as np

from persia_tpu_torch.data.batch import (
    IDTypeFeatureWithSingleID,
    Label,
    NonIDTypeFeature,
    PersiaBatch,
)
from persia_tpu_torch.hashing import farmhash64_np
from persia_tpu_torch.workloads.generator import (  # noqa: F401
    CRITEO_SLOT_NAMES as SLOT_NAMES,
    NUM_DENSE,
    NUM_TABLES as NUM_SLOTS,
    criteo_learnable_batches as learnable_batches,
    criteo_uniform_batches as synthetic_batches,
    hidden_weight as _hidden_weight,
)


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _token_to_u64(t: str) -> int:
    """One categorical token -> its raw u64 (0: missing). A token that is
    not hex packs its first 8 bytes instead of ending the stream."""
    if not t:
        return 0
    try:
        return int(t, 16) & 0xFFFFFFFFFFFFFFFF
    except ValueError:
        return int.from_bytes(t.encode()[:8].ljust(8, b"\0"), "little")


def _hash_token_matrix(rows) -> np.ndarray:
    """A batch's categorical tokens -> (n, 26) u64 signs in one FarmHash
    pass; empty tokens are sign 0, present ones ``farmhash64(u64) | 1``."""
    n = len(rows)
    count = n * NUM_SLOTS
    flat_vals = np.fromiter(
        (_token_to_u64(t) for row in rows for t in row),
        dtype=np.uint64, count=count)
    mask = np.fromiter(
        (bool(t) for row in rows for t in row), dtype=bool, count=count)
    out = np.zeros(count, dtype=np.uint64)
    if mask.any():
        out[mask] = farmhash64_np(flat_vals[mask]) | np.uint64(1)
    return out.reshape(n, NUM_SLOTS)


def criteo_batches(
    path: str,
    batch_size: int = 4096,
    max_samples: Optional[int] = None,
    requires_grad: bool = True,
    replica_index: int = 0,
    replica_size: int = 1,
) -> Iterator[PersiaBatch]:
    """Stream PersiaBatches from a Criteo TSV (``.gz``) file.

    Replica ``replica_index`` of ``replica_size`` owns the lines whose
    ``line_idx // batch_size`` is ``replica_index`` modulo
    ``replica_size`` and skips the others before parsing them. A line
    with the wrong field count is dropped but still counts in
    ``line_idx``, which ``max_samples`` caps. A short last batch is
    yielded."""
    labels, dense_rows, cat_rows = [], [], []
    batch_id = 0
    line_idx = 0

    def flush():
        nonlocal labels, dense_rows, cat_rows, batch_id
        n = len(labels)
        dense = np.log1p(np.maximum(
            np.array(dense_rows, dtype=np.float32), 0.0))
        cats = _hash_token_matrix(cat_rows)
        batch = PersiaBatch(
            [IDTypeFeatureWithSingleID(
                SLOT_NAMES[i], np.ascontiguousarray(cats[:, i]))
             for i in range(NUM_SLOTS)],
            non_id_type_features=[NonIDTypeFeature(dense)],
            labels=[Label(np.array(labels, np.float32).reshape(n, 1))],
            requires_grad=requires_grad,
            batch_id=batch_id,
        )
        labels, dense_rows, cat_rows = [], [], []
        batch_id += 1
        return batch

    with _open(path) as f:
        for line in f:
            if max_samples is not None and line_idx >= max_samples:
                break
            owned = ((line_idx // batch_size) % replica_size
                     == replica_index)
            line_idx += 1
            if not owned:
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 1 + NUM_DENSE + NUM_SLOTS:
                continue
            labels.append(float(parts[0]))
            dense_rows.append(
                [float(x) if x else 0.0 for x in parts[1:1 + NUM_DENSE]])
            cat_rows.append(parts[1 + NUM_DENSE:])
            if len(labels) == batch_size:
                yield flush()
    if labels:
        yield flush()


def write_synthetic_tsv(path: str, num_samples: int, seed: int = 0):
    """A small Criteo-format file from ``seed``: a label 1 with
    probability 0.25, each field empty with probability 0.1, ints in
    [0, 1000), categoricals 8 hex digits."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(num_samples):
            label = int(rng.random() < 0.25)
            ints = [
                "" if rng.random() < 0.1 else str(int(rng.integers(0, 1000)))
                for _ in range(NUM_DENSE)
            ]
            cats = [
                "" if rng.random() < 0.1
                else format(int(rng.integers(0, 1 << 32)), "08x")
                for _ in range(NUM_SLOTS)
            ]
            f.write("\t".join([str(label), *ints, *cats]) + "\n")
