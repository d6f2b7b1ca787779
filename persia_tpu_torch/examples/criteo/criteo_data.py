"""Criteo-shaped batches of the Criteo job (``examples/criteo/criteo_data.py``).

The synthetic streams of the JAX example, draw for draw: ``learnable_batches``
(labels from fixed hidden per-id weights and a dense term, so a tower can
learn them) and ``synthetic_batches`` (uniform signs, noise labels). Both
live in the port's workload zoo (:mod:`persia_tpu_torch.workloads.generator`);
this module keeps the example's names. The JAX example's TSV reader
(``criteo_batches``) is not ported: the dataset files are not in the repo.
"""

from persia_tpu_torch.workloads.generator import (  # noqa: F401
    CRITEO_SLOT_NAMES as SLOT_NAMES,
    NUM_DENSE,
    NUM_TABLES as NUM_SLOTS,
    criteo_learnable_batches as learnable_batches,
    criteo_uniform_batches as synthetic_batches,
    hidden_weight as _hidden_weight,
)
