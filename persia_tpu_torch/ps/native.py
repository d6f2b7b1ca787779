"""Choosing a parameter-server holder (``persia_tpu/ps/native.py``
``make_holder``).

The JAX package negotiates between its native C++ arena store and two
Python holders. The port has the two Python holders; the native store
arrives with a loader of the port's own (ROADMAP.md queue A item 2d).
"""

import logging
from typing import Optional

from persia_tpu_torch.ps.arena import ArenaEmbeddingHolder
from persia_tpu_torch.ps.store import EmbeddingHolder

_logger = logging.getLogger(__name__)

BACKENDS = ("auto", "native", "arena", "python-legacy")
_native_noted = False


def make_holder(capacity: int, num_internal_shards: int,
                prefer_native: bool = True, row_dtype: str = "fp32",
                capacity_bytes=None, hotness=None, spill_dir=None,
                spill_bytes=None, backend: Optional[str] = None):
    """The holder for a storage policy:

    - ``auto`` (the default, also for ``backend=None``): the arena holder,
      noting once in the log that the native C++ store is not ported;
    - ``arena``: the arena holder (:mod:`persia_tpu_torch.ps.arena`);
    - ``python-legacy``: the per-entry ``EmbeddingHolder``, fp32 rows with
      a row budget only (the A/B baseline);
    - ``native``: raises ``NotImplementedError``.
    """
    global _native_noted
    backend = backend or "auto"
    if backend not in BACKENDS:
        raise ValueError(f"unknown PS backend {backend!r} (expected "
                         f"{'|'.join(BACKENDS)})")
    if backend == "native":
        raise NotImplementedError(
            "make_holder(backend='native'): the native C++ store is not "
            "ported; it waits for a loader of the port's own, ROADMAP.md "
            "queue A item 2d")
    if backend == "python-legacy":
        if ((row_dtype or "fp32") != "fp32" or capacity_bytes or hotness
                or spill_dir):
            raise NotImplementedError(
                "make_holder(backend='python-legacy') keeps fp32 rows under "
                "a row budget only; use backend='arena' for row_dtype, "
                "capacity_bytes, hotness or spill_dir")
        return EmbeddingHolder(capacity, num_internal_shards)
    if backend == "auto" and prefer_native and not _native_noted:
        _native_noted = True
        _logger.warning("the native C++ PS store is not ported; using "
                        "the Python arena holder")
    return ArenaEmbeddingHolder(
        capacity, num_internal_shards, row_dtype=row_dtype or "fp32",
        capacity_bytes=capacity_bytes, hotness=hotness,
        spill_dir=spill_dir, spill_bytes=spill_bytes)
