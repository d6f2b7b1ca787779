"""The embedding parameter store: a sharded LRU map of fp32 rows.

A trimmed copy of the semantics of ``persia_tpu/ps/store.py``'s
``EmbeddingHolder`` that the serving path needs:

- ``configure`` stores the initialization hyperparameters;
- the eval ``lookup`` is read-only and answers a miss with zeros;
- ``set_entries`` / ``get_entries`` write and read whole rows;
- inserting at capacity evicts the least recently inserted row of the
  internal shard (eval lookups do not refresh recency).

Training lookups, the sparse optimizer, half-precision rows, the disk
spill tier and hotness sketches belong to later slices of the port.
"""

import threading
from collections import OrderedDict
from typing import List, Tuple

import numpy as np

from persia_tpu_torch.ps.rng import internal_shard_of


class EmbeddingHolder:
    """One process-level PS replica: ``num_internal_shards``
    independently-locked LRU maps of ``sign -> (dim, f32 row)``."""

    def __init__(self, capacity: int = 1_000_000_000,
                 num_internal_shards: int = 8):
        if num_internal_shards <= 0:
            raise ValueError("num_internal_shards must be positive")
        self.capacity = capacity
        self.num_internal_shards = num_internal_shards
        self._per_shard = max(1, capacity // num_internal_shards)
        self._shards: List["OrderedDict[int, Tuple[int, np.ndarray]]"] = [
            OrderedDict() for _ in range(num_internal_shards)]
        self._locks = [threading.Lock() for _ in range(num_internal_shards)]
        self.init_method: str = "bounded_uniform"
        self.init_params: dict = {"lower": -0.01, "upper": 0.01}
        self.admit_probability: float = 1.0
        self.weight_bound: float = 10.0
        self.enable_weight_bound: bool = True
        self.configured = False

    def configure(self, init_method: str, init_params: dict,
                  admit_probability: float = 1.0, weight_bound: float = 10.0,
                  enable_weight_bound: bool = True):
        self.init_method = init_method
        self.init_params = dict(init_params)
        self.admit_probability = admit_probability
        self.weight_bound = weight_bound
        self.enable_weight_bound = enable_weight_bound
        self.configured = True

    def _groups(self, signs: np.ndarray):
        shard_ids = internal_shard_of(signs, self.num_internal_shards)
        for shard_idx in np.unique(shard_ids):
            yield int(shard_idx), np.nonzero(shard_ids == shard_idx)[0]

    def lookup(self, signs: np.ndarray, dim: int,
               training: bool) -> np.ndarray:
        """(n, dim) f32 rows for ``signs``. Eval only: a miss, or a row of
        another width, reads zeros and creates nothing."""
        if training:
            raise NotImplementedError(
                "training lookups are not ported yet (see ROADMAP.md)")
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        out = np.zeros((len(signs), dim), dtype=np.float32)
        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            with self._locks[shard_idx]:
                for pos in sel:
                    entry = shard.get(int(signs[pos]))
                    if entry is not None and entry[0] == dim:
                        out[pos] = entry[1][:dim]
        return out

    def _insert_locked(self, shard_idx: int, sign: int, dim: int,
                       vec: np.ndarray):
        shard = self._shards[shard_idx]
        shard.pop(sign, None)
        shard[sign] = (dim, vec)
        while len(shard) > self._per_shard:
            shard.popitem(last=False)

    def set_entries(self, signs: np.ndarray, dim: int, vecs: np.ndarray):
        """Insert or replace the rows ``vecs`` (n, width >= dim) f32."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        if vecs.ndim != 2 or len(vecs) != len(signs) or vecs.shape[1] < dim:
            raise ValueError(
                f"set_entries: vecs {vecs.shape} does not match "
                f"{len(signs)} signs of dim {dim}")
        for shard_idx, sel in self._groups(signs):
            with self._locks[shard_idx]:
                for pos in sel:
                    self._insert_locked(shard_idx, int(signs[pos]), dim,
                                        vecs[pos].copy())

    def get_entries(self, signs: np.ndarray, width: int):
        """Returns (found (n,) bool, vecs (n, width) f32); entries absent or
        of another width read as not found."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        found = np.zeros(len(signs), dtype=bool)
        vecs = np.zeros((len(signs), width), dtype=np.float32)
        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            with self._locks[shard_idx]:
                for pos in sel:
                    entry = shard.get(int(signs[pos]))
                    if entry is not None and len(entry[1]) == width:
                        found[pos] = True
                        vecs[pos] = entry[1]
        return found, vecs

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)
