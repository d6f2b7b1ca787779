"""The embedding parameter store: a sharded LRU map of rows.

A copy of the semantics of ``persia_tpu/ps/store.py``'s
``EmbeddingHolder``:

- entries are ``[embedding | optimizer state]`` f32 vectors with a
  per-entry dim, kept in ``num_internal_shards`` independently locked LRU
  maps; inserting at capacity evicts the least recently used row of the
  internal shard;
- ``configure`` stores the initialization hyperparameters and
  ``register_optimizer`` the sparse optimizer;
- the **training lookup**: a hit refreshes recency; a miss is admitted
  with the deterministic per-sign probability and then initialized from
  the sign's seeded stream, with the optimizer's state initialization,
  and inserted; a miss that is not admitted reads zeros and leaves no
  entry; a hit of another dim is re-initialized unconditionally;
- the **eval lookup** is read-only and answers a miss with zeros;
- ``update_gradients`` applies the optimizer per sign (duplicate signs
  one after another, otherwise one batched call) and then the weight
  bound; signs absent or of another layout are skipped and counted;
- ``set_entries`` / ``get_entries`` write and read whole rows;
- ``spill_dir`` demotes the rows eviction would drop to the disk spill
  tier (:mod:`persia_tpu_torch.ps.spill`), and any later access faults
  them back in (a training access takes the row and re-inserts it, a
  read-only access peeks); ``hotness`` arms the workload sketches
  (:mod:`persia_tpu_torch.hotness`);
- ``row_dtype`` ``fp16`` / ``bf16`` stores each row's embedding slice
  in half precision and its optimizer state in f32, as one byte buffer
  (:class:`~persia_tpu_torch.ps.optim.RowPrecision`): reads widen, the
  optimizer runs on f32 and writes narrow; ``capacity_bytes`` bounds the
  stored data bytes of each internal shard beside its row budget (the
  least recently used rows go first, down to one row);
- ``dump_bytes`` / ``load_bytes`` (and their file forms) write and read
  the PSD format (v1 for fp32 rows, v2 for half rows), the spilled rows
  included.

The PSD dump format's header and record reader live here, as in the JAX
package, and every holder writes and reads it.
"""

import io
import struct
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from persia_tpu_torch.hotness import disabled_snapshot, make_tracker
from persia_tpu_torch.ps.optim import (
    RowPrecision,
    SparseOptimizer,
    apply_weight_bound,
)
from persia_tpu_torch.ps.rng import (
    admit_mask,
    initialize_entries,
    internal_shard_of,
)
from persia_tpu_torch.ps.spill import SpillStore

DUMP_MAGIC = b"PSD1"
# PSD v2 per-record embedding dtype tags
_DTYPE_CODES = {"fp32": 0, "fp16": 1, "bf16": 2}
_DTYPE_NAMES = {v: k for k, v in _DTYPE_CODES.items()}


def bump_miss(counters: dict, kind: str, dim: int, n: int):
    """Add ``n`` to the table-labelled registry counter ``ps_<kind>_total``
    (``index_miss``: lookups that read zeros; ``gradient_id_miss``:
    updates of absent or re-laid-out rows), one locked add a (call,
    shard). ``counters`` caches the holder's cells; two first uses that
    race build one cell, the registry's."""
    key = (kind, dim)
    c = counters.get(key)
    if c is None:
        from persia_tpu_torch.metrics import default_registry

        c = counters[key] = default_registry().counter(
            f"ps_{kind}_total", {"table": str(dim)},
            help_text=(
                "eval/unadmitted/cold lookups that read zeros, per "
                "embedding table (dim)" if kind == "index_miss" else
                "gradient updates whose sign was absent or "
                "re-laid-out, per embedding table (dim)"))
    c.inc(n)


class EmbeddingHolder:
    """One process-level PS replica: ``num_internal_shards``
    independently-locked LRU maps of ``sign -> (dim, stored row)``, the
    row an f32 array (``row_dtype="fp32"``) or the half layout's bytes.
    ``capacity_bytes`` (0 or None: none) bounds each shard's data bytes
    beside ``capacity`` rows. ``spill_dir`` arms the disk tier (at most
    ``spill_bytes`` on disk), ``hotness`` the workload sketches (None: the
    ``PERSIA_HOTNESS`` knob)."""

    def __init__(self, capacity: int = 1_000_000_000,
                 num_internal_shards: int = 8, row_dtype: str = "fp32",
                 capacity_bytes: Optional[int] = None,
                 hotness: Optional[bool] = None,
                 spill_dir: Optional[str] = None,
                 spill_bytes: Optional[int] = None):
        if num_internal_shards <= 0:
            raise ValueError("num_internal_shards must be positive")
        # 0 (the config default) is no budget, not a zero-byte one
        capacity_bytes = capacity_bytes or None
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self.num_internal_shards = num_internal_shards
        self._rp = RowPrecision(row_dtype)
        self._per_shard = max(1, capacity // num_internal_shards)
        self._per_shard_bytes = (
            max(1, capacity_bytes // num_internal_shards)
            if capacity_bytes is not None else None)
        # each shard's stored data bytes and their embedding share,
        # written under the shard's lock
        self._bytes = [0] * num_internal_shards
        self._emb_bytes = [0] * num_internal_shards
        self._shards: List["OrderedDict[int, Tuple[int, np.ndarray]]"] = [
            OrderedDict() for _ in range(num_internal_shards)]
        self._locks = [threading.Lock() for _ in range(num_internal_shards)]
        self.optimizer: Optional[SparseOptimizer] = None
        self.init_method: str = "bounded_uniform"
        self.init_params: dict = {"lower": -0.01, "upper": 0.01}
        self.admit_probability: float = 1.0
        self.weight_bound: float = 10.0
        self.enable_weight_bound: bool = True
        self.configured = False
        # per-shard cells, each written only under its shard's lock
        self._index_miss = [0] * num_internal_shards
        self._gradient_id_miss = [0] * num_internal_shards
        # their registry twins, ps_index_miss_total and
        # ps_gradient_id_miss_total by table
        self._miss_counters: dict = {}
        # the tracker's and the spill store's locks are leaves: the
        # holder calls into them under its shard locks (spill) or
        # outside them (hotness), never the other way round
        self.hotness = make_tracker(num_internal_shards, enabled=hotness)
        self.spill: Optional[SpillStore] = (
            SpillStore(spill_dir, max_bytes=spill_bytes or None)
            if spill_dir else None)

    @property
    def row_dtype(self) -> str:
        return self._rp.name

    @property
    def resident_bytes(self) -> int:
        """Stored data bytes of every shard (embedding and state)."""
        return sum(self._bytes)

    @property
    def resident_emb_bytes(self) -> int:
        return sum(self._emb_bytes)

    def resident_bytes_per_shard(self) -> List[int]:
        return list(self._bytes)

    def row_nbytes(self, dim: int) -> int:
        """Stored data bytes of a row of ``dim`` under the registered
        optimizer (its state included)."""
        space = self.optimizer.require_space(dim) if self.optimizer else 0
        return self._rp.entry_nbytes(dim, space)

    @property
    def index_miss_count(self) -> int:
        return sum(self._index_miss)

    @property
    def gradient_id_miss_count(self) -> int:
        return sum(self._gradient_id_miss)

    def configure(self, init_method: str, init_params: dict,
                  admit_probability: float = 1.0, weight_bound: float = 10.0,
                  enable_weight_bound: bool = True):
        self.init_method = init_method
        self.init_params = dict(init_params)
        self.admit_probability = admit_probability
        self.weight_bound = weight_bound
        self.enable_weight_bound = enable_weight_bound
        self.configured = True

    def register_optimizer(self, config: dict,
                           feature_index_prefix_bit: int = 0):
        # persialint: ok[lock-discipline] arm-time reference swap; the shard locks guard entry buffers (which optimizer.update mutates in place), not the optimizer binding itself
        self.optimizer = SparseOptimizer.from_config(
            config, feature_index_prefix_bit=feature_index_prefix_bit)

    def hotness_snapshot(self) -> dict:
        """The hotness sketches' snapshot, each table stamped with its
        stored bytes a row; the disabled marker when unarmed."""
        if self.hotness is None:
            return disabled_snapshot()
        snap = self.hotness.snapshot()
        for table, t in snap.get("tables", {}).items():
            t["row_bytes"] = int(table) * self._rp.itemsize
        return snap

    def spill_stats(self) -> dict:
        """The disk tier's counters (empty when unarmed)."""
        return self.spill.stats() if self.spill is not None else {}

    def _groups(self, signs: np.ndarray):
        shard_ids = internal_shard_of(signs, self.num_internal_shards)
        for shard_idx in np.unique(shard_ids):
            yield int(shard_idx), np.nonzero(shard_ids == shard_idx)[0]

    def _shard_idx(self, sign: int) -> int:
        return int(internal_shard_of(np.array([sign], dtype=np.uint64),
                                     self.num_internal_shards)[0])

    def _fault_in_locked(self, shard_idx: int, sign: int, training: bool):
        """A spilled row on a shard miss: training takes it and re-inserts
        it resident (which may demote others), a read-only access peeks.
        Returns the ``(dim, f32 vec)`` entry or None. A missing or
        truncated packet raises ``SpillReadError`` with the holder
        untouched."""
        got = (self.spill.take(sign) if training
               else self.spill.peek(sign))
        if got is None:
            return None
        dim0, raw = got
        vec = raw.view(np.float32) if self._rp.is_fp32 else raw
        if training:
            self._evict_locked(shard_idx, sign, dim0, vec)
        return dim0, vec

    def lookup(self, signs: np.ndarray, dim: int,
               training: bool) -> np.ndarray:
        """(n, dim) f32 rows for ``signs``. Duplicate signs are handled in
        order: the first occurrence initializes, later ones hit it."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = len(signs)
        out = np.zeros((n, dim), dtype=np.float32)
        if n == 0:
            return out
        if training:
            if self.optimizer is None:
                raise RuntimeError(
                    "optimizer not registered on parameter server")
            if not self.configured:
                raise RuntimeError("parameter server not configured")
            # admission and the init rows of every sign at once
            # (deterministic per sign; hits ignore their row); inserts then
            # run sign by sign so intra-batch eviction and duplicates
            # behave as the sequential reference
            space = self.optimizer.require_space(dim)
            admitted = admit_mask(signs, self.admit_probability)
            init_vecs = np.zeros((n, dim + space), dtype=np.float32)
            init_vecs[:, :dim] = initialize_entries(
                signs, dim, self.init_method, self.init_params)
            if space:
                self.optimizer.state_initialization(init_vecs, dim)
        if self.hotness is not None:
            # outside the shard locks: the tracker's locks are leaves
            self.hotness.observe(dim, signs)
        if not self._rp.is_fp32:
            return self._lookup_half(signs, dim, training,
                                     init_vecs if training else None,
                                     admitted if training else None, out)
        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            n_miss = 0
            with self._locks[shard_idx]:
                for pos in sel:
                    sign = int(signs[pos])
                    entry = shard.get(sign)
                    if entry is not None and training:
                        shard.move_to_end(sign)
                    if entry is None and self.spill is not None:
                        entry = self._fault_in_locked(shard_idx, sign,
                                                      training)
                    if entry is not None and entry[0] == dim:
                        out[pos] = entry[1][:dim]
                    elif not training or (entry is None
                                          and not admitted[pos]):
                        self._index_miss[shard_idx] += 1
                        n_miss += 1
                    else:
                        # admitted miss, or a dim mismatch (re-initialized
                        # unconditionally)
                        vec = init_vecs[pos].copy()
                        out[pos] = vec[:dim]
                        self._insert_locked(shard_idx, sign, dim, vec)
                        self._index_miss[shard_idx] += 1
                        n_miss += 1
            if n_miss:
                bump_miss(self._miss_counters, "index_miss", dim, n_miss)
        return out

    def _lookup_half(self, signs, dim, training, init_vecs, admitted, out):
        """The lookup loop for half rows: the same per-sign recency,
        admission and insert sequence; the init rows narrow once for the
        batch, on its first miss, and the hit rows of a shard widen in one
        conversion under its lock. A miss returns the stored (narrowed)
        values, as every later lookup reads them."""
        rp = self._rp
        esz = dim * rp.itemsize
        narrowed = [None]

        def narrow_inits():
            if narrowed[0] is None:
                stored_rows = rp.narrow_matrix(init_vecs, dim)
                widened = rp.to_f32(np.ascontiguousarray(
                    stored_rows[:, :esz]).view(rp.np_dtype))
                narrowed[0] = (stored_rows, widened)
            return narrowed[0]

        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            hit_pos: List[int] = []
            hit_vecs: List[np.ndarray] = []
            n_miss = 0
            with self._locks[shard_idx]:
                for pos in sel:
                    sign = int(signs[pos])
                    entry = shard.get(sign)
                    if entry is not None and training:
                        shard.move_to_end(sign)
                    if entry is None and self.spill is not None:
                        entry = self._fault_in_locked(shard_idx, sign,
                                                      training)
                    if entry is not None and entry[0] == dim:
                        hit_pos.append(pos)
                        hit_vecs.append(entry[1])
                    elif not training or (entry is None
                                          and not admitted[pos]):
                        self._index_miss[shard_idx] += 1
                        n_miss += 1
                    else:
                        stored_rows, widened = narrow_inits()
                        out[pos] = widened[pos]
                        self._insert_locked(shard_idx, sign, dim,
                                            stored_rows[pos].copy())
                        self._index_miss[shard_idx] += 1
                        n_miss += 1
                if hit_pos:
                    # rows of this dim may differ in state width: copy the
                    # embedding bytes row by row, widen them at once
                    raw = np.empty((len(hit_vecs), esz), np.uint8)
                    for i, v in enumerate(hit_vecs):
                        raw[i] = v[:esz]
                    out[np.asarray(hit_pos)] = rp.to_f32(
                        raw.view(rp.np_dtype))
            if n_miss:
                bump_miss(self._miss_counters, "index_miss", dim, n_miss)
        return out

    def update_gradients(self, signs: np.ndarray, grads: np.ndarray,
                         dim: int):
        """Batched optimizer step for ``signs`` with grads (n, dim); half
        rows widen to f32 for it and narrow back."""
        if self.optimizer is None:
            raise RuntimeError("optimizer not registered on parameter server")
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        if len(signs) == 0:
            return
        batch_state = self.optimizer.batch_level_state(signs)
        space = self.optimizer.require_space(dim)
        width = dim + space
        rp = self._rp
        # the stored length of a row of this layout: f32 elements, or the
        # half layout's bytes; another length is another optimizer's
        stored_len = rp.stored_len(dim, space)
        # duplicates must apply one after another (each step sees the
        # previous one's result); a batched gather/update/scatter would
        # keep only the last
        has_dups = len(np.unique(signs)) != len(signs)
        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            n_miss = 0
            # the whole gather/update/write-back runs under the lock
            with self._locks[shard_idx]:
                found_pos: List[int] = []
                found_entries: List[np.ndarray] = []
                for pos in sel:
                    entry = shard.get(int(signs[pos]))
                    if entry is None and self.spill is not None:
                        # a gradient for a spilled row faults it in
                        entry = self._fault_in_locked(
                            shard_idx, int(signs[pos]), True)
                    if entry is None or entry[0] != dim or \
                            len(entry[1]) != stored_len:
                        self._gradient_id_miss[shard_idx] += 1
                        n_miss += 1
                    elif has_dups:
                        # fp32: updated in place; half: widened, updated,
                        # narrowed back
                        row = (entry[1] if rp.is_fp32
                               else rp.unpack(entry[1], dim))[None, :]
                        st = (batch_state[pos:pos + 1]
                              if batch_state is not None else None)
                        self.optimizer.update(row, grads[pos:pos + 1], dim,
                                              st)
                        if self.enable_weight_bound:
                            apply_weight_bound(row[:, :dim],
                                               self.weight_bound)
                        if not rp.is_fp32:
                            rp.pack_into(row[0], entry[1], dim)
                    else:
                        found_pos.append(pos)
                        found_entries.append(entry[1])
                if found_pos:
                    mat = rp.unpack_matrix(found_entries, dim, width)
                    sub_state = (batch_state[np.array(found_pos)]
                                 if batch_state is not None else None)
                    self.optimizer.update(mat, grads[np.array(found_pos)],
                                          dim, sub_state)
                    if self.enable_weight_bound:
                        apply_weight_bound(mat[:, :dim], self.weight_bound)
                    rp.pack_matrix_into(mat, found_entries, dim)
            if n_miss:
                bump_miss(self._miss_counters, "gradient_id_miss", dim,
                          n_miss)

    def _insert_locked(self, shard_idx: int, sign: int, dim: int,
                       vec: np.ndarray):
        """Insert, keeping a resident sign free of a stale spilled copy."""
        if self.spill is not None:
            self.spill.discard(sign)
        self._evict_locked(shard_idx, sign, dim, vec)

    def _account_locked(self, shard_idx: int, dim: int, vec: np.ndarray,
                 mult: int):
        self._bytes[shard_idx] += mult * vec.nbytes
        self._emb_bytes[shard_idx] += mult * min(dim * self._rp.itemsize,
                                                 vec.nbytes)

    def _evict_locked(self, shard_idx: int, sign: int, dim: int,
                      vec: np.ndarray):
        """Insert, then evict the least recently used rows past the
        shard's row budget, or past its byte budget down to one row,
        demoting them to the spill tier when armed."""
        shard = self._shards[shard_idx]
        old = shard.pop(sign, None)
        if old is not None:
            self._account_locked(shard_idx, *old, -1)
        shard[sign] = (dim, vec)
        self._account_locked(shard_idx, dim, vec, +1)
        budget = self._per_shard_bytes
        while len(shard) > self._per_shard or (
                budget is not None and self._bytes[shard_idx] > budget
                and len(shard) > 1):
            old_sign, (old_dim, old_vec) = shard.popitem(last=False)
            self._account_locked(shard_idx, old_dim, old_vec, -1)
            if self.spill is not None:
                self.spill.put(old_sign, old_dim, old_vec)

    def set_entries(self, signs: np.ndarray, dim: int, vecs: np.ndarray):
        """Insert or replace the rows ``vecs`` (n, width >= dim) f32."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        if vecs.ndim != 2 or len(vecs) != len(signs) or vecs.shape[1] < dim:
            raise ValueError(
                f"set_entries: vecs {vecs.shape} does not match "
                f"{len(signs)} signs of dim {dim}")
        rp = self._rp
        for shard_idx, sel in self._groups(signs):
            with self._locks[shard_idx]:
                for pos in sel:
                    self._insert_locked(
                        shard_idx, int(signs[pos]), dim,
                        vecs[pos].copy() if rp.is_fp32
                        else rp.pack(vecs[pos], dim))

    def get_entries(self, signs: np.ndarray, width: int):
        """Returns (found (n,) bool, vecs (n, width) f32); entries absent or
        of another width read as not found."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        found = np.zeros(len(signs), dtype=bool)
        vecs = np.zeros((len(signs), width), dtype=np.float32)
        rp = self._rp
        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            with self._locks[shard_idx]:
                for pos in sel:
                    entry = shard.get(int(signs[pos]))
                    if entry is None and self.spill is not None:
                        entry = self._fault_in_locked(
                            shard_idx, int(signs[pos]), False)
                    if entry is None:
                        continue
                    if rp.is_fp32:
                        if len(entry[1]) == width:
                            found[pos] = True
                            vecs[pos] = entry[1]
                        continue
                    # a half row of dim d and state s is d + s f32 wide
                    state_len = rp.state_len_of(entry[1], entry[0])
                    if state_len is not None and \
                            entry[0] + state_len == width:
                        found[pos] = True
                        rp.unpack_into(entry[1], entry[0], vecs[pos])
        return found, vecs

    def get_entry(self, sign: int) -> Optional[Tuple[int, np.ndarray]]:
        """(dim, f32 [emb|state]) or None: the live stored row (a widened
        copy of a half row); a spilled row reads through (peek)."""
        shard_idx = self._shard_idx(sign)
        with self._locks[shard_idx]:
            entry = self._shards[shard_idx].get(int(sign))
            if entry is None and self.spill is not None:
                entry = self._fault_in_locked(shard_idx, int(sign), False)
            if entry is None or self._rp.is_fp32:
                return entry
            return entry[0], self._rp.unpack(entry[1], entry[0])

    def set_entry(self, sign: int, dim: int, vec: np.ndarray):
        shard_idx = self._shard_idx(sign)
        vec = np.array(vec, dtype=np.float32)
        if not self._rp.is_fp32:
            vec = self._rp.pack(vec, dim)
        with self._locks[shard_idx]:
            self._insert_locked(shard_idx, int(sign), dim, vec)

    def clear(self):
        for i, shard in enumerate(self._shards):
            with self._locks[i]:
                shard.clear()
                self._bytes[i] = self._emb_bytes[i] = 0
        if self.spill is not None:
            # persialint: ok[lock-discipline] SpillStore guards its own state with its leaf lock; shard locks never guard the spill binding
            self.spill.clear()

    def __len__(self) -> int:
        """Rows of the logical table: resident plus spilled."""
        n = sum(len(s) for s in self._shards)
        if self.spill is not None:
            n += len(self.spill)
        return n

    # --- serialization (PSD v1) -----------------------------------------

    def dump_bytes(self) -> bytes:
        """Every entry as PSD v1 (``sign u64 | dim u32 | len u32 | f32
        [emb|state]``), per shard in LRU order; half rows as PSD v2
        (:meth:`_dump_v2`). A spill-armed holder
        dumps the logical table: the shards, then the spilled rows, and
        in front of both the rows that left the spill tier while the dump
        ran (so any newer record of the same sign wins on load). The
        header count is the records serialized."""
        if not self._rp.is_fp32:
            return self._dump_v2()
        chunks = []
        front = []
        if self.spill is not None:
            self.spill.start_dump_capture()
        try:
            for lock, shard in zip(self._locks, self._shards):
                with lock:
                    for sign, (dim, vec) in shard.items():
                        chunks.append(struct.pack("<QII", sign, dim,
                                                  len(vec)))
                        chunks.append(np.ascontiguousarray(
                            vec, dtype=np.float32).tobytes())
            if self.spill is not None:
                for sign, dim, raw in self.spill.items():
                    chunks.append(struct.pack("<QII", sign, dim,
                                              len(raw) // 4))
                    chunks.append(raw.tobytes())
                for sign, (dim, raw) in \
                        self.spill.stop_dump_capture().items():
                    front.append(struct.pack("<QII", sign, dim,
                                             len(raw) // 4))
                    front.append(raw.tobytes())
        finally:
            if self.spill is not None:
                self.spill.stop_dump_capture()
        count = (len(chunks) + len(front)) // 2
        return b"".join([DUMP_MAGIC, struct.pack("<IQ", 1, count)]
                        + front + chunks)

    def _dump_v2(self) -> bytes:
        """Half rows as PSD v2: records ``sign u64 | dim u32 | emb-dtype u8
        | state_len u32 | emb bytes | state f32 bytes``, in the order and
        with the spill tier's records as :meth:`dump_bytes` says."""
        rp = self._rp
        code = _DTYPE_CODES[rp.name]

        def record(sign, dim, raw):
            return [struct.pack("<QIBI", sign, dim, code,
                                rp.state_len_of(raw, dim)), raw.tobytes()]

        chunks, front = [], []
        if self.spill is not None:
            self.spill.start_dump_capture()
        try:
            for lock, shard in zip(self._locks, self._shards):
                with lock:
                    for sign, (dim, vec) in shard.items():
                        chunks += record(sign, dim, vec)
            if self.spill is not None:
                for sign, dim, raw in self.spill.items():
                    chunks += record(sign, dim, raw)
                for sign, (dim, raw) in \
                        self.spill.stop_dump_capture().items():
                    front += record(sign, dim, raw)
        finally:
            if self.spill is not None:
                self.spill.stop_dump_capture()
        count = (len(chunks) + len(front)) // 2
        return b"".join([DUMP_MAGIC, struct.pack("<IQ", 2, count)]
                        + front + chunks)

    def load_bytes(self, buf: bytes, clear: bool = True):
        """Install a PSD v1 or v2 dump (records widen or narrow to this
        holder's row dtype)."""
        reader = io.BytesIO(buf)
        version, count = read_psd_header(reader, "<load_bytes>")
        if clear:
            self.clear()
        for sign, dim, vec in iter_psd_records(reader.read, version, count):
            self.set_entry(sign, dim, vec)

    def dump_file(self, path: str):
        with open(path, "wb") as f:
            f.write(self.dump_bytes())

    def load_file(self, path: str, clear: bool = True):
        with open(path, "rb") as f:
            self.load_bytes(f.read(), clear=clear)


def read_psd_header(f, name: str = "<psd>"):
    """Validate magic + version off a file-like; returns (version,
    count)."""
    head = f.read(4 + struct.calcsize("<IQ"))
    if head[:4] != DUMP_MAGIC:
        raise ValueError(f"{name}: bad PSD1 magic")
    version, count = struct.unpack_from("<IQ", head, 4)
    if version not in (1, 2):
        raise ValueError(f"{name}: unsupported PSD version {version}")
    return version, count


def iter_psd_records(read, version: int, count: int):
    """Yield ``(sign, dim, f32 [emb|state] vec)`` records via a
    ``read(n) -> bytes`` callable. v1 records are ``sign u64 | dim u32 |
    len u32 | f32 [emb|state]``; v2 records are ``sign u64 | dim u32 |
    emb-dtype u8 | state_len u32 | emb bytes | state f32 bytes``, and
    their embedding slices widen from the tagged dtype, so any holder
    reads any version. Yielded vecs are fresh writable arrays."""
    rec1 = struct.calcsize("<QII")
    rec2 = struct.calcsize("<QIBI")
    rp_by_code: Dict[int, RowPrecision] = {}
    for _ in range(count):
        if version == 1:
            sign, dim, total = struct.unpack("<QII", read(rec1))
            vec = np.frombuffer(read(4 * total), dtype=np.float32).copy()
        else:
            sign, dim, code, state_len = struct.unpack("<QIBI", read(rec2))
            rp = rp_by_code.get(code)
            if rp is None:
                name = _DTYPE_NAMES.get(code)
                if name is None:
                    raise ValueError(f"unknown PSD2 dtype code {code}")
                rp = rp_by_code[code] = RowPrecision(name)
            raw = np.frombuffer(read(rp.entry_nbytes(dim, state_len)),
                                dtype=np.uint8)
            if rp.is_fp32:
                # code 0 is legal in a v2 record: the bytes ARE f32, so
                # reinterpret (unpack would value-convert each byte)
                vec = raw.view(np.float32).copy()
            else:
                vec = rp.unpack(raw, dim)
        yield sign, dim, vec
