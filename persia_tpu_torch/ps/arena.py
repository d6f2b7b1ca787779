"""Arena-backed embedding parameter store (``persia_tpu/ps/arena.py``).

Rows live in one contiguous byte arena per ``(dim, optimizer state
width)`` record class instead of one numpy object per entry:

- **Record classes.** A record is ``[emb bytes (row_dtype) | pad to 4 |
  f32 optimizer state | pad to 8]``; the LOGICAL record (what PSD v2
  sees) is the unpadded ``[emb | state]``, byte-identical with
  :class:`~persia_tpu_torch.ps.optim.RowPrecision`'s layout.
- **Slab arena.** Each class owns one uint8 buffer grown in ``slab_rows``
  quanta (amortized doubling), with a free list recycling evicted slots.
  Strided views expose the emb/state fields of all rows at once, so a
  batched lookup is one gather and a batched update is one gather, one
  optimizer call and one scatter.
- **Flat sign index.** An open-addressing hash per internal shard maps
  sign -> packed ``(class << 44) | slot``, probed for a whole batch in a
  few vectorized passes; tombstoned deletes, rebuilt past 3/4 fill.
- **Exact LRU by stamp.** Every training access writes a per-shard
  monotone stamp; eviction pops the minimum-stamp row through a
  batch-frozen victim queue. Stamp order is the per-entry holder's
  recency order, so an fp32 holder's PSD v1 dump is byte-identical to
  ``EmbeddingHolder``'s.

A shard's batch takes one of three paths, counted in :meth:`arena_stats`:

- **batched**: its signs are distinct;
- **rounds**: its signs repeat (on seq_rec every shard does: the history,
  click and target slots share one item sign space). Rank each position
  by how many times its sign appeared earlier in the batch; round k
  holds the k-th occurrences, which are distinct. A lookup runs round 0
  (the first occurrences, in batch order) on the batched path, and every
  later occurrence reads the row its first occurrence left, or zeros and
  a miss where that sign was not admitted; stamps then go by batch
  position, so a repeated row keeps its last occurrence's. An update
  applies one gather, optimizer call and scatter per round, in
  occurrence order. Both give exactly what the per-sign sequence gives;
- **sequential**: a lookup whose inserts could wrap the shard's row or
  byte budget (capacity below one batch) runs the exact per-sign
  sequence, where each access sees every earlier eviction.

With ``spill_dir`` the rows eviction would drop are demoted to the disk
spill tier (:mod:`persia_tpu_torch.ps.spill`) and any later access faults
them back in: a training access takes the row and re-inserts it resident,
a read-only access peeks. With ``hotness`` the lookups feed the workload
sketches (:mod:`persia_tpu_torch.hotness`). The metrics-registry counters
are not ported; the miss counters are plain per-shard ints.

Lock discipline: each ``_ArenaShard`` carries its own ``lock`` and every
mutating shard method is suffixed ``_locked`` (the caller holds it).
"""

import io
import struct
import threading
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
from persia_tpu_torch.ps.store import (
    _DTYPE_CODES,
    DUMP_MAGIC,
    iter_psd_records,
    read_psd_header,
)

_H_MULT = 0x9E3779B97F4A7C15  # fibonacci multiplier, splits u64 keys
_SLOT_BITS = 44  # packed index value: (class << 44) | slot
_SLOT_MASK = (1 << _SLOT_BITS) - 1

# the JAX package's PERSIA_ARENA_SLAB_ROWS / PERSIA_ARENA_INDEX_SLOTS
# defaults (persia_tpu/knobs.py)
SLAB_ROWS = 65536
INDEX_SLOTS = 1024

PATHS = ("lookup_batched", "lookup_rounds", "lookup_sequential",
         "update_batched", "update_rounds")


class _RowClass:
    """All rows of one ``(dim, state space)`` shape in one strided buffer
    plus parallel metadata arrays, mutated under the owning shard's
    lock."""

    __slots__ = ("dim", "space", "rp", "np_dtype", "itemsize", "emb_bytes",
                 "emb_pad", "stride", "logical_bytes", "cap", "data", "emb",
                 "state", "signs", "stamps", "free", "next_fresh", "live",
                 "slab_rows")

    def __init__(self, dim: int, space: int, rp: RowPrecision,
                 slab_rows: int):
        self.dim = dim
        self.space = space
        self.rp = rp
        self.np_dtype = rp.np_dtype
        self.itemsize = rp.itemsize
        self.emb_bytes = dim * rp.itemsize
        self.emb_pad = (self.emb_bytes + 3) & ~3
        self.stride = (self.emb_pad + 4 * space + 7) & ~7
        self.logical_bytes = self.emb_bytes + 4 * space
        self.slab_rows = slab_rows
        self.cap = 0
        self.data: Optional[np.ndarray] = None
        self.emb: Optional[np.ndarray] = None
        self.state: Optional[np.ndarray] = None
        self.signs: Optional[np.ndarray] = None
        self.stamps: Optional[np.ndarray] = None
        self.free: List[int] = []
        self.next_fresh = 0
        self.live = 0

    def _grow(self, need_rows: int):
        new_cap = max(self.cap * 2, self.slab_rows)
        while new_cap < need_rows:
            new_cap += self.slab_rows
        data = np.zeros(new_cap * self.stride, np.uint8)
        signs = np.zeros(new_cap, np.uint64)
        stamps = np.full(new_cap, -1, np.int64)
        if self.cap:
            data[: self.cap * self.stride] = self.data
            signs[: self.cap] = self.signs
            stamps[: self.cap] = self.stamps
        self.cap = new_cap
        self.data = data
        self.signs = signs
        self.stamps = stamps
        self.emb = np.ndarray((new_cap, self.dim), dtype=self.np_dtype,
                              buffer=data, strides=(self.stride,
                                                    self.itemsize))
        self.state = (np.ndarray((new_cap, self.space), dtype=np.float32,
                                 buffer=data, offset=self.emb_pad,
                                 strides=(self.stride, 4))
                      if self.space else None)

    def emb_f32(self, slots) -> np.ndarray:
        """The embedding rows of ``slots`` widened to f32."""
        return self.rp.to_f32(self.emb[slots])

    def set_emb(self, slots, values_f32: np.ndarray):
        """Narrow f32 rows into the embedding field of ``slots``."""
        self.emb[slots] = self.rp.from_f32(values_f32)

    def alloc_locked(self, k: int) -> np.ndarray:
        """k fresh/recycled slot ids (free list LIFO first)."""
        out = np.empty(k, np.int64)
        reuse = min(k, len(self.free))
        for i in range(reuse):
            out[i] = self.free.pop()
        fresh = k - reuse
        if fresh:
            if self.next_fresh + fresh > self.cap:
                self._grow(self.next_fresh + fresh)
            out[reuse:] = np.arange(self.next_fresh,
                                    self.next_fresh + fresh)
            self.next_fresh += fresh
        self.live += k
        return out

    def free_locked(self, slot: int):
        self.stamps[slot] = -1
        self.free.append(slot)
        self.live -= 1

    def logical_rows_locked(self, slots: np.ndarray) -> np.ndarray:
        """The logical ``[emb bytes | state f32 bytes]`` records of
        ``slots`` as one (k, logical_bytes) uint8 matrix."""
        k = len(slots)
        out = np.empty((k, self.logical_bytes), np.uint8)
        out[:, : self.emb_bytes] = (
            np.ascontiguousarray(self.emb[slots]).view(np.uint8))
        if self.space:
            out[:, self.emb_bytes:] = (
                np.ascontiguousarray(self.state[slots]).view(np.uint8))
        return out

    def write_raw_locked(self, slot: int, raw: np.ndarray):
        """Store a logical record byte-exactly (spill fault-in)."""
        self.emb[slot] = raw[: self.emb_bytes].view(self.np_dtype)
        if self.space:
            self.state[slot] = raw[self.emb_bytes:].view(np.float32)

    def slab_bytes(self) -> int:
        return self.cap * self.stride


class _ArenaShard:
    """One internal shard: its record classes, flat sign index, stamp
    clock, victim queue, byte accounting and path counters. ``lock`` is
    acquired by the holder around every ``*_locked`` call."""

    def __init__(self, capacity: int, byte_capacity: Optional[int],
                 rp: RowPrecision, slab_rows: int, index_slots: int):
        self.lock = threading.Lock()
        self.capacity = capacity
        self.byte_capacity = byte_capacity
        self.rp = rp
        self.slab_rows = slab_rows
        self.classes: List[_RowClass] = []
        self._class_of: Dict[Tuple[int, int], int] = {}
        self.resident_bytes = 0
        self.clock = 0
        self.path_calls = dict.fromkeys(PATHS, 0)
        # open-addressing sign -> packed (class << 44 | slot); value -1
        # empty, -2 tombstone (sign 0 is a legal key)
        size = 8
        while size < index_slots:
            size <<= 1
        self._h_size = size
        self._h_mask = size - 1
        self._h_shift = 65 - size.bit_length()
        self._h_sign = np.zeros(size, np.uint64)
        self._h_val = np.full(size, -1, np.int64)
        self._h_fill = 0  # occupied + tombstones (bounds probe chains)
        # batch-frozen victim queue (stamp-ascending), cursor-skip on
        # stale stamps, rebuilt on exhaustion
        self._vq_cls: Optional[np.ndarray] = None
        self._vq_slot: Optional[np.ndarray] = None
        self._vq_stamp: Optional[np.ndarray] = None
        self._vq_cursor = 0

    # --- record classes -------------------------------------------------

    def class_id_locked(self, dim: int, space: int,
                        create: bool = True) -> Optional[int]:
        cid = self._class_of.get((dim, space))
        if cid is None and create:
            cid = len(self.classes)
            self.classes.append(_RowClass(dim, space, self.rp,
                                          self.slab_rows))
            self._class_of[(dim, space)] = cid
        return cid

    def live_rows(self) -> int:
        return sum(c.live for c in self.classes)

    # --- flat sign index ------------------------------------------------

    def probe_locked(self, keys: np.ndarray) -> np.ndarray:
        """Bulk lookup: packed int64 value per key, -1 for absent. Each
        round resolves every key whose probe cell is a hit or a virgin
        empty; mismatches and tombstones advance one cell."""
        mask = self._h_mask
        out = np.full(len(keys), -1, np.int64)
        idx = ((keys * np.uint64(_H_MULT))
               >> np.uint64(self._h_shift)).astype(np.int64)
        pend = np.arange(len(keys))
        kp = keys
        h_val, h_sign = self._h_val, self._h_sign
        while len(pend):
            v = h_val[idx]
            found = (v >= 0) & (h_sign[idx] == kp)
            if found.any():
                out[pend[found]] = v[found]
            cont = ~found & (v != -1)
            pend = pend[cont]
            kp = kp[cont]
            idx = (idx[cont] + 1) & mask
        return out

    def _h_find(self, sign: int) -> int:
        mask = self._h_mask
        h_val, h_sign = self._h_val, self._h_sign
        i = ((sign * _H_MULT) & 0xFFFFFFFFFFFFFFFF) >> self._h_shift
        while True:
            v = h_val[i]
            if v == -1:
                return -1
            if v >= 0 and h_sign[i] == sign:
                return i
            i = (i + 1) & mask

    def index_put_locked(self, sign: int, packed: int):
        """Insert/overwrite one index entry."""
        i = self._h_find(sign)
        if i >= 0:
            self._h_val[i] = packed
            return
        mask = self._h_mask
        h_val = self._h_val
        i = ((sign * _H_MULT) & 0xFFFFFFFFFFFFFFFF) >> self._h_shift
        while h_val[i] >= 0:
            i = (i + 1) & mask
        if h_val[i] == -1:
            self._h_fill += 1
        self._h_sign[i] = sign
        h_val[i] = packed
        if 4 * self._h_fill > 3 * self._h_size:
            self._h_rebuild_locked()

    def index_del_locked(self, sign: int):
        i = self._h_find(sign)
        if i >= 0:
            self._h_val[i] = -2  # tombstone

    def _h_rebuild_locked(self):
        """Grow/compact the index from its own LIVE entries, never from
        stamps: the batched insert path stamps rows only after all its
        index inserts."""
        old_sign, old_val = self._h_sign, self._h_val
        sel = np.nonzero(old_val >= 0)[0]
        live = len(sel)
        size = self._h_size
        while size < 4 * max(live, 1):
            size <<= 1
        self._h_size = size
        self._h_mask = size - 1
        self._h_shift = 65 - size.bit_length()
        self._h_sign = np.zeros(size, np.uint64)
        self._h_val = np.full(size, -1, np.int64)
        h_sign, h_val = self._h_sign, self._h_val
        mask = self._h_mask
        for sign, val in zip(old_sign[sel].tolist(),
                             old_val[sel].tolist()):
            i = ((sign * _H_MULT) & 0xFFFFFFFFFFFFFFFF) \
                >> self._h_shift
            while h_val[i] >= 0:
                i = (i + 1) & mask
            h_sign[i] = sign
            h_val[i] = val
        self._h_fill = live

    # --- stamps / eviction ----------------------------------------------

    def stamp_batch_locked(self, cls_ids: np.ndarray, slots: np.ndarray,
                           has_dups: bool):
        """Refresh recency for the accessed rows, in access order.
        Duplicate positions keep the LAST occurrence's stamp via
        maximum.at (stamps grow with batch position)."""
        n = len(slots)
        if n == 0:
            return
        stamps = np.arange(self.clock, self.clock + n, dtype=np.int64)
        self.clock += n
        for cid in np.unique(cls_ids):
            m = cls_ids == cid
            cls = self.classes[cid]
            if has_dups:
                np.maximum.at(cls.stamps, slots[m], stamps[m])
            else:
                cls.stamps[slots[m]] = stamps[m]

    def stamp_one_locked(self, cls_id: int, slot: int):
        self.classes[cls_id].stamps[slot] = self.clock
        self.clock += 1

    def _vq_rebuild_locked(self):
        parts = []
        for cid, cls in enumerate(self.classes):
            rows = np.nonzero(cls.stamps[: cls.next_fresh] >= 0)[0]
            if len(rows):
                parts.append((np.full(len(rows), cid, np.int64), rows,
                              cls.stamps[rows]))
        if not parts:
            self._vq_cls = self._vq_slot = self._vq_stamp = \
                np.empty(0, np.int64)
            self._vq_cursor = 0
            return
        cls_ids = np.concatenate([p[0] for p in parts])
        slots = np.concatenate([p[1] for p in parts])
        stamps = np.concatenate([p[2] for p in parts])
        order = np.argsort(stamps, kind="stable")
        self._vq_cls = cls_ids[order]
        self._vq_slot = slots[order]
        self._vq_stamp = stamps[order]
        self._vq_cursor = 0

    def pop_victim_locked(self) -> Optional[Tuple[int, int]]:
        """(class, slot) of the least-recently-stamped live row; None when
        the shard is empty. Queue entries whose row was refreshed or freed
        since the freeze are skipped by stamp comparison."""
        for _ in range(2):  # current queue, then one rebuild
            if self._vq_stamp is not None:
                vq_stamp, vq_cls, vq_slot = (self._vq_stamp, self._vq_cls,
                                             self._vq_slot)
                i = self._vq_cursor
                n = len(vq_stamp)
                while i < n:
                    cid = vq_cls[i]
                    slot = vq_slot[i]
                    if self.classes[cid].stamps[slot] == vq_stamp[i]:
                        self._vq_cursor = i + 1
                        return int(cid), int(slot)
                    i += 1
                self._vq_cursor = n
            if self.live_rows() == 0:
                return None
            self._vq_rebuild_locked()
        return None

    def over_budget_locked(self) -> bool:
        live = self.live_rows()
        return live > self.capacity or (
            self.byte_capacity is not None
            and self.resident_bytes > self.byte_capacity
            and live > 1)

    def evict_locked(self, spill_rows: Optional[List] = None) -> int:
        """Restore the row/byte budget; returns rows evicted. With
        ``spill_rows`` a list, evicted rows are appended as ``(sign, dim,
        cls_id, slot)`` for :meth:`extract_spill_locked` (a freed slot
        keeps its bytes until it is reallocated)."""
        evicted = 0
        while self.over_budget_locked():
            victim = self.pop_victim_locked()
            if victim is None:
                break
            cid, slot = victim
            cls = self.classes[cid]
            sign = int(cls.signs[slot])
            self.index_del_locked(sign)
            self.resident_bytes -= cls.logical_bytes
            cls.free_locked(slot)
            if spill_rows is not None:
                spill_rows.append((sign, cls.dim, cid, slot))
            evicted += 1
        return evicted

    def extract_spill_locked(self, spill_rows: List):
        """The logical bytes of the rows :meth:`evict_locked` collected,
        one vectorized pass per class: ``[(signs u64, dim, (k, logical)
        uint8), ...]``. Valid only right after the eviction."""
        out = []
        by_class: Dict[int, List[Tuple[int, int]]] = {}
        for sign, _dim, cid, slot in spill_rows:
            by_class.setdefault(cid, []).append((sign, slot))
        for cid, pairs in by_class.items():
            cls = self.classes[cid]
            signs = np.array([p[0] for p in pairs], np.uint64)
            slots = np.array([p[1] for p in pairs], np.int64)
            out.append((signs, cls.dim, cls.logical_rows_locked(slots)))
        return out

    def free_entry_locked(self, cid: int, slot: int):
        """Release one live row (dim-mismatch reinit path)."""
        cls = self.classes[cid]
        self.resident_bytes -= cls.logical_bytes
        cls.free_locked(slot)

    # --- scalar row ops (sequential / debug paths) ----------------------

    def get_locked(self, sign: int) -> Optional[Tuple[int, int]]:
        packed = self._h_find(sign)
        if packed < 0:
            return None
        v = int(self._h_val[packed])
        return v >> _SLOT_BITS, v & _SLOT_MASK

    def insert_row_locked(self, sign: int, dim: int,
                          full_f32: Optional[np.ndarray],
                          raw: Optional[np.ndarray] = None
                          ) -> Tuple[int, int]:
        """Insert/replace one row (refreshing recency) WITHOUT budget
        enforcement; the caller runs eviction after. ``raw`` given stores
        a logical record's bytes exactly; else ``full_f32`` narrows in."""
        space = ((len(raw) - dim * self.rp.itemsize) // 4 if raw is not None
                 else len(full_f32) - dim)
        cid = self.class_id_locked(dim, space)
        cls = self.classes[cid]
        existing = self.get_locked(sign)
        if existing is not None and existing[0] == cid:
            slot = existing[1]
        else:
            if existing is not None:
                self.free_entry_locked(*existing)
            slot = int(cls.alloc_locked(1)[0])
            cls.signs[slot] = sign
            self.index_put_locked(sign, (cid << _SLOT_BITS) | slot)
            self.resident_bytes += cls.logical_bytes
        if raw is not None:
            cls.write_raw_locked(slot, raw)
        else:
            cls.set_emb(slot, full_f32[:dim])
            if cls.space:
                cls.state[slot] = full_f32[dim:]
        self.stamp_one_locked(cid, slot)
        return cid, slot

    def stats_locked(self) -> Dict[str, int]:
        return {
            "slab_bytes": sum(c.slab_bytes() for c in self.classes),
            "free_slots": sum(len(c.free) for c in self.classes),
            "live_rows": self.live_rows(),
            "allocated_rows": sum(c.next_fresh for c in self.classes),
            "resident_bytes": self.resident_bytes,
            **self.path_calls,
        }


def _occurrence_rank(keys: np.ndarray) -> np.ndarray:
    """For each position, how many times its key appeared earlier in
    ``keys`` (0 for a first occurrence)."""
    order = np.argsort(keys, kind="stable")
    srt = keys[order]
    idx = np.arange(len(keys))
    start = np.ones(len(keys), bool)
    start[1:] = srt[1:] != srt[:-1]
    rank = np.empty(len(keys), np.int64)
    rank[order] = idx - np.maximum.accumulate(np.where(start, idx, 0))
    return rank


class ArenaEmbeddingHolder:
    """Drop-in twin of :class:`~persia_tpu_torch.ps.store.EmbeddingHolder`
    over the contiguous row arena (module docstring has the layout and
    the paths). ``row_dtype`` narrows the stored embedding slice,
    ``capacity_bytes`` arms byte-accounted eviction, ``spill_dir`` demotes
    evictions to the disk tier (at most ``spill_bytes`` on disk, oldest
    packets dropped first), ``hotness`` arms the workload sketches (None:
    the ``PERSIA_HOTNESS`` knob); ``slab_rows`` and ``index_slots`` size
    the arena's growth quantum and each shard's initial sign index."""

    def __init__(self, capacity: int = 1_000_000_000,
                 num_internal_shards: int = 8, row_dtype: str = "fp32",
                 capacity_bytes: Optional[int] = None,
                 hotness: Optional[bool] = None,
                 spill_dir: Optional[str] = None,
                 spill_bytes: Optional[int] = None,
                 slab_rows: int = SLAB_ROWS,
                 index_slots: int = INDEX_SLOTS):
        if num_internal_shards <= 0:
            raise ValueError("num_internal_shards must be positive")
        capacity_bytes = capacity_bytes or None
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self.num_internal_shards = num_internal_shards
        self._rp = RowPrecision(row_dtype)
        per_shard = max(1, capacity // num_internal_shards)
        per_shard_bytes = (
            max(1, capacity_bytes // num_internal_shards)
            if capacity_bytes is not None else None)
        self._shards = [
            _ArenaShard(per_shard, per_shard_bytes, self._rp,
                        max(1024, int(slab_rows)),
                        max(8, int(index_slots)))
            for _ in range(num_internal_shards)
        ]
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
        self.hotness = make_tracker(num_internal_shards, enabled=hotness)
        self.spill: Optional[SpillStore] = (
            SpillStore(spill_dir, max_bytes=spill_bytes or None)
            if spill_dir else None)

    # --- observables ------------------------------------------------------

    @property
    def row_dtype(self) -> str:
        return self._rp.name

    @property
    def resident_bytes(self) -> int:
        return sum(s.resident_bytes for s in self._shards)

    @property
    def index_miss_count(self) -> int:
        return sum(self._index_miss)

    @property
    def gradient_id_miss_count(self) -> int:
        return sum(self._gradient_id_miss)

    def arena_stats(self) -> Dict[str, float]:
        """Slab accounting summed over the shards: allocated slab bytes,
        reusable free slots, live rows, logical resident bytes, the
        fragmentation ratio (1 - live/allocated rows), and how many shard
        calls took each path (:data:`PATHS`)."""
        totals: Dict[str, float] = {}
        for shard in self._shards:
            with shard.lock:
                for k, v in shard.stats_locked().items():
                    totals[k] = totals.get(k, 0) + v
        alloc = totals.pop("allocated_rows")
        totals["fragmentation_ratio"] = (
            round(1.0 - totals["live_rows"] / alloc, 6) if alloc else 0.0)
        return totals

    def hotness_snapshot(self) -> dict:
        """The hotness sketches' snapshot, each table stamped with its
        stored bytes a row (``row_bytes``); the disabled marker when
        unarmed."""
        if self.hotness is None:
            return disabled_snapshot()
        snap = self.hotness.snapshot()
        for table, t in snap.get("tables", {}).items():
            t["row_bytes"] = int(table) * self._rp.itemsize
        return snap

    def spill_stats(self) -> dict:
        """The disk tier's counters (empty when unarmed)."""
        return self.spill.stats() if self.spill is not None else {}

    # --- control plane ---------------------------------------------------

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
        self.optimizer = SparseOptimizer.from_config(
            config, feature_index_prefix_bit=feature_index_prefix_bit)

    def _groups(self, signs: np.ndarray):
        shard_ids = internal_shard_of(signs, self.num_internal_shards)
        for shard_idx in np.unique(shard_ids):
            yield int(shard_idx), np.nonzero(shard_ids == shard_idx)[0]

    # --- spill helpers ----------------------------------------------------

    def _evict_and_spill_locked(self, shard: _ArenaShard):
        """Restore the shard's budget; with the spill tier armed, the
        evicted rows are demoted to it (one slab-slice pass per class)."""
        if self.spill is None:
            shard.evict_locked()
            return
        spill_rows: List = []
        shard.evict_locked(spill_rows)
        for signs, dim, rows in shard.extract_spill_locked(spill_rows):
            self.spill.put_batch(signs, dim, rows)

    def _fault_in_locked(self, shard: _ArenaShard, sign: int,
                         training: bool):
        """Fault a spilled row in: training takes it and re-inserts it
        resident, a read-only access peeks. Returns ``(dim, raw logical
        bytes)`` or None."""
        got = (self.spill.take(sign) if training
               else self.spill.peek(sign))
        if got is None:
            return None
        dim0, raw = got
        if training:
            shard.insert_row_locked(sign, dim0, None, raw=raw)
            self._evict_and_spill_locked(shard)
        return dim0, raw

    # --- data plane -------------------------------------------------------

    def lookup(self, signs: np.ndarray, dim: int,
               training: bool) -> np.ndarray:
        """(n, dim) f32 rows for ``signs``; the training lookup admits
        and initializes misses, the eval lookup reads zeros for them."""
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
        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            with shard.lock:
                if training:
                    n_miss = self._lookup_train_locked(
                        shard, signs[sel], sel, dim, space, init_vecs,
                        admitted, out)
                else:
                    n_miss = self._lookup_eval_locked(
                        shard, signs[sel], sel, dim, out)
                self._index_miss[shard_idx] += n_miss
        return out

    def _lookup_train_locked(self, shard, ssigns, sel, dim, space,
                             init_vecs, admitted, out) -> int:
        shard.class_id_locked(dim, space)
        uniq, first, inv = np.unique(ssigns, return_index=True,
                                     return_inverse=True)
        if len(uniq) == len(ssigns):
            got = self._lookup_batch_locked(shard, ssigns, sel, dim, space,
                                            init_vecs, admitted, out)
            if got is None:
                return self._lookup_train_seq_locked(
                    shard, ssigns, sel, dim, space, init_vecs, admitted,
                    out)
            n_miss, p_cls, p_slot, touched = got
            shard.stamp_batch_locked(p_cls[touched], p_slot[touched],
                                     has_dups=False)
            shard.path_calls["lookup_batched"] += 1
        else:
            # round 0: the first occurrences, in batch order
            order0 = np.argsort(first, kind="stable")
            firsts = first[order0]
            got = self._lookup_batch_locked(
                shard, ssigns[firsts], sel[firsts], dim, space, init_vecs,
                admitted, out)
            if got is None:
                out[sel] = 0.0  # undo round 0's hit reads
                return self._lookup_train_seq_locked(
                    shard, ssigns, sel, dim, space, init_vecs, admitted,
                    out)
            n_miss, p_cls0, p_slot0, touched0 = got
            # later rounds: each occurrence reads what its first
            # occurrence left (a hit or the inserted row), or zeros and
            # a miss where its sign was not admitted
            k_of_u = np.empty(len(uniq), np.int64)
            k_of_u[order0] = np.arange(len(uniq))
            k = k_of_u[inv]
            later = np.ones(len(ssigns), bool)
            later[firsts] = False
            touched = touched0[k]
            reread = later & touched
            out[sel[reread]] = out[sel[firsts[k[reread]]]]
            n_miss += int((later & ~touched).sum())
            shard.stamp_batch_locked(p_cls0[k][touched],
                                     p_slot0[k][touched], has_dups=True)
            shard.path_calls["lookup_rounds"] += 1
        self._evict_and_spill_locked(shard)
        return n_miss

    def _lookup_batch_locked(self, shard, ssigns, sel, dim, space,
                             init_vecs, admitted, out):
        """The batched training lookup of DISTINCT signs, without stamps:
        ``(n_miss, p_cls, p_slot, touched)``, or None (after reading the
        hits into ``out`` and changing nothing) when the batch's inserts
        could wrap the shard's budget and the caller must take the exact
        sequential path."""
        cid = shard.class_id_locked(dim, space)
        cls = shard.classes[cid]
        packed = shard.probe_locked(ssigns)
        p_cls = packed >> _SLOT_BITS
        p_slot = packed & _SLOT_MASK
        # a hit is any resident class of the SAME dim (the state width may
        # differ under an older optimizer layout)
        hit = np.zeros(len(ssigns), bool)
        for ocid in np.unique(p_cls[packed >= 0]):
            ocls = shard.classes[ocid]
            if ocls.dim != dim:
                continue
            m = (packed >= 0) & (p_cls == ocid)
            out[sel[m]] = ocls.emb_f32(p_slot[m])
            hit |= m
        # batched insert-then-evict is sequence-exact only while the batch
        # evicts nothing: pessimistically, any insert past the row/byte
        # budget sends the shard's batch down the sequential path
        n_nonhit = int((~hit).sum())
        # a row faulted in from the spill tier may belong to a wider class
        worst_row = cls.logical_bytes
        if self.spill is not None and shard.byte_capacity is not None:
            worst_row = max(c.logical_bytes for c in shard.classes)
        if n_nonhit and (
                shard.live_rows() + n_nonhit > shard.capacity
                or (shard.byte_capacity is not None
                    and shard.resident_bytes + n_nonhit * worst_row
                    > shard.byte_capacity)):
            return None
        # resident under another dim: reinitialized unconditionally
        # (admission does not apply to dim mismatches)
        stale = (packed >= 0) & ~hit
        if self.spill is not None and (~hit & ~stale).any():
            # fault spilled rows in before deciding miss-init: a faulted
            # row of this dim is a plain hit (read, not a miss), one of
            # another dim is reinitialized
            for j in np.nonzero(~hit & ~stale)[0]:
                got = self._fault_in_locked(shard, int(ssigns[j]), True)
                if got is None:
                    continue
                loc = shard.get_locked(int(ssigns[j]))
                if loc is None:
                    continue
                p_cls[j], p_slot[j] = loc
                if got[0] == dim:
                    hit[j] = True
                    out[sel[j]] = shard.classes[loc[0]].emb_f32(loc[1])
                else:
                    stale[j] = True
        n_miss = int((~hit).sum())
        miss = ~hit & (admitted[sel] | stale)
        miss_idx = np.nonzero(miss)[0]
        if len(miss_idx):
            if self.spill is not None:
                # a resident row never shadows a stale disk copy
                for s in ssigns[miss_idx].tolist():
                    self.spill.discard(s)
            # dim-mismatched residents release their old slots first
            for j in np.nonzero(stale)[0].tolist():
                shard.free_entry_locked(int(p_cls[j]), int(p_slot[j]))
            rows = cls.alloc_locked(len(miss_idx))
            cls.set_emb(rows, init_vecs[sel[miss_idx], :dim])
            if space:
                cls.state[rows] = init_vecs[sel[miss_idx], dim:]
            cls.signs[rows] = ssigns[miss_idx]
            base = cid << _SLOT_BITS
            for s, r in zip(ssigns[miss_idx].tolist(), rows.tolist()):
                shard.index_put_locked(s, base | r)
            shard.resident_bytes += len(miss_idx) * cls.logical_bytes
            # the caller reads the STORED value (narrow, then widen)
            out[sel[miss_idx]] = cls.emb_f32(rows)
            p_cls[miss_idx] = cid
            p_slot[miss_idx] = rows
        return n_miss, p_cls, p_slot, hit | miss

    def _lookup_train_seq_locked(self, shard, ssigns, sel, dim, space,
                                 init_vecs, admitted, out) -> int:
        """The exact per-sign sequence: each access sees every earlier
        access's insertions and evictions."""
        shard.path_calls["lookup_sequential"] += 1
        cls = shard.classes[shard.class_id_locked(dim, space)]
        n_miss = 0
        for j, pos in enumerate(sel.tolist()):
            sign = int(ssigns[j])
            loc = shard.get_locked(sign)
            if loc is None and self.spill is not None:
                if self._fault_in_locked(shard, sign, True) is not None:
                    loc = shard.get_locked(sign)
            if loc is not None and shard.classes[loc[0]].dim == dim:
                out[pos] = shard.classes[loc[0]].emb_f32(loc[1])
                shard.stamp_one_locked(loc[0], loc[1])
            elif loc is None and not admitted[pos]:
                n_miss += 1
            else:
                if self.spill is not None:
                    self.spill.discard(sign)
                _, slot = shard.insert_row_locked(sign, dim, init_vecs[pos])
                out[pos] = cls.emb_f32(slot)
                self._evict_and_spill_locked(shard)
                n_miss += 1
        return n_miss

    def _lookup_eval_locked(self, shard, ssigns, sel, dim, out) -> int:
        packed = shard.probe_locked(ssigns)
        p_cls = packed >> _SLOT_BITS
        p_slot = packed & _SLOT_MASK
        hit = np.zeros(len(ssigns), bool)
        for cid in np.unique(p_cls[packed >= 0]):
            cls = shard.classes[cid]
            if cls.dim != dim:
                continue
            m = (packed >= 0) & (p_cls == cid)
            out[sel[m]] = cls.emb_f32(p_slot[m])
            hit |= m
        if self.spill is not None:
            # a read-only lookup peeks the disk tier, residency unchanged
            for j in np.nonzero(~hit)[0]:
                got = self._fault_in_locked(shard, int(ssigns[j]), False)
                if got is not None and got[0] == dim:
                    out[sel[j]] = self._rp.unpack_raw(got[1], dim)[:dim]
                    hit[j] = True
        return int((~hit).sum())

    def update_gradients(self, signs: np.ndarray, grads: np.ndarray,
                         dim: int):
        """One optimizer step for ``signs`` with grads (n, dim); a
        repeated sign steps once per occurrence, in batch order."""
        if self.optimizer is None:
            raise RuntimeError("optimizer not registered on parameter server")
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        if len(signs) == 0:
            return
        batch_state = self.optimizer.batch_level_state(signs)
        space = self.optimizer.require_space(dim)
        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            with shard.lock:
                self._gradient_id_miss[shard_idx] += self._update_locked(
                    shard, signs[sel], sel, grads, dim, space, batch_state)

    def _update_locked(self, shard, ssigns, sel, grads, dim, space,
                       batch_state) -> int:
        packed = shard.probe_locked(ssigns)
        if self.spill is not None:
            # a gradient for a spilled row faults it in first. A fault-in
            # may evict (and a freed slot be reused), so the batch probes
            # again after; two rounds, since a fault-in's eviction can
            # demote a sign later in this batch
            for _ in range(2):
                faulted = False
                for j in np.nonzero(packed < 0)[0]:
                    if self._fault_in_locked(shard, int(ssigns[j]),
                                             True) is not None:
                        faulted = True
                if not faulted:
                    break
                packed = shard.probe_locked(ssigns)
        cid = shard.class_id_locked(dim, space, create=False)
        if cid is None:
            return len(ssigns)
        found = (packed >= 0) & ((packed >> _SLOT_BITS) == cid)
        n_miss = int((~found).sum())
        if not found.any():
            return n_miss
        cls = shard.classes[cid]
        rows = (packed & _SLOT_MASK)[found]
        pos = sel[found]
        rank = _occurrence_rank(rows)
        n_rounds = int(rank.max()) + 1
        shard.path_calls["update_batched" if n_rounds == 1
                         else "update_rounds"] += 1
        for k in range(n_rounds):
            if n_rounds == 1:
                r, p = rows, pos
            else:
                m = rank == k
                r, p = rows[m], pos[m]
            # one gather, one optimizer call, one scatter a round
            mat = np.empty((len(r), dim + space), np.float32)
            mat[:, :dim] = cls.emb_f32(r)
            if space:
                mat[:, dim:] = cls.state[r]
            self.optimizer.update(
                mat, grads[p], dim,
                batch_state[p] if batch_state is not None else None)
            if self.enable_weight_bound:
                apply_weight_bound(mat[:, :dim], self.weight_bound)
            cls.set_emb(r, mat[:, :dim])
            if space:
                cls.state[r] = mat[:, dim:]
        return n_miss

    # --- rows -------------------------------------------------------------

    def _shard_of(self, sign: int) -> _ArenaShard:
        return self._shards[int(internal_shard_of(
            np.array([sign], dtype=np.uint64), self.num_internal_shards)[0])]

    def get_entry(self, sign: int) -> Optional[Tuple[int, np.ndarray]]:
        """(dim, f32 [emb|state]) or None: a live f32 view over the arena
        record under fp32 (valid until the next insert, which may grow
        the slab), a widened copy under half precision. A spilled row reads
        through (peek)."""
        shard = self._shard_of(sign)
        with shard.lock:
            loc = shard.get_locked(int(sign))
            if loc is None and self.spill is not None:
                got = self._fault_in_locked(shard, int(sign), False)
                if got is not None:
                    return got[0], self._rp.unpack_raw(got[1], got[0])
            if loc is None:
                return None
            cid, slot = loc
            cls = shard.classes[cid]
            if self._rp.is_fp32:
                return cls.dim, np.ndarray((cls.dim + cls.space,),
                                           np.float32, buffer=cls.data,
                                           offset=slot * cls.stride)
            vec = np.empty(cls.dim + cls.space, np.float32)
            vec[: cls.dim] = cls.emb_f32(slot)
            if cls.space:
                vec[cls.dim:] = cls.state[slot]
            return cls.dim, vec

    def set_entry(self, sign: int, dim: int, vec: np.ndarray):
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        shard = self._shard_of(sign)
        with shard.lock:
            if self.spill is not None:
                self.spill.discard(int(sign))
            shard.insert_row_locked(int(sign), dim, vec)
            self._evict_and_spill_locked(shard)

    def get_entries(self, signs: np.ndarray, width: int):
        """Returns (found (n,) bool, vecs (n, width) f32); entries absent
        or of another width read as not found; spilled rows read through
        (peek)."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        n = len(signs)
        found = np.zeros(n, dtype=bool)
        vecs = np.zeros((n, width), dtype=np.float32)
        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            with shard.lock:
                packed = shard.probe_locked(signs[sel])
                p_cls = packed >> _SLOT_BITS
                p_slot = packed & _SLOT_MASK
                for cid in np.unique(p_cls[packed >= 0]):
                    cls = shard.classes[cid]
                    if cls.dim + cls.space != width:
                        continue
                    m = (packed >= 0) & (p_cls == cid)
                    rows = p_slot[m]
                    vecs[sel[m], : cls.dim] = cls.emb_f32(rows)
                    if cls.space:
                        vecs[sel[m], cls.dim:] = cls.state[rows]
                    found[sel[m]] = True
                if self.spill is not None:
                    for j in np.nonzero(packed < 0)[0]:
                        got = self._fault_in_locked(
                            shard, int(signs[sel[j]]), False)
                        if got is None:
                            continue
                        vec = self._rp.unpack_raw(got[1], got[0])
                        if len(vec) == width:
                            vecs[sel[j]] = vec
                            found[sel[j]] = True
        return found, vecs

    def set_entries(self, signs: np.ndarray, dim: int, vecs: np.ndarray):
        """Insert or replace the rows ``vecs`` (n, width >= dim) f32, one
        after another."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        for shard_idx, sel in self._groups(signs):
            shard = self._shards[shard_idx]
            with shard.lock:
                for pos in sel.tolist():
                    if self.spill is not None:
                        self.spill.discard(int(signs[pos]))
                    shard.insert_row_locked(int(signs[pos]), dim,
                                            vecs[pos])
                    self._evict_and_spill_locked(shard)

    def clear(self):
        for shard in self._shards:
            with shard.lock:
                shard.classes = []
                shard._class_of = {}
                shard.resident_bytes = 0
                shard.clock = 0
                shard._h_sign = np.zeros(shard._h_size, np.uint64)
                shard._h_val = np.full(shard._h_size, -1, np.int64)
                shard._h_fill = 0
                shard._vq_cls = shard._vq_slot = shard._vq_stamp = None
                shard._vq_cursor = 0
        if self.spill is not None:
            self.spill.clear()

    def __len__(self) -> int:
        """Rows of the logical table: resident plus spilled."""
        n = sum(s.live_rows() for s in self._shards)
        if self.spill is not None:
            n += len(self.spill)
        return n

    # --- serialization (PSD1 / PSD2) --------------------------------------

    def _iter_records_locked(self, shard: _ArenaShard):
        """Yield ``(sign, dim, state_len, logical bytes)`` in stamp (LRU)
        order, the per-entry holder's dump order."""
        parts = []
        for cid, cls in enumerate(shard.classes):
            rows = np.nonzero(cls.stamps[: cls.next_fresh] >= 0)[0]
            if len(rows):
                parts.append((cid, rows, cls.stamps[rows]))
        if not parts:
            return
        cls_ids = np.concatenate(
            [np.full(len(p[1]), p[0], np.int64) for p in parts])
        slots = np.concatenate([p[1] for p in parts])
        stamps = np.concatenate([p[2] for p in parts])
        order = np.argsort(stamps, kind="stable")
        cls_ids, slots = cls_ids[order], slots[order]
        # extract per class in slab order, then emit in stamp order
        mats: Dict[int, np.ndarray] = {}
        row_pos: Dict[int, Dict[int, int]] = {}
        for cid in np.unique(cls_ids):
            rows = slots[cls_ids == cid]
            mats[cid] = shard.classes[cid].logical_rows_locked(rows)
            row_pos[cid] = {int(r): i for i, r in enumerate(rows)}
        for cid, slot in zip(cls_ids.tolist(), slots.tolist()):
            cls = shard.classes[cid]
            yield (int(cls.signs[slot]), cls.dim, cls.space,
                   mats[cid][row_pos[cid][slot]])

    def _record_head(self, sign: int, dim: int, state_len: int) -> bytes:
        if self._rp.is_fp32:
            return struct.pack("<QII", sign, dim, dim + state_len)
        return struct.pack("<QIBI", sign, dim, _DTYPE_CODES[self._rp.name],
                           state_len)

    def dump_bytes(self) -> bytes:
        """Every entry, per shard in LRU order: PSD v1 (``sign u64 | dim
        u32 | len u32 | f32 [emb|state]``) for fp32 rows, v2 (``sign u64 |
        dim u32 | emb-dtype u8 | state_len u32 | emb bytes | state f32``)
        for half rows. The header count is the records serialized, each
        shard under its own lock.

        A spill-armed holder dumps the logical table: the shards, then the
        spilled rows, and in front of both the rows that left the spill
        tier while the dump ran (the spill store's dump capture), so any
        newer record of the same sign wins on load."""
        rp = self._rp
        chunks = []
        front = []
        if self.spill is not None:
            self.spill.start_dump_capture()
        try:
            for shard in self._shards:
                with shard.lock:
                    for sign, dim, state_len, raw in \
                            self._iter_records_locked(shard):
                        chunks.append(self._record_head(sign, dim,
                                                        state_len))
                        chunks.append(raw.tobytes())
            if self.spill is not None:
                # spilled records keep the logical bytes of their row
                def state_len(raw, dim):
                    return ((len(raw) - dim * rp.itemsize) // 4)

                for sign, dim, raw in self.spill.items():
                    chunks.append(self._record_head(sign, dim,
                                                    state_len(raw, dim)))
                    chunks.append(raw.tobytes())
                for sign, (dim, raw) in \
                        self.spill.stop_dump_capture().items():
                    front.append(self._record_head(sign, dim,
                                                   state_len(raw, dim)))
                    front.append(raw.tobytes())
        finally:
            if self.spill is not None:
                self.spill.stop_dump_capture()
        count = (len(chunks) + len(front)) // 2
        version = 1 if rp.is_fp32 else 2
        return b"".join([DUMP_MAGIC, struct.pack("<IQ", version, count)]
                        + front + chunks)

    def load_bytes(self, buf: bytes, clear: bool = True):
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
