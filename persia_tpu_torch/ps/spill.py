"""Disk spill tier for the embedding parameter store
(``persia_tpu/ps/spill.py``).

The bottom rung of the storage ladder (HBM device cache <-> host PS RAM
<-> disk): when the holder's row/byte-budget eviction would DROP a cold
row, a spill-armed holder hands it here instead, and a later access
faults it back in transparently — so capacity pressure demotes rows down
the ladder rather than destroying training state.

Layout: evicted rows stage in memory and flush as immutable append-only
**packet** files (``spill_<seq>.pkt``) through
:class:`~persia_tpu_torch.storage.PersiaPath` (local disk or ``hdfs://``),
written atomically (tmp + rename) so a crash mid-write leaves either a
complete packet or a cleanable ``*.tmp`` — never a torn file that a
fault-in would decode as garbage. An in-memory index maps ``sign ->
(packet, offset, nbytes, dim)``; fault-in is one ranged read. Records
keep the holder's STORED byte form (fp32 f32 vector, or the
RowPrecision half layout), so a spill -> fault-in round trip is
bit-identical by construction — the parity the tier bench pins.

Dead space: a faulted-in row's bytes stay behind in its packet; the
packet is deleted once its last live row leaves. A ``max_bytes`` budget
drops whole OLDEST packets (their still-live rows die — the cold-cold
end of the ladder, counted in ``dropped_rows``).

Thread-safety: one lock guards index + staging + packet table. The
holder calls in under its per-shard locks (shard lock -> spill lock,
strictly; this module never calls back into the holder), so the spill
lock is a leaf like the hotness tracker's.

Failure semantics: a fault-in whose packet is missing or truncated
raises :class:`SpillReadError` (a typed ``IOError``) and leaves both
the index entry and the holder untouched — callers see a loud error,
not a silently corrupted or quietly re-initialized row.
"""

import os
import struct
import subprocess
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from persia_tpu_torch.storage import PersiaPath

# per-record header: sign u64 | dim u32 | stored-vec nbytes u32
_REC = struct.Struct("<QII")


class SpillReadError(IOError):
    """A spilled row could not be read back (packet missing/truncated/
    corrupt). The spill index and the holder are left untouched."""


class SpillStore:
    """Append-only packet store of evicted rows with an in-memory index.

    ``stored`` vecs are whatever the holder keeps in its eviction maps
    (f32 arrays for fp32 holders, uint8 half layouts otherwise); this
    store never reinterprets them — bytes in, the same bytes out.
    """

    PACKET_BYTES = 4 << 20  # flush staging once this many bytes accrue

    def __init__(self, root: str, max_bytes: Optional[int] = None,
                 packet_bytes: Optional[int] = None):
        self.root = root
        self.max_bytes = max_bytes or None
        self.packet_bytes = int(packet_bytes or self.PACKET_BYTES)
        self._lock = threading.Lock()
        # sign -> (packet_seq, offset, nbytes, dim); packet_seq 0 means
        # "still staged in memory"
        self._index: Dict[int, Tuple[int, int, int, int]] = {}
        # staged (not yet on disk) sign -> (dim, stored vec)
        self._staged: "OrderedDict[int, Tuple[int, np.ndarray]]" = \
            OrderedDict()
        self._staged_bytes = 0
        # packet_seq -> [path, data_bytes, live_rows]
        self._packets: "OrderedDict[int, List]" = OrderedDict()
        self._seq = 0
        self.disk_bytes = 0
        # active dump capture (sign -> (dim, stored vec)) or None; see
        # start_dump_capture
        self._capture: Optional[Dict[int, Tuple[int, np.ndarray]]] = None
        # counters (read under the lock via stats(); plain ints)
        self.spilled_rows_total = 0
        self.fault_ins_total = 0
        self.dropped_rows = 0
        PersiaPath(root).makedirs()
        self._sweep_partials()

    # --- hygiene ---------------------------------------------------------

    def _sweep_partials(self):
        """Remove torn ``*.tmp`` packets left by a crash mid-write (the
        atomic rename means a ``.pkt`` is always complete) AND any
        previous run's ``*.pkt`` files: the sign->packet index lives
        only in memory, so after a restart those packets are
        unreadable dead bytes — the authoritative restore path is the
        checkpoint (+ inc replay). Left in place they would sit
        outside the ``max_bytes`` accounting forever and collide by
        name with this run's packets (``_seq`` restarts at 0)."""
        try:
            names = PersiaPath(self.root).listdir()
        except (OSError, RuntimeError):
            return
        for p in names:
            if p.endswith(".tmp") or p.endswith(".pkt"):
                try:
                    PersiaPath(p).remove()
                except (OSError, RuntimeError):
                    pass

    def _packet_path(self, seq: int) -> str:
        return os.path.join(self.root, f"spill_{seq:08d}.pkt")

    # --- spill (holder eviction path) ------------------------------------

    def put(self, sign: int, dim: int, stored: np.ndarray):
        """Stage one evicted row (overwrites any older spilled copy —
        the eviction carries the freshest value). The vec is kept (and
        later returned) as its raw uint8 byte image, whatever the
        holder's stored dtype — the store never reinterprets row bytes.
        Flushes a packet once the staging buffer reaches
        ``packet_bytes``."""
        sign = int(sign)
        with self._lock:
            self._evict_index_locked(sign)
            vec = np.ascontiguousarray(stored).view(np.uint8)
            self._staged[sign] = (int(dim), vec)
            self._staged_bytes += vec.nbytes
            self._index[sign] = (0, 0, vec.nbytes, int(dim))
            self.spilled_rows_total += 1
            if self._staged_bytes >= self.packet_bytes:
                self._flush_locked()

    def put_batch(self, signs: np.ndarray, dim: int, rows: np.ndarray):
        """Stage a SLAB SLICE of evicted rows in one call: ``rows`` is a
        ``(k, nbytes)`` uint8 matrix of stored (logical) records, one
        per sign. Each staged entry keeps a VIEW into the matrix — no
        per-row byte copies on the demotion path; serialization happens
        once, at packet flush. One lock acquisition for the batch."""
        if len(signs) == 0:
            return
        rows = np.ascontiguousarray(rows).view(np.uint8)
        nbytes = int(rows.shape[1])
        with self._lock:
            for i, sign in enumerate(signs.tolist()):
                sign = int(sign)
                self._evict_index_locked(sign)
                self._staged[sign] = (int(dim), rows[i])
                self._staged_bytes += nbytes
                self._index[sign] = (0, 0, nbytes, int(dim))
            self.spilled_rows_total += len(signs)
            if self._staged_bytes >= self.packet_bytes:
                self._flush_locked()

    def contains_batch(self, signs: np.ndarray) -> np.ndarray:
        """Vectorized membership (one lock acquisition): bool mask of
        which signs currently have a spilled copy — the native
        wrapper's pre-lookup fault-in planner."""
        with self._lock:
            if not self._index:
                return np.zeros(len(signs), dtype=bool)
            idx = self._index
            return np.fromiter((int(s) in idx for s in signs),
                               dtype=bool, count=len(signs))

    def flush(self):
        """Write every staged row to a packet (tests/checkpoint sync
        points; the spill path flushes on its own cadence)."""
        with self._lock:
            self._flush_locked()

    def _flush_locked(self):
        if not self._staged:
            return
        self._seq += 1
        seq = self._seq
        chunks = []
        offset = 0
        placed = []
        for sign, (dim, vec) in self._staged.items():
            raw = vec.tobytes()
            chunks.append(_REC.pack(sign, dim, len(raw)))
            chunks.append(raw)
            placed.append((sign, offset + _REC.size, len(raw), dim))
            offset += _REC.size + len(raw)
        data = b"".join(chunks)
        PersiaPath(self._packet_path(seq)).write_bytes_atomic(data)
        for sign, off, nbytes, dim in placed:
            self._index[sign] = (seq, off, nbytes, dim)
        self._packets[seq] = [self._packet_path(seq), len(data),
                              len(placed)]
        self.disk_bytes += len(data)
        self._staged = OrderedDict()
        self._staged_bytes = 0
        self._enforce_budget_locked()

    def _enforce_budget_locked(self):
        while (self.max_bytes is not None and len(self._packets) > 1
               and self.disk_bytes > self.max_bytes):
            seq, (path, nbytes, live) = next(iter(self._packets.items()))
            del self._packets[seq]
            self.disk_bytes -= nbytes
            if live:
                # cold-cold rows in the dropped packet die last-tier
                dead = [s for s, loc in self._index.items()
                        if loc[0] == seq]
                for s in dead:
                    del self._index[s]
                self.dropped_rows += live
            try:
                PersiaPath(path).remove()
            except (OSError, RuntimeError):
                pass

    # --- fault-in (holder access path) -----------------------------------

    def __contains__(self, sign: int) -> bool:
        with self._lock:
            return int(sign) in self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def take(self, sign: int) -> Optional[Tuple[int, np.ndarray]]:
        """Remove and return ``(dim, stored vec)`` for a spilled sign
        (None if absent) — the fault-in that promotes the row back to
        the RAM tier. Raises :class:`SpillReadError`, leaving the entry
        indexed, when the packet cannot be read."""
        sign = int(sign)
        with self._lock:
            loc = self._index.get(sign)
            if loc is None:
                return None
            dim, vec = self._read_locked(sign, loc)
            if self._capture is not None:
                self._capture[sign] = (dim, vec)
            self._evict_index_locked(sign)
            self.fault_ins_total += 1
            return dim, vec

    def discard(self, sign: int):
        """Drop any spilled copy of ``sign`` without reading it — the
        holder calls this before (re)inserting a sign resident, keeping
        the invariant that a resident row never shadows a stale disk
        copy."""
        sign = int(sign)
        with self._lock:
            if self._capture is not None and sign in self._index:
                try:
                    self._capture[sign] = self._read_locked(
                        sign, self._index[sign])
                except SpillReadError:
                    pass  # unreadable anyway; nothing to preserve
            self._evict_index_locked(sign)

    # --- dump-window capture ---------------------------------------------

    def start_dump_capture(self):
        """Arm the checkpoint-consistency net: while a dump is
        serializing shards, a row leaving the spill tier (fault-in /
        discard) AFTER its destination shard was already serialized
        would appear in neither section and silently fall out of the
        checkpoint. Between start and stop, every row removed from the
        index is also recorded here; the dump prepends those records
        (lowest load priority — any shard/spill record of the same
        sign is newer and wins on load)."""
        with self._lock:
            self._capture = {}

    def stop_dump_capture(self) -> Dict[int, Tuple[int, np.ndarray]]:
        """Disarm and return the rows captured since
        :meth:`start_dump_capture`."""
        with self._lock:
            cap, self._capture = self._capture, None
            return cap or {}

    def peek(self, sign: int) -> Optional[Tuple[int, np.ndarray]]:
        """Read WITHOUT removing — the read-only (eval/serving) path,
        which must not mutate tier residency."""
        sign = int(sign)
        with self._lock:
            loc = self._index.get(sign)
            if loc is None:
                return None
            return self._read_locked(sign, loc)

    def _read_locked(self, sign: int, loc) -> Tuple[int, np.ndarray]:
        seq, offset, nbytes, dim = loc
        if seq == 0:
            return self._staged[sign]
        pkt = self._packets.get(seq)
        if pkt is None:
            raise SpillReadError(
                f"spilled sign {sign}: packet seq {seq} is gone")
        try:
            raw = PersiaPath(pkt[0]).read_range(offset, nbytes)
        except (OSError, RuntimeError,
                subprocess.CalledProcessError) as e:
            raise SpillReadError(
                f"spilled sign {sign}: cannot read {pkt[0]} "
                f"[{offset}:{offset + nbytes}]: {e}") from e
        return dim, np.frombuffer(raw, dtype=np.uint8).copy()

    def _evict_index_locked(self, sign: int):
        loc = self._index.pop(sign, None)
        if loc is None:
            return
        seq = loc[0]
        if seq == 0:
            dim, vec = self._staged.pop(sign)
            self._staged_bytes -= vec.nbytes
            return
        pkt = self._packets.get(seq)
        if pkt is not None:
            pkt[2] -= 1
            if pkt[2] <= 0:  # last live row left: reclaim the packet
                del self._packets[seq]
                self.disk_bytes -= pkt[1]
                try:
                    PersiaPath(pkt[0]).remove()
                except (OSError, RuntimeError):
                    pass

    # --- whole-table views (checkpoint / len) ----------------------------

    def items(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield every live spilled ``(sign, dim, stored vec)`` — the
        checkpoint path's view of the disk tier. Iterates a snapshot of
        the index so concurrent spills/fault-ins don't invalidate it;
        rows that leave mid-iteration are skipped."""
        with self._lock:
            snapshot = list(self._index.items())
        for sign, loc in snapshot:
            with self._lock:
                cur = self._index.get(sign)
                if cur is None:
                    continue
                try:
                    dim, vec = self._read_locked(sign, cur)
                except SpillReadError:
                    continue
            yield sign, dim, vec

    def clear(self):
        with self._lock:
            for seq, (path, _nbytes, _live) in self._packets.items():
                try:
                    PersiaPath(path).remove()
                except (OSError, RuntimeError):
                    pass
            self._packets = OrderedDict()
            self._index = {}
            self._staged = OrderedDict()
            self._staged_bytes = 0
            self.disk_bytes = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "spilled_rows": len(self._index),
                "spill_disk_bytes": self.disk_bytes,
                "spill_staged_bytes": self._staged_bytes,
                "spill_packets": len(self._packets),
                "spilled_rows_total": self.spilled_rows_total,
                "spill_fault_ins_total": self.fault_ins_total,
                "spill_dropped_rows": self.dropped_rows,
            }
