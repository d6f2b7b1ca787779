"""Incremental updates: train -> serve delta sync
(``persia_tpu/inc_update.py``).

- **Train side.** :class:`IncrementalUpdateDumper` sits on a PS holder:
  the signs of every update collect in a dedup buffer, and once it holds
  ``buffer_size`` signs their current rows are dumped as one packet
  directory ``inc_<ts>_<seq>_r<replica>_p<pid>/<replica>.inc`` (PSD
  records: v1 for fp32 holders, v2 for fp16 / bf16 ones) with an
  ``inc_update_done`` marker, renamed into place whole.
- **Infer side.** :class:`IncrementalUpdateLoader` scans the directory
  and loads the packets it has not applied into a holder, in name
  (dump-time) order: an infer PS hot-loads them on a thread, and a PS
  restored after a crash replays its own replica's packets over its
  checkpoint.

The packet bytes are the JAX package's, so either package reads the
other's packets. :func:`ready_packets` and :func:`packet_files` are the
discovery conventions both consumers share, the other one being the
serving cache's delta subscriber (:mod:`persia_tpu_torch.online`).
"""

import json
import logging
import os
import struct
import threading
import time
from typing import Optional, Set

import numpy as np

from persia_tpu_torch.checkpoint import iter_psd_entries
from persia_tpu_torch.metrics import AGE_BUCKETS, COUNT_BUCKETS, \
    default_registry
from persia_tpu_torch.ps.optim import RowPrecision
from persia_tpu_torch.ps.store import _DTYPE_CODES, DUMP_MAGIC

_logger = logging.getLogger(__name__)

DONE_MARKER = "inc_update_done"


def ready_packets(inc_dir: str, applied: Set[str]):
    """Yield ``(name, pkt_dir, marker_info)`` for every complete packet
    under ``inc_dir`` that is not in ``applied``, in name order (names
    sort by dump time). A packet is visible once its done marker exists;
    the dumper renames the whole directory into place, so a partly
    written packet is never listed."""
    if not os.path.isdir(inc_dir):
        return
    for name in sorted(os.listdir(inc_dir)):
        pkt_dir = os.path.join(inc_dir, name)
        marker = os.path.join(pkt_dir, DONE_MARKER)
        if (name in applied or not name.startswith("inc_")
                or not os.path.exists(marker)):
            continue
        with open(marker) as f:
            info = json.load(f)
        yield name, pkt_dir, info


def packet_files(pkt_dir: str):
    """The ``(source_replica, path)`` pairs of one packet's ``.inc``
    files, in replica order. A file's stem is the index of the replica
    that dumped it."""
    out = []
    for fn in sorted(os.listdir(pkt_dir)):
        if not fn.endswith(".inc"):
            continue
        try:
            replica = int(fn[:-len(".inc")])
        except ValueError:
            continue
        out.append((replica, os.path.join(pkt_dir, fn)))
    return out


def load_owned_rows(holder, path: str, replica_index: int, routing,
                    batch_rows: int = 65536) -> int:
    """Set the rows of the PSD file at ``path`` that ``routing`` (a
    :class:`~persia_tpu_torch.routing.RoutingTable`) sends to
    ``replica_index``, ``batch_rows`` at a time; returns their count."""
    kept = 0
    batch = []

    def flush():
        nonlocal kept
        if not batch:
            return
        owners = routing.replica_of(
            np.array([b[0] for b in batch], dtype=np.uint64))
        for (sign, dim, vec), owner in zip(batch, owners):
            if int(owner) == replica_index:
                holder.set_entry(sign, dim, vec)
                kept += 1
        batch.clear()

    for rec in iter_psd_entries(path):
        batch.append(rec)
        if len(batch) >= batch_rows:
            flush()
    flush()
    return kept


class IncrementalUpdateDumper:
    """Train side: attach to a holder and call :meth:`commit` with the
    signs of every update; :meth:`flush` dumps what the buffer holds."""

    def __init__(self, holder, inc_dir: str, buffer_size: int = 1_000_000,
                 replica_index: int = 0):
        self.holder = holder
        self.inc_dir = inc_dir
        self.buffer_size = buffer_size
        self.replica_index = replica_index
        self._buffer: Set[int] = set()
        self._lock = threading.Lock()
        self._seq = 0
        os.makedirs(inc_dir, exist_ok=True)

    def commit(self, signs: np.ndarray):
        flush: Optional[Set[int]] = None
        with self._lock:
            self._buffer.update(int(s) for s in signs)
            if len(self._buffer) >= self.buffer_size:
                flush = self._buffer
                self._buffer = set()
                seq = self._seq = self._seq + 1
        if flush:
            self._dump_packet(flush, seq)

    def flush(self):
        with self._lock:
            flush, self._buffer = self._buffer, set()
            if flush:
                seq = self._seq = self._seq + 1
        if flush:
            self._dump_packet(flush, seq)

    def _dump_packet(self, signs: Set[int], seq: int):
        # a half-precision holder ships v2 records (its stored embedding
        # bytes and the f32 state), an fp32 one v1
        rp = RowPrecision(getattr(self.holder, "row_dtype", "fp32"))
        version = 1 if rp.is_fp32 else 2
        # every replica shares the directory, so the replica index is part
        # of the name; a restarted replica starts its seq at 1 again, so
        # the pid keeps it from colliding with its predecessor's packets.
        # ``seq`` is allocated under the lock in commit / flush, so two
        # update handlers flushing at once never mint one name.
        name = (f"inc_{time.strftime('%Y%m%d%H%M%S')}_{seq:06d}"
                f"_r{self.replica_index}_p{os.getpid()}")
        pkt_dir = os.path.join(self.inc_dir, name)
        tmp_dir = pkt_dir + ".tmp"
        os.makedirs(tmp_dir, exist_ok=True)
        records = []
        count = 0
        for sign in signs:
            entry = self.holder.get_entry(sign)
            if entry is None:
                continue
            dim, vec = entry
            vec = np.ascontiguousarray(vec, np.float32)
            if version == 1:
                records.append(struct.pack("<QII", sign, dim, len(vec)))
                records.append(vec.tobytes())
            else:
                records.append(struct.pack(
                    "<QIBI", sign, dim, _DTYPE_CODES[rp.name],
                    len(vec) - dim))
                records.append(rp.pack(vec, dim).tobytes())
            count += 1
        with open(os.path.join(tmp_dir, f"{self.replica_index}.inc"),
                  "wb") as f:
            f.write(DUMP_MAGIC)
            f.write(struct.pack("<IQ", version, count))
            for r in records:
                f.write(r)
        with open(os.path.join(tmp_dir, DONE_MARKER), "w") as f:
            json.dump({"count": count, "time": time.time()}, f)
        os.rename(tmp_dir, pkt_dir)
        _logger.info("incremental packet %s: %d entries", name, count)


class IncrementalUpdateLoader:
    """Infer side: scan ``inc_dir`` and load the packets not applied yet
    into ``holder``.

    ``replica_index`` loads only that replica's ``.inc`` files (a PS
    restored after a crash rebuilds its own rows); None loads every
    replica's. ``routing`` (a
    :class:`~persia_tpu_torch.routing.RoutingTable`) replaces the file
    filter by ownership: every replica's files are read and only the
    rows the table routes to ``replica_index`` apply, which is the right
    replay across a change of the shard count.

    Its series in the metrics registry are the JAX loader's:
    ``inc_update_last_delay_sec``, ``inc_update_sec_since_last_apply``,
    ``inc_update_freshness_lag_sec``, ``inc_update_packet_entries``,
    ``inc_update_packets_applied_total`` and
    ``inc_update_entries_applied_total``."""

    def __init__(self, holder, inc_dir: str, scan_interval_sec: float = 10.0,
                 replica_index: Optional[int] = None, routing=None):
        self.holder = holder
        self.inc_dir = inc_dir
        self.scan_interval_sec = scan_interval_sec
        self.replica_index = replica_index
        self.routing = routing
        if routing is not None and replica_index is None:
            raise ValueError(
                "routing-filtered replay needs the replica_index the "
                "table should route to")
        self._applied: Set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_delay_sec: float = 0.0
        self.packets_applied: int = 0
        # the stall clock: seconds since the last apply (or since this
        # loader started), refreshed on every scan
        self._t_last_apply = time.monotonic()
        reg = default_registry()
        self._g_delay = reg.gauge(
            "inc_update_last_delay_sec",
            help_text="age of the newest applied incremental packet at "
                      "its apply time (train->serve sync delay)")
        self._g_since_apply = reg.gauge(
            "inc_update_sec_since_last_apply",
            help_text="seconds since this loader last applied a packet "
                      "(or since it started) — keeps rising while the "
                      "train->serve sync loop is stalled")
        self._h_freshness = reg.histogram(
            "inc_update_freshness_lag_sec",
            help_text="per-packet sign-to-servable age: packet dump "
                      "timestamp to its apply completing",
            buckets=AGE_BUCKETS)
        self._h_entries = reg.histogram(
            "inc_update_packet_entries",
            help_text="entries loaded per applied incremental packet",
            buckets=COUNT_BUCKETS)
        self._c_packets = reg.counter(
            "inc_update_packets_applied_total",
            help_text="incremental packets applied by this loader")
        self._c_entries = reg.counter(
            "inc_update_entries_applied_total",
            help_text="entries hot-loaded from incremental packets")

    def _apply_file(self, path: str) -> int:
        if self.routing is not None:
            return load_owned_rows(self.holder, path, self.replica_index,
                                   self.routing)
        n = 0
        for sign, dim, vec in iter_psd_entries(path):
            self.holder.set_entry(sign, dim, vec)
            n += 1
        return n

    def scan_once(self) -> int:
        """Apply every complete packet not applied yet; returns the
        entries loaded."""
        loaded = 0
        for name, pkt_dir, info in ready_packets(self.inc_dir,
                                                 self._applied):
            pkt_loaded = 0
            for src, path in packet_files(pkt_dir):
                if (self.routing is None and self.replica_index is not None
                        and src != self.replica_index):
                    continue
                pkt_loaded += self._apply_file(path)
            loaded += pkt_loaded
            self._applied.add(name)
            # the packet's rows are servable now, against its dump time
            self.last_delay_sec = max(0.0, time.time() - info["time"])
            self.packets_applied += 1
            self._h_freshness.observe(self.last_delay_sec)
            self._h_entries.observe(pkt_loaded)
            self._c_packets.inc()
            self._c_entries.inc(pkt_loaded)
            self._g_delay.set(self.last_delay_sec)
            self._t_last_apply = time.monotonic()
        self._g_since_apply.set(self.sec_since_last_apply)
        return loaded

    @property
    def sec_since_last_apply(self) -> float:
        return max(0.0, time.monotonic() - self._t_last_apply)

    def start(self):
        def run():
            while not self._stop.wait(self.scan_interval_sec):
                try:
                    self.scan_once()
                except Exception as e:  # keep scanning past a bad packet
                    _logger.error("incremental scan failed: %s", e)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="inc-update-scanner")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
