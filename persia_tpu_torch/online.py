"""The online learning loop: trainer deltas into live serving
(``persia_tpu/online.py``).

Without it a row the trainer moved stays stale in a serving replica's
hot-row cache for up to ``cache_ttl_sec``. :class:`DeltaSubscriber`
scans the incremental-update packets the training PS dump
(:mod:`persia_tpu_torch.inc_update`, the stream an infer PS loads too)
and upserts their rows into the RESIDENT entries of an
``InferenceServer``'s :class:`~persia_tpu_torch.serving.HotRowCache`:
a versioned in-place swap that never inserts or evicts, refreshes the
entry's TTL, and keeps a fetch that read the PS before the delta from
rolling the row back.

- A write-rate governor (:class:`RateGovernor`, a token bucket over
  applied rows, ``PERSIA_ONLINE_APPLY_ROWS_PER_SEC``) spreads a large
  flush's applies instead of convoying the predict path on the cache
  lock; ``PERSIA_ONLINE_APPLY_BATCH_ROWS`` rows take the lock at a time.
- With a routing view (``routing_fn``), a row applies only when the
  replica that dumped it owns the row's slot under the live table (or
  the open window's predecessor), so a donor's late packet never shadows
  the new owner.
- The age of each packet's rows when they become servable lands in
  ``serving_sign_to_servable_lag_sec``; the stall clock is
  ``inc_update_sec_since_last_apply{consumer="serving"}``.

A server that attaches no subscriber runs no thread and sends no extra
RPC: the packets are read from disk.
"""

import logging
import threading
import time
from typing import Dict, Optional, Set, Tuple

import numpy as np

from persia_tpu_torch import knobs
from persia_tpu_torch.checkpoint import iter_psd_entries
from persia_tpu_torch.inc_update import packet_files, ready_packets
from persia_tpu_torch.metrics import default_registry

_logger = logging.getLogger(__name__)

# sign-to-servable ages in seconds: a subscriber's lags are sub-second
# to seconds, the TTL-only regime's tens of seconds, and both must
# resolve
LAG_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
               120.0, 300.0, 600.0)


class RateGovernor:
    """Token bucket over applied rows with a one-second burst.
    ``spend(rows)`` blocks until the budget allows the batch and returns
    the seconds it throttled; ``rows_per_sec <= 0`` never blocks. The
    clock and the sleep are injectable, for tests on a fake clock."""

    def __init__(self, rows_per_sec: float,
                 clock=time.monotonic, sleep=time.sleep):
        self.rows_per_sec = float(max(rows_per_sec, 0.0))
        self._clock = clock
        self._sleep = sleep
        self._allowance = self.rows_per_sec  # one full burst to start
        self._t_last = clock()
        self.throttled_sec = 0.0

    def spend(self, rows: int) -> float:
        if self.rows_per_sec <= 0 or rows <= 0:
            return 0.0
        now = self._clock()
        self._allowance = min(
            self.rows_per_sec,
            self._allowance + (now - self._t_last) * self.rows_per_sec)
        self._t_last = now
        if rows <= self._allowance:
            self._allowance -= rows
            return 0.0
        deficit = rows - self._allowance
        self._allowance = 0.0
        wait = deficit / self.rows_per_sec
        self._sleep(wait)
        # this batch consumed the tokens it slept for: move the refill
        # origin past the sleep so they are not counted twice
        self._t_last = self._clock()
        self.throttled_sec += wait
        return wait


class DeltaSubscriber:
    """Scan the incremental-update packets and upsert resident hot rows.

    ``routing_fn`` returns ``(table, prev)``: the live
    :class:`~persia_tpu_torch.routing.RoutingTable` and the open window's
    predecessor (or None). Without it every packet's rows apply (one PS,
    or a remote worker). ``scan_interval_sec``, ``rows_per_sec`` and
    ``batch_rows`` default to the ``PERSIA_ONLINE_*`` knobs.

    One scanner thread owns the applied set and the counters; the cache
    is the only object it shares with the predict path."""

    def __init__(self, cache, inc_dir: str,
                 scan_interval_sec: Optional[float] = None,
                 rows_per_sec: Optional[float] = None,
                 batch_rows: Optional[int] = None,
                 routing_fn=None,
                 consumer: str = "serving"):
        self.cache = cache
        self.inc_dir = inc_dir
        self.scan_interval_sec = float(
            scan_interval_sec if scan_interval_sec is not None
            else knobs.get("PERSIA_ONLINE_SCAN_SEC"))
        self.batch_rows = int(
            batch_rows if batch_rows is not None
            else knobs.get("PERSIA_ONLINE_APPLY_BATCH_ROWS"))
        self.governor = RateGovernor(
            rows_per_sec if rows_per_sec is not None
            else knobs.get("PERSIA_ONLINE_APPLY_ROWS_PER_SEC"))
        self.routing_fn = routing_fn
        self._applied: Set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.packets_applied = 0
        self.rows_applied = 0
        self.rows_skipped = 0     # not resident in the cache
        self.rows_filtered = 0    # the dumping replica does not own them
        self.last_lag_sec = 0.0
        self.last_packet: Optional[str] = None
        self.last_packet_seq = 0
        self._t_last_apply = time.monotonic()

        reg = default_registry()
        labels = {"consumer": consumer}
        self._h_lag = reg.histogram(
            "serving_sign_to_servable_lag_sec", labels,
            help_text="end-to-end online-learning freshness: packet "
                      "dump timestamp to its rows being servable from "
                      "the hot-row cache (delta apply completed)",
            buckets=LAG_BUCKETS)
        self._c_packets = reg.counter(
            "serving_delta_packets_applied_total", labels,
            help_text="incremental packets the serving delta "
                      "subscriber applied into the hot-row cache")
        self._c_rows = reg.counter(
            "serving_delta_rows_applied_total", labels,
            help_text="resident hot rows upserted in place from "
                      "incremental packets")
        self._c_skipped = reg.counter(
            "serving_delta_rows_skipped_total", labels,
            help_text="packet rows ignored because the sign is not "
                      "resident in the hot-row cache (a later miss "
                      "fetches the fresh row from the PS anyway)")
        self._c_filtered = reg.counter(
            "serving_delta_rows_filtered_total", labels,
            help_text="packet rows dropped by the routing ownership "
                      "filter (the dumping replica no longer owns the "
                      "sign's slot — a stale donor packet must not "
                      "shadow the live owner)")
        self._g_throttle = reg.gauge(
            "serving_delta_throttled_sec_total", labels,
            help_text="cumulative seconds the write-rate governor "
                      "stalled delta applies to protect serving p99")
        # the PS loader's stall-clock name, told apart by the label
        self._g_since_apply = reg.gauge(
            "inc_update_sec_since_last_apply", labels,
            help_text="seconds since this delta subscriber last "
                      "applied a packet (or since it started) — keeps "
                      "rising while the train->serve loop is stalled")

    # --- packet application ----------------------------------------------

    def _owner_mask(self, signs: np.ndarray, src: int
                    ) -> Optional[np.ndarray]:
        """True where the dumping replica ``src`` owns the sign under the
        live routing view or its predecessor; None applies everything
        (no view, or the view is unavailable)."""
        if self.routing_fn is None:
            return None
        try:
            table, prev = self.routing_fn()
        except Exception:  # the view is unavailable: apply everything
            return None
        if table is None:
            return None
        keep = table.replica_of(signs) == src
        if prev is not None and prev.num_slots == table.num_slots:
            keep |= prev.replica_of(signs) == src
        return keep

    def _apply_packet(self, pkt_dir: str) -> Tuple[int, int, int]:
        applied = skipped = filtered = 0
        for src, path in packet_files(pkt_dir):
            # the cache keys are (dim, sign) and a packet interleaves
            # dims, so bucket a file's rows by dim
            per_dim: Dict[int, list] = {}
            for sign, dim, vec in iter_psd_entries(path):
                # a packet row is [emb | optimizer state]; the cache
                # holds the embedding slice
                per_dim.setdefault(int(dim), []).append(
                    (sign, np.asarray(vec[:dim], np.float32)))
            for dim, entries in per_dim.items():
                signs = np.array([s for s, _ in entries], np.uint64)
                rows = np.stack([r for _, r in entries])
                keep = self._owner_mask(signs, src)
                if keep is not None:
                    filtered += int(len(signs) - keep.sum())
                    signs, rows = signs[keep], rows[keep]
                for at in range(0, len(signs), self.batch_rows):
                    chunk = slice(at, at + self.batch_rows)
                    self.governor.spend(len(signs[chunk]))
                    n = self.cache.apply_delta(signs[chunk], dim,
                                               rows[chunk])
                    applied += n
                    skipped += len(signs[chunk]) - n
        return applied, skipped, filtered

    def scan_once(self) -> int:
        """Apply every complete packet not applied yet; returns the
        resident rows upserted. A packet applies once in a subscriber's
        life, keyed by its name."""
        total = 0
        for name, pkt_dir, info in ready_packets(self.inc_dir,
                                                 self._applied):
            applied, skipped, filtered = self._apply_packet(pkt_dir)
            self._applied.add(name)
            self.packets_applied += 1
            self.rows_applied += applied
            self.rows_skipped += skipped
            self.rows_filtered += filtered
            self.last_packet = name
            # inc_<ts>_<seq>_r<replica>_p<pid>
            try:
                self.last_packet_seq = int(name.split("_")[2])
            except (IndexError, ValueError):
                pass
            # the rows are servable now, against the packet's dump time
            self.last_lag_sec = max(0.0, time.time() - info["time"])
            self._h_lag.observe(self.last_lag_sec)
            self._c_packets.inc()
            self._c_rows.inc(applied)
            self._c_skipped.inc(skipped)
            self._c_filtered.inc(filtered)
            self._t_last_apply = time.monotonic()
            total += applied
        self._g_throttle.set(self.governor.throttled_sec)
        self._g_since_apply.set(self.sec_since_last_apply)
        return total

    @property
    def sec_since_last_apply(self) -> float:
        return max(0.0, time.monotonic() - self._t_last_apply)

    def health(self) -> Dict:
        """The serving replica's freshness, for its health doc and
        stats."""
        return {
            "sec_since_last_apply": round(self.sec_since_last_apply, 3),
            "last_lag_sec": round(self.last_lag_sec, 3),
            "last_packet": self.last_packet,
            "last_packet_seq": self.last_packet_seq,
            "packets_applied": self.packets_applied,
            "rows_applied": self.rows_applied,
            "rows_skipped": self.rows_skipped,
            "rows_filtered": self.rows_filtered,
            "throttled_sec": round(self.governor.throttled_sec, 3),
            "inc_dir": self.inc_dir,
        }

    # --- lifecycle -------------------------------------------------------

    def start(self):
        def run():
            while not self._stop.wait(self.scan_interval_sec):
                try:
                    self.scan_once()
                except Exception as e:  # keep scanning past a bad packet
                    _logger.error("delta-subscriber scan failed: %s", e)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="serving-delta-subscriber")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
