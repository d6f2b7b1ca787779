"""Embedding parameter-server service and its RPC client
(``persia_tpu/service/ps_service.py``).

:class:`PsService` serves one PS replica's holder (the native C++ store
by default, :func:`persia_tpu_torch.ps.native.make_holder`) over
:mod:`persia_tpu_torch.rpc`; :class:`PsClient` presents the holder
interface over the wire, so an
:class:`~persia_tpu_torch.worker.worker.EmbeddingWorker` runs over the
network unchanged. Requests and replies are the JAX package's bytes:
lookups answer through ``pack_arrays_sg``, as fp16 rows when a
codec-negotiated client asks ``resp: fp16``, and with the holder's update
version ``hver`` only when asked ``hv``; updates take int8 rows and
per-row scales under ``codec: int8``.

The incremental-update tier (:mod:`persia_tpu_torch.inc_update`): a
training replica's ``inc_dumper`` commits the signs of every write
(``update_gradients``, ``set_entry``, ``set_entries``); an infer
replica's ``inc_loader`` hot-loads the packets, and its health doc
carries the loader's freshness. ``restore(replay_inc_dir=)`` replays a
replica's packets over its checkpoint after a crash.

The live-resharding surface (:mod:`persia_tpu_torch.reshard` drives
it): ``reshard_begin`` arms write capture for the moving slots and
snapshots their rows, ``reshard_extract`` / ``reshard_install`` stream
them donor -> target, ``reshard_drain`` replays the captured writes'
current rows, ``reshard_freeze`` bounces writes to the moving slots with
``routing_stale`` (:mod:`persia_tpu_torch.routing`), ``reshard_finish``
disarms; ``reshard_status`` and ``set_routing_epoch`` report and record
the epoch. Every reshard call carries a fencing token, and a donor whose
controller stops renewing its lease thaws by itself. A write handler
passes a write gate and, only while a migration runs, the capture guard;
the ``__routing__`` rider acks a probing client with the epoch. None of
it rides the wire of a fleet that never reshards.

The registry series (``ps_*`` with a ``server`` label: resident bytes a
shard, the arena's slabs, the spill tier, the SIMD path and dispatch
mode, the served requests and looked-up rows with their rate, the
frozen-slot age and the lease expiries, the gradient staleness) are set
by :meth:`PsService._refresh_mem_gauges` before each ``/metrics`` render
and each health read.

Run: ``python -m persia_tpu_torch.service.ps_service --port 0
--replica-index 0 --replica-size 2 [--coordinator host:port]
[--global-config global.yml] [--initial-checkpoint replica_0.psd
--replay-inc-dir <incremental_dir>]``
"""

import argparse
import contextlib
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from persia_tpu_torch import _msgpack, faults, knobs, obs_http, tracing
from persia_tpu_torch import wire_codec
from persia_tpu_torch.hashing import farmhash64_np
from persia_tpu_torch.metrics import STEP_BUCKETS, default_registry
from persia_tpu_torch.routing import STALE_PREFIX
from persia_tpu_torch.rpc import (
    CircuitBreaker,
    RpcCircuitOpen,
    RpcClient,
    RpcError,
    RpcServer,
    pack_arrays,
    pack_arrays_sg,
    tcp_probe,
    unpack_arrays,
)
from persia_tpu_torch.service.coordinator import ROLE_PS, CoordinatorClient

_logger = logging.getLogger(__name__)


class _WriteGate:
    """Generation-counted barrier over the PS write handlers.

    Every write (gradient update, row write, training lookup: they create
    rows) enters the current generation and exits once applied.
    :meth:`drain_prior` flips the generation and waits for the old one to
    empty, so every write that began before the flip is visible in the
    holder. ``reshard_begin`` calls it between arming capture and the
    snapshot: a write already past the (then absent) capture guard could
    otherwise land in a shard the snapshot has read, in neither the copy
    nor the capture set — a lost update. One uncontended lock pair a
    write."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # in-flight counts by generation (pruned at zero): a drain that
        # timed out on a wedged write leaves its generation visible to
        # the next drain
        self._counts: Dict[int, int] = {}
        self._gen = 0

    def enter(self) -> int:
        with self._lock:
            g = self._gen
            self._counts[g] = self._counts.get(g, 0) + 1
        return g

    def exit(self, g: int):
        with self._lock:
            self._counts[g] -= 1
            if self._counts[g] == 0:
                del self._counts[g]
                self._cond.notify_all()

    def drain_prior(self, timeout: float = 10.0):
        """Bump the generation; wait until every write of an earlier one
        has applied (one caller at a time: the reshard lock)."""
        with self._lock:
            self._gen += 1
            cur = self._gen
            deadline = time.monotonic() + timeout
            while any(g < cur for g in self._counts):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        "pre-arm writes did not drain before the "
                        "reshard snapshot")
                self._cond.wait(left)


class _ReshardState:
    """A donor's state of one migration: the moving slots' mask, the
    write-capture set, the snapshot stream and the freeze barrier. One a
    replica at a time; while none runs, a write handler pays one
    ``is None`` test."""

    def __init__(self, slots, num_slots: int, epoch: int,
                 mig_id: Optional[str] = None,
                 token: Optional[tuple] = None,
                 lease_sec: Optional[float] = None):
        self.num_slots = int(num_slots)
        self.epoch = int(epoch)
        # which migration attempt owns this state (None on both: an
        # unfenced controller)
        self.mig_id = mig_id
        self.token = (int(token[0]), int(token[1])) if token else None
        self.mask = np.zeros(self.num_slots, dtype=bool)
        self.mask[np.asarray(sorted(set(int(s) for s in slots)),
                             dtype=np.int64)] = True
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.frozen = False  # a plain bool: reads are atomic
        self.frozen_at = 0.0  # time.monotonic() of the freeze
        self.inflight = 0
        self.captured: set = set()
        self.captured_total = 0
        self.snapshot_rows: List = []
        self.extract_pos = 0
        # the controller's lease: every fenced reshard call renews it; on
        # expiry the donor thaws (capture dropped, slots unfrozen) rather
        # than serve a shard frozen for ever. 0 disables it.
        if lease_sec is None:
            lease_sec = float(
                knobs.get("PERSIA_RESHARD_FREEZE_LEASE_SEC"))
        self.lease_sec = float(lease_sec)
        self.lease_deadline = (time.monotonic() + self.lease_sec
                               if self.lease_sec > 0 else float("inf"))

    def touch(self):
        """Renew the controller's lease."""
        if self.lease_sec > 0:
            self.lease_deadline = time.monotonic() + self.lease_sec

    def lease_expired(self) -> bool:
        return time.monotonic() >= self.lease_deadline

    def hits(self, signs: np.ndarray) -> Optional[np.ndarray]:
        """The signs of ``signs`` in a moving slot (None when none is)."""
        s = np.ascontiguousarray(signs, dtype=np.uint64)
        if len(s) == 0:
            return None
        slot = (farmhash64_np(s)
                % np.uint64(self.num_slots)).astype(np.int64)
        hit = self.mask[slot]
        return s[hit] if hit.any() else None

    def enter_write(self, signs: np.ndarray) -> Optional[np.ndarray]:
        """Gate one write: None when it touches no moving slot, else the
        signs to capture at :meth:`exit_write` (the write is counted for
        the freeze barrier). Frozen, the writer bounces with
        ``routing_stale``."""
        hit = self.hits(signs)
        if hit is None:
            return None
        with self._lock:
            if self.frozen:
                raise RpcError(f"{STALE_PREFIX}{self.epoch}")
            self.inflight += 1
        return hit

    def exit_write(self, hit: np.ndarray):
        with self._lock:
            self.captured.update(int(x) for x in hit)
            self.captured_total += len(hit)
            self.inflight -= 1
            if self.inflight == 0:
                self._cond.notify_all()

    def freeze(self, timeout: float = 5.0):
        """Admit no more writes to the moving slots and wait out those
        already past the gate: the final drain then reads definitive
        rows. A repeated freeze waits the (empty) barrier again."""
        with self._lock:
            if not self.frozen:
                self.frozen = True
                self.frozen_at = time.monotonic()
            deadline = time.monotonic() + timeout
            while self.inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        "reshard freeze: in-flight writes did not "
                        "settle within the barrier timeout")
                self._cond.wait(left)

    def drain_captured(self) -> set:
        with self._lock:
            out, self.captured = self.captured, set()
        return out

    def doc(self, with_token: bool = False) -> dict:
        """The state as the health doc (and, ``with_token``,
        ``reshard_status``) shows it."""
        with self._lock:
            token = ({"token": list(self.token) if self.token else None}
                     if with_token else {})
            return {
                "frozen": self.frozen,
                "frozen_age_sec": (
                    round(time.monotonic() - self.frozen_at, 3)
                    if self.frozen else 0.0),
                "pending_epoch": self.epoch,
                "mig_id": self.mig_id,
                **token,
                "lease_sec": self.lease_sec,
                "captured": len(self.captured),
                "captured_total": self.captured_total,
                "snapshot_rows_left": len(self.snapshot_rows),
            }


# numeric codes of the per-process path gauges (a scraper compares them
# across replicas)
SIMD_PATH_CODES = {"scalar": 0, "avx2": 1, "neon": 2}
DISPATCH_MODE_CODES = {"serial": 0, "pool": 1, "native": 2}


class ShardParallelDispatcher:
    """How a replica runs its holder's lookups and updates across the
    holder's internal shards.

    The native store fans a call out over its shards by itself and
    releases the interpreter lock for the whole call. Where the library
    has the tuning capability (``parallel_tuning`` in
    :func:`~persia_tpu_torch.ps.native.native_capabilities`), the
    dispatcher is in ``native`` mode: it tunes the store to fan out from
    :attr:`MIN_PARALLEL` signs (hosts past 8 cores get a thread a core,
    up to a thread a shard), and every call stays one foreign call. A
    holder that computes under the interpreter lock (the Python arena
    and per-entry holders), or ``PERSIA_PS_SHARD_PARALLEL=0``, is
    ``serial``. Either way a call is the holder's own, so every shard
    sees the serial call's order of operations. (The JAX dispatcher's
    thread-pool mode serves native libraries without the tuning
    capability, which the port's library always has.)"""

    MIN_PARALLEL = 512

    def __init__(self, holder):
        from persia_tpu_torch.ps.native import (
            NativeEmbeddingHolder,
            native_capabilities,
        )

        self.holder = holder
        n = int(getattr(holder, "num_internal_shards", 1))
        cpus = os.cpu_count() or 1
        self._workers = min(n, cpus)
        self._native_par = None
        self.mode = "serial"
        if (knobs.get("PERSIA_PS_SHARD_PARALLEL") and n > 1
                and isinstance(holder, NativeEmbeddingHolder)
                and "parallel_tuning" in native_capabilities()):
            holder.set_parallel(0 if cpus <= 8 else min(n, cpus),
                                self.MIN_PARALLEL)
            self._native_par = holder.parallel_info()
            self.mode = "native"
        self.enabled = self.mode == "native"

    def info(self) -> dict:
        doc = {"mode": self.mode, "enabled": self.enabled,
               "workers": self._workers}
        if self._native_par is not None:
            doc["native_threads"] = int(self._native_par["threads"])
            doc["native_min_batch"] = int(self._native_par["min_batch"])
        return doc


class PsService:
    """One PS replica behind an RPC server. ``http_port`` starts the
    observability sidecar (0 = ephemeral, None = off); ``legacy_frames``
    answers with the concatenating ``pack_arrays`` instead of the
    scatter-gather frames. ``inc_dumper`` (an
    :class:`~persia_tpu_torch.inc_update.IncrementalUpdateDumper`) is
    handed the signs of every write; ``inc_loader`` (an
    :class:`~persia_tpu_torch.inc_update.IncrementalUpdateLoader`)
    reports its freshness in the health doc."""

    def __init__(self, holder, host: str = "127.0.0.1", port: int = 0,
                 concurrent_streams: int = 8, legacy_frames: bool = False,
                 http_port: Optional[int] = None, inc_dumper=None,
                 inc_loader=None):
        self.holder = holder
        self.inc_dumper = inc_dumper
        self.inc_loader = inc_loader
        # a multiplexing worker (tagged framing) gets out-of-order
        # completion from the per-connection dispatch pool
        self.server = RpcServer(host, port,
                                concurrent_streams=concurrent_streams)
        self._dispatch = ShardParallelDispatcher(holder)
        self._pack = pack_arrays if legacy_frames else pack_arrays_sg
        self.status = "Idle"  # Idle | Dumping | Loading | Failed: ...
        self._status_lock = threading.Lock()
        # the update-batch version: one bump per applied write; a
        # telemetry-armed client echoes the version its lookup saw, and
        # the difference is its gradient's staleness in applies
        self._ver_lock = threading.Lock()
        self._update_ver = 0
        s = self.server
        for name, fn in (
                ("configure", self._configure),
                ("register_optimizer", self._register_optimizer),
                ("lookup", self._lookup),
                ("update_gradients", self._update_gradients),
                ("len", self._len), ("get_entry", self._get_entry),
                ("set_entry", self._set_entry),
                ("get_entries", self._get_entries),
                ("set_entries", self._set_entries), ("clear", self._clear),
                ("dump", self._dump), ("load", self._load),
                ("status", self._status), ("ready_for_serving", self._ready),
                ("health", self._health_rpc),
                ("hotness", self._hotness_rpc),
                ("reshard_begin", self._reshard_begin),
                ("reshard_extract", self._reshard_extract),
                ("reshard_install", self._reshard_install),
                ("reshard_drain", self._reshard_drain),
                ("reshard_freeze", self._reshard_freeze),
                ("reshard_finish", self._reshard_finish),
                ("reshard_status", self._reshard_status),
                ("set_routing_epoch", self._set_routing_epoch)):
            s.register(name, fn)
        # the live-resharding state: one migration at a time; the fencing
        # watermark is the highest (epoch, attempt) token any reshard call
        # presented, and outlives the state it fenced (a thawed or
        # finished migration still fences out its dead controller)
        self._reshard: Optional[_ReshardState] = None
        self._reshard_lock = threading.Lock()
        self._reshard_fence = (0, 0)
        self._routing_epoch = 0
        self._wgate = _WriteGate()
        # the __routing__ rider: acks a probing client with this
        # replica's epoch; a client that never probes sees no change
        s.register("__routing__", lambda payload: _msgpack.packb(
            {"epoch": self._routing_epoch}))
        reg = default_registry()
        port_label = self.server.addr.rsplit(":", 1)[1]
        lbl = {"server": port_label}
        self._mem_gauges = [
            reg.gauge("ps_resident_bytes",
                      {"server": port_label, "shard": str(i)})
            for i in range(holder.num_internal_shards)
        ] if hasattr(holder, "resident_bytes_per_shard") else []
        # the arena's slab accounting (both arena backends)
        self._arena_gauges = None
        if getattr(holder, "arena_stats", None) is not None:
            self._arena_gauges = {
                "slab_bytes": reg.gauge(
                    "ps_arena_slab_bytes", lbl,
                    help_text="bytes of allocated arena slabs (resident "
                              "rows + free slots + padding)"),
                "free_slots": reg.gauge(
                    "ps_arena_free_slots", lbl,
                    help_text="evicted row slots awaiting reuse in the "
                              "arena free lists"),
                "live_rows": reg.gauge(
                    "ps_arena_live_rows", lbl,
                    help_text="rows resident in the arena (excludes "
                              "the disk spill tier)"),
                "fragmentation_ratio": reg.gauge(
                    "ps_arena_fragmentation_ratio", lbl,
                    help_text="free slots / allocated slots — slab "
                              "space held by eviction churn instead of "
                              "live rows (the arena never returns "
                              "slabs; a runaway ratio means capacity "
                              "planning should shrink the table or "
                              "restart the replica)"),
            }
        # per-process codes: -1 no SIMD ABI, 0 scalar, 1 avx2, 2 neon;
        # 0 serial, 1 thread pool, 2 native GIL-free dispatch
        reg.gauge(
            "ps_simd_path", lbl,
            help_text="native kernel path this replica selected "
                      "(-1 none/pre-SIMD .so, 0 scalar, 1 avx2, "
                      "2 neon) — scalar on an AVX2 host usually means "
                      "PERSIA_NATIVE_SIMD was forced down").set(
            SIMD_PATH_CODES.get(getattr(holder, "simd_path", None), -1))
        reg.gauge(
            "ps_dispatch_mode", lbl,
            help_text="shard-parallel dispatch mode (0 serial, "
                      "1 thread-pool, 2 native-internal GIL-free)").set(
            DISPATCH_MODE_CODES.get(self._dispatch.mode, 0))
        # the disk tier (spill-armed holders only)
        self._spill_gauges = None
        if getattr(holder, "spill", None) is not None:
            self._spill_gauges = {
                "spilled_rows": reg.gauge(
                    "ps_spill_resident_rows", lbl,
                    help_text="rows currently demoted to the disk "
                              "spill tier"),
                "spill_disk_bytes": reg.gauge(
                    "ps_spill_disk_bytes", lbl,
                    help_text="bytes of live spill packets on disk"),
                "spilled_rows_total": reg.gauge(
                    "ps_spill_demotions_total", lbl,
                    help_text="rows ever demoted RAM->disk (monotone)"),
                "spill_fault_ins_total": reg.gauge(
                    "ps_spill_fault_ins_total", lbl,
                    help_text="rows ever faulted disk->RAM (monotone)"),
                "spill_dropped_rows": reg.gauge(
                    "ps_spill_dropped_rows_total", lbl,
                    help_text="rows dropped with their packet when the "
                              "disk budget overflowed (monotone)"),
            }
        # the donor's own migration observables: a controller that dies
        # after the freeze shows only here; the counter records each
        # thaw of an expired lease
        self._g_frozen_age = reg.gauge(
            "ps_frozen_slot_age_sec", lbl,
            help_text="seconds this replica's moving slots have been "
                      "write-frozen by an in-flight migration (0 when "
                      "not frozen) — a stuck value means the reshard "
                      "controller died post-freeze; the freeze lease "
                      "auto-thaws it")
        self._c_lease_expired = reg.counter(
            "ps_reshard_lease_expired_total", lbl,
            help_text="migrations this donor auto-thawed because the "
                      "controller stopped heartbeating within the "
                      "freeze lease")
        self._h_staleness = reg.histogram(
            "ps_gradient_staleness_steps", lbl,
            help_text="update batches applied between a telemetry-"
                      "armed client's lookup and its gradient's "
                      "apply (async-pipeline staleness, in steps)",
            buckets=STEP_BUCKETS)
        # the load signal: rows, which partition with slot ownership
        # (every request reaches every replica, so the request rate does
        # not); the rate is computed at each refresh
        self._rows_lock = threading.Lock()
        self._rows_served = 0
        self._rows_rate_last: Optional[tuple] = None  # (t, rows)
        self._g_served_reqs = reg.gauge(
            "ps_served_requests_total", lbl,
            help_text="RPC requests this replica answered (monotone; "
                      "mirrors the health doc's served_rpcs so wire-"
                      "neutrality gates can read it from a scrape)")
        self._g_lookup_rows = reg.gauge(
            "ps_lookup_rows_total", lbl,
            help_text="embedding rows served by lookup RPCs (monotone) "
                      "— the load unit that scales with slot ownership")
        self._g_lookup_row_rate = reg.gauge(
            "ps_lookup_row_rate", lbl,
            help_text="lookup rows/sec over the interval between the "
                      "last two gauge refreshes (scrapes) — the "
                      "autopilot's sustained() scale signal and its "
                      "per-replica imbalance breakdown")
        self.http = obs_http.maybe_start(host, http_port, self._health,
                                         refresh_fn=self._refresh_mem_gauges,
                                         hotness_fn=self._hotness_snapshot)

    @property
    def addr(self):
        return self.server.addr

    def stop(self):
        self.server.stop()
        if self.http is not None:
            self.http.stop()

    # --- observability ---------------------------------------------------

    def _refresh_mem_gauges(self):
        """Set the registry series from the holder and the counters (the
        sidecar calls it before each ``/metrics`` render; each health
        read calls it too)."""
        self._maybe_expire_reshard()
        rs = self._reshard
        self._g_frozen_age.set(
            round(time.monotonic() - rs.frozen_at, 3)
            if rs is not None and rs.frozen else 0)
        if self._mem_gauges:
            for g, b in zip(self._mem_gauges,
                            self.holder.resident_bytes_per_shard()):
                g.set(b)
        for gauges, stats_fn in ((self._arena_gauges, "arena_stats"),
                                 (self._spill_gauges, "spill_stats")):
            if gauges is not None:
                stats = getattr(self.holder, stats_fn)()
                for key, g in gauges.items():
                    g.set(stats.get(key, 0))
        # the rate re-anchors only after 50 ms, so a health read right
        # after a scrape does not shrink its window to noise
        t_now = time.monotonic()
        rate = None
        with self._rows_lock:
            rows = self._rows_served
            last = self._rows_rate_last
            if last is None:
                self._rows_rate_last = (t_now, rows)
            elif t_now - last[0] >= 0.05:
                self._rows_rate_last = (t_now, rows)
                rate = (rows - last[1]) / (t_now - last[0])
        self._g_lookup_rows.set(rows)
        self._g_served_reqs.set(self.server.health()["served_rpcs"])
        if rate is not None:
            self._g_lookup_row_rate.set(max(rate, 0.0))

    def _health(self) -> dict:
        doc = self.server.health()
        with self._status_lock:
            doc["model_manager_status"] = self.status
        holder = self.holder
        doc["holder_entries"] = len(holder)
        doc["shard_parallel"] = self._dispatch.enabled
        doc["simd"] = getattr(holder, "simd_path", None)
        doc["dispatch"] = self._dispatch.info()
        doc["row_dtype"] = getattr(holder, "row_dtype", "fp32")
        doc["resident_bytes"] = getattr(holder, "resident_bytes", -1)
        doc["resident_emb_bytes"] = getattr(holder, "resident_emb_bytes",
                                            -1)
        doc["backend"] = type(holder).__name__
        arena_stats = getattr(holder, "arena_stats", None)
        if arena_stats is not None and arena_stats():
            doc["arena"] = arena_stats()
        doc["hotness_enabled"] = getattr(holder, "hotness", None) is not None
        doc["update_version"] = self._current_update_ver()
        # the published routing epoch and, while a migration runs, the
        # donor's capture and freeze state
        doc["routing_epoch"] = self._routing_epoch
        self._maybe_expire_reshard()
        rs = self._reshard
        if rs is not None:
            doc["reshard"] = rs.doc()
        spill_stats = getattr(holder, "spill_stats", None)
        if spill_stats is not None and spill_stats():
            doc["spill"] = spill_stats()
        if self.inc_loader is not None:
            # how far this replica's hot-loaded rows run behind the
            # training tier
            doc["inc_update_last_delay_sec"] = round(
                self.inc_loader.last_delay_sec, 3)
            doc["inc_update_sec_since_last_apply"] = round(
                self.inc_loader.sec_since_last_apply, 3)
            doc["inc_update_packets_applied"] = (
                self.inc_loader.packets_applied)
        self._refresh_mem_gauges()
        # readiness, distinct from liveness: the sidecar's
        # /healthz?ready=1 answers 503 until an optimizer is registered
        # and no dump or load runs
        doc["ready"] = self._is_ready()
        return doc

    def _is_ready(self) -> bool:
        with self._status_lock:
            idle = self.status == "Idle"
        return getattr(self.holder, "optimizer", True) is not None and idle

    def _health_rpc(self, payload: bytes) -> bytes:
        return _msgpack.packb(self._health())

    def _hotness_snapshot(self) -> dict:
        from persia_tpu_torch import hotness

        snap = getattr(self.holder, "hotness_snapshot", None)
        return snap() if snap is not None else hotness.disabled_snapshot()

    def _hotness_rpc(self, payload: bytes) -> bytes:
        return _msgpack.packb(self._hotness_snapshot())

    def _bump_update_ver(self) -> int:
        with self._ver_lock:
            self._update_ver += 1
            return self._update_ver

    def _current_update_ver(self) -> int:
        with self._ver_lock:
            return self._update_ver

    # --- data plane ------------------------------------------------------

    def _configure(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        self.holder.configure(
            req["init_method"], req["init_params"],
            admit_probability=req["admit_probability"],
            weight_bound=req["weight_bound"],
            enable_weight_bound=req["enable_weight_bound"])
        return b""

    def _register_optimizer(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        self.holder.register_optimizer(
            req["config"],
            feature_index_prefix_bit=req["feature_index_prefix_bit"])
        return b""

    def _lookup(self, payload: bytes) -> bytes:
        meta, (signs,) = unpack_arrays(payload)
        if faults._active:
            faults.fire("ps.lookup", n=len(signs), dim=meta["dim"])
        # a training lookup creates rows: a write for the gate and the
        # migration's capture (an eval read is served by the donor all
        # through the double-read window)
        with self._guarded_write(signs, meta, meta["training"]):
            with tracing.span("ps/lookup", ctx=tracing.current_context(),
                              n=len(signs), dim=meta["dim"]):
                out = self.holder.lookup(signs, meta["dim"],
                                         meta["training"])
        with self._rows_lock:
            self._rows_served += len(signs)
        # the update version rides the reply only when asked, so a
        # client without telemetry sees the plain reply bytes
        extra = {"hver": self._current_update_ver()} if meta.get("hv") \
            else {}
        # a server that refuses the codec probe answers fp32 on every path
        if meta.get("resp") == "fp16" and self.server._enable_codec:
            return self._pack({"codec": "fp16", **extra},
                              [wire_codec.encode_fp16_rows(out)])
        return self._pack(extra, [out])

    def _update_gradients(self, payload: bytes) -> bytes:
        meta, arrays = unpack_arrays(payload)
        if meta.get("codec") == "int8":
            signs, q, scales = arrays
            grads = wire_codec.dequantize_int8_rows(q, scales)
        else:
            signs, grads = arrays
        if faults._active:
            faults.fire("ps.update", n=len(signs), dim=meta["dim"])
        with self._guarded_write(signs, meta):
            with tracing.span("ps/update", ctx=tracing.current_context(),
                              n=len(signs), dim=meta["dim"]):
                self.holder.update_gradients(signs, grads, meta["dim"])
        ver = self._bump_update_ver()
        hver = meta.get("hver")
        if hver is not None:
            self._h_staleness.observe(max(ver - 1 - int(hver), 0))
        if self.inc_dumper is not None:
            self.inc_dumper.commit(signs)
        return b""

    def _len(self, payload: bytes) -> bytes:
        return _msgpack.packb({"len": len(self.holder)})

    def _get_entry(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        entry = self.holder.get_entry(req["sign"])
        if entry is None:
            return pack_arrays({"found": False, "dim": 0}, [])
        dim, vec = entry
        return pack_arrays({"found": True, "dim": dim}, [vec])

    def _set_entry(self, payload: bytes) -> bytes:
        meta, (vec,) = unpack_arrays(payload)
        with self._guarded_write(
                np.asarray([meta["sign"]], dtype=np.uint64), meta):
            self.holder.set_entry(meta["sign"], meta["dim"], vec)
        # a full-row write joins the version stream and the
        # incremental-update log as a gradient apply does
        self._bump_update_ver()
        if self.inc_dumper is not None:
            self.inc_dumper.commit(
                np.asarray([meta["sign"]], dtype=np.uint64))
        return b""

    def _get_entries(self, payload: bytes) -> bytes:
        meta, (signs,) = unpack_arrays(payload)
        found, vecs = self.holder.get_entries(signs, meta["width"])
        return self._pack({}, [found.astype(np.uint8), vecs])

    def _set_entries(self, payload: bytes) -> bytes:
        meta, (signs, vecs) = unpack_arrays(payload)
        with self._guarded_write(signs, meta):
            self.holder.set_entries(signs, meta["dim"],
                                    vecs.reshape(len(signs), -1))
        ver = self._bump_update_ver()
        if self.inc_dumper is not None:
            self.inc_dumper.commit(signs)
        if meta.get("wv"):
            # the versioned write-back, answered only when asked
            return _msgpack.packb({"ver": ver})
        return b""

    def _clear(self, payload: bytes) -> bytes:
        self.holder.clear()
        return b""

    # --- live resharding: the donor's and the target's surface ------------

    @contextlib.contextmanager
    def _guarded_write(self, signs: np.ndarray, meta: dict,
                       is_write: bool = True):
        """One write handler's passage: the write gate, and while a
        migration runs the capture guard (a bounce for frozen slots)."""
        if not is_write:
            yield
            return
        g = self._wgate.enter()
        rs = hit = None
        try:
            rs, hit = self._reshard_guard(signs, meta)
            yield
        finally:
            if rs is not None and hit is not None:
                rs.exit_write(hit)
            self._wgate.exit(g)

    def _maybe_expire_reshard(self):
        """Thaw a migration whose controller lease expired: capture
        dropped, slots unfrozen, the old epoch served again (bounced
        writers settle by their ``routing_stale`` retry). Checked from
        the write guard, the health doc and ``reshard_status``, so idle
        donors recover too. The fencing watermark stays."""
        rs = self._reshard
        if rs is None or not rs.lease_expired():
            return
        with self._reshard_lock:
            rs = self._reshard
            if rs is None or not rs.lease_expired():
                return
            self._reshard = None
        self._c_lease_expired.inc()
        if self._routing_epoch >= rs.epoch:
            # the epoch reached this replica already: the thaw is the
            # reshard_finish the controller did not send
            _logger.warning(
                "reshard lease expired (%.1fs without a controller "
                "heartbeat): self-finalized migration %s — epoch %d "
                "already published, capture disarmed", rs.lease_sec,
                rs.mig_id, rs.epoch)
            return
        _logger.warning(
            "reshard lease expired (%.1fs without a controller "
            "heartbeat): auto-thawed migration %s pending epoch %d — "
            "capture discarded, %d slots unfrozen, serving the old "
            "epoch again. If the controller died MID-PUBLISH (some "
            "workers already on epoch %d), resume() from its journal "
            "promptly: old-epoch writers can now land on moved slots",
            rs.lease_sec, rs.mig_id, rs.epoch, int(rs.mask.sum()),
            rs.epoch)

    def _check_fence(self, fence, renew: bool = True):
        """Order a reshard call against the fencing watermark: a lower
        token is refused (a superseded controller), a higher one advances
        it and drops the state an older attempt left. ``fence=None`` (an
        unfenced controller) passes. Returns the state (or None) with its
        lease renewed."""
        from persia_tpu_torch.reshard import FENCED_PREFIX

        if fence is None:
            rs = self._reshard
            if rs is not None and renew:
                rs.touch()
            return rs
        token = (int(fence[0]), int(fence[1]))
        with self._reshard_lock:
            if token < self._reshard_fence:
                raise RpcError(
                    f"{FENCED_PREFIX}{self._reshard_fence[0]}."
                    f"{self._reshard_fence[1]}")
            if token > self._reshard_fence:
                self._reshard_fence = token
                rs = self._reshard
                if rs is not None and rs.token is not None \
                        and rs.token < token:
                    # the newer attempt begins again from scratch
                    self._reshard = None
                    _logger.warning(
                        "reshard state of superseded attempt %s/%s "
                        "discarded by newer token %s",
                        rs.mig_id, rs.token, token)
            rs = self._reshard
        if rs is not None and renew:
            rs.touch()
        return rs

    def _reshard_guard(self, signs: np.ndarray, meta: Optional[dict] = None):
        """The write path's gate: one None test when no migration runs.
        During one, writes to moving slots are captured (bounced once
        frozen); a client's ``re`` epoch below the pending one bounces a
        frozen write before any hashing."""
        rs = self._reshard
        if rs is None:
            return None, None
        if rs.lease_expired():
            self._maybe_expire_reshard()
            rs = self._reshard
            if rs is None:
                return None, None
        if rs.frozen and meta is not None:
            ce = meta.get("re")
            if ce is not None and int(ce) < rs.epoch:
                raise RpcError(f"{STALE_PREFIX}{rs.epoch}")
        return rs, rs.enter_write(signs)

    def _reshard_begin(self, payload: bytes) -> bytes:
        """Arm capture for the moving slots, then snapshot their rows out
        of the holder's PSD stream (capture first: a write landing during
        the snapshot replays later, so the copy never misses it). The
        snapshot streams through a temporary dump, so the donor holds
        only the moving rows in memory. Returns the snapshot's row
        count."""
        from persia_tpu_torch.ps.store import (
            iter_psd_records,
            read_psd_header,
        )

        req = _msgpack.unpackb(payload)
        if faults._active:
            faults.fire("ps.reshard.begin", epoch=req.get("epoch"),
                        mig_id=req.get("mig_id"))
        self._maybe_expire_reshard()
        fence = req.get("fence")
        self._check_fence(fence, renew=False)
        rs = _ReshardState(req["slots"], req["num_slots"], req["epoch"],
                           mig_id=req.get("mig_id"), token=fence,
                           lease_sec=req.get("lease_sec"))
        with self._reshard_lock:
            cur = self._reshard
            if cur is not None:
                if (fence is not None and cur.token is not None
                        and tuple(cur.token) <= (int(fence[0]),
                                                 int(fence[1]))):
                    # the same (or a newer) attempt arms again from
                    # scratch: its old capture set re-snapshots below
                    _logger.warning(
                        "reshard_begin: re-arming over attempt %s/%s "
                        "with token %s", cur.mig_id, cur.token, fence)
                else:
                    raise RuntimeError(
                        "a slot migration is already in flight on this "
                        "replica")
            self._reshard = rs
            # writes already past the (then absent) capture guard apply
            # before the snapshot reads the store
            self._wgate.drain_prior()
        pending: List = []

        def flush_pending():
            if not pending:
                return
            signs = np.array([r[0] for r in pending], np.uint64)
            slot = (farmhash64_np(signs)
                    % np.uint64(rs.num_slots)).astype(np.int64)
            keep = rs.mask[slot]
            rs.snapshot_rows.extend(
                r for r, k in zip(pending, keep) if k)
            pending.clear()

        fd, path = tempfile.mkstemp(prefix="persia_reshard_snap_")
        os.close(fd)
        try:
            self.holder.dump_file(path)
            with open(path, "rb") as fh:
                version, count = read_psd_header(fh, "<reshard-snapshot>")
                for rec in iter_psd_records(fh.read, version, count):
                    pending.append(rec)
                    if len(pending) >= 65536:
                        flush_pending()
                flush_pending()
        finally:
            os.unlink(path)
        _logger.info("reshard_begin: %d slots, %d snapshot rows, "
                     "epoch %d pending", int(rs.mask.sum()),
                     len(rs.snapshot_rows), rs.epoch)
        return _msgpack.packb({"rows": len(rs.snapshot_rows)})

    def _reshard_extract(self, payload: bytes) -> bytes:
        from persia_tpu_torch.reshard import pack_rows

        req = _msgpack.unpackb(payload)
        if faults._active:
            faults.fire("ps.reshard.extract",
                        max_rows=req.get("max_rows"))
        rs = self._check_fence(req.get("fence"))
        if rs is None:
            raise RuntimeError("no migration in flight")
        a = rs.extract_pos
        b = min(a + int(req.get("max_rows") or 65536),
                len(rs.snapshot_rows))
        rs.extract_pos = b
        chunk = pack_rows(rs.snapshot_rows[a:b])
        done = b >= len(rs.snapshot_rows)
        if done:
            rs.snapshot_rows = []  # freed: capture carries the rest
            rs.extract_pos = 0
        return self._pack({"done": done},
                          [np.frombuffer(chunk, np.uint8)])

    def _reshard_install(self, payload: bytes) -> bytes:
        """Install a migrated chunk on the target: one ``set_entries`` a
        (dim, row width), versioned and committed to the incremental-
        update log as any full-row write, so a target that crashes later
        rebuilds its migrated rows from the replay stream."""
        from persia_tpu_torch.reshard import unpack_row_runs

        meta, (blob,) = unpack_arrays(payload)
        if faults._active:
            faults.fire("ps.reshard.install", nbytes=len(blob),
                        mig_id=meta.get("mig_id"))
        # an install from a superseded controller must not overwrite rows
        # the live attempt installed; the live attempt's repeats are
        # idempotent full-row writes
        self._check_fence(meta.get("fence"), renew=False)
        by_shape: dict = {}
        for signs, dim, mat in unpack_row_runs(blob):
            by_shape.setdefault((dim, mat.shape[1]), []).append(
                (signs, mat))
        n = 0
        for (dim, _width), runs in by_shape.items():
            signs = (runs[0][0] if len(runs) == 1
                     else np.concatenate([s for s, _m in runs]))
            vecs = (runs[0][1] if len(runs) == 1
                    else np.concatenate([m for _s, m in runs]))
            self.holder.set_entries(signs, dim, vecs)
            self._bump_update_ver()
            if self.inc_dumper is not None:
                self.inc_dumper.commit(signs)
            n += len(signs)
        return _msgpack.packb({"installed": n})

    def _reshard_drain(self, payload: bytes) -> bytes:
        """The captured writes' current rows (a sign captured N times
        ships once, with its latest value and state). Frozen, the read is
        definitive: the cutover's final drain."""
        from persia_tpu_torch.reshard import pack_rows

        req = _msgpack.unpackb(payload) if payload else {}
        if faults._active:
            faults.fire("ps.reshard.drain",
                        frozen=bool(self._reshard
                                    and self._reshard.frozen))
        rs = self._check_fence(req.get("fence"))
        if rs is None:
            raise RuntimeError("no migration in flight")
        rows = []
        for sign in rs.drain_captured():
            entry = self.holder.get_entry(sign)
            if entry is not None:
                rows.append((sign, entry[0], entry[1]))
        chunk = pack_rows(rows)
        return self._pack({"rows": len(rows)},
                          [np.frombuffer(chunk, np.uint8)])

    def _reshard_freeze(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        if faults._active:
            faults.fire("ps.reshard.freeze", epoch=req.get("epoch"))
        rs = self._check_fence(req.get("fence"))
        if rs is None:
            raise RuntimeError("no migration in flight")
        if req.get("epoch") is not None:
            rs.epoch = int(req["epoch"])
        rs.freeze()
        _logger.info("reshard_freeze: moving slots write-frozen pending "
                     "epoch %d", rs.epoch)
        return b""

    def _reshard_finish(self, payload: bytes) -> bytes:
        """Disarm capture (the cutover published, the double-read window
        closed). The moved rows stay and age out as cold rows: the new
        table never routes to them. Idempotent (``was_active: False`` when
        nothing was armed) and fenced."""
        req = _msgpack.unpackb(payload) if payload else {}
        if faults._active:
            faults.fire("ps.reshard.finish", mig_id=req.get("mig_id"))
        self._check_fence(req.get("fence"), renew=False)
        with self._reshard_lock:
            rs, self._reshard = self._reshard, None
        return _msgpack.packb(
            {"was_active": rs is not None,
             "captured_total": rs.captured_total if rs else 0,
             "mig_id": rs.mig_id if rs else None})

    def _reshard_status(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload) if payload else {}
        self._maybe_expire_reshard()
        # a fenced status is the controller's heartbeat (renews the
        # lease); an unfenced one only reads
        rs = (self._check_fence(req["fence"]) if req.get("fence")
              else self._reshard)
        doc = {"active": rs is not None,
               "routing_epoch": self._routing_epoch,
               "fence": list(self._reshard_fence)}
        if rs is not None:
            doc.update(rs.doc(with_token=True))
        return _msgpack.packb(doc)

    def _set_routing_epoch(self, payload: bytes) -> bytes:
        self._routing_epoch = int(_msgpack.unpackb(payload)["epoch"])
        return b""

    # --- model manager: dump, load, restore ------------------------------

    def _set_status(self, status: str):
        with self._status_lock:
            self.status = status

    def _managed(self, req: dict, status: str, fn) -> bytes:
        """Run ``fn`` under ``status`` (in the background when the request
        says ``blocking: False``); a failure is kept in the status."""
        self._set_status(status)

        def run():
            try:
                fn()
                self._set_status("Idle")
            except Exception as e:  # noqa: BLE001 — kept for status polls
                _logger.error("%s failed: %s", status.lower(), e)
                self._set_status(f"Failed: {e}")

        if req.get("blocking", True):
            run()
        else:
            threading.Thread(target=run, daemon=True).start()
        return b""

    def _dump(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        return self._managed(req, "Dumping",
                             lambda: self.holder.dump_file(req["path"]))

    def _load(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        return self._managed(req, "Loading", lambda: self.holder.load_file(
            req["path"], clear=req.get("clear", True)))

    def restore(self, checkpoint_path: Optional[str] = None,
                replay_inc_dir: Optional[str] = None,
                replica_index: Optional[int] = None,
                routing=None) -> int:
        """Boot restore after a crash: load this replica's checkpoint
        shard, then replay the incremental-update packets under
        ``replay_inc_dir`` over it (``replica_index``'s own files, or with
        ``routing`` every file's rows the table routes to
        ``replica_index``), which together hold every row the training
        tier recorded. The status machine rides along: ``Loading``
        (``/healthz?ready=1`` answers 503) until it completes. With
        ``routing`` the checkpoint, sharded by an older table, loads only
        the rows the table routes here. Returns the replayed entries."""
        from persia_tpu_torch.inc_update import (
            IncrementalUpdateLoader,
            load_owned_rows,
        )

        self._set_status("Loading")
        replayed = 0
        try:
            if checkpoint_path and routing is not None:
                kept = load_owned_rows(self.holder, checkpoint_path,
                                       replica_index, routing)
                _logger.info("restored checkpoint %s (%d rows kept under "
                             "the live routing table)", checkpoint_path,
                             kept)
            elif checkpoint_path:
                self.holder.load_file(checkpoint_path)
                _logger.info("restored checkpoint %s (%d entries)",
                             checkpoint_path, len(self.holder))
            if replay_inc_dir:
                replayed = IncrementalUpdateLoader(
                    self.holder, replay_inc_dir,
                    replica_index=replica_index,
                    routing=routing).scan_once()
                _logger.info("replayed %d incremental entries from %s",
                             replayed, replay_inc_dir)
            self._set_status("Idle")
        except BaseException as e:
            _logger.error("restore failed: %s", e)
            self._set_status(f"Failed: {e}")
            raise
        return replayed

    def _status(self, payload: bytes) -> bytes:
        with self._status_lock:
            return _msgpack.packb({"status": self.status})

    def _ready(self, payload: bytes) -> bytes:
        return _msgpack.packb({"ready": bool(self._is_ready())})


class PsClient:
    """The holder interface over RPC.

    A connection negotiates tagged framing, so :meth:`lookup_future` /
    :meth:`update_gradients_future` multiplex on one socket and a
    dispatch-pool server answers them out of order; a legacy server
    negotiates down and the futures resolve synchronously.

    Every call passes through a per-replica circuit breaker (on unless
    ``PERSIA_PS_CIRCUIT_BREAKER=0`` or ``circuit_breaker=False``): after
    :attr:`CB_THRESHOLD` calls in a row that exhausted the transport's
    retries, calls fail fast with
    :class:`~persia_tpu_torch.rpc.RpcCircuitOpen` (a ``ConnectionError``)
    while a background TCP probe watches the address; the first accept
    arms one trial call whose success closes the breaker again.

    ``wire_codec`` (default ``PERSIA_PS_WIRE_CODEC``): ``fp16`` asks for
    fp16 lookup rows, ``fp16+int8`` also ships gradients as int8 rows and
    per-row scales, the fp32 residual kept here for the signs' next
    shipment (:class:`~persia_tpu_torch.worker.middleware.GradErrorFeedback`).
    The codec is negotiated per connection; off, the wire is the legacy
    fp32 one. ``hotness`` (default ``PERSIA_HOTNESS``) asks every lookup
    for the replica's update version and echoes it on the next update.
    ``routing_wire`` (default ``PERSIA_ROUTING_WIRE``) probes the
    ``__routing__`` rider at dial and stamps this client's routing epoch
    (``re``) on lookups and updates, so a resharding replica bounces a
    stale-epoch write before hashing it; off, no probe and no rider.
    ``deadline`` is the transport's default deadline a call.
    ``enable_tags=False`` keeps the connection on untagged framing, and
    ``legacy_frames`` packs requests in the concatenating frames, the
    server's ``PERSIA_PS_LEGACY_FRAMES`` lever on the client side.

    The ``reshard_*`` calls (:mod:`persia_tpu_torch.reshard` drives them)
    take an optional fencing token ``(epoch, attempt)``, and carry the
    ``PERSIA_RESHARD_RPC_TIMEOUT_SEC`` deadline once
    :meth:`enable_reshard_deadline` armed the connection."""

    CB_THRESHOLD = 3
    CB_COOLDOWN = 1.0

    # policy -> (fp16 lookups, int8 updates)
    _WIRE_CODECS = {
        "": (False, False), "0": (False, False), "off": (False, False),
        "fp32": (False, False),
        "fp16": (True, False),
        "int8": (False, True),
        "fp16+int8": (True, True), "full": (True, True),
    }

    @classmethod
    def parse_wire_codec(cls, value) -> tuple:
        """Strict policy parse -> (fp16 lookups, int8 updates); an
        unknown policy raises."""
        try:
            return cls._WIRE_CODECS[str(value).lower()]
        except KeyError:
            raise ValueError(
                f"unknown wire codec {value!r} (expected one of "
                f"{sorted(cls._WIRE_CODECS)})") from None

    def __init__(self, addr: str, enable_tags: bool = True,
                 legacy_frames: bool = False, circuit_breaker=None,
                 wire_codec: Optional[str] = None,
                 hotness: Optional[bool] = None,
                 routing_wire: Optional[bool] = None,
                 deadline: Optional[float] = None):
        from persia_tpu_torch.worker.middleware import GradErrorFeedback

        self.addr = addr
        if routing_wire is None:
            routing_wire = knobs.get("PERSIA_ROUTING_WIRE")
        self.routing_wire = bool(routing_wire)
        self.routing_epoch: Optional[int] = None
        self._reshard_rpc_deadline: Optional[float] = None
        if hotness is None:
            hotness = knobs.get("PERSIA_HOTNESS")
        self.telemetry = bool(hotness)
        self._last_hver: Optional[int] = None
        # the update version the last versioned write-back became
        self.last_writeback_ver: Optional[int] = None
        if wire_codec is None:
            wire_codec = knobs.get("PERSIA_PS_WIRE_CODEC")
        self.wire_fp16, self.wire_int8 = self.parse_wire_codec(wire_codec)
        self.client = RpcClient(addr, enable_tags=enable_tags,
                                deadline=deadline,
                                enable_codec=self.wire_fp16 or self.wire_int8,
                                enable_routing=self.routing_wire)
        self._ef = GradErrorFeedback() if self.wire_int8 else None
        self._pack = pack_arrays if legacy_frames else pack_arrays_sg
        if circuit_breaker is None:
            circuit_breaker = knobs.get("PERSIA_PS_CIRCUIT_BREAKER")
        if circuit_breaker is True:
            circuit_breaker = CircuitBreaker(
                threshold=self.CB_THRESHOLD, cooldown=self.CB_COOLDOWN,
                probe=tcp_probe(addr))
        elif circuit_breaker is False:
            circuit_breaker = None
        self.breaker: Optional[CircuitBreaker] = circuit_breaker

    # --- the breaker ------------------------------------------------------

    def _check_open(self):
        br = self.breaker
        if br is not None and not br.allow():
            raise RpcCircuitOpen(
                f"{self.addr}: circuit open (failing fast after "
                f"{br.threshold} consecutive transport failures)")

    def _settle(self, fn):
        """One call's outcome on the breaker: a transport loss trips it;
        an application error means the replica answered, which counts as
        a success (and releases the half-open trial slot)."""
        br = self.breaker
        try:
            out = fn()
        except (ConnectionError, OSError):
            if br is not None:
                br.record_failure()
            raise
        except BaseException:
            if br is not None:
                br.record_success()
            raise
        if br is not None:
            br.record_success()
        return out

    def _guarded(self, fn):
        self._check_open()
        return self._settle(fn)

    # --- control plane ----------------------------------------------------

    def configure(self, init_method, init_params, admit_probability=1.0,
                  weight_bound=10.0, enable_weight_bound=True):
        self._guarded(lambda: self.client.call_msg(
            "configure", init_method=init_method, init_params=init_params,
            admit_probability=admit_probability, weight_bound=weight_bound,
            enable_weight_bound=enable_weight_bound))

    def register_optimizer(self, config: dict, feature_index_prefix_bit=0):
        self._guarded(lambda: self.client.call_msg(
            "register_optimizer", config=config,
            feature_index_prefix_bit=feature_index_prefix_bit))

    # --- lookups and updates ----------------------------------------------

    def _lookup_meta(self, dim: int, training: bool) -> dict:
        meta = {"dim": int(dim), "training": bool(training)}
        if self.wire_fp16 and self.client.codec_active():
            meta["resp"] = "fp16"
        if self.telemetry:
            meta["hv"] = 1
        return self._with_epoch(meta)

    def _with_epoch(self, meta: dict) -> dict:
        """``meta`` with this client's routing epoch, when the rider is
        armed and the replica acked it."""
        if (self.routing_wire and self.routing_epoch is not None
                and self.client.routing_active()):
            meta["re"] = int(self.routing_epoch)
        return meta

    def _decode_rows(self, payload, n: int, dim: int) -> np.ndarray:
        """A lookup reply decoded by what it says it is: a legacy server
        ignores the fp16 ask and answers fp32."""
        meta, (out,) = unpack_arrays(payload)
        hv = meta.get("hver")
        if hv is not None:
            self._last_hver = int(hv)
        if meta.get("codec") == "fp16":
            out = wire_codec.decode_fp16_rows(out)
        return out.reshape(n, dim)

    def _update_payload(self, signs: np.ndarray, grads: np.ndarray,
                        dim: int):
        signs = np.ascontiguousarray(signs, np.uint64)
        grads = np.ascontiguousarray(grads, np.float32)
        meta = {"dim": int(dim)}
        if self.telemetry and self._last_hver is not None:
            meta["hver"] = self._last_hver
        self._with_epoch(meta)
        if self.wire_int8 and self.client.codec_active():
            # error feedback: this shipment takes the signs' stored
            # residuals, and leaves its own for their next one (on a
            # copy: the caller's buffer stays as it was)
            g = grads.copy()
            self._ef.apply(signs, g, dim)
            q, scales, residual = wire_codec.quantize_int8_rows(g)
            self._ef.store(signs, residual, dim)
            return self._pack({**meta, "codec": "int8"}, [signs, q, scales])
        return self._pack(meta, [signs, grads])

    def lookup(self, signs: np.ndarray, dim: int,
               training: bool) -> np.ndarray:
        self._check_open()
        payload = self._pack(self._lookup_meta(dim, training),
                             [np.ascontiguousarray(signs, np.uint64)])
        return self._decode_rows(
            self._settle(lambda: self.client.call("lookup", payload)),
            len(signs), dim)

    def lookup_future(self, signs: np.ndarray, dim: int, training: bool):
        """Issue the lookup without waiting; returns a resolver of no
        arguments giving the (n, dim) rows. Lookups in flight multiplex on
        this thread's connection. The breaker gates the issue and settles
        on the resolver's outcome."""
        self._check_open()
        n = len(signs)
        payload = self._pack(self._lookup_meta(dim, training),
                             [np.ascontiguousarray(signs, np.uint64)])
        fut = self._settle(lambda: self.client.call_future("lookup",
                                                           payload))
        return lambda: self._decode_rows(self._settle(fut.result), n, dim)

    def update_gradients(self, signs: np.ndarray, grads: np.ndarray,
                         dim: int):
        self._check_open()
        payload = self._update_payload(signs, grads, dim)
        # not idempotent: the dedup id applies a retry at most once
        self._settle(lambda: self.client.call("update_gradients", payload,
                                              dedup=True))

    def update_gradients_future(self, signs: np.ndarray, grads: np.ndarray,
                                dim: int):
        """Issue the gradient push without waiting; returns a resolver
        that raises on failure."""
        self._check_open()
        payload = self._update_payload(signs, grads, dim)
        fut = self._settle(lambda: self.client.call_future(
            "update_gradients", payload, dedup=True))
        return lambda: self._settle(fut.result)

    # --- rows, state, health ----------------------------------------------

    def health(self) -> dict:
        return _msgpack.unpackb(
            self._guarded(lambda: self.client.call("health")))

    def hotness(self) -> dict:
        return _msgpack.unpackb(
            self._guarded(lambda: self.client.call("hotness")))

    def wire_stats(self) -> dict:
        """Payload bytes this client sent and received."""
        return self.client.wire_stats()

    def __len__(self) -> int:
        return _msgpack.unpackb(
            self._guarded(lambda: self.client.call("len")))["len"]

    def get_entry(self, sign: int):
        payload = _msgpack.packb({"sign": int(sign)})
        meta, arrays = unpack_arrays(
            self._guarded(lambda: self.client.call("get_entry", payload)))
        if not meta["found"]:
            return None
        return meta["dim"], arrays[0]

    def set_entry(self, sign: int, dim: int, vec: np.ndarray):
        self._guarded(lambda: self.client.call("set_entry", pack_arrays(
            {"sign": int(sign), "dim": int(dim)},
            [np.ascontiguousarray(vec, np.float32)])))

    def get_entries(self, signs: np.ndarray, width: int):
        payload = self._pack({"width": int(width)},
                             [np.ascontiguousarray(signs, np.uint64)])
        _, (found, vecs) = unpack_arrays(
            self._guarded(lambda: self.client.call("get_entries", payload)))
        return (found.astype(bool),
                vecs.reshape(len(signs), width).astype(np.float32))

    def set_entries(self, signs: np.ndarray, dim: int, vecs: np.ndarray):
        meta = {"dim": int(dim)}
        if self.telemetry:
            meta["wv"] = 1
        resp = self._guarded(lambda: self.client.call(
            "set_entries", self._pack(meta, [
                np.ascontiguousarray(signs, np.uint64),
                np.ascontiguousarray(vecs, np.float32)]), dedup=True))
        if meta.get("wv") and resp:
            ver = _msgpack.unpackb(resp).get("ver")
            if ver is not None:
                self.last_writeback_ver = int(ver)

    def clear(self):
        self._guarded(lambda: self.client.call("clear"))

    # --- the live-resharding surface ---------------------------------------

    def enable_reshard_deadline(self):
        """Arm ``PERSIA_RESHARD_RPC_TIMEOUT_SEC`` (0 = off) on this
        client's reshard calls: they carry the negotiated ``__deadline__``
        slot, so a wedged replica sheds an expired call. The connection
        is dialed again with the probe. The controller arms it when a
        migration starts, so a fleet that never reshards never sends it."""
        timeout = float(knobs.get("PERSIA_RESHARD_RPC_TIMEOUT_SEC"))
        if timeout <= 0:
            return
        self._reshard_rpc_deadline = timeout
        if not self.client.enable_deadline:
            self.client.enable_deadline = True
            self.client.renegotiate()

    def _reshard_call(self, method: str, payload: bytes = b"",
                      dedup: bool = False) -> bytes:
        dl = self._reshard_rpc_deadline
        kw = {"deadline": dl} if dl else {}
        return self._guarded(lambda: self.client.call(method, payload,
                                                      dedup=dedup, **kw))

    @staticmethod
    def _fenced(req: dict, fence, **extra) -> dict:
        if fence is not None:
            req.update(fence=[int(fence[0]), int(fence[1])], **extra)
        return req

    def reshard_begin(self, slots, num_slots: int, epoch: int,
                      fence=None, mig_id: Optional[str] = None,
                      lease_sec: Optional[float] = None) -> int:
        """Donor: arm write capture for ``slots`` and snapshot their
        rows; returns the snapshot's row count. A fenced begin with the
        same (or a newer) token arms again from scratch."""
        req = self._fenced({"slots": [int(s) for s in slots],
                            "num_slots": int(num_slots),
                            "epoch": int(epoch)}, fence, mig_id=mig_id)
        if lease_sec is not None:
            req["lease_sec"] = float(lease_sec)
        return int(_msgpack.unpackb(self._reshard_call(
            "reshard_begin", _msgpack.packb(req)))["rows"])

    def reshard_extract(self, max_rows: int, fence=None):
        """Donor: the next snapshot chunk, as ``(row_blob, done)``."""
        req = self._fenced({"max_rows": int(max_rows)}, fence)
        meta, (blob,) = unpack_arrays(self._reshard_call(
            "reshard_extract", _msgpack.packb(req)))
        return bytes(blob), bool(meta["done"])

    def reshard_install(self, row_blob: bytes, fence=None,
                        mig_id: Optional[str] = None) -> int:
        """Target: install a chunk (values and optimizer state); full-row
        writes, so a retry or a resumed re-copy is harmless."""
        meta = self._fenced({}, fence, mig_id=mig_id)
        return int(_msgpack.unpackb(self._reshard_call(
            "reshard_install",
            pack_arrays(meta, [np.frombuffer(row_blob, np.uint8)]),
            dedup=True))["installed"])

    def reshard_drain(self, fence=None) -> bytes:
        """Donor: the captured writes' current rows (the capture set is
        emptied)."""
        payload = (_msgpack.packb(self._fenced({}, fence))
                   if fence is not None else b"")
        _meta, (blob,) = unpack_arrays(self._reshard_call("reshard_drain",
                                                          payload))
        return bytes(blob)

    def reshard_freeze(self, epoch: Optional[int] = None, fence=None,
                       mig_id: Optional[str] = None):
        """Donor: admit no more writes to the moving slots (a bounce
        demands ``epoch``). A repeated freeze changes nothing."""
        self._reshard_call("reshard_freeze", _msgpack.packb(
            self._fenced({"epoch": epoch}, fence, mig_id=mig_id)))

    def reshard_finish(self, fence=None,
                       mig_id: Optional[str] = None) -> dict:
        payload = (_msgpack.packb(self._fenced({}, fence, mig_id=mig_id))
                   if fence is not None else b"")
        return _msgpack.unpackb(self._reshard_call("reshard_finish",
                                                   payload))

    def reshard_status(self, fence=None) -> dict:
        """The migration's state; fenced, it is also the controller's
        lease heartbeat."""
        payload = (_msgpack.packb(self._fenced({}, fence))
                   if fence is not None else b"")
        return _msgpack.unpackb(self._reshard_call("reshard_status",
                                                   payload))

    def set_routing_epoch(self, epoch: int):
        """Record the published routing epoch on the replica (its health
        doc and ``__routing__`` ack) and stamp it on this client's rider-
        armed requests."""
        self.routing_epoch = int(epoch)
        self._guarded(lambda: self.client.call_msg(
            "set_routing_epoch", epoch=int(epoch)))

    def dump_file(self, path: str, blocking: bool = True):
        self._guarded(lambda: self.client.call_msg(
            "dump", path=path, blocking=blocking))

    def load_file(self, path: str, clear: bool = True,
                  blocking: bool = True):
        self._guarded(lambda: self.client.call_msg(
            "load", path=path, clear=clear, blocking=blocking))

    def model_manager_status(self) -> str:
        return _msgpack.unpackb(
            self._guarded(lambda: self.client.call("status")))["status"]

    def ready_for_serving(self) -> bool:
        return _msgpack.unpackb(self._guarded(
            lambda: self.client.call("ready_for_serving")))["ready"]

    def shutdown(self):
        self.client.shutdown_server()


def _holder_for(gc, args):
    """The replica's holder for the global config and the flags; a
    storage policy the native library cannot serve raises."""
    from persia_tpu_torch.ps.native import (
        make_holder,
        native_capabilities,
        required_capabilities,
    )

    ps = gc.parameter_server
    # replicas share one spill_dir; each keeps its packets in its own
    # subdirectory
    spill_dir = args.spill_dir or ps.spill_dir or None
    if spill_dir:
        spill_dir = os.path.join(spill_dir, f"r{args.replica_index}")
    row_dtype = args.row_dtype or ps.row_dtype
    capacity_bytes = ps.capacity_bytes or None
    missing = required_capabilities(row_dtype, capacity_bytes,
                                    spill_dir) - native_capabilities()
    if missing:
        raise RuntimeError(f"the native PS library lacks {sorted(missing)} "
                           f"for row_dtype={row_dtype!r}, capacity_bytes="
                           f"{capacity_bytes}, spill_dir={spill_dir!r}")
    return make_holder(ps.capacity, ps.num_hashmap_internal_shards,
                       row_dtype=row_dtype, capacity_bytes=capacity_bytes,
                       spill_dir=spill_dir,
                       spill_bytes=args.spill_bytes or ps.spill_bytes or None)


def _inc_tier(gc, holder, replica_index: int):
    """``(inc_dumper, inc_loader)`` under
    ``parameter_server.enable_incremental_update``: an infer job's replica
    hot-loads the packets on a scanner thread, any other dumps them."""
    from persia_tpu_torch.config import JobType
    from persia_tpu_torch.inc_update import (
        IncrementalUpdateDumper,
        IncrementalUpdateLoader,
    )

    ps = gc.parameter_server
    if not ps.enable_incremental_update:
        return None, None
    if gc.common.job_type == JobType.INFER:
        loader = IncrementalUpdateLoader(holder, ps.incremental_dir)
        loader.start()
        return None, loader
    return IncrementalUpdateDumper(
        holder, ps.incremental_dir,
        buffer_size=ps.incremental_buffer_size,
        replica_index=replica_index), None


def main():
    from persia_tpu_torch.config import GlobalConfig
    from persia_tpu_torch.utils import write_addr_file

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--replica-index", type=int,
                   default=int(os.environ.get("REPLICA_INDEX", 0)))
    p.add_argument("--replica-size", type=int,
                   default=int(os.environ.get("REPLICA_SIZE", 1)))
    p.add_argument("--coordinator",
                   default=knobs.get_raw("PERSIA_COORDINATOR_ADDR"))
    p.add_argument("--global-config", default=None)
    p.add_argument("--initial-checkpoint", default=None)
    p.add_argument("--replay-inc-dir", default=None,
                   help="replay this replica's incremental-update packets "
                        "after --initial-checkpoint")
    p.add_argument("--addr-file", default=None,
                   help="write the bound address here after listen")
    p.add_argument("--row-dtype", default=knobs.get("PERSIA_PS_ROW_DTYPE"),
                   choices=["fp32", "fp16", "bf16"],
                   help="storage precision of the rows' embedding slice; "
                        "overrides parameter_server.row_dtype")
    p.add_argument("--spill-dir", default=knobs.get("PERSIA_TIER_SPILL_DIR"),
                   help="arm the disk spill tier under <dir>/r<replica>; "
                        "overrides parameter_server.spill_dir")
    p.add_argument("--spill-bytes", type=int,
                   default=knobs.get("PERSIA_TIER_SPILL_BYTES"),
                   help="the spill tier's disk budget (0 = unbounded)")
    obs_http.add_http_args(p)
    p.add_argument("--concurrent-streams", type=int,
                   default=knobs.get("PERSIA_PS_CONCURRENT_STREAMS"),
                   help="per-connection dispatch pool depth (1 = serial)")
    args = p.parse_args()
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO").upper())
    tracing.start_deadlock_detection()
    tracing.set_service_name(f"ps{args.replica_index}")
    gc = (GlobalConfig.load(args.global_config) if args.global_config
          else GlobalConfig())
    if knobs.get("PERSIA_PS_GC_TUNE"):
        # freeze the boot state and make full collections rare: a store's
        # Python objects would otherwise make gen2 walks request stalls
        import gc as gcmod

        gcmod.collect()
        gcmod.freeze()
        gcmod.set_threshold(50_000, 25, 100)
    holder = _holder_for(gc, args)
    inc_dumper, inc_loader = _inc_tier(gc, holder, args.replica_index)
    service = PsService(
        holder, args.host, args.port,
        concurrent_streams=args.concurrent_streams,
        legacy_frames=knobs.get("PERSIA_PS_LEGACY_FRAMES"),
        http_port=obs_http.port_from_args(args), inc_dumper=inc_dumper,
        inc_loader=inc_loader)
    if args.initial_checkpoint or args.replay_inc_dir:
        # before registering: workers never route to a half-restored
        # replica
        service.restore(args.initial_checkpoint, args.replay_inc_dir,
                        replica_index=args.replica_index)
    _logger.info("parameter server %d/%d listening on %s (sidecar %s)",
                 args.replica_index, args.replica_size, service.addr,
                 service.http.addr if service.http else "off")
    if args.addr_file:
        write_addr_file(service.addr, args.addr_file)
    obs_http.write_addr_file_from_args(service.http, args)
    if args.coordinator:
        CoordinatorClient(args.coordinator).register(
            ROLE_PS, args.replica_index, service.addr,
            http_addr=service.http.addr if service.http else None)
    service.server.serve_forever()


if __name__ == "__main__":
    main()
