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

Not ported: the live-resharding surface (``reshard_*``,
``set_routing_epoch``, the ``__routing__`` rider and the write gate) is
no method here, so a ``reshard_*`` call gets the error an unknown method
gets; it waits for ROADMAP.md queue A item 9c.

Run: ``python -m persia_tpu_torch.service.ps_service --port 0
--replica-index 0 --replica-size 2 [--coordinator host:port]
[--global-config global.yml] [--initial-checkpoint replica_0.psd
--replay-inc-dir <incremental_dir>]``
"""

import argparse
import logging
import os
import threading
from typing import Optional

import numpy as np

from persia_tpu_torch import _msgpack, faults, knobs, obs_http, tracing
from persia_tpu_torch import wire_codec
from persia_tpu_torch.metrics import STEP_BUCKETS, default_registry
from persia_tpu_torch.rpc import (
    CircuitBreaker,
    RpcCircuitOpen,
    RpcClient,
    RpcServer,
    pack_arrays,
    pack_arrays_sg,
    tcp_probe,
    unpack_arrays,
)
from persia_tpu_torch.service.coordinator import ROLE_PS, CoordinatorClient

_logger = logging.getLogger(__name__)


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
                ("hotness", self._hotness_rpc)):
            s.register(name, fn)
        reg = default_registry()
        port_label = self.server.addr.rsplit(":", 1)[1]
        self._mem_gauges = [
            reg.gauge("ps_resident_bytes",
                      {"server": port_label, "shard": str(i)})
            for i in range(holder.num_internal_shards)
        ] if hasattr(holder, "resident_bytes_per_shard") else []
        self._h_staleness = reg.histogram(
            "ps_gradient_staleness_steps", {"server": port_label},
            help_text="update batches applied between a telemetry-armed "
                      "client's lookup and its gradient's apply",
            buckets=STEP_BUCKETS)
        self.http = obs_http.maybe_start(host, http_port, self._health,
                                         refresh_fn=self._refresh_gauges,
                                         hotness_fn=self._hotness_snapshot)

    @property
    def addr(self):
        return self.server.addr

    def stop(self):
        self.server.stop()
        if self.http is not None:
            self.http.stop()

    # --- observability ---------------------------------------------------

    def _refresh_gauges(self):
        if self._mem_gauges:
            for g, b in zip(self._mem_gauges,
                            self.holder.resident_bytes_per_shard()):
                g.set(b)

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
        self._refresh_gauges()
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
        with tracing.span("ps/lookup", ctx=tracing.current_context(),
                          n=len(signs), dim=meta["dim"]):
            out = self.holder.lookup(signs, meta["dim"], meta["training"])
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
    for the replica's update version and echoes it on the next update."""

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

    def __init__(self, addr: str, circuit_breaker=None,
                 wire_codec: Optional[str] = None,
                 hotness: Optional[bool] = None):
        from persia_tpu_torch.worker.middleware import GradErrorFeedback

        self.addr = addr
        if hotness is None:
            hotness = knobs.get("PERSIA_HOTNESS")
        self.telemetry = bool(hotness)
        self._last_hver: Optional[int] = None
        # the update version the last versioned write-back became
        self.last_writeback_ver: Optional[int] = None
        if wire_codec is None:
            wire_codec = knobs.get("PERSIA_PS_WIRE_CODEC")
        self.wire_fp16, self.wire_int8 = self.parse_wire_codec(wire_codec)
        self.client = RpcClient(addr,
                                enable_codec=self.wire_fp16 or self.wire_int8)
        self._ef = GradErrorFeedback() if self.wire_int8 else None
        self._pack = pack_arrays_sg
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
