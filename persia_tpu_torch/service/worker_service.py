"""Embedding-worker service and the remote worker client
(``persia_tpu/service/worker_service.py``).

:class:`WorkerService` serves one worker replica: an
:class:`~persia_tpu_torch.worker.worker.EmbeddingWorker` whose PS clients
are :class:`~persia_tpu_torch.service.ps_service.PsClient` stubs found
through the coordinator. :class:`RemoteEmbeddingWorker` is the trainer's
and the data loader's side: the in-process worker's interface over one or
more replicas, whose refs are ``(worker address, ref id)`` pairs, so a
lookup and its gradients reach the replica that holds the batch. The
requests and replies are the JAX package's bytes.

The reshard controller publishes a successor routing table to a worker
fleet through :meth:`RemoteEmbeddingWorker.apply_routing` (a partial
broadcast raises :class:`PartialPublishError`), and each replica's
``apply_routing`` handler dials only the PS addresses it does not hold
yet. A replica that found its PS through the coordinator also pulls
published tables from the coordinator's KV when a write bounces
(``routing_fetch``); its health doc carries its ``routing_epoch``.

Run: ``python -m persia_tpu_torch.service.worker_service --replica-index 0
--replica-size 1 --coordinator host:port --embedding-config schema.yml``
"""

import argparse
import itertools
import logging
import os
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from persia_tpu_torch import _msgpack, knobs, obs_http, tracing, wire_codec
from persia_tpu_torch.rpc import (
    RpcClient,
    RpcServer,
    pack_arrays,
    pack_arrays_sg,
    unpack_arrays,
)
from persia_tpu_torch.service import serialization as ser
from persia_tpu_torch.service.coordinator import (
    ROLE_PS,
    ROLE_WORKER,
    CoordinatorClient,
)
from persia_tpu_torch.service.ps_service import PsClient

_logger = logging.getLogger(__name__)

def _ps_ready(worker) -> bool:
    """Whether every PS replica of ``worker`` is serving."""
    try:
        return all(c.ready_for_serving() for c in worker.ps_clients
                   if hasattr(c, "ready_for_serving"))
    except (ConnectionError, OSError):
        return False


class WorkerService:
    CONCURRENT_STREAMS = 8

    def __init__(self, worker, host: str = "127.0.0.1", port: int = 0,
                 concurrent_streams: int = CONCURRENT_STREAMS,
                 http_port: Optional[int] = None):
        self.worker = worker
        # a pipelining client's tagged requests complete out of order, so
        # one slow lookup does not hold back the next batch's ingestion
        self.server = RpcServer(host, port,
                                concurrent_streams=concurrent_streams)
        # readiness is a call to every PS replica: cached for probes
        self._ready_lock = threading.Lock()
        self._ready_cache = (0.0, True)
        # gradient shipments by trainer process label ("" for a trainer
        # that sends none): each member of a trainer group's share
        self._ship_lock = threading.Lock()
        self._ship_counts: Dict[str, int] = {}
        self.http = obs_http.maybe_start(host, http_port, self._health)
        for name, fn in (
                ("forward_batched", self._forward_batched),
                ("forward_batch_id", self._forward_batch_id),
                ("forward_batched_direct", self._forward_batched_direct),
                ("lookup_signs", self._lookup_signs),
                ("update_gradients", self._update_gradients),
                ("configure", self._configure),
                ("register_optimizer", self._register_optimizer),
                ("dump", self._dump), ("load", self._load),
                ("staleness", self._staleness), ("ready", self._ready),
                ("apply_routing", self._apply_routing),
                ("close_routing_window", self._close_routing_window)):
            self.server.register(name, fn)

    @property
    def addr(self):
        return self.server.addr

    def stop(self):
        self.server.stop()
        if self.http is not None:
            self.http.stop()

    READY_CACHE_SEC = 2.0

    def _ready_cached(self) -> bool:
        now = time.monotonic()
        with self._ready_lock:
            t, val = self._ready_cache
            if now - t < self.READY_CACHE_SEC:
                return val
        ready = _ps_ready(self.worker)
        with self._ready_lock:
            self._ready_cache = (time.monotonic(), ready)
        return ready

    def _health(self) -> dict:
        """The buffer depths and the staleness: a stuck pipeline shows as
        staleness pegged at its bound or a forward buffer that climbs."""
        doc = self.server.health()
        w = self.worker
        with w._lock:
            doc["forward_buffer_depth"] = len(w._forward_id_buffer)
            doc["post_forward_buffer_depth"] = len(w._post_forward_buffer)
            doc["staleness"] = w.staleness
        doc["ps_replicas"] = w.replica_size
        # the epoch this worker splits by (a fleet compares them)
        doc["routing_epoch"] = w.routing_epoch
        doc["ready"] = self._ready_cached()
        with self._ship_lock:
            if self._ship_counts:
                doc["ship_counts"] = dict(self._ship_counts)
        return doc

    def _forward_batched(self, payload: bytes) -> bytes:
        _, feats = ser.unpack_id_features(payload)
        ref_id = self.worker.put_batch(feats)  # raises ForwardBufferFull
        return _msgpack.packb({"ref_id": ref_id})

    def _forward_batch_id(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        return ser.pack_lookup_result(
            self.worker.lookup(req["ref_id"], training=req["training"]))

    def _forward_batched_direct(self, payload: bytes) -> bytes:
        meta, feats = ser.unpack_id_features(payload)
        return ser.pack_lookup_result(self.worker.lookup_direct(
            feats, training=meta.get("training", False)))

    def _lookup_signs(self, payload: bytes) -> bytes:
        """The serving cache's miss fetch (read-only); fp16 rows when the
        client asks ``resp: fp16`` and the codec is on, named in the
        reply's meta."""
        meta, (signs,) = unpack_arrays(payload)
        rows = self.worker.lookup_signs(signs, meta["dim"])
        if meta.get("resp") == "fp16" and self.server._enable_codec:
            return pack_arrays_sg({"codec": "fp16"},
                                  [wire_codec.encode_fp16_rows(rows)])
        return pack_arrays_sg({}, [rows])

    def _update_gradients(self, payload: bytes) -> bytes:
        meta, grads = ser.unpack_gradients(payload)
        self.worker.update_gradients(meta["ref_id"], grads,
                                     loss_scale=meta.get("loss_scale", 1.0))
        label = str(meta.get("process", ""))
        with self._ship_lock:
            self._ship_counts[label] = self._ship_counts.get(label, 0) + 1
        return b""

    def _configure(self, payload: bytes) -> bytes:
        req = _msgpack.unpackb(payload)
        self.worker.configure_parameter_servers(
            req["init_method"], req["init_params"], req["admit_probability"],
            req["weight_bound"], req["enable_weight_bound"])
        return b""

    def _register_optimizer(self, payload: bytes) -> bytes:
        self.worker.register_optimizer(_msgpack.unpackb(payload)["config"])
        return b""

    def _dump(self, payload: bytes) -> bytes:
        self.worker.dump(_msgpack.unpackb(payload)["path"])
        return b""

    def _load(self, payload: bytes) -> bytes:
        self.worker.load(_msgpack.unpackb(payload)["path"])
        return b""

    def _staleness(self, payload: bytes) -> bytes:
        return _msgpack.packb({"staleness": self.worker.staleness})

    def _apply_routing(self, payload: bytes) -> bytes:
        from persia_tpu_torch.routing import RoutingTable

        req = _msgpack.unpackb(payload)
        table = RoutingTable.from_bytes(req["table"])
        clients = None
        if req.get("ps_addrs"):
            # keep the live client (and its connections) of every address
            # held already; the worker closes those that drop out
            held = {getattr(c, "addr", None): c
                    for c in self.worker.ps_clients}
            clients = [held.get(a) or PsClient(a)
                       for a in req["ps_addrs"]]
        applied = self.worker.apply_routing(table, ps_clients=clients)
        return _msgpack.packb({"applied": bool(applied),
                               "epoch": self.worker.routing_epoch})

    def _close_routing_window(self, payload: bytes) -> bytes:
        self.worker.close_routing_window()
        return b""

    def _ready(self, payload: bytes) -> bytes:
        """Ready iff every PS replica is serving (the trainer's recovery
        wait polls it)."""
        return _msgpack.packb({"ready": bool(_ps_ready(self.worker))})


class PartialPublishError(RuntimeError):
    """A routing-table broadcast reached only part of a worker fleet.
    ``applied_any``: whether some replica already routes by the new
    epoch (then the controller must retry the publish, not roll back)."""

    def __init__(self, applied_any: bool, failures):
        self.applied_any = bool(applied_any)
        self.failures = list(failures)
        super().__init__(
            f"routing publish failed on {len(self.failures)} worker "
            f"replica(s) (applied_any={self.applied_any}): "
            + "; ".join(f"{a}: {e!r}" for a, e in self.failures))


class RemoteEmbeddingWorker:
    """The in-process worker's interface over worker replicas. A batch is
    put on the replicas in turn; its ref is ``(address, ref id)``."""

    def __init__(self, addrs: Sequence[str]):
        if not addrs:
            raise ValueError("need at least one embedding-worker address")
        self.addrs = list(addrs)
        self._clients = {a: RpcClient(a) for a in self.addrs}
        self._rr = itertools.cycle(self.addrs)
        self._rr_lock = threading.Lock()
        # a member of a trainer group sets this ("p1") to label its
        # gradient shipments; None sends the unlabeled meta (the same
        # bytes as a lone trainer's)
        self.process_label: Optional[str] = None
        self.schema = None
        # the lowest epoch the replicas answered the last complete
        # apply_routing broadcast with (None before one): what a snapshot
        # manifest records, and what tells the reshard controller that a
        # repeated publish found the fleet at its epoch already
        self.routing_epoch: Optional[int] = None
        # the serving miss fetch follows the PS wire's codec policy
        self._fp16_rows = PsClient.parse_wire_codec(
            knobs.get("PERSIA_PS_WIRE_CODEC"))[0]

    def _next_addr(self) -> str:
        with self._rr_lock:
            return next(self._rr)

    # --- data loader and trainer ------------------------------------------

    def put_batch(self, id_type_features) -> Tuple[str, int]:
        addr = self._next_addr()
        # not idempotent: the dedup id keeps a retry from filing the
        # batch twice
        resp = self._clients[addr].call(
            "forward_batched", ser.pack_id_features(id_type_features),
            dedup=True)
        return (addr, _msgpack.unpackb(resp)["ref_id"])

    def lookup(self, ref, training: bool = True) -> Dict[str, object]:
        payload = _msgpack.packb({"ref_id": ref[1], "training": training})
        # not idempotent (it takes the batch from the forward buffer)
        return ser.unpack_lookup_result(self._clients[ref[0]].call(
            "forward_batch_id", payload, dedup=True))

    def lookup_direct(self, id_type_features, training: bool = False):
        payload = ser.pack_id_features(id_type_features,
                                       {"training": training})
        return ser.unpack_lookup_result(self._clients[self._next_addr()].call(
            "forward_batched_direct", payload))

    def lookup_signs(self, signs: np.ndarray, dim: int) -> np.ndarray:
        """The serving miss fetch: an idempotent read (no dedup id), on
        the replicas in turn; fp16 rows when the codec policy asks."""
        meta = {"dim": int(dim)}
        if self._fp16_rows:
            meta["resp"] = "fp16"
        resp = self._clients[self._next_addr()].call(
            "lookup_signs",
            pack_arrays(meta, [np.ascontiguousarray(signs, np.uint64)]))
        rmeta, (rows,) = unpack_arrays(resp)
        if rmeta.get("codec") == "fp16":
            rows = wire_codec.decode_fp16_rows(rows)
        return rows

    def lookup_direct_training(self, id_type_features):
        ref = self.put_batch(id_type_features)
        return ref, self.lookup(ref, training=True)

    def update_gradients(self, ref, grads: Dict[str, np.ndarray],
                         loss_scale: float = 1.0):
        meta = {"ref_id": ref[1], "loss_scale": loss_scale}
        if self.process_label is not None:
            meta["process"] = self.process_label
        self._clients[ref[0]].call(
            "update_gradients", ser.pack_gradients(grads, meta), dedup=True)

    # --- control plane ----------------------------------------------------

    def configure_parameter_servers(self, init_method, init_params,
                                    admit_probability, weight_bound,
                                    enable_weight_bound=True):
        for c in self._clients.values():
            c.call_msg(
                "configure", init_method=init_method,
                init_params=init_params, admit_probability=admit_probability,
                weight_bound=weight_bound,
                enable_weight_bound=enable_weight_bound)

    def register_optimizer(self, config: dict):
        for c in self._clients.values():
            c.call_msg("register_optimizer", config=config)

    @property
    def staleness(self) -> int:
        return sum(_msgpack.unpackb(c.call("staleness"))["staleness"]
                   for c in self._clients.values())

    def ready_for_serving(self) -> bool:
        """True iff every worker replica, and through them every PS, is
        serving."""
        try:
            return all(_msgpack.unpackb(c.call("ready"))["ready"]
                       for c in self._clients.values())
        except (ConnectionError, OSError):
            return False

    def wait_for_serving(self, timeout: float = 120.0):
        """Block, polling with backoff, until the service tier serves."""
        deadline = time.monotonic() + timeout
        delay = 0.1
        while not self.ready_for_serving():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"service tier not serving after {timeout}s")
            time.sleep(delay)
            delay = min(delay * 2, 2.0)

    def dump(self, path: str):
        from persia_tpu_torch.pipeline import flush_backward_engines

        # the updates in flight from this trainer land before the dump
        flush_backward_engines(self)
        # the first replica dumps every PS
        self._clients[self.addrs[0]].call_msg("dump", path=path)

    def load(self, path: str):
        self._clients[self.addrs[0]].call_msg("load", path=path)

    def apply_routing(self, table, ps_addrs=None) -> bool:
        """Broadcast a successor table (and, on a scale-out, the grown PS
        address list) to every replica: the controller's cutover publish.
        A broadcast that fails on some replica raises
        :class:`PartialPublishError`, saying whether any replica applied
        (then the donors must stay frozen, not roll back)."""
        applied = False
        failures = []
        epochs = []
        for addr in self.addrs:
            try:
                rep = self._clients[addr].call_msg(
                    "apply_routing", table=table.to_bytes(),
                    ps_addrs=list(ps_addrs) if ps_addrs else None)
            except Exception as e:  # noqa: BLE001 — reported together
                failures.append((addr, e))
                continue
            applied = applied or bool(rep.get("applied"))
            epochs.append(int(rep.get("epoch", 0)))
        if failures:
            raise PartialPublishError(applied, failures)
        self.routing_epoch = min(epochs)
        return applied

    def close_routing_window(self):
        for addr in self.addrs:
            self._clients[addr].call("close_routing_window")

    def shutdown(self):
        for c in self._clients.values():
            c.shutdown_server()

    def close(self):
        """Close every pooled connection to the replicas."""
        for c in self._clients.values():
            c.close()


def main():
    from persia_tpu_torch.config import EmbeddingSchema, GlobalConfig
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--replica-index", type=int,
                   default=int(os.environ.get("REPLICA_INDEX", 0)))
    p.add_argument("--replica-size", type=int,
                   default=int(os.environ.get("REPLICA_SIZE", 1)))
    p.add_argument("--coordinator",
                   default=knobs.get_raw("PERSIA_COORDINATOR_ADDR"))
    p.add_argument("--embedding-config", required=True,
                   help="embedding schema YAML")
    p.add_argument("--global-config", default=None)
    p.add_argument("--num-ps", type=int, default=knobs.get("PERSIA_NUM_PS"))
    p.add_argument("--ps-addrs", default=None,
                   help="comma-separated fixed PS addresses")
    p.add_argument("--enable-monitor", action="store_true",
                   default=knobs.get("PERSIA_ENABLE_MONITOR"),
                   help="estimate distinct ids per feature (HLL gauge)")
    obs_http.add_http_args(p)
    args = p.parse_args()
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO").upper())
    tracing.start_deadlock_detection()
    tracing.set_service_name(f"worker{args.replica_index}")
    schema = EmbeddingSchema.load(args.embedding_config)
    gc = (GlobalConfig.load(args.global_config) if args.global_config
          else GlobalConfig())
    ps_resolver = routing_fetch = None
    if args.ps_addrs:
        ps_addrs = args.ps_addrs.split(",")
    else:
        from persia_tpu_torch.routing import fetch_from_coordinator

        coord = CoordinatorClient(args.coordinator)
        ps_addrs = coord.wait_members(ROLE_PS, args.num_ps, timeout=120)

        def ps_resolver():
            return [PsClient(a) for a in
                    coord.wait_members(ROLE_PS, args.num_ps, timeout=120)]

        def routing_fetch():
            # the tables the reshard controller publishes to the KV: a
            # bounced write pulls the epoch when nobody pushes it
            return fetch_from_coordinator(coord)
    worker = EmbeddingWorker(
        schema, [PsClient(a) for a in ps_addrs],
        forward_buffer_size=gc.embedding_worker.forward_buffer_size,
        buffered_data_expired_sec=gc.embedding_worker
        .buffered_data_expired_sec,
        enable_monitor=args.enable_monitor,
        ps_resolver=ps_resolver, routing_fetch=routing_fetch)
    service = WorkerService(worker, args.host, args.port,
                            http_port=obs_http.port_from_args(args))
    _logger.info("embedding worker %d/%d listening on %s (%d PS, sidecar "
                 "%s)", args.replica_index, args.replica_size, service.addr,
                 len(ps_addrs), service.http.addr if service.http else "off")
    obs_http.write_addr_file_from_args(service.http, args)
    if args.coordinator:
        CoordinatorClient(args.coordinator).register(
            ROLE_WORKER, args.replica_index, service.addr,
            http_addr=service.http.addr if service.http else None)
    service.server.serve_forever()


if __name__ == "__main__":
    main()
