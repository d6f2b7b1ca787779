"""Online inference serving (``persia_tpu/serving.py``): the predict path
over the RPC wire and in process.

:class:`InferenceServer` is an RPC server (:mod:`persia_tpu_torch.rpc`)
whose ``predict`` takes PTB2 bytes and answers ``pack_arrays({}, [pred])``
with the JAX server's bytes, so an :class:`InferenceClient` of either
package reaches a model of either package. In process, ``predict`` /
``predict_bytes`` / ``predict_many`` take the same route. Its throughput
path has the JAX package's three pieces:

- **Adaptive micro-batching** (``max_batch_rows > 0``): concurrent
  requests are coalesced by a dispatcher thread into one merged batch ->
  one embedding lookup -> one forward, and the per-request row slices are
  scattered back. The linger (``max_wait_us``) only applies when the
  recent coalescing EWMA says traffic is concurrent.
- **Shape bucketing**: merged batches are padded with empty rows up to a
  small ladder of sizes, so the forward sees a handful of shapes. Padding
  rows look nothing up and are never scattered back.
- **Cross-request sign dedup + a hot-row TTL cache** (``cache_rows >
  0``): the merged batch is preprocessed locally, distinct
  post-transform signs are served from an in-process LRU, and only the
  misses go to the worker through one deduplicated ``lookup_signs`` call
  per dim. The predict path never writes rows back; the online delta
  subscriber (:meth:`InferenceServer.attach_delta_subscriber`,
  :mod:`persia_tpu_torch.online`) upserts resident rows from the
  trainer's incremental-update packets, so a trained row is servable
  without waiting for its TTL.

Around it:

- **Multi-model variants** (:mod:`persia_tpu_torch.variants`): N dense
  models over one worker and cache, routed per request (an explicit pin,
  a route key, or ``PERSIA_VARIANT_ROUTE_FEATURE``) through the
  deterministic weighted split, with per-variant metrics and live
  add / remove / promote over the ``variant_admin`` RPC.
- **Degraded fallback** (``degraded_fallback=True``): a lookup that fails
  with a transport error (:data:`DEGRADABLE_ERRORS`) serves zero vectors
  for the signs it could not fetch instead of failing the request.
- **Observability**: counters and histograms in the metrics registry
  under the JAX server's names and labels, a ``stats`` RPC, and with
  ``http_port`` the sidecar (:mod:`persia_tpu_torch.obs_http`).

The embedding tier is an in-process worker or, with ``worker_addrs``,
a :class:`~persia_tpu_torch.service.worker_service.RemoteEmbeddingWorker`.
"""

import itertools
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from persia_tpu_torch import _msgpack
from persia_tpu_torch import checkpoint as ckpt
from persia_tpu_torch import knobs, obs_http, tracing
from persia_tpu_torch.config import EmbeddingSchema
from persia_tpu_torch.ctx import InferCtx
from persia_tpu_torch.data.batch import (
    MAX_BATCH_SIZE,
    IDTypeFeature,
    NonIDTypeFeature,
    PersiaBatch,
)
from persia_tpu_torch.device import DeviceLike
from persia_tpu_torch.metrics import default_registry
from persia_tpu_torch.rpc import (
    RpcClient,
    RpcDeadlineExceeded,
    RpcError,
    RpcServer,
    pack_arrays,
    unpack_arrays,
)
from persia_tpu_torch.variants import VariantRegistry
from persia_tpu_torch.worker import middleware as mw

# failures that degrade to zero-vector embeddings instead of failing the
# request: a shed deadline, transport loss and timeouts. Application
# errors (schema mismatch, bad payload) still fail it.
DEGRADABLE_ERRORS = (RpcDeadlineExceeded, ConnectionError, OSError)

_logger = logging.getLogger(__name__)


# --- batch merging / padding (the micro-batcher's data plane) ------------


def _merge_id_features(feats: Sequence[IDTypeFeature]) -> IDTypeFeature:
    """CSR concatenation of the same feature across requests."""
    total_rows = sum(f.batch_size for f in feats)
    offsets = np.empty(total_rows + 1, np.uint32)
    offsets[0] = 0
    signs_parts: List[np.ndarray] = []
    pos, nnz = 1, 0
    for f in feats:
        bs = f.batch_size
        offsets[pos:pos + bs] = (
            f.offsets[1:].astype(np.int64) + nnz).astype(np.uint32)
        pos += bs
        nnz += int(f.offsets[-1])
        signs_parts.append(f.signs)
    signs = np.concatenate(signs_parts) if nnz else np.empty(0, np.uint64)
    return IDTypeFeature.from_csr(feats[0].name, offsets, signs)


def merge_batches(batches: Sequence[PersiaBatch]
                  ) -> Tuple[PersiaBatch, List[int]]:
    """Concatenate per-request batches into one batch + the row sizes
    needed to scatter predictions back. Labels are dropped. Callers
    pre-group by :func:`_batch_signature`."""
    sizes = [b.batch_size for b in batches]
    if len(batches) == 1:
        return batches[0], sizes
    id_feats = [
        _merge_id_features([b.id_type_features[i] for b in batches])
        for i in range(len(batches[0].id_type_features))
    ]
    non_id = [
        NonIDTypeFeature(
            np.concatenate([b.non_id_type_features[i].data
                            for b in batches]),
            name=batches[0].non_id_type_features[i].name)
        for i in range(len(batches[0].non_id_type_features))
    ]
    return PersiaBatch(id_feats, non_id_type_features=non_id,
                       requires_grad=False), sizes


def pad_batch(batch: PersiaBatch, target_rows: int) -> PersiaBatch:
    """Pad to ``target_rows`` with EMPTY samples: id features gain rows
    with no signs (nothing new is looked up or cached), dense features
    gain zero rows."""
    extra = target_rows - batch.batch_size
    if extra <= 0:
        return batch
    id_feats = [
        IDTypeFeature.from_csr(
            f.name,
            np.concatenate([f.offsets,
                            np.full(extra, f.offsets[-1], np.uint32)]),
            f.signs)
        for f in batch.id_type_features
    ]
    non_id = [
        NonIDTypeFeature(
            np.concatenate([
                x.data, np.zeros((extra,) + x.data.shape[1:], x.data.dtype)]),
            name=x.name)
        for x in batch.non_id_type_features
    ]
    return PersiaBatch(id_feats, non_id_type_features=non_id,
                       requires_grad=False)


def _batch_signature(batch: PersiaBatch) -> tuple:
    """Merge-compatibility key: feature names/order + dense geometry."""
    return (
        tuple(f.name for f in batch.id_type_features),
        tuple((x.name, x.data.dtype.str, x.data.shape[1:])
              for x in batch.non_id_type_features),
    )


def default_buckets(max_rows: int) -> Tuple[int, ...]:
    """Power-of-two ladder up to ``max_rows`` (4 sizes)."""
    out = []
    b = max_rows
    for _ in range(4):
        if b < 1:
            break
        out.append(b)
        b //= 2
    return tuple(sorted(set(out)))


# --- hot-row cache -------------------------------------------------------


class HotRowCache:
    """LRU of (dim, sign) -> embedding row with a TTL and a delta version.

    The predict path never writes rows back. Without a delta subscriber
    the version stays 0 and an entry expires ``ttl_sec`` after its fetch,
    which bounds its staleness against the PS at one TTL. Absent signs
    cache as zero rows (the PS eval lookup's zero-fill) under the same
    TTL. :meth:`apply_delta` (the subscriber's entry point) upserts
    resident rows in place under a new version; a miss path snapshots
    :attr:`version` before it fetches, and :meth:`put` keeps any row a
    delta refreshed after that snapshot.
    """

    def __init__(self, capacity: int, ttl_sec: float):
        self.capacity = int(capacity)
        self.ttl_sec = float(ttl_sec)
        # (dim, sign) -> (row, expiry, version)
        self._od: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self._ver = 0
        self.delta_rows_applied = 0

    def __len__(self) -> int:
        return len(self._od)

    @property
    def version(self) -> int:
        """The delta-apply counter."""
        return self._ver

    def gather(self, signs: np.ndarray, dim: int,
               out: np.ndarray) -> np.ndarray:
        """Fill ``out`` rows for cached signs; return miss positions."""
        now = time.monotonic()
        miss: List[int] = []
        with self._lock:
            od = self._od
            for i, s in enumerate(signs.tolist()):
                key = (dim, s)
                item = od.get(key)
                if item is None or item[1] < now:
                    miss.append(i)
                else:
                    out[i] = item[0]
                    od.move_to_end(key)
            self.hits += len(signs) - len(miss)
            self.misses += len(miss)
        return np.asarray(miss, np.int64)

    def put(self, signs: np.ndarray, dim: int, rows: np.ndarray,
            seen_ver: Optional[int] = None):
        """Install fetched rows. ``seen_ver``, the :attr:`version` taken
        before the fetch, keeps every entry a delta upserted since: the
        fetch read the PS before that delta landed."""
        if self.capacity <= 0:
            return
        expires = time.monotonic() + self.ttl_sec
        stamp = self._ver if seen_ver is None else int(seen_ver)
        with self._lock:
            od = self._od
            for s, row in zip(signs.tolist(), rows):
                key = (dim, s)
                if seen_ver is not None:
                    cur = od.get(key)
                    if cur is not None and cur[2] > seen_ver:
                        od.move_to_end(key)
                        continue
                # a private copy per row: a view would pin the whole
                # fetched matrix for as long as any one row stays cached
                od[key] = (np.array(row, np.float32), expires, stamp)
                od.move_to_end(key)
            while len(od) > self.capacity:
                od.popitem(last=False)

    def apply_delta(self, signs: np.ndarray, dim: int,
                    rows: np.ndarray) -> int:
        """Upsert the resident (dim, sign) entries under a new version,
        their TTL refreshed; absent signs are ignored (a later miss
        fetches them from the PS). Never inserts, evicts or reorders.
        Returns the rows applied."""
        if self.capacity <= 0:
            return 0
        expires = time.monotonic() + self.ttl_sec
        applied = 0
        with self._lock:
            self._ver += 1
            ver = self._ver
            od = self._od
            for s, row in zip(np.asarray(signs).tolist(), rows):
                key = (dim, s)
                if key in od:
                    # a new tuple, not a write into the stored row: a
                    # gather that copied the old row keeps it whole, and
                    # assigning an existing key keeps its LRU position
                    od[key] = (np.array(row, np.float32), expires, ver)
                    applied += 1
            self.delta_rows_applied += applied
        return applied

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


# --- micro-batcher -------------------------------------------------------


class _PendingRequest:
    __slots__ = ("batch", "done", "pred", "error", "t_enqueue", "tctx",
                 "variant")

    def __init__(self, batch: PersiaBatch, variant: str):
        self.batch = batch
        # merged forwards are single-variant (the dense models differ), so
        # the variant name joins the coalescing group key
        self.variant = variant
        self.done = threading.Event()
        self.pred: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        # the submitting thread's span context: the dispatcher thread has
        # none of its own, so the merged forward's span parents to the
        # first traced request it serves
        self.tctx = tracing.current_context()


class _MicroBatcher:
    """Coalesce concurrent predict requests into merged forwards.

    Callers park in :meth:`wait`; one dispatcher thread drains the queue,
    merges requests of one schema signature and one variant up to
    ``max_rows`` and runs the server's merged forward. When the recent
    coalescing EWMA is ~1 (serial traffic) the dispatcher never lingers,
    so an unloaded server serves at serialized-path latency.
    """

    def __init__(self, run_merged, max_rows: int, max_wait_s: float):
        self._run_merged = run_merged
        self.max_rows = int(max_rows)
        self.max_wait_s = float(max_wait_s)
        self._queue: "deque[_PendingRequest]" = deque()
        self._cond = threading.Condition()
        self._running = True
        self._ewma = 1.0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="infer-microbatcher")
        self._thread.start()

    def enqueue(self, batch: PersiaBatch, variant: str) -> _PendingRequest:
        req = _PendingRequest(batch, variant)
        with self._cond:
            if not self._running:
                raise RpcError("inference server is shutting down")
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def wait(self, req: _PendingRequest, timeout: float = 120.0
             ) -> np.ndarray:
        if not req.done.wait(timeout):
            # shed the abandoned request so an overloaded dispatcher does
            # no work nobody reads
            with self._cond:
                try:
                    self._queue.remove(req)
                except ValueError:
                    pass  # already dispatched (in flight)
            raise RpcError("micro-batch dispatch timed out")
        if req.error is not None:
            raise req.error
        return req.pred

    def _pending_rows(self) -> int:
        return sum(r.batch.batch_size for r in self._queue)

    def _collect(self) -> List[_PendingRequest]:
        with self._cond:
            while self._running and not self._queue:
                self._cond.wait(0.25)
            if not self._queue:
                return []
            if self.max_wait_s > 0 and self._ewma > 1.05:
                deadline = time.monotonic() + self.max_wait_s
                while self._pending_rows() < self.max_rows:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            if not self._queue:
                return []
            # group key = (schema signature, variant): different dense
            # models never share one merged forward
            sig0 = (_batch_signature(self._queue[0].batch),
                    self._queue[0].variant)
            reqs: List[_PendingRequest] = []
            rows = 0
            while self._queue:
                r = self._queue[0]
                rb = r.batch.batch_size
                if reqs and (rows + rb > min(self.max_rows, MAX_BATCH_SIZE)
                             or (_batch_signature(r.batch),
                                 r.variant) != sig0):
                    break  # stays queued for the next dispatch
                reqs.append(self._queue.popleft())
                rows += rb
            self._ewma = 0.8 * self._ewma + 0.2 * len(reqs)
        return reqs

    def _loop(self):
        # the dispatcher must never die: every waiter would park until
        # its timeout
        while True:
            reqs = self._collect()
            if not reqs:
                if not self._running:
                    return
                continue
            try:
                self._run_merged(reqs)
            except Exception as e:  # fail whatever has not completed
                for r in reqs:
                    if not r.done.is_set():
                        r.error = e
                        r.done.set()

    def close(self):
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
        with self._cond:
            while self._queue:
                r = self._queue.popleft()
                r.error = RpcError("inference server closed")
                r.done.set()


# --- the server ----------------------------------------------------------

# the metric series' ``run`` label: a server restarted on the same port in
# one process must not blend into the dead server's counters
_SERVER_SEQ = itertools.count(1)


def _model_zoo() -> dict:
    """Name -> factory ``(num_dense, schema, compute_dtype, device)`` of
    the dense towers ``variant_admin``'s ``add`` builds (the JAX package's
    zoo names). The widths come from the schema, in its feature order."""
    from persia_tpu_torch.models import DCNv2, DLRM, DNN, DeepFM, \
        WideAndDeep

    def dims(schema):
        return [schema.get_slot(n).dim for n in schema.feature_names]

    def fields(cls):
        return lambda nd, schema, **kw: cls(
            nd, len(schema.feature_names), dims(schema)[0], **kw)

    def slots(cls):
        return lambda nd, schema, **kw: cls(nd, dims(schema), **kw)

    return {"dnn": slots(DNN), "dlrm": fields(DLRM), "dcnv2": slots(DCNv2),
            "deepfm": fields(DeepFM), "wide_deep": slots(WideAndDeep)}


class _ServedVariant:
    """Data-plane state of one registered variant: its InferCtx (its own
    model and forward) and its metric series. The registry
    (:mod:`persia_tpu_torch.variants`) holds the routing truth."""

    __slots__ = ("name", "ctx", "m_requests", "m_rows", "t_e2e",
                 "m_degraded", "m_zero_rows")

    def __init__(self, name: str, ctx, reg, base_labels: dict):
        self.name = name
        self.ctx = ctx
        labels = dict(base_labels, variant=name)
        self.m_requests = reg.counter(
            "inference_variant_requests_total", labels,
            help_text="predict requests served per model variant")
        self.m_rows = reg.counter(
            "inference_variant_rows_total", labels,
            help_text="prediction rows served per model variant")
        self.t_e2e = reg.histogram(
            "inference_variant_request_time_cost_sec", labels,
            help_text="end-to-end predict latency per model variant")
        self.m_degraded = reg.counter(
            "inference_variant_degraded_total", labels,
            help_text="predicts of this variant that served zero-vector "
                      "embedding fallback for some signs")
        self.m_zero_rows = reg.counter(
            "inference_variant_zero_rows_total", labels,
            help_text="embedding rows zero-filled for this variant's "
                      "predicts while the embedding tier was degraded")


def _remote_worker(worker_addrs: Optional[Sequence[str]],
                   schema: EmbeddingSchema):
    """A remote worker over the replicas at ``worker_addrs``."""
    from persia_tpu_torch.service.worker_service import (
        RemoteEmbeddingWorker,
    )

    if not worker_addrs:
        raise ValueError("InferenceServer needs worker= (an embedding "
                         "worker) or worker_addrs= (its replicas)")
    worker = RemoteEmbeddingWorker(list(worker_addrs))
    worker.schema = schema
    return worker


def dense_path(dense_checkpoint: str) -> str:
    """The dense file a ``--dense-checkpoint`` names: a checkpoint
    directory's ``dense.pt`` (through :func:`checkpoint.dense_file`), or
    the file itself. The JAX package's ``dense.msgpack`` (flax state) is
    refused by name."""
    if os.path.isdir(dense_checkpoint):
        path = ckpt.dense_file(dense_checkpoint)
        if path is None:
            raise FileNotFoundError(
                f"{dense_checkpoint} holds no {ckpt.DENSE_FILE}")
        return path
    if dense_checkpoint.endswith(".msgpack"):
        raise ValueError(
            f"{dense_checkpoint} is a flax msgpack dense state (the JAX "
            f"package's {ckpt.JAX_DENSE_FILE}); the port reads only torch "
            f"dense state ({ckpt.DENSE_FILE})")
    return dense_checkpoint


def load_zoo_model(model_name: str, dense_checkpoint: str, num_dense: int,
                   schema: EmbeddingSchema, device: DeviceLike = None,
                   **kw):
    """A zoo tower (``_model_zoo``'s widths from ``schema``) on
    ``device`` with the weights of ``dense_checkpoint``, in eval mode."""
    model = _model_zoo()[model_name](int(num_dense), schema, device=device,
                                     **kw)
    with open(dense_path(dense_checkpoint), "rb") as f:
        ckpt.apply_dense_bytes((model, None), f.read())
    return model.eval()


class InferenceServer:
    """Predict server over an :class:`InferCtx` on ``device`` (default
    CUDA), reachable in process and over the RPC wire.

    ``max_batch_rows=0`` keeps the serialized one-request-one-forward
    path; ``cache_rows=0`` sends every lookup to the worker. Either can be
    enabled independently. ``worker`` is an embedding worker object; without
    one the server dials a
    :class:`~persia_tpu_torch.service.worker_service.RemoteEmbeddingWorker`
    over the replicas at ``worker_addrs``.

    The RPC server binds ``host:port`` at construction and serves after
    :meth:`serve_background` / :meth:`serve_forever`; it registers
    ``predict``, ``health``, ``stats``, ``predict_variant`` and
    ``variant_admin``, with the JAX server's request and reply bytes.
    ``http_port`` starts the observability sidecar (0 = ephemeral).

    The forward runs on the thread that serves the request (a connection
    thread, a stream-pool thread or the micro-batcher's dispatcher), on
    that thread's current stream of the model's card; the serialized
    path holds one lock around it, since every connection shares the
    model and the stream.
    """

    def __init__(self, model, schema: EmbeddingSchema, worker=None, *,
                 device: DeviceLike = None,
                 worker_addrs: Optional[Sequence[str]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch_rows: int = 0, max_wait_us: int = 2000,
                 buckets: Optional[Sequence[int]] = None,
                 cache_rows: int = 0, cache_ttl_sec: float = 30.0,
                 concurrent_streams: Optional[int] = None,
                 http_port: Optional[int] = None,
                 degraded_fallback: bool = True,
                 variant_name: str = "default"):
        if worker is None:
            worker = _remote_worker(worker_addrs, schema)
        # read-ahead streams only make sense when the micro-batcher exists
        # to coalesce them; a serialized server keeps one thread per
        # connection
        if concurrent_streams is None:
            concurrent_streams = 32 if max_batch_rows > 0 else 1
        self.worker = worker
        self.schema = schema
        self.model = model
        self.ctx = InferCtx(model, schema, worker, device=device)
        self.device = self.ctx.device
        self.server = RpcServer(host, port,
                                concurrent_streams=concurrent_streams)
        self.server.register("predict", self._predict)
        self.server.register("health", lambda p: b"ok")
        self.server.register("stats", self._stats)
        self.server.register("predict_variant", self._predict_variant)
        self.server.register("variant_admin", self._variant_admin)

        self.max_batch_rows = min(int(max_batch_rows), MAX_BATCH_SIZE)
        if self.max_batch_rows > 0:
            self.buckets = tuple(sorted(
                buckets if buckets else default_buckets(self.max_batch_rows)))
            self._batcher: Optional[_MicroBatcher] = _MicroBatcher(
                self._run_merged, self.max_batch_rows, max_wait_us / 1e6)
        else:
            self.buckets = ()
            self._batcher = None
        self.cache = (HotRowCache(cache_rows, cache_ttl_sec)
                      if cache_rows > 0 else None)
        # when the embedding tier is unreachable for a lookup, predict
        # serves zero vectors for the affected signs instead of failing;
        # zero rows are never cached, so recovery is immediate
        self.degraded_fallback = bool(degraded_fallback)
        self._forward_lock = threading.Lock()

        labels = {"server": self.addr.rsplit(":", 1)[1],
                  "run": str(next(_SERVER_SEQ))}
        reg = default_registry()
        self._m_requests = reg.counter("inference_requests_total", labels)
        self._m_batches = reg.counter("inference_batches_total", labels)
        self._m_rows = reg.counter("inference_rows_total", labels)
        self._m_padded = reg.counter("inference_padded_rows_total", labels)
        self._t_e2e = reg.histogram("inference_request_time_cost_sec",
                                    labels)
        self._t_queue = reg.histogram(
            "inference_queue_wait_time_cost_sec", labels)
        self._t_lookup = reg.histogram("inference_lookup_time_cost_sec",
                                       labels)
        self._t_forward = reg.histogram(
            "inference_forward_time_cost_sec", labels)
        self._m_degraded = reg.counter("inference_degraded_lookups_total",
                                       labels)
        self._m_zero_rows = reg.counter(
            "inference_zero_fallback_rows_total", labels)
        # the boot model is the first, default variant: a server nobody
        # registers a second variant on serves exactly as a single-model
        # server
        self._reg = reg
        self._metric_labels = labels
        self.variants = VariantRegistry()
        self.variants.add(variant_name, weight=1.0, default=True,
                          meta={"source": "boot"})
        # name -> _ServedVariant; mutated under _variants_lock, read
        # lock-free on the predict path
        self._variants_lock = threading.Lock()
        self._served_variants: Dict[str, _ServedVariant] = {
            variant_name: _ServedVariant(variant_name, self.ctx, reg,
                                         labels)}
        # request-field routing: a plain predict's route key is this id
        # feature's first sign (frozen at construction)
        self._route_feature = knobs.get("PERSIA_VARIANT_ROUTE_FEATURE")
        # the online delta subscriber, once attach_delta_subscriber arms
        # it; None keeps the TTL-only freshness
        self.online = None
        self.http = obs_http.maybe_start(host, http_port, self._healthz,
                                         variants_fn=self._variants_doc)

    @property
    def addr(self) -> str:
        return self.server.addr

    def _healthz(self) -> dict:
        doc = self.server.health()
        if self._batcher is not None:
            with self._batcher._cond:
                doc["microbatch_queue_depth"] = len(self._batcher._queue)
        if self.cache is not None:
            doc["cache_rows_resident"] = len(self.cache)
            doc["cache_hit_rate"] = round(self.cache.hit_rate, 4)
            # the freshness bound: a cached row lags the PS by at most this
            doc["cache_ttl_sec"] = self.cache.ttl_sec
        doc["requests_total"] = self._m_requests.value
        doc["degraded_lookups_total"] = self._m_degraded.value
        # this replica's own freshness: the subscriber's stall clock and
        # last packet
        if self.online is not None:
            doc["online"] = self.online.health()
        doc["variants"] = self._variants_doc()
        epoch = getattr(self.worker, "routing_epoch", None)
        if epoch is not None:
            doc["routing_epoch"] = epoch
        # degrading still answers requests: the counter is the alert, not
        # a routing decision
        doc["ready"] = True
        return doc

    # --- variant control plane -------------------------------------------

    def add_variant(self, name: str, model, weight: float = 0.0,
                    default: bool = False, meta: Optional[dict] = None):
        """Register a live variant: its own dense model (weights loaded,
        on the server's device) over the same worker and cache."""
        ctx = InferCtx(model, self.schema, self.worker, device=self.device)
        with self._variants_lock:
            self.variants.add(name, weight=weight, default=default,
                              meta=meta)
            self._served_variants[name] = _ServedVariant(
                name, ctx, self._reg, self._metric_labels)
        _logger.info("variant %r registered (weight=%s default=%s)",
                     name, weight, default)

    def add_variant_from_checkpoint(self, name: str, model_name: str,
                                    dense_checkpoint: str,
                                    num_dense: int = 5,
                                    weight: float = 0.0,
                                    default: bool = False):
        """The operator-facing add: a zoo name and a dense checkpoint (a
        checkpoint directory, read through :func:`checkpoint.dense_file`,
        or a ``dense.pt`` file). The tower computes in the boot model's
        dtype."""
        kw = {}
        if hasattr(self.model, "compute_dtype"):
            kw["compute_dtype"] = self.model.compute_dtype
        model = load_zoo_model(model_name, dense_checkpoint, num_dense,
                               self.schema, self.device, **kw)
        self.add_variant(name, model, weight=weight, default=default,
                         meta={"model": model_name,
                               "dense_checkpoint": dense_checkpoint})

    def remove_variant(self, name: str):
        with self._variants_lock:
            self.variants.remove(name)  # validates (default protected)
            self._served_variants.pop(name, None)
        _logger.info("variant %r removed", name)

    def promote_variant(self, name: str):
        """Make ``name`` the default (what plain ``predict`` serves)."""
        if name not in self._served_variants:
            raise KeyError(f"variant {name!r} has no serving context")
        self.variants.promote(name)
        _logger.info("variant %r promoted to default", name)

    def _variants_doc(self) -> list:
        docs = self.variants.describe()
        for d in docs:
            sv = self._served_variants.get(d["name"])
            if sv is not None:
                d["requests"] = sv.m_requests.value
                d["rows"] = sv.m_rows.value
                d["degraded"] = sv.m_degraded.value
                d["compiled_buckets"] = sorted(sv.ctx.eval_batch_rows_seen)
        return docs

    def _variant_admin(self, payload: bytes) -> bytes:
        """Live variant add / remove / promote / weight / drain / resume /
        list, msgpack in and out."""
        req = _msgpack.unpackb(payload)
        op = req.get("op")
        if op == "list":
            return _msgpack.packb({"variants": self._variants_doc()})
        name = req["name"]
        if op == "add":
            self.add_variant_from_checkpoint(
                name, req.get("model", "dnn"), req["dense_checkpoint"],
                num_dense=int(req.get("num_dense", 5)),
                weight=float(req.get("weight", 0.0)),
                default=bool(req.get("default", False)))
        elif op == "remove":
            self.remove_variant(name)
        elif op == "promote":
            self.promote_variant(name)
        elif op == "weight":
            self.variants.set_weight(name, float(req["weight"]))
        elif op == "drain":
            self.variants.set_status(name, "draining")
        elif op == "resume":
            self.variants.set_status(name, "live")
        else:
            raise RpcError(f"unknown variant_admin op {op!r}")
        return _msgpack.packb({"ok": True,
                               "variants": self._variants_doc()})

    # --- online delta subscription ---------------------------------------

    def attach_delta_subscriber(self, inc_dir: str, **kw):
        """Subscribe the hot-row cache to the trainer's incremental-update
        packets under ``inc_dir`` and start scanning
        (:class:`persia_tpu_torch.online.DeltaSubscriber`; ``kw`` goes to
        it). The ownership filter follows the worker's live routing
        window when it has one; otherwise pass ``routing_fn``, or every
        packet's rows apply. Returns the subscriber."""
        from persia_tpu_torch.online import DeltaSubscriber

        if self.cache is None:
            raise ValueError(
                "delta subscription upserts the hot-row cache; start "
                "the server with cache_rows > 0")
        if self.online is not None:
            raise RuntimeError("a delta subscriber is already attached")
        if "routing_fn" not in kw and hasattr(self.worker,
                                              "routing_window"):
            kw["routing_fn"] = lambda: self.worker.routing_window
        self.online = DeltaSubscriber(self.cache, inc_dir, **kw).start()
        _logger.info("delta subscriber attached to %s (scan=%.2fs)",
                     inc_dir, self.online.scan_interval_sec)
        return self.online

    # --- predict paths ---------------------------------------------------

    def predict(self, batch: PersiaBatch) -> np.ndarray:
        """(rows, 1) float32 predictions for one request, in process."""
        return self.predict_many([batch])[0]

    def predict_bytes(self, payload: bytes) -> np.ndarray:
        """``predict`` for a request given as PTB2 bytes."""
        return self.predict(PersiaBatch.from_bytes(payload))

    def predict_many(self, batches: Sequence) -> List[np.ndarray]:
        """Several requests (PersiaBatch or PTB2 bytes) at once, in
        process, each routed as a plain ``predict``: with the
        micro-batcher they are all queued before the first is awaited,
        so one caller can fill a merged forward."""
        batches = [PersiaBatch.from_bytes(b)
                   if isinstance(b, (bytes, bytearray, memoryview)) else b
                   for b in batches]
        routed = [(b, self._route(b, None, None)) for b in batches]
        preds = []
        if self._batcher is not None:
            reqs = [(self._batcher.enqueue(b, sv.name), sv)
                    for b, sv in routed]
            for r, sv in reqs:
                preds.append(self._batcher.wait(r))
                self._observe_e2e(sv, time.perf_counter() - r.t_enqueue)
            return preds
        for b, sv in routed:
            t0 = time.perf_counter()
            preds.append(self._forward_one(b, sv))
            self._observe_e2e(sv, time.perf_counter() - t0)
        return preds

    def _route_key_from_batch(self, batch: PersiaBatch) -> Optional[bytes]:
        """Field-based A/B routing (``PERSIA_VARIANT_ROUTE_FEATURE``): the
        named id feature's first sign is the request's route key."""
        if self._route_feature is None or len(self.variants) <= 1:
            return None
        for f in batch.id_type_features:
            if f.name == self._route_feature and len(f.signs):
                return int(f.signs[0]).to_bytes(8, "little")
        return None

    def _route(self, batch: PersiaBatch, explicit: Optional[str],
               key: Optional[bytes]) -> _ServedVariant:
        """Resolve a request to its variant and count it."""
        if explicit is None and key is None:
            key = self._route_key_from_batch(batch)
        try:
            vname = self.variants.route(key=key, explicit=explicit)
        except KeyError as e:
            raise RpcError(str(e))
        sv = self._served_variants.get(vname)
        if sv is None:
            raise RpcError(f"variant {vname!r} has no serving context")
        self._m_requests.inc()
        sv.m_requests.inc()
        return sv

    def _observe_e2e(self, sv: _ServedVariant, seconds: float):
        self._t_e2e.observe(seconds)
        sv.t_e2e.observe(seconds)

    def _predict(self, payload) -> bytes:
        # request = PTB2 bytes, reply = pack_arrays({}, [pred]): the JAX
        # server's bytes
        return self._serve(payload, None, None, reply_variant=False)

    def _predict_variant(self, payload) -> bytes:
        """Variant-addressed predict: msgpack ``{v: explicit variant |
        None, k: route key bytes | None, b: PTB2 bytes}``; the reply's
        meta names the variant that served."""
        req = _msgpack.unpackb(payload)
        return self._serve(req["b"], req.get("v"), req.get("k"),
                           reply_variant=True)

    def _serve(self, payload, explicit: Optional[str],
               key: Optional[bytes], reply_variant: bool) -> bytes:
        t0 = time.perf_counter()
        with tracing.span("serving/predict"):
            batch = PersiaBatch.from_bytes(payload)
            sv = self._route(batch, explicit, key)
            if self._batcher is not None:
                pred = self._batcher.wait(
                    self._batcher.enqueue(batch, sv.name))
            else:
                pred = self._forward_one(batch, sv)
        self._observe_e2e(sv, time.perf_counter() - t0)
        meta = {"variant": sv.name} if reply_variant else {}
        return pack_arrays(meta, [np.ascontiguousarray(pred)])

    def _forward_one(self, batch: PersiaBatch,
                     sv: _ServedVariant) -> np.ndarray:
        """The serialized path: one request, one forward."""
        with self._forward_lock:
            pred = self._forward(batch, sv)
        self._m_batches.inc()
        self._m_rows.inc(batch.batch_size)
        sv.m_rows.inc(batch.batch_size)
        return pred

    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return rows  # oversized request: exact shape, no padding

    def _run_merged(self, reqs: List[_PendingRequest]):
        """Dispatcher entry: merge -> pad to bucket -> one lookup + one
        forward -> scatter per-request row slices. The collect loop
        groups by (signature, variant), so a merged batch is
        single-variant."""
        now = time.perf_counter()
        for r in reqs:
            self._t_queue.observe(now - r.t_enqueue)
        sv = self._served_variants.get(reqs[0].variant)
        if sv is None:
            raise RpcError(f"variant {reqs[0].variant!r} removed mid-flight")
        tctx = next((r.tctx for r in reqs if r.tctx is not None), None)
        kw = {"ctx": tctx} if tctx is not None else {}
        with tracing.span("serving/merged_forward", n_reqs=len(reqs), **kw):
            merged, sizes = merge_batches([r.batch for r in reqs])
            rows = merged.batch_size
            bucket = self._bucket_for(rows)
            pred = self._forward(pad_batch(merged, bucket), sv)
        self._m_batches.inc()
        self._m_rows.inc(rows)
        self._m_padded.inc(bucket - rows)
        sv.m_rows.inc(rows)
        off = 0
        for r, s in zip(reqs, sizes):
            r.pred = pred[off:off + s]
            off += s
            r.done.set()

    def _forward(self, batch: PersiaBatch,
                 sv: _ServedVariant) -> np.ndarray:
        with self._t_lookup.timer(), tracing.span("serving/lookup"):
            lookup = self._lookup(batch.id_type_features, sv)
        with self._t_forward.timer(), tracing.span("serving/forward"):
            pred, _labels = sv.ctx.forward_prepared(batch, lookup)
            return pred.float().cpu().numpy()  # waits for the device

    # --- lookups and the degraded fallback -------------------------------

    def _lookup(self, id_type_features: List[IDTypeFeature],
                sv: _ServedVariant):
        if self.cache is None:
            try:
                return self.worker.lookup_direct(id_type_features,
                                                 training=False)
            except DEGRADABLE_ERRORS as e:
                if not self.degraded_fallback:
                    raise
                return self._zero_lookup(id_type_features, e, sv)
        return self._lookup_cached(id_type_features, sv)

    def _count_degraded(self, sv: _ServedVariant, rows: int):
        self._m_degraded.inc()
        self._m_zero_rows.inc(rows)
        sv.m_degraded.inc()
        sv.m_zero_rows.inc(rows)

    def _zero_lookup(self, id_type_features: List[IDTypeFeature], cause,
                     sv: _ServedVariant):
        """Whole-lookup degradation (no cache to salvage hits from):
        preprocess locally, as the worker would, and zero-fill every
        embedding row."""
        feats = mw.preprocess_batch(id_type_features, self.schema)
        out = {}
        rows = 0
        for f in feats:
            slot = self.schema.get_slot(f.name)
            rows += f.num_distinct
            out[f.name] = mw.postprocess_feature(
                f, slot, np.zeros((f.num_distinct, slot.dim), np.float32))
        self._count_degraded(sv, rows)
        _logger.warning("degraded predict: embedding tier unreachable "
                        "(%s); %d rows served as zero vectors", cause, rows)
        return out

    def _lookup_cached(self, id_type_features: List[IDTypeFeature],
                       sv: _ServedVariant):
        """Preprocess locally (the worker's own transforms, so cache keys
        are post-transform signs), serve distinct signs from the LRU and
        fetch only the misses through one deduplicated ``lookup_signs``
        call per dim. Requests were merged before this runs, so the dedup
        is cross-request. A dim whose fetch fails degrades to zero rows,
        which are not cached."""
        feats = mw.preprocess_batch(id_type_features, self.schema)
        # before any fetch: a delta landing while a fetch is in flight
        # moves the version past this, and put() keeps the delta's row
        seen_ver = self.cache.version
        mats: List[np.ndarray] = []
        misses: Dict[int, list] = {}
        for f in feats:
            dim = self.schema.get_slot(f.name).dim
            mat = np.zeros((f.num_distinct, dim), np.float32)
            miss_pos = self.cache.gather(f.distinct_signs, dim, mat)
            if len(miss_pos):
                misses.setdefault(dim, []).append(
                    (mat, miss_pos, f.distinct_signs[miss_pos]))
            mats.append(mat)
        for dim, parts in misses.items():
            all_signs = np.concatenate([p[2] for p in parts])
            uniq, inverse = np.unique(all_signs, return_inverse=True)
            try:
                rows = self.worker.lookup_signs(uniq, dim)
            except DEGRADABLE_ERRORS as e:
                if not self.degraded_fallback:
                    raise
                self._count_degraded(sv, len(all_signs))
                _logger.warning(
                    "degraded lookup (dim=%d): %d miss rows served as zero "
                    "vectors (%s)", dim, len(all_signs), e)
                continue
            self.cache.put(uniq, dim, rows, seen_ver=seen_ver)
            pos = 0
            for mat, miss_pos, s in parts:
                mat[miss_pos] = rows[inverse[pos:pos + len(s)]]
                pos += len(s)
        return {f.name: mw.postprocess_feature(
                    f, self.schema.get_slot(f.name), mat)
                for f, mat in zip(feats, mats)}

    # --- observability ---------------------------------------------------

    def stats(self) -> dict:
        """The ``stats`` reply: the JAX server's keys, and the port's
        lookup / forward medians (per forward, a merged batch with the
        micro-batcher: the host-side lookup, then H2D + model + D2H)."""
        req = self._m_requests.value
        bat = self._m_batches.value
        rows = self._m_rows.value
        padded = self._m_padded.value
        d = {
            "requests": req,
            "batches": bat,
            "rows": rows,
            "padded_rows": padded,
            "avg_coalesce": req / bat if bat else 0.0,
            "batch_fill_ratio": rows / (rows + padded) if rows else 0.0,
            "queue_wait_p50_ms": self._t_queue.percentile(50) * 1e3,
            "queue_wait_p99_ms": self._t_queue.percentile(99) * 1e3,
            "request_p50_ms": self._t_e2e.percentile(50) * 1e3,
            "request_p99_ms": self._t_e2e.percentile(99) * 1e3,
            "lookup_p50_ms": self._t_lookup.percentile(50) * 1e3,
            "forward_p50_ms": self._t_forward.percentile(50) * 1e3,
            "compiled_buckets": sorted(self.ctx.eval_batch_rows_seen),
            "buckets": list(self.buckets),
            "degraded_lookups": self._m_degraded.value,
            "zero_fallback_rows": self._m_zero_rows.value,
        }
        if self.cache is not None:
            d.update(cache_hit_rate=self.cache.hit_rate,
                     cache_hits=self.cache.hits,
                     cache_misses=self.cache.misses,
                     cache_rows_resident=len(self.cache),
                     cache_delta_rows_applied=self.cache.delta_rows_applied)
        if len(self.variants) > 1:
            d["variants"] = self._variants_doc()
        if self.online is not None:
            d["online"] = self.online.health()
        return d

    def _stats(self, payload) -> bytes:
        return _msgpack.packb(self.stats())

    # --- lifecycle -------------------------------------------------------

    def serve_background(self):
        self.server.serve_background()

    def serve_forever(self):
        _logger.info(
            "inference server listening on %s (max_batch_rows=%d buckets=%s "
            "cache_rows=%s)", self.addr, self.max_batch_rows,
            list(self.buckets),
            self.cache.capacity if self.cache is not None else 0)
        self.server.serve_forever()

    def stop(self):
        self.server.stop()
        if self._batcher is not None:
            self._batcher.close()
        if self.online is not None:
            self.online.stop()
        if self.http is not None:
            self.http.stop()


class InferenceClient:
    """Client of an :class:`InferenceServer` of either package."""

    def __init__(self, addr: str, timeout: float = 60.0):
        self.client = RpcClient(addr, timeout=timeout)

    def predict(self, batch: PersiaBatch) -> np.ndarray:
        return self.predict_bytes(batch.to_bytes())

    def predict_bytes(self, payload: bytes) -> np.ndarray:
        _, (pred,) = unpack_arrays(self.client.call("predict", payload))
        return pred

    def predict_variant(self, batch, variant: Optional[str] = None,
                        key: Optional[bytes] = None):
        """Pin a variant explicitly, or hand a route key to the server's
        deterministic weighted split. Returns ``(pred, served variant)``."""
        payload = batch if isinstance(batch, (bytes, bytearray)) \
            else batch.to_bytes()
        req = _msgpack.packb(
            {"v": variant, "k": bytes(key) if key is not None else None,
             "b": bytes(payload)})
        meta, (pred,) = unpack_arrays(
            self.client.call("predict_variant", req))
        return pred, meta.get("variant")

    def variant_admin(self, op: str, **kw) -> dict:
        """Live variant control: ``op`` in add | remove | promote |
        weight | drain | resume | list."""
        return self.client.call_msg("variant_admin", op=op, **kw)

    def predict_many(self, batches: Sequence) -> List[np.ndarray]:
        """Pipelined predicts on one connection (``RpcClient.call_many``):
        with the server's read-ahead streams one client can keep the
        micro-batcher full without threads."""
        payloads = [b if isinstance(b, (bytes, bytearray)) else b.to_bytes()
                    for b in batches]
        return [unpack_arrays(r)[1][0]
                for r in self.client.call_many("predict", payloads)]

    def stats(self) -> dict:
        return _msgpack.unpackb(self.client.call("stats"))

    def healthy(self) -> bool:
        try:
            return self.client.call("health") == b"ok"
        except (RpcError, ConnectionError, OSError):
            return False

    def close(self):
        self.client.close()


def main(argv=None):
    """Serve a trained zoo model (the JAX package's ``persia-tpu-serving``,
    ``persia_tpu/serving.py`` ``main``): ``python -m
    persia_tpu_torch.serving --model dlrm --dense-checkpoint dense.pt
    --embedding-config schema.yml [--worker-addrs a,b] [--coordinator
    addr] [--device cuda]``. With ``--coordinator`` the replica registers
    as ``inference-server`` with its sidecar, so the fleet monitor
    scrapes it."""
    import argparse

    from persia_tpu_torch.service_discovery import (
        get_embedding_worker_services,
    )

    zoo = _model_zoo()
    p = argparse.ArgumentParser(prog="persia-tpu-torch-serving")
    p.add_argument("--model", choices=sorted(zoo), default="dnn")
    p.add_argument("--dense-checkpoint", required=True,
                   help="dense.pt from dump_checkpoint, or its checkpoint "
                        "directory (a JAX dense.msgpack is refused)")
    p.add_argument("--embedding-config", required=True)
    p.add_argument("--num-dense", type=int, default=5,
                   help="dense feature width the model was trained with")
    p.add_argument("--device", default="cuda",
                   help="the towers' device (default cuda; cpu on a host "
                        "without a card)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--worker-addrs", default=None,
                   help="comma-separated; default EMBEDDING_WORKER_SERVICE "
                        "or the coordinator's workers")
    p.add_argument("--coordinator",
                   default=knobs.get_raw("PERSIA_COORDINATOR_ADDR"),
                   help="register this serving replica (and its "
                        "observability sidecar) with the coordinator so "
                        "the fleet monitor scrapes it")
    p.add_argument("--replica-index", type=int,
                   default=int(os.environ.get("REPLICA_INDEX", 0)))
    p.add_argument("--max-batch-rows", type=int, default=0,
                   help="enable micro-batching up to this many coalesced "
                        "rows (0 = serialized path)")
    p.add_argument("--max-wait-us", type=int, default=2000,
                   help="adaptive linger window for straggler coalescing")
    p.add_argument("--cache-rows", type=int, default=0,
                   help="hot-row LRU capacity (0 = no cache)")
    p.add_argument("--cache-ttl-sec", type=float, default=30.0,
                   help="hot-row TTL; bounds staleness vs inc_update")
    p.add_argument("--inc-dir", default=None,
                   help="attach the online delta subscriber to this "
                        "incremental-update packet directory: trained "
                        "rows upsert the hot-row cache in place instead "
                        "of waiting out the TTL. Requires --cache-rows")
    p.add_argument("--online-scan-sec", type=float, default=None,
                   help="delta-subscriber scan interval "
                        "(default PERSIA_ONLINE_SCAN_SEC)")
    p.add_argument("--variant", action="append", default=[],
                   metavar="NAME=WEIGHT:MODEL:DENSE_CKPT[:default]",
                   help="register an extra serving variant at boot "
                        "(repeatable); more can be added live through the "
                        "variant_admin RPC")
    p.add_argument("--variant-name", default="default",
                   help="name of the boot model's variant (the default "
                        "unless a --variant entry claims it)")
    p.add_argument("--no-degraded-fallback", action="store_true",
                   help="fail predicts when the embedding tier is "
                        "unreachable instead of serving zero-vector "
                        "embeddings for the affected signs")
    p.add_argument("--wire-codec", default=None,
                   choices=["off", "fp16", "fp16+int8"],
                   help="embedding-row wire precision policy "
                        "(PERSIA_PS_WIRE_CODEC): the miss-fetch hop ships "
                        "fp16 rows when enabled; legacy peers negotiate "
                        "down to fp32")
    obs_http.add_http_args(p)
    args = p.parse_args(argv)
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO").upper())
    tracing.set_service_name(f"serving:{args.port}")
    if args.wire_codec is not None:
        # read by every row-wire client built below
        os.environ["PERSIA_PS_WIRE_CODEC"] = args.wire_codec

    schema = EmbeddingSchema.load(args.embedding_config)
    model = load_zoo_model(args.model, args.dense_checkpoint, args.num_dense,
                           schema, args.device)
    if args.worker_addrs:
        addrs = [a.strip() for a in args.worker_addrs.split(",")
                 if a.strip()]
    else:
        addrs = get_embedding_worker_services(args.coordinator)
    server = InferenceServer(model, schema, worker_addrs=addrs,
                             device=args.device, host=args.host,
                             port=args.port,
                             max_batch_rows=args.max_batch_rows,
                             max_wait_us=args.max_wait_us,
                             cache_rows=args.cache_rows,
                             cache_ttl_sec=args.cache_ttl_sec,
                             http_port=obs_http.port_from_args(args),
                             degraded_fallback=not args.no_degraded_fallback,
                             variant_name=args.variant_name)
    for spec in args.variant:
        name, _, rest = spec.partition("=")
        parts = rest.split(":")
        if len(parts) < 3:
            p.error(f"--variant {spec!r}: expected "
                    "NAME=WEIGHT:MODEL:DENSE_CKPT[:default]")
        server.add_variant_from_checkpoint(
            name, parts[1], parts[2], num_dense=args.num_dense,
            weight=float(parts[0]),
            default=len(parts) > 3 and parts[3] == "default")
    if args.inc_dir:
        kw = {}
        if args.online_scan_sec is not None:
            kw["scan_interval_sec"] = args.online_scan_sec
        server.attach_delta_subscriber(args.inc_dir, **kw)
    obs_http.write_addr_file_from_args(server.http, args)
    if args.coordinator:
        from persia_tpu_torch.service.coordinator import (
            ROLE_INFERENCE,
            CoordinatorClient,
        )

        CoordinatorClient(args.coordinator).register(
            ROLE_INFERENCE, args.replica_index, server.addr,
            http_addr=server.http.addr if server.http else None)
    server.serve_forever()


if __name__ == "__main__":
    main()
