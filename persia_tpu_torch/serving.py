"""Online inference serving: the predict path of ``persia_tpu/serving.py``,
in process.

:class:`InferenceServer` takes PersiaBatch objects or PTB2 bytes and
returns the model's predictions. Its throughput path has the JAX
package's three pieces:

- **Adaptive micro-batching** (``max_batch_rows > 0``): concurrent
  requests are coalesced by a dispatcher thread into one merged batch ->
  one embedding lookup -> one forward, and the per-request row slices are
  scattered back. The linger (``max_wait_us``) only applies when the
  recent coalescing EWMA says traffic is concurrent.
- **Shape bucketing**: merged batches are padded with empty rows up to a
  small ladder of sizes, so the forward sees a handful of shapes. Padding
  rows look nothing up and are never scattered back.
- **Cross-request sign dedup + a read-only hot-row TTL cache**
  (``cache_rows > 0``): the merged batch is preprocessed locally, distinct
  post-transform signs are served from an in-process LRU, and only the
  misses go to the worker through one deduplicated ``lookup_signs`` call
  per dim.

The RPC socket layer, model variants, the metrics registry, the online
delta subscriber and the degraded zero-vector fallback belong to later
slices of the port.
"""

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from persia_tpu_torch.config import EmbeddingSchema
from persia_tpu_torch.ctx import InferCtx
from persia_tpu_torch.data.batch import (
    MAX_BATCH_SIZE,
    IDTypeFeature,
    NonIDTypeFeature,
    PersiaBatch,
)
from persia_tpu_torch.device import DeviceLike
from persia_tpu_torch.worker import middleware as mw


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
    """LRU of (dim, sign) -> embedding row with a TTL.

    The predict path never writes rows back, so the cache cannot diverge
    from the PS beyond one TTL. Absent signs cache as zero rows (the PS
    eval lookup's zero-fill) under the same TTL.
    """

    def __init__(self, capacity: int, ttl_sec: float):
        self.capacity = int(capacity)
        self.ttl_sec = float(ttl_sec)
        self._od: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._od)

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

    def put(self, signs: np.ndarray, dim: int, rows: np.ndarray):
        """Install fetched rows."""
        if self.capacity <= 0:
            return
        expires = time.monotonic() + self.ttl_sec
        with self._lock:
            od = self._od
            for s, row in zip(signs.tolist(), rows):
                key = (dim, s)
                # a private copy per row: a view would pin the whole
                # fetched matrix for as long as any one row stays cached
                od[key] = (np.array(row, np.float32), expires)
                od.move_to_end(key)
            while len(od) > self.capacity:
                od.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


# --- micro-batcher -------------------------------------------------------


class _PendingRequest:
    __slots__ = ("batch", "done", "pred", "error", "t_enqueue")

    def __init__(self, batch: PersiaBatch):
        self.batch = batch
        self.done = threading.Event()
        self.pred: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()


class _MicroBatcher:
    """Coalesce concurrent predict requests into merged forwards.

    Callers park in :meth:`wait`; one dispatcher thread drains the queue,
    merges schema-compatible requests up to ``max_rows`` and runs the
    server's merged forward. When the recent coalescing EWMA is ~1
    (serial traffic) the dispatcher never lingers, so an unloaded server
    serves at serialized-path latency.
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

    def enqueue(self, batch: PersiaBatch) -> _PendingRequest:
        req = _PendingRequest(batch)
        with self._cond:
            if not self._running:
                raise RuntimeError("inference server is shutting down")
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
            raise TimeoutError("micro-batch dispatch timed out")
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
            sig0 = _batch_signature(self._queue[0].batch)
            reqs: List[_PendingRequest] = []
            rows = 0
            while self._queue:
                r = self._queue[0]
                rb = r.batch.batch_size
                if reqs and (rows + rb > min(self.max_rows, MAX_BATCH_SIZE)
                             or _batch_signature(r.batch) != sig0):
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
                r.error = RuntimeError("inference server closed")
                r.done.set()


class _Timings:
    """Bounded window of durations (seconds) with percentiles."""

    def __init__(self, window: int = 100_000):
        self._d: "deque[float]" = deque(maxlen=window)
        self._lock = threading.Lock()

    def observe(self, seconds: float):
        with self._lock:
            self._d.append(seconds)

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._d:
                return 0.0
            return float(np.percentile(np.fromiter(self._d, float), q))


# --- the server ----------------------------------------------------------


class InferenceServer:
    """In-process predict server over an :class:`InferCtx` on ``device``
    (default CUDA).

    ``max_batch_rows=0`` keeps the serialized one-request-one-forward
    path; ``cache_rows=0`` sends every lookup to the worker. Either can be
    enabled independently.
    """

    def __init__(self, model, schema: EmbeddingSchema, worker, *,
                 device: DeviceLike = None, max_batch_rows: int = 0,
                 max_wait_us: int = 2000,
                 buckets: Optional[Sequence[int]] = None,
                 cache_rows: int = 0, cache_ttl_sec: float = 30.0):
        self.worker = worker
        self.schema = schema
        self.model = model
        self.ctx = InferCtx(model, schema, worker, device=device)
        self.device = self.ctx.device
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
        self._count_lock = threading.Lock()
        self._requests = 0
        self._batches = 0
        self._rows = 0
        self._padded = 0
        self._t_e2e = _Timings()
        self._t_queue = _Timings()
        self._t_lookup = _Timings()
        self._t_forward = _Timings()
        # one forward at a time on the serialized path: the model and the
        # device stream are shared by every calling thread
        self._forward_lock = threading.Lock()

    # --- predict paths ---------------------------------------------------

    def predict(self, batch: PersiaBatch) -> np.ndarray:
        """(rows, 1) float32 predictions for one request."""
        return self.predict_many([batch])[0]

    def predict_bytes(self, payload: bytes) -> np.ndarray:
        """``predict`` for a request given as PTB2 bytes."""
        return self.predict(PersiaBatch.from_bytes(payload))

    def predict_many(self, batches: Sequence) -> List[np.ndarray]:
        """Several requests (PersiaBatch or PTB2 bytes) at once: with the
        micro-batcher they are all queued before the first is awaited, so
        one caller can fill a merged forward."""
        batches = [PersiaBatch.from_bytes(bytes(b))
                   if isinstance(b, (bytes, bytearray, memoryview)) else b
                   for b in batches]
        with self._count_lock:
            self._requests += len(batches)
        if self._batcher is not None:
            reqs = [self._batcher.enqueue(b) for b in batches]
            preds = []
            for r in reqs:
                preds.append(self._batcher.wait(r))
                self._t_e2e.observe(time.perf_counter() - r.t_enqueue)
            return preds
        preds = []
        for b in batches:
            t0 = time.perf_counter()
            with self._forward_lock:
                preds.append(self._forward(b))
            with self._count_lock:
                self._batches += 1
                self._rows += b.batch_size
            self._t_e2e.observe(time.perf_counter() - t0)
        return preds

    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return rows  # oversized request: exact shape, no padding

    def _run_merged(self, reqs: List[_PendingRequest]):
        """Dispatcher entry: merge -> pad to bucket -> one lookup + one
        forward -> scatter per-request row slices."""
        now = time.perf_counter()
        for r in reqs:
            self._t_queue.observe(now - r.t_enqueue)
        merged, sizes = merge_batches([r.batch for r in reqs])
        rows = merged.batch_size
        bucket = self._bucket_for(rows)
        pred = self._forward(pad_batch(merged, bucket))
        with self._count_lock:
            self._batches += 1
            self._rows += rows
            self._padded += bucket - rows
        off = 0
        for r, s in zip(reqs, sizes):
            r.pred = pred[off:off + s]
            off += s
            r.done.set()

    def _forward(self, batch: PersiaBatch) -> np.ndarray:
        t0 = time.perf_counter()
        if self.cache is None:
            lookup = self.worker.lookup_direct(batch.id_type_features,
                                               training=False)
        else:
            lookup = self._lookup_cached(batch.id_type_features)
        t1 = time.perf_counter()
        pred, _labels = self.ctx.forward_prepared(batch, lookup)
        out = pred.float().cpu().numpy()  # waits for the device
        self._t_lookup.observe(t1 - t0)
        self._t_forward.observe(time.perf_counter() - t1)
        return out

    def _lookup_cached(self, id_type_features: List[IDTypeFeature]):
        """Preprocess locally (the worker's own transforms, so cache keys
        are post-transform signs), serve distinct signs from the LRU and
        fetch only the misses through one deduplicated ``lookup_signs``
        call per dim. Requests were merged before this runs, so the dedup
        is cross-request."""
        feats = mw.preprocess_batch(id_type_features, self.schema)
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
            rows = self.worker.lookup_signs(uniq, dim)
            self.cache.put(uniq, dim, rows)
            pos = 0
            for mat, miss_pos, s in parts:
                mat[miss_pos] = rows[inverse[pos:pos + len(s)]]
                pos += len(s)
        return {f.name: mw.postprocess_feature(
                    f, self.schema.get_slot(f.name), mat)
                for f, mat in zip(feats, mats)}

    # --- observability ---------------------------------------------------

    def stats(self) -> dict:
        with self._count_lock:
            req, bat = self._requests, self._batches
            rows, padded = self._rows, self._padded
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
            # per forward (a merged batch with the micro-batcher): the
            # host-side lookup, then H2D + model + D2H
            "lookup_p50_ms": self._t_lookup.percentile(50) * 1e3,
            "forward_p50_ms": self._t_forward.percentile(50) * 1e3,
            "forward_batch_rows": sorted(self.ctx.eval_batch_rows_seen),
            "buckets": list(self.buckets),
        }
        if self.cache is not None:
            d.update(cache_hit_rate=self.cache.hit_rate,
                     cache_hits=self.cache.hits,
                     cache_misses=self.cache.misses,
                     cache_rows_resident=len(self.cache))
        return d

    def stop(self):
        if self._batcher is not None:
            self._batcher.close()
