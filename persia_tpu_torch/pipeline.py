"""Asynchronous forward and backward pipeline engines
(``persia_tpu/pipeline.py``).

- :class:`ForwardEngine`: a feeder pulls ``PersiaBatch``es from the
  dataset and takes one **embedding-staleness permit** per training batch,
  in sequence order; lookup worker threads ingest each batch into the
  embedding worker, look it up and stage its inputs on the device
  (``ctx.stage_batch``); a reorder heap yields the batches in sequence
  order. ``reproducible=True`` runs one lookup worker.
- :class:`BackwardEngine`: gradient updates queue and ship to the
  embedding worker from background threads, and a batch's permit is
  released only after its update has been applied (or counted lost), so
  at most ``embedding_staleness`` batches are ever looked up ahead of
  their gradients.

``TrainCtx.train_step`` takes the engine's :class:`LookedUpBatch` and
hands its still-on-device packed gradients to the batch's backward
engine, whose thread copies them to the host and unpacks them. Over a
mesh the engine runs on the sparse leader alone (``DataLoader``).

Tracing: each batch's lookup opens a root ``pipeline/lookup`` span (the
trace the worker's and the PS's spans, the trainer's step and the
asynchronous ``pipeline/backward_update`` join), carried on
:attr:`LookedUpBatch.trace`.

Registry series: the backward engine's
``pipeline_backward_pending_updates`` gauge (queued and running
updates), its ``pipeline_gradient_staleness_steps`` histogram (the
batches submitted after a batch before its update applied) and its
``pipeline_lost_updates_total`` counter; the forward engine's
``pipeline_staleness_permits_in_use`` gauge (a
:class:`_GaugedSemaphore`), ``pipeline_lookup_queue_depth`` and
``pipeline_ready_queue_depth``; the ``forward_client_time_cost_sec`` and
``backward_client_time_cost_sec`` histograms (a batch's lookup, and its
update with the copy and unpack). Both engines beat the stall watchdog's
heartbeat and count their work in flight
(:func:`~persia_tpu_torch.tracing.start_deadlock_detection`, armed by a
forward engine under ``PERSIA_DEADLOCK_DETECTION``).
"""

import heapq
import itertools
import logging
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import (Any, Dict, Hashable, Iterator, List, Optional, Sequence,
                    Tuple)

from persia_tpu_torch import tracing
from persia_tpu_torch.data.batch import PersiaBatch
from persia_tpu_torch.metrics import STEP_BUCKETS, default_registry
from persia_tpu_torch.tracing import (
    StageTimer,
    heartbeat,
    start_deadlock_detection,
    work_finished,
    work_started,
)

_logger = logging.getLogger(__name__)

_SENTINEL = object()


def _retry_with_recovery(fn, what: str, max_recoveries: int = 4,
                         stop: Optional[threading.Event] = None):
    """Run ``fn``, retrying after a connection failure (``ConnectionError``
    or ``OSError``) up to ``max_recoveries`` times with a growing pause.
    Shared by the forward lookup and the backward update."""
    attempts = 0
    while True:
        try:
            return fn()
        except (ConnectionError, OSError) as e:
            attempts += 1
            if attempts > max_recoveries or (
                    stop is not None and stop.is_set()):
                raise
            _logger.warning("%s failed (%s); retry %d/%d", what, e,
                            attempts, max_recoveries)
            time.sleep(min(0.5 * attempts, 2.0))


@dataclass
class LookedUpBatch:
    """A batch whose embeddings have been fetched: ready for the dense
    step. ``staged`` carries its device-resident train-step inputs when a
    prefetch worker already ran the host-to-device staging. ``trace`` is
    the ``(trace_id, span_id)`` of the prefetch worker's
    ``pipeline/lookup`` span, which the trainer's step and the batch's
    backward update join (None untraced)."""

    batch: PersiaBatch
    lookup: Dict[str, Any]
    # the worker's opaque ref: an in-process worker's int, a remote
    # worker's (address, id); None for a batch that takes no gradients
    ref_id: Optional[Hashable]
    engine: Optional["ForwardEngine"] = None
    staged: Optional[tuple] = None
    trace: Optional[Tuple[int, int]] = None

    @property
    def requires_grad(self) -> bool:
        return self.batch.requires_grad


@dataclass
class _PackedGrads:
    """A still-on-device packed gradient array awaiting the copy to the
    host and the unpack: the flat per-slot concatenation of ``shapes``,
    or with ``slot_dims`` the batch-major (batch, sum dims) layout of the
    data-parallel step."""

    flat: Any  # a torch tensor in the wire dtype
    shapes: Sequence[Tuple[int, ...]]
    names: Sequence[str]
    slot_dims: Optional[Sequence[int]] = None


class _GaugedSemaphore:
    """A semaphore that mirrors its permits in use into a gauge (pegged
    at the bound: the PS tier is the bottleneck; near zero: the card
    is)."""

    def __init__(self, value: int, gauge):
        self._sem = threading.Semaphore(value)
        self._gauge = gauge

    def acquire(self, *a, **kw):
        got = self._sem.acquire(*a, **kw)
        if got:
            self._gauge.add(1)
        return got

    def release(self):
        self._gauge.dec(1)
        self._sem.release()

    @property
    def _value(self):
        """The permits available, as ``threading.Semaphore``'s."""
        return self._sem._value


def flush_backward_engines(worker, timeout: Optional[float] = None):
    """Flush every BackwardEngine feeding ``worker``: wait for the
    in-flight asynchronous gradient updates (before a checkpoint dump)."""
    for engine in list(getattr(worker, "_backward_engines", ())):
        engine.flush(timeout=timeout)


class BackwardEngine:
    """Asynchronous gradient return path. ``submit`` / ``submit_packed``
    queue a batch's gradients; ``num_workers`` threads apply them through
    ``worker.update_gradients`` and then release the batch's staleness
    permit.

    An update whose connection keeps failing after every retry is dropped
    and counted in ``lost_updates`` (bounded-staleness asynchronous SGD
    tolerates a lost sparse update), and its permit is released. Any other
    error is kept and raised by the next ``submit`` or ``flush``."""

    def __init__(self, worker, num_workers: int = 2,
                 staleness_sem: Optional[threading.Semaphore] = None,
                 loss_scale: float = 1.0, queue_size: int = 16):
        self.worker = worker
        self.staleness_sem = staleness_sem
        self.loss_scale = loss_scale
        # bounded: packed submissions hold device gradient blobs, so a
        # blocking submit is the backpressure when PS updates lag
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._pending = 0
        self._pending_cv = threading.Condition()
        self._errors: List[BaseException] = []
        self.lost_updates = 0  # guarded by _pending_cv
        reg = default_registry()
        self._g_pending = reg.gauge("pipeline_backward_pending_updates")
        # step-shaped buckets: the default sub-second latency bounds
        # would put every observation in one bucket
        self._h_staleness = reg.histogram(
            "pipeline_gradient_staleness_steps",
            help_text="training steps submitted between a batch's "
                      "gradient submit and its PS apply",
            buckets=STEP_BUCKETS)
        self._submit_seq = 0  # guarded by _pending_cv
        self._c_lost = reg.counter("pipeline_lost_updates_total")
        self._timer_hist = StageTimer("backward_client_time_cost_sec").hist
        # register on the worker so checkpoint dumps can quiesce us
        engines = getattr(worker, "_backward_engines", None)
        if engines is None:
            engines = worker._backward_engines = weakref.WeakSet()
        engines.add(self)
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"backward-worker-{i}")
            for i in range(num_workers)
        ]
        for t in self._threads:
            t.start()

    def submit(self, ref_id: int, grads):
        if self._errors:
            # this batch's grads will never enqueue: its permit must not
            # stay captive, or the feeder blocks at the bound forever
            if self.staleness_sem is not None:
                self.staleness_sem.release()
            raise self._errors[0]
        with self._pending_cv:
            self._pending += 1
            self._submit_seq += 1
            seq = self._submit_seq
        self._g_pending.add(1)
        work_started()
        # the submitting thread's span (the trainer's step) parents the
        # update on the backward thread
        self._q.put((ref_id, grads, tracing.current_context(), seq))

    def submit_packed(self, ref_id: int, flat_grads,
                      shapes: Sequence[Tuple[int, ...]],
                      names: Sequence[str],
                      slot_dims: Optional[Sequence[int]] = None):
        """Queue a packed gradient tensor WITHOUT copying it to the host:
        the copy and the unpack run in a backward worker thread, off the
        training thread. ``slot_dims`` names the batch-major layout."""
        self.submit(ref_id, _PackedGrads(flat_grads, shapes, names,
                                         slot_dims))

    def _run(self):
        from persia_tpu_torch.parallel.train import (
            unpack_embedding_grads,
            unpack_embedding_grads_batch_major,
        )

        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            ref_id, grads, tctx, seq = item
            try:
                with self._timer_hist.timer(), \
                        tracing.span("pipeline/backward_update", ctx=tctx,
                                     ref_id=ref_id):
                    if isinstance(grads, _PackedGrads):
                        # .cpu() runs on this thread's current stream, the
                        # default stream the training thread also issues
                        # on, so it is ordered after the kernels that
                        # wrote flat
                        flat = grads.flat.cpu()
                        per_slot = (
                            unpack_embedding_grads(flat, grads.shapes)
                            if grads.slot_dims is None else
                            unpack_embedding_grads_batch_major(
                                flat, grads.slot_dims))
                        grads = dict(zip(grads.names, per_slot))
                    _retry_with_recovery(
                        lambda: self.worker.update_gradients(
                            ref_id, grads, loss_scale=self.loss_scale),
                        "gradient update")
                with self._pending_cv:
                    now_seq = self._submit_seq
                self._h_staleness.observe(now_seq - seq)
                heartbeat()
            except (ConnectionError, OSError) as e:
                # the connection stayed down through every retry: drop
                # this update rather than wedge the engine
                with self._pending_cv:
                    self.lost_updates += 1
                self._c_lost.inc()
                _logger.error("backward update permanently failed (%s); "
                              "counted as lost update #%d", e,
                              self.lost_updates)
            except BaseException as e:  # kept; raised by submit / flush
                _logger.error("backward update failed: %s", e)
                self._errors.append(e)
            finally:
                work_finished()
                self._g_pending.dec(1)
                if self.staleness_sem is not None:
                    self.staleness_sem.release()
                with self._pending_cv:
                    self._pending -= 1
                    self._pending_cv.notify_all()

    def flush(self, timeout: Optional[float] = None):
        """Block until every queued update has been applied."""
        with self._pending_cv:
            ok = self._pending_cv.wait_for(lambda: self._pending == 0,
                                           timeout=timeout)
        if not ok:
            raise TimeoutError("backward engine flush timed out")
        if self._errors:
            raise self._errors[0]

    def shutdown(self):
        for _ in self._threads:
            self._q.put(_SENTINEL)


class ForwardEngine:
    """Prefetching lookup pipeline over ``ctx.worker``."""

    def __init__(self, ctx, num_workers: int = 8, buffer_size: int = 10,
                 reproducible: bool = False,
                 embedding_staleness: Optional[int] = None):
        self.ctx = ctx
        self.worker = ctx.worker
        self.num_workers = num_workers
        self.buffer_size = buffer_size
        self.reproducible = reproducible
        reg = default_registry()
        self.staleness_sem = (
            _GaugedSemaphore(embedding_staleness,
                             reg.gauge("pipeline_staleness_permits_in_use"))
            if embedding_staleness is not None else None)
        self._g_in_q = reg.gauge("pipeline_lookup_queue_depth")
        self._g_out_q = reg.gauge("pipeline_ready_queue_depth")
        self.backward = BackwardEngine(self.worker,
                                       staleness_sem=self.staleness_sem)
        self._forward_hist = StageTimer("forward_client_time_cost_sec").hist
        start_deadlock_detection()

    def _lookup_with_recovery(self, batch: PersiaBatch,
                              stop: Optional[threading.Event] = None):
        """One batch's lookup, surviving connection failures. The worker
        puts its forward-buffer entry back on a failed lookup, so a retry
        by ref_id finds its batch; a ``put_batch`` that succeeded is never
        sent again. A batch whose ID features a data loader already put
        into a remote worker (``remote_ref``) is looked up by that ref."""
        rref = getattr(batch, "remote_ref", None)
        state = {"ref_id": None}

        def attempt():
            if rref is not None:
                return (rref if batch.requires_grad else None), \
                    self.worker.lookup(rref, training=batch.requires_grad)
            if batch.requires_grad:
                if state["ref_id"] is None:
                    state["ref_id"] = self.worker.put_batch(
                        batch.id_type_features)
                return state["ref_id"], self.worker.lookup(
                    state["ref_id"], training=True)
            return None, self.worker.lookup_direct(batch.id_type_features,
                                                   training=False)

        return _retry_with_recovery(attempt, "lookup", stop=stop)

    def run(self, batches: Iterator[PersiaBatch],
            timeout_ms: int = 600_000) -> Iterator[LookedUpBatch]:
        timeout = timeout_ms / 1000.0
        in_q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        errors: List[BaseException] = []
        stop = threading.Event()
        n_workers = 1 if self.reproducible else self.num_workers
        seq_counter = itertools.count()

        def feeder():
            try:
                for batch in batches:
                    if stop.is_set():
                        break
                    # take the permit HERE, in sequence order: taken by the
                    # racing lookup workers, permits could all be held by
                    # out-of-order batches while the next one the reorder
                    # heap needs waits for a permit
                    if batch.requires_grad and self.staleness_sem is not None:
                        self.staleness_sem.acquire()
                    in_q.put((next(seq_counter), batch))
                    self._g_in_q.add(1)
            except BaseException as e:
                errors.append(e)
            finally:
                for _ in range(n_workers):
                    in_q.put(_SENTINEL)

        def lookup_worker():
            while True:
                item = in_q.get()
                if item is _SENTINEL:
                    out_q.put(_SENTINEL)
                    return
                self._g_in_q.dec(1)
                seq, batch = item
                if stop.is_set():
                    # another worker failed: drain, don't process
                    if batch.requires_grad and self.staleness_sem is not None:
                        self.staleness_sem.release()
                    continue
                work_started()
                try:
                    # the batch's root span; the histogram times the
                    # lookup alone, not the staging
                    with tracing.span("pipeline/lookup", root=True,
                                      seq=seq) as sp:
                        with self._forward_hist.timer():
                            ref_id, lookup = self._lookup_with_recovery(
                                batch, stop=stop)
                        staged = None
                        stage = getattr(self.ctx, "stage_batch", None)
                        if stage is not None and batch.requires_grad:
                            # host-to-device staging off the training
                            # thread
                            staged = stage(batch, lookup)
                    heartbeat()
                    out_q.put((seq, LookedUpBatch(batch, lookup, ref_id,
                                                  self, staged,
                                                  trace=sp.ctx)))
                    self._g_out_q.add(1)
                except BaseException as e:
                    # this batch will never train: release its permit, and
                    # stop the feeder taking more
                    if batch.requires_grad and self.staleness_sem is not None:
                        self.staleness_sem.release()
                    stop.set()
                    errors.append(e)
                    out_q.put(_SENTINEL)
                    return
                finally:
                    work_finished()

        feeder_thread = threading.Thread(target=feeder, daemon=True,
                                         name="forward-feeder")
        threads = [feeder_thread] + [
            threading.Thread(target=lookup_worker, daemon=True,
                             name=f"forward-worker-{i}")
            for i in range(n_workers)]
        for t in threads:
            t.start()

        # reorder by sequence number, so iteration order is the dataset's
        # with any number of workers (determinism of the UPDATES needs
        # staleness 1 as well)
        heap: list = []
        finished_workers = 0
        next_seq = 0
        while finished_workers < n_workers:
            item = out_q.get(timeout=timeout)
            if item is _SENTINEL:
                finished_workers += 1
                continue
            self._g_out_q.dec(1)
            heapq.heappush(heap, item)
            while heap and heap[0][0] == next_seq:
                _, lb = heapq.heappop(heap)
                next_seq += 1
                yield lb
        if not errors:
            while heap:
                yield heapq.heappop(heap)[1]
        if errors:
            self._release_abandoned_permits(in_q, out_q, heap, feeder_thread)
            raise errors[0]

    def _release_abandoned_permits(self, in_q, out_q, heap, feeder_thread):
        """After a fatal pipeline error, hand back the permits of batches
        that will never reach a gradient update (queued, looked up but not
        yielded, or waiting in the heap), so an engine that outlives the
        error is not throttled for good."""
        if self.staleness_sem is None:
            return

        def release_for(batch):
            if batch.requires_grad:
                self.staleness_sem.release()

        # heap and out_q first: their permits may be the ones a blocked
        # feeder waits for, and releasing them lets the in_q drain end
        for _, lb in heap:
            release_for(lb.batch)
        while True:
            try:
                item = out_q.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL:
                self._g_out_q.dec(1)
                release_for(item[1].batch)
        deadline = time.monotonic() + 10.0
        while feeder_thread.is_alive() or not in_q.empty():
            try:
                item = in_q.get(timeout=0.2)
            except queue.Empty:
                if time.monotonic() > deadline:
                    break
                continue
            if item is not _SENTINEL:
                self._g_in_q.dec(1)
                release_for(item[1])

    def flush(self, timeout: Optional[float] = None):
        self.backward.flush(timeout=timeout)

    def shutdown(self):
        self.backward.shutdown()
