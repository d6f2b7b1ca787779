"""In-process embedding worker (``persia_tpu/worker/worker.py``).

The worker sits between the dense tier and the parameter servers. Forward:
it preprocesses a batch's ID features (dedup, hashstack, prefix), splits
the distinct signs by (PS shard, dim), looks each group up on its PS and
postprocesses the rows into model-ready tensors. Backward: it aggregates
the model's embedding gradients per distinct sign and ships each (shard,
dim) group to its PS's optimizer.

A training batch is kept between the two directions: ``put_batch`` files
its preprocessed features under a ``ref_id`` in the forward buffer, a
training ``lookup`` moves them (with the shard split) to the post-forward
buffer, and ``update_gradients`` consumes them. ``staleness`` counts the
batches looked up for training whose gradients have not been taken yet
(the pipeline's bounded-staleness observable). A failed lookup or update
puts its buffer entry back, so a retry by ``ref_id`` still finds its
batch; an update's entry remembers which (shard, dim) groups landed, and
the retry ships only the others, so no group applies twice. A batch left in either buffer longer than
``buffered_data_expired_sec`` is dropped, by the next ``put_batch`` or by
a sweep thread, and gives its staleness count back.

Fan-out: with more than one PS shard on a host with more than one core,
the (shard, dim) groups go to their shards through a thread pool
(``2 * shards`` threads, at most 32); the native store releases the
interpreter lock for each call, so the shards work at once. Two planes:

- **streaming** (the default): one task per group, whose result scatters
  into the output as soon as it completes; a gradient group ships as
  soon as its last feature has aggregated, while later features are
  still aggregating (with one dim, every group waits for the last
  feature, so the update takes the serialized plane);
- **serialized** (``streaming=False``, or ``PERSIA_WORKER_STREAMING=0``
  when ``streaming`` is None): every lookup result is gathered, then
  scattered; every gradient aggregated, then every group shipped.

Checkpoints: ``dump`` drains this worker's backward engines and dumps
every PS shard through :func:`persia_tpu_torch.checkpoint.dump_sharded`;
``load`` loads (and reshards) a dump onto the shards. Both route by the
uniform table, ``farmhash64(sign) % replica_size``.

Remote parameter servers (:class:`~persia_tpu_torch.service.ps_service.PsClient`,
anything with an ``addr``): the fan-out pool exists whenever there is
more than one shard, and on the streaming plane a shard's groups
multiplex on one connection (``lookup_future``, at most
:attr:`EmbeddingWorker.MUX_WINDOW` in flight) once it has
:attr:`EmbeddingWorker.MUX_MIN_GROUPS` of them. A fan-out that fails on
the connection runs once more after recovery (when something can
recover: a resolver, or replicas that report readiness; an in-process
holder's error reaches the caller, whose pipeline retries by
``ref_id``): with a ``ps_resolver``
the PS list is resolved anew (a replica restarted on another address),
else the replicas that report not ready (restarted on the same address)
are re-armed with the remembered configuration and optimizer; a
healthy replica is never re-armed, which would reset its optimizer
state. An application error from a replica that is not ready re-arms it
the same way. The retried update still ships only the groups that had
not landed, to whichever client now serves their shard.

Tracing: a lookup runs under a ``worker/rpc`` span and an update under
``worker/update_stream``, and each PS call on the fan-out pool under a
``worker/ps_lookup`` / ``worker/ps_update`` child of it (the JAX
worker's names), so that a traced request reaches the PS with its
context. Live routing tables and resharding, the other spans and the
registry gauges belong to later slices of the port.
"""

import logging
import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from persia_tpu_torch import knobs, tracing
from persia_tpu_torch.checkpoint import dump_sharded, load_sharded
from persia_tpu_torch.config import EmbeddingSchema
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.hashing import sign_to_shard
from persia_tpu_torch.pipeline import flush_backward_engines
from persia_tpu_torch.routing import RoutingTable
from persia_tpu_torch.worker import middleware as mw

_logger = logging.getLogger(__name__)


def _wait_all(futures):
    """Wait for every future, then raise the first one's error: no PS call
    of a failed fan-out is still running when its caller retries."""
    for f in futures:
        f.exception()
    for f in futures:
        f.result()


class ForwardBufferFull(RuntimeError):
    """The forward buffer holds ``forward_buffer_size`` batches already."""


def _traced(name: str, ctx, call):
    """``call()`` inside span ``name``, a child of the propagated ``ctx``
    (a fan-out pool thread has no span of its own)."""
    with tracing.span(name, ctx=ctx):
        return call()


class EmbeddingWorker:
    """``ps_clients`` are objects with the ``EmbeddingHolder`` interface
    (``configure``, ``register_optimizer``, ``lookup``,
    ``update_gradients``, ``set_entries``); shard r owns the signs with
    ``farmhash64(sign) % len(ps_clients) == r``. ``streaming`` picks the
    data plane (module docstring); ``ps_resolver`` returns a fresh client
    list after a connection failure; ``forward_buffer_size`` bounds the
    forward buffer. Call :meth:`close` when done."""

    FORWARD_BUFFER_SIZE = 1000
    # multiplex a remote shard's group lookups on one connection only
    # from this many groups; below it a fan-out task a group is cheaper
    MUX_MIN_GROUPS = 3
    # lookups in flight on a multiplexed connection
    MUX_WINDOW = 2

    def __init__(self, schema: EmbeddingSchema, ps_clients: Sequence,
                 buffered_data_expired_sec: float = 1800,
                 streaming: Optional[bool] = None, ps_resolver=None,
                 forward_buffer_size: Optional[int] = None):
        self.schema = schema
        self.ps_clients = list(ps_clients)
        self.replica_size = len(self.ps_clients)
        if self.replica_size == 0:
            raise ValueError("EmbeddingWorker needs at least one PS client")
        self.buffered_data_expired_sec = buffered_data_expired_sec
        self.forward_buffer_size = (forward_buffer_size
                                    or self.FORWARD_BUFFER_SIZE)
        if streaming is None:
            streaming = knobs.get("PERSIA_WORKER_STREAMING")
        self.streaming = bool(streaming)
        self._ps_resolver = ps_resolver
        self._ps_lock = threading.Lock()
        # one recovery pass at a time: two threads failing together must
        # not both re-arm a restarted PS (the second registration would
        # wipe the state the first retry built on)
        self._rearm_lock = threading.Lock()
        self._last_configure: Optional[tuple] = None
        self._last_optimizer: Optional[dict] = None
        # remote replicas always gain from concurrent calls; in-process
        # holders on one core gain nothing from threads
        remote = any(hasattr(c, "addr") for c in self.ps_clients)
        self._fanout: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=min(2 * self.replica_size, 32),
                               thread_name_prefix="ps-fanout")
            if self.replica_size > 1
            and (remote or (os.cpu_count() or 1) > 1)
            else None)
        self._lock = threading.Lock()
        self._next_ref_id = 0
        # ref_id -> (preprocessed features, enter time), awaiting their
        # training lookup
        self._forward_id_buffer: Dict[
            int, Tuple[List[mw.DedupedFeature], float]] = {}
        # ref_id -> (features, shard groups, indices of the groups whose
        # update landed, enter time), awaiting their gradients
        self._post_forward_buffer: Dict[
            int, Tuple[List[mw.DedupedFeature], List[mw.ShardGroup],
                       Set[int], float]] = {}
        # training lookups whose gradients are not taken yet (under _lock)
        self.staleness = 0
        # the expiry sweep: without it a dead pipeline's entries (and
        # their staleness counts) stay until the next put_batch, which
        # for a dead pipeline never comes. It holds the worker weakly,
        # so an unclosed worker is still freed.
        self._sweep_stop = threading.Event()
        self._sweep_thread = threading.Thread(
            target=self._sweep_loop,
            args=(weakref.ref(self), self._sweep_stop,
                  max(1.0, min(buffered_data_expired_sec / 4.0, 30.0))),
            daemon=True, name="worker-expiry-sweep")
        self._sweep_thread.start()

    def configure_parameter_servers(self, init_method: str,
                                    init_params: dict,
                                    admit_probability: float,
                                    weight_bound: float,
                                    enable_weight_bound: bool = True):
        # remembered, so a restarted PS can be re-armed
        self._last_configure = (init_method, init_params, admit_probability,
                                weight_bound, enable_weight_bound)
        for c in self.ps_clients:
            c.configure(init_method, init_params, admit_probability,
                        weight_bound, enable_weight_bound)

    def register_optimizer(self, config: dict):
        self._last_optimizer = config
        for c in self.ps_clients:
            c.register_optimizer(
                config,
                feature_index_prefix_bit=self.schema.feature_index_prefix_bit)

    # --- forward ---------------------------------------------------------

    def put_batch(self, id_type_features: List[IDTypeFeature]) -> int:
        """Ingest a batch before its lookup; returns its ref_id."""
        self._expire_stale()
        with self._lock:
            if len(self._forward_id_buffer) >= self.forward_buffer_size:
                raise ForwardBufferFull(
                    f"forward buffer full ({self.forward_buffer_size})")
            ref_id = self._next_ref_id
            self._next_ref_id += 1
        feats = mw.preprocess_batch(id_type_features, self.schema)
        with self._lock:
            self._forward_id_buffer[ref_id] = (feats, time.monotonic())
        return ref_id

    def _expire_stale(self):
        """Drop the entries of both buffers older than
        ``buffered_data_expired_sec``; each post-forward entry gives back
        the staleness count its lookup took."""
        horizon = time.monotonic() - self.buffered_data_expired_sec
        with self._lock:
            for buf in (self._forward_id_buffer, self._post_forward_buffer):
                expired = [r for r, item in buf.items() if item[-1] < horizon]
                for r in expired:
                    del buf[r]
                if buf is self._post_forward_buffer:
                    self.staleness -= len(expired)

    @staticmethod
    def _sweep_loop(ref, stop: threading.Event, interval: float):
        while not stop.wait(interval):
            worker = ref()
            if worker is None:
                return
            worker._expire_stale()
            del worker

    def close(self):
        """Stop the expiry sweep and the fan-out pool."""
        self._sweep_stop.set()
        if self._fanout is not None:
            self._fanout.shutdown(wait=False)

    def lookup(self, ref_id: int, training: bool = True) -> Dict[str, object]:
        """Look up a batch filed by ``put_batch``. A training lookup keeps
        the batch for its ``update_gradients``."""
        with self._lock:
            item = self._forward_id_buffer.pop(ref_id, None)
        if item is None:
            raise KeyError(f"ref_id {ref_id} not in forward buffer")
        feats = item[0]
        try:
            result, groups = self._lookup_feats(feats, training)
        except BaseException:
            # a retry after the PS recovers must still find its batch
            with self._lock:
                self._forward_id_buffer[ref_id] = item
            raise
        if training:
            with self._lock:
                self._post_forward_buffer[ref_id] = (feats, groups, set(),
                                                     time.monotonic())
                self.staleness += 1
        return result

    def lookup_direct(self, id_type_features: List[IDTypeFeature],
                      training: bool = False) -> Dict[str, object]:
        """One-shot preprocess + lookup without buffers: the inference and
        eval path."""
        feats = mw.preprocess_batch(id_type_features, self.schema)
        return self._lookup_feats(feats, training)[0]

    def lookup_direct_training(self, id_type_features: List[IDTypeFeature]
                               ) -> Tuple[int, Dict[str, object]]:
        """Preprocess + training lookup keeping the gradient state: the
        synchronous training path. Returns (ref_id, lookup results)."""
        ref_id = self.put_batch(id_type_features)
        return ref_id, self.lookup(ref_id, training=True)

    def _lookup_feats(self, feats: List[mw.DedupedFeature], training: bool
                      ) -> Tuple[Dict[str, object], List[mw.ShardGroup]]:
        groups = mw.shard_split(feats, self.schema, self.replica_size)
        mats = mw.alloc_lookup_mats(feats, self.schema)

        def ps_lookup(g):
            return self.ps_clients[g.shard].lookup(g.signs, g.dim, training)

        def lookup_and_scatter(g):
            mw.scatter_group(mats, g, ps_lookup(g))

        def lookup_shard_mux(gs):
            # one remote shard's groups in flight together on this
            # thread's connection, each scattered as it resolves
            client = self.ps_clients[gs[0].shard]

            # a future fails at once on a dead pooled connection, where
            # the blocking call redials
            def issue(g):
                try:
                    return client.lookup_future(g.signs, g.dim, training)
                except (ConnectionError, OSError):
                    return partial(client.lookup, g.signs, g.dim, training)

            def settle(g, resolve):
                try:
                    return resolve()
                except (ConnectionError, OSError):
                    return client.lookup(g.signs, g.dim, training)

            pending = []
            for g in gs:
                if len(pending) >= self.MUX_WINDOW:
                    pg, resolve = pending.pop(0)
                    mw.scatter_group(mats, pg, settle(pg, resolve))
                pending.append((g, issue(g)))
            for g, resolve in pending:
                mw.scatter_group(mats, g, settle(g, resolve))

        def do_lookup():
            if not self.streaming:
                results = self._fan_out([partial(ps_lookup, g)
                                         for g in groups],
                                        "worker/ps_lookup")
                for g, res in zip(groups, results):
                    mw.scatter_group(mats, g, res)
                return
            # each result scatters as its call completes; groups
            # partition the distinct signs, so the scatters are disjoint
            by_shard: Dict[int, List[mw.ShardGroup]] = {}
            for g in groups:
                by_shard.setdefault(g.shard, []).append(g)
            calls = []
            for gs in by_shard.values():
                if (len(gs) >= self.MUX_MIN_GROUPS and hasattr(
                        self.ps_clients[gs[0].shard], "lookup_future")):
                    calls.append(partial(lookup_shard_mux, gs))
                else:
                    calls.extend(partial(lookup_and_scatter, g) for g in gs)
            self._fan_out(calls, "worker/ps_lookup")

        # a retry scatters every group again into the same matrices
        with tracing.span("worker/rpc", groups=len(groups)):
            self._with_ps_retry(do_lookup)
        out = {feat.name: mw.postprocess_feature(
            feat, self.schema.get_slot(feat.name), mat)
            for feat, mat in zip(feats, mats)}
        return out, groups

    # --- backward --------------------------------------------------------

    def update_gradients(self, ref_id: int, grads: Dict[str, np.ndarray],
                         loss_scale: float = 1.0):
        """Aggregate a looked-up batch's model gradients (one array per
        feature name, as ``aggregate_gradients`` takes them) and ship them
        to the parameter servers' optimizers."""
        with self._lock:
            item = self._post_forward_buffer.pop(ref_id, None)
            if item is not None:
                self.staleness -= 1
        if item is None:
            raise KeyError(f"ref_id {ref_id} not in post-forward buffer")
        try:
            self._update_gradients_inner(item, grads, loss_scale)
        except BaseException:
            # put the batch back so a retry still finds it; its landed
            # set keeps the retry from applying those groups again
            with self._lock:
                self._post_forward_buffer[ref_id] = item
                self.staleness += 1
            raise

    def _update_gradients_inner(self, item, grads, loss_scale):
        feats, groups, landed, _ = item
        # before any group ships (the streaming plane ships as it goes)
        missing = [f.name for f in feats if f.name not in grads]
        if missing:
            raise KeyError(f"missing gradients for features {missing}")
        # a retry after recovery ships only the groups still not landed,
        # through the clients serving their shards then
        with tracing.span("worker/update_stream", groups=len(groups)):
            self._with_ps_retry(lambda: self._ship_pending(
                feats, groups, landed, grads, loss_scale))

    def _ship_pending(self, feats, groups, landed, grads, loss_scale):
        todo = [i for i in range(len(groups)) if i not in landed]
        tctx = tracing.current_context()

        def ship(i, group_grads):
            g = groups[i]
            with tracing.span("worker/ps_update", ctx=tctx, shard=g.shard):
                self.ps_clients[g.shard].update_gradients(
                    g.signs, group_grads, g.dim)
            landed.add(i)

        # a group can ship once its last feature (feature_idx is
        # nondecreasing) has aggregated
        by_last: Dict[int, List[int]] = {}
        for i in todo:
            by_last.setdefault(int(groups[i].feature_idx[-1]), []).append(i)
        if not self.streaming or self._fanout is None or len(by_last) <= 1:
            self._update_serialized(feats, groups, todo, ship, grads,
                                    loss_scale)
            return
        futures = []
        per_feature: List[Optional[np.ndarray]] = [None] * len(feats)
        try:
            for fi, feat in enumerate(feats):
                per_feature[fi] = mw.aggregate_gradients(
                    feat, self.schema.get_slot(feat.name), grads[feat.name],
                    loss_scale)
                for i in by_last.get(fi, ()):
                    futures.append(self._fanout.submit(
                        ship, i, mw.gather_group_grads(groups[i],
                                                       per_feature)))
        finally:
            _wait_all(futures)

    def _update_serialized(self, feats, groups, todo, ship, grads,
                           loss_scale):
        """Aggregate every feature, then ship the groups ``todo``."""
        per_feature = [
            mw.aggregate_gradients(feat, self.schema.get_slot(feat.name),
                                   grads[feat.name], loss_scale)
            for feat in feats]
        self._fan_out([
            partial(ship, i, mw.gather_group_grads(groups[i], per_feature))
            for i in todo])

    def _fan_out(self, calls, span: Optional[str] = None) -> list:
        """Run ``calls`` (callables without arguments) on the fan-out
        pool, or in order on this thread when there is no pool or one
        call; wait for every one, then raise the first error. Returns
        their results. Under a traced span each call runs in a ``span``
        child of it."""
        tctx = tracing.current_context() if span else None
        if tctx is not None:
            calls = [partial(_traced, span, tctx, call) for call in calls]
        if self._fanout is None or len(calls) <= 1:
            return [call() for call in calls]
        futures = [self._fanout.submit(call) for call in calls]
        _wait_all(futures)
        return [f.result() for f in futures]

    # --- rows ------------------------------------------------------------

    def lookup_signs(self, signs: np.ndarray, dim: int) -> np.ndarray:
        """Eval-mode rows for already-preprocessed distinct signs (the
        serving tier's hot-row cache miss path). Absent signs read zeros
        and are never created."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        out = np.zeros((len(signs), dim), np.float32)
        for sel, rows in zip(*self._per_shard(
                signs, lambda r, sel: self.ps_clients[r].lookup(
                    signs[sel], dim, False))):
            out[sel] = rows
        return out

    def _per_shard(self, signs: np.ndarray, call):
        """``call(shard, sel)`` for each shard owning some of ``signs``
        (``sel`` their indices), fanned out, once more after a recovery.
        Returns (the selections, the results)."""
        shards = sign_to_shard(signs, self.replica_size)
        sels = [np.nonzero(shards == r)[0] for r in np.unique(shards)]
        return sels, self._with_ps_retry(lambda: self._fan_out(
            [partial(call, int(shards[sel[0]]), sel) for sel in sels]))

    # --- recovery from PS failures ----------------------------------------

    def _with_ps_retry(self, fn):
        """Run a PS fan-out; after a failure, recover and run it once
        more:

        - a connection failure (the client's retries spent): resolve the
          PS list anew with the ``ps_resolver`` (a restart on another
          address), else re-arm the replicas that report not ready (a
          restart on the same address);
        - an application error: a restarted PS answers but lost its
          configuration; re-arm the replicas that report not ready, or
          raise the error when none does.

        Without a resolver and with no replica that reports readiness
        (in-process holders) nothing can recover, and the error reaches
        the caller at once: the pipeline retries by ``ref_id``.
        """
        from persia_tpu_torch.rpc import RpcError

        if self._ps_resolver is None and not any(
                hasattr(c, "ready_for_serving") for c in self.ps_clients):
            return fn()
        try:
            return fn()
        except (ConnectionError, OSError):
            if self._ps_resolver is not None:
                self._refresh_ps_clients()
            else:
                self._rearm_unready_clients()
            return fn()
        except RpcError:
            if not self._rearm_unready_clients():
                raise
            return fn()

    def _rearm_unready_clients(self) -> bool:
        """Push the remembered configuration and optimizer to the
        replicas that report not ready. A ready replica is left alone:
        registering an optimizer again replaces its state. Returns
        whether any replica was re-armed."""
        with self._rearm_lock:
            rearmed = False
            for c in list(self.ps_clients):
                ready_fn = getattr(c, "ready_for_serving", None)
                if ready_fn is None:
                    continue
                try:
                    if ready_fn():
                        continue
                except (ConnectionError, OSError):
                    continue  # still down: the transport retry handles it
                try:
                    if self._last_configure is not None:
                        c.configure(*self._last_configure)
                    if self._last_optimizer is not None:
                        c.register_optimizer(
                            self._last_optimizer,
                            feature_index_prefix_bit=(
                                self.schema.feature_index_prefix_bit))
                    rearmed = True
                    _logger.warning("re-armed restarted PS %s",
                                    getattr(c, "addr", c))
                except Exception as e:  # noqa: BLE001 — the retry decides
                    _logger.warning("re-arm of %s failed: %s",
                                    getattr(c, "addr", c), e)
            return rearmed

    def _refresh_ps_clients(self):
        """Take the resolver's client list (of the same length: the shard
        split stays), close the replaced clients' connections, and re-arm
        the replicas that report not ready."""
        new_clients = list(self._ps_resolver())
        if len(new_clients) != self.replica_size:
            raise RuntimeError(
                f"PS re-resolution returned {len(new_clients)} replicas, "
                f"expected {self.replica_size} (shard routing would "
                f"change)")
        with self._ps_lock:
            old_clients, self.ps_clients = self.ps_clients, new_clients
        for c in old_clients:
            close = getattr(getattr(c, "client", None), "close", None)
            if close is not None and all(c is not n for n in new_clients):
                close()
        _logger.warning("refreshed the PS client list after a connection "
                        "failure")
        self._rearm_unready_clients()

    def lookup_rows_with_state(self, signs: np.ndarray, dim: int,
                               default_state: float = 0.0
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Rows with their optimizer state, for the device cache's miss
        import: on each owning shard a training ``lookup`` creates and
        initializes the missing rows as a training lookup does, then
        ``get_entries`` reads [value | state] of width ``2 * dim`` (the
        non-shared Adagrad's accumulator, the one optimizer the cache
        takes), so a sign that comes back keeps its accumulator. A sign
        the PS did not admit stays absent: value 0, state
        ``default_state``. Returns (vals, state), each (n, dim) f32."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        vals = np.zeros((len(signs), dim), np.float32)
        state = np.full((len(signs), dim), default_state, np.float32)

        def fetch(r, sel):
            client = self.ps_clients[r]
            client.lookup(signs[sel], dim, True)
            return client.get_entries(signs[sel], 2 * dim)

        for sel, (found, vecs) in zip(*self._per_shard(signs, fetch)):
            hit = np.nonzero(found)[0]
            vals[sel[hit]] = vecs[hit, :dim]
            state[sel[hit]] = vecs[hit, dim:]
        return vals, state

    def set_rows(self, signs: np.ndarray, vecs: np.ndarray, dim: int):
        """Write whole rows to their owning PS shards."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        self._per_shard(signs, lambda r, sel: self.ps_clients[r].set_entries(
            signs[sel], dim, vecs[sel]))

    # --- checkpoints -------------------------------------------------------

    def dump(self, dirpath: str):
        """Dump every PS shard into ``dirpath`` once the in-flight
        gradient updates of this worker's backward engines have landed."""
        flush_backward_engines(self)
        dump_sharded(self.ps_clients, dirpath,
                     routing=RoutingTable.uniform(self.replica_size))

    def load(self, dirpath: str):
        """Load the dump in ``dirpath`` onto the PS shards, resharding
        when it was taken over another shard count."""
        load_sharded(self.ps_clients, dirpath,
                     routing=RoutingTable.uniform(self.replica_size))
