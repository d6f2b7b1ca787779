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

Routing: every shard decision reads one immutable
:class:`~persia_tpu_torch.routing.RoutingTable` through a
:class:`~persia_tpu_torch.routing.RoutingHolder` (``routing=``, by
default the uniform table, which routes as ``farmhash64(sign) %
replica_size`` and keeps the native split). The reshard controller, or a
``routing_fetch`` pull from the coordinator, installs successor epochs
with :meth:`EmbeddingWorker.apply_routing` (the client list may grow with
it); the predecessor stays for the double-read window until
:meth:`EmbeddingWorker.close_routing_window`. A write bounced with
``routing_stale`` (its slots froze for a migration) settles by itself:
the bounced portion alone is split again by the table whose epoch the
bounce demands (``_settle_stale``; each round returns to the current
epoch after 0.25 s, so an aborted migration settles too), within
``PERSIA_RESHARD_STALE_RETRY_SEC``. A gradient return whose forward split
used an older epoch splits its groups that have not landed again by the
live table.

Checkpoints: ``dump`` drains this worker's backward engines and dumps
every PS shard the live table routes to through
:func:`persia_tpu_torch.checkpoint.dump_sharded` (a uniform table's dump
is the legacy one byte for byte); ``load`` loads (and reshards) a dump
onto them.

Registry series, each labelled by a ``worker`` sequence number: the
stage histograms ``lookup_{preprocess,rpc,postprocess}_time_cost_sec``
and ``update_{aggregate,ship}_time_cost_sec`` (``stage_snapshot`` /
``stage_breakdown`` diff them), and the gauges
``worker_forward_buffer_depth``, ``worker_post_forward_buffer_depth`` and
``worker_staleness``, set under the buffers' lock.
``enable_monitor=True`` feeds each feature's distinct signs to a
:class:`~persia_tpu_torch.worker.monitor.DistinctIdMonitor`.

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

Tracing (the JAX worker's names): a lookup runs its stages under
``worker/preprocess``, ``worker/rpc`` and ``worker/postprocess`` spans,
each PS call on the fan-out pool under a ``worker/ps_lookup`` child of
``worker/rpc``, and a remote shard's multiplexed groups under one
``worker/ps_lookup_mux``. An update that ships groups while later
features aggregate (the streaming plane with a pool, and more than one
last feature) runs under ``worker/update_stream``; any other aggregates
every feature and gathers each group's rows under ``worker/aggregate``,
then ships under ``worker/ship`` (which, as in JAX, also holds a retry
after recovery). Each PS update call is a ``worker/ps_update`` child,
so that a traced request reaches the PS with its context.
"""

import itertools
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
from persia_tpu_torch.metrics import default_registry
from persia_tpu_torch.pipeline import flush_backward_engines
from persia_tpu_torch.routing import (
    RoutingHolder,
    RoutingTable,
    is_routing_stale,
)
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


# a worker's series label: two workers in one process keep their own
_WORKER_SEQ = itertools.count(1)


class _Pending:
    """A looked-up training batch awaiting its gradients: its features,
    the shard groups of its forward split and the routing epoch of that
    split, the indices of the groups whose update landed, and its enter
    time."""

    __slots__ = ("feats", "groups", "epoch", "landed", "t")

    def __init__(self, feats, groups, epoch: int, t: float):
        self.feats = feats
        self.groups = groups
        self.epoch = epoch
        self.landed: Set[int] = set()
        self.t = t


def _traced(name: str, ctx, call):
    """``call()`` inside span ``name``, a child of the propagated ``ctx``
    (a fan-out pool thread has no span of its own)."""
    with tracing.span(name, ctx=ctx):
        return call()


class EmbeddingWorker:
    """``ps_clients`` are objects with the ``EmbeddingHolder`` interface
    (``configure``, ``register_optimizer``, ``lookup``,
    ``update_gradients``, ``set_entries``); shard r owns the signs the
    routing table (``routing``, by default the uniform one:
    ``farmhash64(sign) % len(ps_clients) == r``) routes to it.
    ``streaming`` picks the data plane (module docstring); ``ps_resolver``
    returns a fresh client list after a connection failure;
    ``routing_fetch`` returns the latest published table (or None);
    ``forward_buffer_size`` bounds the forward buffer; ``enable_monitor``
    estimates each feature's distinct ids. Call :meth:`close` when
    done."""

    FORWARD_BUFFER_SIZE = 1000
    # multiplex a remote shard's group lookups on one connection only
    # from this many groups; below it a fan-out task a group is cheaper
    MUX_MIN_GROUPS = 3
    # lookups in flight on a multiplexed connection
    MUX_WINDOW = 2

    def __init__(self, schema: EmbeddingSchema, ps_clients: Sequence,
                 buffered_data_expired_sec: float = 1800,
                 streaming: Optional[bool] = None, ps_resolver=None,
                 forward_buffer_size: Optional[int] = None,
                 enable_monitor: bool = False, routing=None,
                 routing_fetch=None):
        self.schema = schema
        self.ps_clients = list(ps_clients)
        self.replica_size = len(self.ps_clients)
        if self.replica_size == 0:
            raise ValueError("EmbeddingWorker needs at least one PS client")
        if routing is None:
            routing = RoutingTable.uniform(self.replica_size)
        elif routing.num_replicas > self.replica_size:
            raise ValueError(
                f"routing table references {routing.num_replicas} "
                f"replicas but only {self.replica_size} PS clients given")
        self._routing = RoutingHolder(routing)
        self._routing_fetch = routing_fetch
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
        # ref_id -> its _Pending, awaiting the gradients
        self._post_forward_buffer: Dict[int, _Pending] = {}
        # training lookups whose gradients are not taken yet (under _lock)
        self.staleness = 0
        if enable_monitor:
            from persia_tpu_torch.worker.monitor import DistinctIdMonitor

            self.monitor = DistinctIdMonitor()
        else:
            self.monitor = None
        reg = default_registry()
        labels = {"worker": str(next(_WORKER_SEQ))}
        self._t_preprocess = reg.histogram(
            "lookup_preprocess_time_cost_sec", labels)
        self._t_rpc = reg.histogram("lookup_rpc_time_cost_sec", labels)
        self._t_postprocess = reg.histogram(
            "lookup_postprocess_time_cost_sec", labels)
        self._t_aggregate = reg.histogram(
            "update_aggregate_time_cost_sec", labels)
        self._t_ship = reg.histogram("update_ship_time_cost_sec", labels)
        # set under self._lock with the buffers they mirror: a stuck
        # pipeline shows as staleness pegged at its bound or a forward
        # buffer climbing toward ForwardBufferFull
        self._g_forward_buf = reg.gauge("worker_forward_buffer_depth",
                                        labels)
        self._g_post_buf = reg.gauge("worker_post_forward_buffer_depth",
                                     labels)
        self._g_staleness = reg.gauge("worker_staleness", labels)
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

    # --- routing ---------------------------------------------------------

    @property
    def routing(self) -> RoutingTable:
        """The current table (immutable; a reference read)."""
        return self._routing.table

    @property
    def routing_epoch(self) -> int:
        return self._routing.epoch

    @property
    def routing_window(self):
        """``(table, prev)``: the live table and, while a migration's
        window is open, its predecessor, read together (a consumer that
        must agree with this worker's split across epochs, as the
        serving tier's delta subscriber, never sees a torn pair)."""
        return self._routing.window()

    def apply_routing(self, table: RoutingTable, ps_clients=None) -> bool:
        """Swap in a successor table (and, on a scale-out or in, the
        client list) under traffic. A table whose epoch does not advance
        changes nothing (False). The predecessor stays readable until
        :meth:`close_routing_window`; batches split under it keep their
        groups, and a gradient return splits again by the live table."""
        dropped = []
        with self._ps_lock:
            if table.epoch <= self._routing.epoch:
                return False
            new_clients = (list(ps_clients) if ps_clients is not None
                           else self.ps_clients)
            if table.num_replicas > len(new_clients):
                raise ValueError(
                    f"routing epoch {table.epoch} references "
                    f"{table.num_replicas} replicas but worker has "
                    f"{len(new_clients)} PS clients")
            applied = self._routing.apply(table)
            if applied:
                # the client list changes only with its table
                if self.ps_clients is not new_clients:
                    keep = set(map(id, new_clients))
                    dropped = [c for c in self.ps_clients
                               if id(c) not in keep]
                self.ps_clients = new_clients
                self.replica_size = len(new_clients)
        for c in dropped:
            # a replaced client's sockets do not outlive it
            close = getattr(getattr(c, "client", None), "close", None)
            if close is not None:
                try:
                    close()
                except OSError:
                    pass
        if applied and self._fanout is None and len(self.ps_clients) > 1:
            self._fanout = ThreadPoolExecutor(
                max_workers=min(2 * len(self.ps_clients), 32),
                thread_name_prefix="ps-fanout")
        if applied:
            _logger.info("routing epoch %d applied (%d replicas, %d slots)",
                         table.epoch, table.num_replicas, table.num_slots)
        return applied

    def close_routing_window(self):
        """End the double-read window (the migration drained)."""
        self._routing.close_window()

    def _await_epoch(self, min_epoch: int, deadline: float,
                     retry_interval: float = 0.25):
        """Wait until the table's epoch reaches ``min_epoch``, returning
        early every ``retry_interval`` so that the settle loop retries at
        the current epoch (an aborted migration unfreezes its donors and
        never publishes the demanded epoch). Pulls from ``routing_fetch``
        when there is one; a pulled table that needs more replicas than
        this worker has clients for takes the resolver's list."""
        t_next_retry = time.monotonic() + retry_interval
        while self._routing.epoch < min_epoch:
            if self._routing_fetch is not None:
                try:
                    t = self._routing_fetch()
                    if t is not None and t.epoch > self._routing.epoch:
                        try:
                            self.apply_routing(t)
                            continue
                        except ValueError:
                            if self._ps_resolver is not None:
                                clients = list(self._ps_resolver())
                                if len(clients) >= t.num_replicas:
                                    self.apply_routing(t,
                                                       ps_clients=clients)
                                    continue
                except Exception as e:  # noqa: BLE001 — the deadline bounds
                    _logger.debug("routing fetch failed: %s", e)
            now = time.monotonic()
            if now > deadline:
                raise RuntimeError(
                    f"routing epoch {min_epoch} demanded by a resharding "
                    f"PS never arrived within the stale-retry budget")
            if now >= t_next_retry:
                return
            time.sleep(0.01)

    @staticmethod
    def _stale_deadline() -> float:
        return time.monotonic() + float(
            knobs.get("PERSIA_RESHARD_STALE_RETRY_SEC"))

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
            self._sync_gauges_locked()
        return ref_id

    def _sync_gauges_locked(self):
        """The buffer depths and the staleness into their gauges (the
        caller holds ``_lock``)."""
        self._g_forward_buf.set(len(self._forward_id_buffer))
        self._g_post_buf.set(len(self._post_forward_buffer))
        self._g_staleness.set(self.staleness)

    def _expire_stale(self):
        """Drop the entries of both buffers older than
        ``buffered_data_expired_sec``; each post-forward entry gives back
        the staleness count its lookup took."""
        horizon = time.monotonic() - self.buffered_data_expired_sec
        with self._lock:
            for buf, enter_time in (
                    (self._forward_id_buffer, lambda item: item[1]),
                    (self._post_forward_buffer, lambda item: item.t)):
                expired = [r for r, item in buf.items()
                           if enter_time(item) < horizon]
                for r in expired:
                    del buf[r]
                if buf is self._post_forward_buffer:
                    self.staleness -= len(expired)
            self._sync_gauges_locked()

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

    # --- observability -----------------------------------------------------

    STAGE_NAMES = ("preprocess", "rpc", "postprocess", "aggregate", "ship")

    def _stage_hists(self):
        return dict(zip(self.STAGE_NAMES, (
            self._t_preprocess, self._t_rpc, self._t_postprocess,
            self._t_aggregate, self._t_ship)))

    def stage_snapshot(self) -> Dict[str, tuple]:
        """(count, total seconds) of each worker-cycle stage; diff two
        with :meth:`stage_breakdown`."""
        return {k: h.snapshot() for k, h in self._stage_hists().items()}

    @staticmethod
    def stage_breakdown(before: Dict[str, tuple],
                        after: Dict[str, tuple]) -> Dict[str, dict]:
        """Each stage's {count, total_sec, avg_ms} between two
        snapshots."""
        out = {}
        for k in before:
            n = after[k][0] - before[k][0]
            sec = after[k][1] - before[k][1]
            out[k] = {"count": n, "total_sec": round(sec, 4),
                      "avg_ms": round(sec / n * 1e3, 3) if n else 0.0}
        return out

    def lookup(self, ref_id: int, training: bool = True) -> Dict[str, object]:
        """Look up a batch filed by ``put_batch``. A training lookup keeps
        the batch for its ``update_gradients``."""
        with self._lock:
            item = self._forward_id_buffer.pop(ref_id, None)
            self._sync_gauges_locked()
        if item is None:
            raise KeyError(f"ref_id {ref_id} not in forward buffer")
        feats = item[0]
        try:
            result, groups, epoch = self._lookup_feats(feats, training)
        except BaseException:
            # a retry after the PS recovers must still find its batch
            with self._lock:
                self._forward_id_buffer[ref_id] = item
                self._sync_gauges_locked()
            raise
        if training:
            with self._lock:
                self._post_forward_buffer[ref_id] = _Pending(
                    feats, groups, epoch, time.monotonic())
                self.staleness += 1
                self._sync_gauges_locked()
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
                      ) -> Tuple[Dict[str, object], List[mw.ShardGroup],
                                 int]:
        """The lookup fan-out; returns (the rows a feature, the shard
        groups, the routing epoch that split them)."""
        if self.monitor is not None:
            for f in feats:
                self.monitor.observe(f.name, f.distinct_signs)
        routing = self._routing.table
        with self._t_preprocess.timer(), tracing.span("worker/preprocess"):
            groups = mw.shard_split(feats, self.schema,
                                    routing.num_replicas, routing=routing)
            mats = mw.alloc_lookup_mats(feats, self.schema)
        # the fan-out pool's threads have no span of their own: each call
        # parents to the worker/rpc span, captured when the fan-out runs
        tctx = None

        def ps_lookup(g):
            with tracing.span("worker/ps_lookup", ctx=tctx, shard=g.shard,
                              dim=g.dim, n=len(g.signs)):
                try:
                    return self.ps_clients[g.shard].lookup(g.signs, g.dim,
                                                           training)
                except Exception as e:  # noqa: BLE001 — settled or raised
                    return self._settle_stale_lookup(g, training, e)

        def lookup_and_scatter(g):
            mw.scatter_group(mats, g, ps_lookup(g))

        def lookup_shard_mux(gs):
            with tracing.span("worker/ps_lookup_mux", ctx=tctx,
                              shard=gs[0].shard, groups=len(gs)):
                mux_groups(gs)

        def mux_groups(gs):
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
                    return ps_lookup(g)
                except Exception as e:  # noqa: BLE001 — settled or raised
                    return self._settle_stale_lookup(g, training, e)

            pending = []
            for g in gs:
                if len(pending) >= self.MUX_WINDOW:
                    pg, resolve = pending.pop(0)
                    mw.scatter_group(mats, pg, settle(pg, resolve))
                pending.append((g, issue(g)))
            for g, resolve in pending:
                mw.scatter_group(mats, g, settle(g, resolve))

        def do_lookup():
            nonlocal tctx
            tctx = tracing.current_context()
            if not self.streaming:
                results = self._fan_out([partial(ps_lookup, g)
                                         for g in groups])
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
            self._fan_out(calls)

        # a retry scatters every group again into the same matrices
        with self._t_rpc.timer(), tracing.span("worker/rpc",
                                               groups=len(groups)):
            self._with_ps_retry(do_lookup)
        with self._t_postprocess.timer(), \
                tracing.span("worker/postprocess"):
            out = {feat.name: mw.postprocess_feature(
                feat, self.schema.get_slot(feat.name), mat)
                for feat, mat in zip(feats, mats)}
        return out, groups, routing.epoch

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
            self._sync_gauges_locked()
        if item is None:
            raise KeyError(f"ref_id {ref_id} not in post-forward buffer")
        try:
            self._update_gradients_inner(ref_id, item, grads, loss_scale)
        except BaseException:
            # put the batch back so a retry still finds it; its landed
            # set keeps the retry from applying those groups again
            with self._lock:
                self._post_forward_buffer[ref_id] = item
                self.staleness += 1
                self._sync_gauges_locked()
            raise

    def _update_gradients_inner(self, ref_id, item: _Pending, grads,
                                loss_scale):
        # before any group ships (the streaming plane ships as it goes)
        missing = [f.name for f in item.feats if f.name not in grads]
        if missing:
            raise KeyError(f"missing gradients for features {missing}")
        routing = self._routing.table
        if item.epoch != routing.epoch:
            # a reshard cut over between this batch's forward and its
            # gradients: its split routes by a retired table, whose
            # donors may have disarmed their capture (the moved rows
            # there are unreachable). The groups not landed yet split
            # again by the live table.
            _logger.info(
                "gradient return for ref %s crosses routing epochs "
                "(%d -> %d); re-splitting by the live table", ref_id,
                item.epoch, routing.epoch)
            item.groups = _resplit(item.groups, item.landed, routing)
            item.landed = set()
            item.epoch = routing.epoch
        # a retry after recovery ships only the groups still not landed,
        # through the clients serving their shards then
        if self._streams(item):
            with tracing.span("worker/update_stream",
                              groups=len(item.groups)):
                self._with_ps_retry(lambda: self._ship_streaming(
                    item, grads, loss_scale))
            return
        with self._t_aggregate.timer(), tracing.span("worker/aggregate"):
            per_feature = [
                mw.aggregate_gradients(feat, self.schema.get_slot(feat.name),
                                       grads[feat.name], loss_scale)
                for feat in item.feats]
            gathered = {i: mw.gather_group_grads(g, per_feature)
                        for i, g in enumerate(item.groups)
                        if i not in item.landed}
        with self._t_ship.timer(), tracing.span("worker/ship"):
            self._with_ps_retry(lambda: self._ship_aggregated(
                item, gathered))

    @staticmethod
    def _by_last(item: _Pending) -> Dict[int, List[int]]:
        """The groups not landed yet, by their last feature
        (``feature_idx`` is nondecreasing): a group can ship once that
        feature has aggregated."""
        by_last: Dict[int, List[int]] = {}
        for i, g in enumerate(item.groups):
            if i not in item.landed:
                by_last.setdefault(int(g.feature_idx[-1]), []).append(i)
        return by_last

    def _streams(self, item: _Pending) -> bool:
        """Ship groups while later features aggregate: a pool and more
        than one last feature (otherwise every group waits for the same
        one, and the batch aggregates once, then ships)."""
        return (self.streaming and self._fanout is not None
                and len(self._by_last(item)) > 1)

    def _shipper(self, item: _Pending):
        """``ship(i, group_grads)``: group ``i`` to its shard, in a
        ``worker/ps_update`` span child of the calling thread's span; a
        group that lands joins ``item.landed``."""
        tctx = tracing.current_context()

        def ship(i, group_grads):
            g = item.groups[i]
            with tracing.span("worker/ps_update", ctx=tctx, shard=g.shard):
                try:
                    self.ps_clients[g.shard].update_gradients(
                        g.signs, group_grads, g.dim)
                except Exception as e:  # noqa: BLE001 — settled or raised
                    self._settle_stale_update(g.signs, group_grads, g.dim,
                                              e)
            item.landed.add(i)

        return ship

    def _ship_streaming(self, item: _Pending, grads, loss_scale):
        by_last = self._by_last(item)
        ship = self._shipper(item)
        futures = []
        per_feature: List[Optional[np.ndarray]] = [None] * len(item.feats)
        agg_sec = 0.0
        try:
            for fi, feat in enumerate(item.feats):
                t0 = time.perf_counter()
                per_feature[fi] = mw.aggregate_gradients(
                    feat, self.schema.get_slot(feat.name), grads[feat.name],
                    loss_scale)
                ready = [(i, mw.gather_group_grads(item.groups[i],
                                                   per_feature))
                         for i in by_last.get(fi, ())]
                agg_sec += time.perf_counter() - t0
                for i, gmat in ready:
                    futures.append(self._fanout.submit(ship, i, gmat))
        finally:
            self._t_aggregate.observe(agg_sec)
            with self._t_ship.timer():
                _wait_all(futures)

    def _ship_aggregated(self, item: _Pending, gathered):
        """Ship every group not landed yet, from ``gathered`` (group index
        to its gradient rows)."""
        ship = self._shipper(item)
        self._fan_out([partial(ship, i, gmat)
                       for i, gmat in gathered.items()
                       if i not in item.landed])

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

    # --- the reshard cutover's settlement ----------------------------------

    def _settle_stale(self, signs, exc, ship_fn, prepare_fn=None):
        """The bounce-retry protocol of every write path. A shipment
        bounced with ``routing_stale`` (its slots froze for a migration)
        splits again, alone, by the current table and ships to each new
        owner: landed portions are not touched, and the migration replays
        every captured row to the target before the new epoch publishes,
        so a re-routed portion lands where its rows already are. Each
        round waits for the demanded epoch at most 0.25 s, so an aborted
        migration settles at the current one. ``ship_fn(replica, sel)``
        ships the sign indices ``sel``; a second reshard bouncing a retry
        loops until ``PERSIA_RESHARD_STALE_RETRY_SEC``.

        A connection failure (the original one, or one in a round: a
        replica killed during the cutover) is settled here too, when
        something can recover (a resolver, or replicas that report
        readiness): the client tier recovers first, and each round splits
        the failed portion by the then current table. The
        caller's whole-fan-out retry would ship its pre-reshard groups
        to a restarted donor's stale copies instead. Before each ship of
        such a round ``prepare_fn(replica, sel)`` runs (the update path's
        training lookup re-creates rows a restarted replica lost). A
        portion that never settles raises the last connection error at
        the deadline; any other error is raised at once."""
        from persia_tpu_torch.rpc import RpcError

        last_conn_exc = None
        min_epoch = is_routing_stale(exc)
        if min_epoch is None:
            if not (isinstance(exc, (ConnectionError, OSError))
                    and self._can_recover()):
                raise exc
            last_conn_exc = exc
            min_epoch = self._routing.epoch
        deadline = self._stale_deadline()
        need_prepare = last_conn_exc is not None
        if need_prepare:
            # the client's own retries are spent: recover before the
            # first round, as the whole-fan-out retry would
            self._recover_transport()
        pending = np.arange(len(signs), dtype=np.int64)
        while len(pending):
            if time.monotonic() > deadline:
                if last_conn_exc is not None:
                    raise last_conn_exc
                raise RuntimeError(
                    "routing_stale bounces did not settle within the "
                    "stale-retry budget (a replica is refusing writes "
                    "for slots the current table routes to it)")
            self._await_epoch(min_epoch, deadline)
            shards = self._routing.table.replica_of(signs[pending])
            bounced = []
            conn_failed = False
            for r in np.unique(shards):
                sel = pending[np.nonzero(shards == r)[0]]
                try:
                    if need_prepare and prepare_fn is not None:
                        prepare_fn(int(r), sel)
                    ship_fn(int(r), sel)
                except Exception as e:  # noqa: BLE001 — sorted below
                    me = is_routing_stale(e)
                    if me is not None:
                        min_epoch = max(min_epoch, me)
                        bounced.append(sel)
                        continue
                    if isinstance(e, (ConnectionError, OSError)):
                        conn_failed = True
                        last_conn_exc = e
                        bounced.append(sel)
                        continue
                    if (isinstance(e, RpcError)
                            and self._rearm_unready_clients()):
                        # a restored but blank replica, re-armed in place
                        need_prepare = True
                        bounced.append(sel)
                        continue
                    raise
            if conn_failed:
                need_prepare = True
                self._recover_transport()
            pending = (np.concatenate(bounced) if bounced
                       else pending[:0])
            if len(pending):
                # a bounce at the current epoch: the freeze window is
                # still closing; a downed replica needs its restart
                time.sleep(0.2 if conn_failed else 0.005)

    def _recover_transport(self):
        """One recovery pass after a connection failure: the resolver's
        new client list, else the not-ready replicas re-armed. A replica
        still down is left to the settle loop's deadline."""
        try:
            if self._ps_resolver is not None:
                self._refresh_ps_clients()
            else:
                self._rearm_unready_clients()
        except Exception as e:  # noqa: BLE001 — the deadline bounds
            _logger.debug("recovery pass failed: %s", e)

    def _settle_stale_lookup(self, group, training: bool, exc):
        signs, dim = group.signs, group.dim
        res = np.empty((len(signs), dim), np.float32)

        def ship(r, sel):
            res[sel] = self.ps_clients[r].lookup(signs[sel], dim, training)

        self._settle_stale(signs, exc, ship)
        return res

    def _settle_stale_update(self, signs, gmat, dim, exc):
        # in a recovery round a training lookup first re-creates the rows
        # a restarted replica lost (the PS drops gradients of missing
        # rows, so the update would be acked and not applied)
        self._settle_stale(
            signs, exc,
            lambda r, sel: self.ps_clients[r].update_gradients(
                signs[sel], gmat[sel], dim),
            prepare_fn=lambda r, sel: self.ps_clients[r].lookup(
                signs[sel], dim, True))

    def _settle_stale_set(self, signs, vecs, dim, exc):
        self._settle_stale(
            signs, exc,
            lambda r, sel: self.ps_clients[r].set_entries(
                signs[sel], dim, vecs[sel]))

    # --- rows ------------------------------------------------------------

    def lookup_signs(self, signs: np.ndarray, dim: int) -> np.ndarray:
        """Eval-mode rows for already-preprocessed distinct signs (the
        serving tier's hot-row cache miss path). Absent signs read zeros
        and are never created. In a reshard's double-read window, a moved
        sign that reads all-zero from its new owner is read from its
        previous one, so an epoch swap never serves a transient zero for
        a row the fleet holds."""
        routing, prev = self._routing.window()
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        out = np.zeros((len(signs), dim), np.float32)
        if len(signs) == 0:
            return out
        with self._t_rpc.timer():
            sels, results = self._per_shard(
                signs, lambda r, sel: self.ps_clients[r].lookup(
                    signs[sel], dim, False), routing, "worker/ps_lookup")
        for sel, rows in zip(sels, results):
            out[sel] = rows
        if prev is not None and prev.num_slots == routing.num_slots:
            moved = np.nonzero(prev.replica_of(signs)
                               != routing.replica_of(signs))[0]
            empty = moved[~out[moved].any(axis=1)]
            if len(empty):
                old_owner = prev.replica_of(signs[empty])
                for r in np.unique(old_owner):
                    sel = empty[np.nonzero(old_owner == r)[0]]
                    try:
                        out[sel] = self.ps_clients[int(r)].lookup(
                            signs[sel], dim, False)
                    except Exception as e:  # noqa: BLE001 — keep zeros
                        _logger.debug("double read on donor %d: %s",
                                      int(r), e)
        return out

    def _per_shard(self, signs: np.ndarray, call, routing=None,
                   span: Optional[str] = None):
        """``call(shard, sel)`` for each shard owning some of ``signs``
        (``sel`` their indices) under ``routing`` (default the live
        table), fanned out, once more after a recovery; each in a
        ``span`` child of the caller's span when given. Returns (the
        selections, the results)."""
        routing = routing or self._routing.table
        shards = routing.replica_of(signs)
        sels = [np.nonzero(shards == r)[0] for r in np.unique(shards)]
        return sels, self._with_ps_retry(lambda: self._fan_out(
            [partial(call, int(shards[sel[0]]), sel) for sel in sels],
            span))

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

        if not self._can_recover():
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

    def _can_recover(self) -> bool:
        """Whether a failed PS call can recover here: with a resolver, or
        with replicas that report their readiness (not in-process
        holders, whose errors reach the caller at once)."""
        return self._ps_resolver is not None or any(
            hasattr(c, "ready_for_serving") for c in self.ps_clients)

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
        """Write whole rows to their owning PS shards (a write to frozen
        moving slots settles as a gradient shipment does)."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)

        def push(r, sel):
            try:
                self.ps_clients[r].set_entries(signs[sel], dim, vecs[sel])
            except Exception as e:  # noqa: BLE001 — settled or raised
                self._settle_stale_set(signs[sel], vecs[sel], dim, e)

        self._per_shard(signs, push)

    # --- checkpoints -------------------------------------------------------

    def dump(self, dirpath: str):
        """Dump every PS shard the live table routes to into ``dirpath``
        once the in-flight gradient updates of this worker's backward
        engines have landed."""
        flush_backward_engines(self)
        t = self._routing.table
        dump_sharded(self.ps_clients[:t.num_replicas], dirpath, routing=t)

    def load(self, dirpath: str):
        """Load the dump in ``dirpath`` onto the PS shards, resharding
        when it was taken over another table."""
        t = self._routing.table
        load_sharded(self.ps_clients[:t.num_replicas], dirpath, routing=t)


def _resplit(groups: List[mw.ShardGroup], landed: Set[int],
             routing: RoutingTable) -> List[mw.ShardGroup]:
    """The groups not in ``landed``, each split by ``routing``'s owner of
    its signs (features stay in batch order inside a piece)."""
    out = []
    for i, g in enumerate(groups):
        if i in landed:
            continue
        owners = routing.replica_of(g.signs)
        for r in np.unique(owners):
            sel = np.nonzero(owners == r)[0]
            out.append(mw.ShardGroup(int(r), g.dim, g.signs[sel],
                                     g.feature_idx[sel],
                                     g.distinct_idx[sel]))
    return out
