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
- **serialized** (``streaming=False``): every lookup result is gathered,
  then scattered; every gradient aggregated, then every group shipped.

Checkpoints: ``dump`` drains this worker's backward engines and dumps
every PS shard through :func:`persia_tpu_torch.checkpoint.dump_sharded`;
``load`` loads (and reshards) a dump onto the shards. Both route by the
uniform table, ``farmhash64(sign) % replica_size``.

Live routing tables, resharding, retries across replicas, tracing spans
and registry gauges belong to later slices of the port.
"""

import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from persia_tpu_torch.checkpoint import dump_sharded, load_sharded
from persia_tpu_torch.config import EmbeddingSchema
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.hashing import sign_to_shard
from persia_tpu_torch.pipeline import flush_backward_engines
from persia_tpu_torch.routing import RoutingTable
from persia_tpu_torch.worker import middleware as mw


def _wait_all(futures):
    """Wait for every future, then raise the first one's error: no PS call
    of a failed fan-out is still running when its caller retries."""
    for f in futures:
        f.exception()
    for f in futures:
        f.result()


class ForwardBufferFull(RuntimeError):
    """The forward buffer holds ``FORWARD_BUFFER_SIZE`` batches already."""


class EmbeddingWorker:
    """``ps_clients`` are objects with the ``EmbeddingHolder`` interface
    (``configure``, ``register_optimizer``, ``lookup``,
    ``update_gradients``, ``set_entries``); shard r owns the signs with
    ``farmhash64(sign) % len(ps_clients) == r``. ``streaming`` picks the
    data plane (module docstring). Call :meth:`close` when done."""

    FORWARD_BUFFER_SIZE = 1000

    def __init__(self, schema: EmbeddingSchema, ps_clients: Sequence,
                 buffered_data_expired_sec: float = 1800,
                 streaming: bool = True):
        self.schema = schema
        self.ps_clients = list(ps_clients)
        self.replica_size = len(self.ps_clients)
        if self.replica_size == 0:
            raise ValueError("EmbeddingWorker needs at least one PS client")
        self.buffered_data_expired_sec = buffered_data_expired_sec
        self.streaming = bool(streaming)
        # in-process holders on one core gain nothing from threads
        self._fanout: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=min(2 * self.replica_size, 32),
                               thread_name_prefix="ps-fanout")
            if self.replica_size > 1 and (os.cpu_count() or 1) > 1
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
        for c in self.ps_clients:
            c.configure(init_method, init_params, admit_probability,
                        weight_bound, enable_weight_bound)

    def register_optimizer(self, config: dict):
        for c in self.ps_clients:
            c.register_optimizer(
                config,
                feature_index_prefix_bit=self.schema.feature_index_prefix_bit)

    # --- forward ---------------------------------------------------------

    def put_batch(self, id_type_features: List[IDTypeFeature]) -> int:
        """Ingest a batch before its lookup; returns its ref_id."""
        self._expire_stale()
        with self._lock:
            if len(self._forward_id_buffer) >= self.FORWARD_BUFFER_SIZE:
                raise ForwardBufferFull(
                    f"forward buffer full ({self.FORWARD_BUFFER_SIZE})")
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

        if self.streaming:
            # each result scatters as its call completes; groups
            # partition the distinct signs, so the scatters are disjoint.
            # (The JAX worker multiplexes a shard's groups on one
            # connection through lookup_future, which only remote
            # clients have: that waits for the service tier, ROADMAP.md
            # queue A item 9.)
            self._fan_out([partial(lookup_and_scatter, g) for g in groups])
        else:
            results = self._fan_out([partial(ps_lookup, g) for g in groups])
            for g, res in zip(groups, results):
                mw.scatter_group(mats, g, res)
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
        todo = [i for i in range(len(groups)) if i not in landed]

        def ship(i, group_grads):
            g = groups[i]
            self.ps_clients[g.shard].update_gradients(g.signs, group_grads,
                                                      g.dim)
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

    def _fan_out(self, calls) -> list:
        """Run ``calls`` (callables without arguments) on the fan-out
        pool, or in order on this thread when there is no pool or one
        call; wait for every one, then raise the first error. Returns
        their results."""
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
        (``sel`` their indices), fanned out. Returns (the selections, the
        results)."""
        shards = sign_to_shard(signs, self.replica_size)
        sels = [np.nonzero(shards == r)[0] for r in np.unique(shards)]
        return sels, self._fan_out([partial(call, int(shards[sel[0]]), sel)
                                    for sel in sels])

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
