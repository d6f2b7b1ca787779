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
batch. PS calls are serialized (one group after another); routing epochs,
buffer expiry and the streaming update plane belong to later slices of
the port.
"""

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from persia_tpu_torch.config import EmbeddingSchema
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.hashing import sign_to_shard
from persia_tpu_torch.worker import middleware as mw


class ForwardBufferFull(RuntimeError):
    """The forward buffer holds ``FORWARD_BUFFER_SIZE`` batches already."""


class EmbeddingWorker:
    """``ps_clients`` are objects with the ``EmbeddingHolder`` interface
    (``configure``, ``register_optimizer``, ``lookup``,
    ``update_gradients``, ``set_entries``); shard r owns the signs with
    ``farmhash64(sign) % len(ps_clients) == r``."""

    # batches put but not yet looked up that the worker will hold
    FORWARD_BUFFER_SIZE = 1000

    def __init__(self, schema: EmbeddingSchema, ps_clients: Sequence):
        self.schema = schema
        self.ps_clients = list(ps_clients)
        self.replica_size = len(self.ps_clients)
        if self.replica_size == 0:
            raise ValueError("EmbeddingWorker needs at least one PS client")
        self._lock = threading.Lock()
        self._next_ref_id = 0
        # ref_id -> preprocessed features, awaiting their training lookup
        self._forward_id_buffer: Dict[int, List[mw.DedupedFeature]] = {}
        # ref_id -> (features, shard groups), awaiting their gradients
        self._post_forward_buffer: Dict[
            int, Tuple[List[mw.DedupedFeature], List[mw.ShardGroup]]] = {}
        # training lookups whose gradients are not taken yet (under _lock)
        self.staleness = 0

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
        with self._lock:
            if len(self._forward_id_buffer) >= self.FORWARD_BUFFER_SIZE:
                raise ForwardBufferFull(
                    f"forward buffer full ({self.FORWARD_BUFFER_SIZE})")
            ref_id = self._next_ref_id
            self._next_ref_id += 1
        feats = mw.preprocess_batch(id_type_features, self.schema)
        with self._lock:
            self._forward_id_buffer[ref_id] = feats
        return ref_id

    def lookup(self, ref_id: int, training: bool = True) -> Dict[str, object]:
        """Look up a batch filed by ``put_batch``. A training lookup keeps
        the batch for its ``update_gradients``."""
        with self._lock:
            feats = self._forward_id_buffer.pop(ref_id, None)
        if feats is None:
            raise KeyError(f"ref_id {ref_id} not in forward buffer")
        try:
            result, groups = self._lookup_feats(feats, training)
        except BaseException:
            # a retry after the PS recovers must still find its batch
            with self._lock:
                self._forward_id_buffer[ref_id] = feats
            raise
        if training:
            with self._lock:
                self._post_forward_buffer[ref_id] = (feats, groups)
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
        for g in groups:
            mw.scatter_group(
                mats, g, self.ps_clients[g.shard].lookup(g.signs, g.dim,
                                                         training))
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
            # put the batch back so a retry still finds it; shard groups
            # applied before the failure apply again on that retry
            with self._lock:
                self._post_forward_buffer[ref_id] = item
                self.staleness += 1
            raise

    def _update_gradients_inner(self, item, grads, loss_scale):
        feats, groups = item
        missing = [f.name for f in feats if f.name not in grads]
        if missing:
            raise KeyError(f"missing gradients for features {missing}")
        per_feature = [
            mw.aggregate_gradients(feat, self.schema.get_slot(feat.name),
                                   grads[feat.name], loss_scale)
            for feat in feats]
        for shard, dim, signs, g in mw.shard_gradients(
                feats, self.schema, per_feature, self.replica_size,
                groups=groups):
            self.ps_clients[shard].update_gradients(signs, g, dim)

    # --- rows ------------------------------------------------------------

    def lookup_signs(self, signs: np.ndarray, dim: int) -> np.ndarray:
        """Eval-mode rows for already-preprocessed distinct signs (the
        serving tier's hot-row cache miss path). Absent signs read zeros
        and are never created."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        out = np.zeros((len(signs), dim), np.float32)
        shards = sign_to_shard(signs, self.replica_size)
        for r in np.unique(shards):
            sel = np.nonzero(shards == r)[0]
            out[sel] = self.ps_clients[int(r)].lookup(signs[sel], dim, False)
        return out

    def set_rows(self, signs: np.ndarray, vecs: np.ndarray, dim: int):
        """Write whole rows to their owning PS shards."""
        signs = np.ascontiguousarray(signs, dtype=np.uint64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        shards = sign_to_shard(signs, self.replica_size)
        for r in np.unique(shards):
            sel = np.nonzero(shards == r)[0]
            self.ps_clients[int(r)].set_entries(signs[sel], dim, vecs[sel])
