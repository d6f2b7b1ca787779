"""User-facing contexts (``persia_tpu/ctx.py``).

- :func:`current_ctx` and the context stack: contexts nest, the innermost
  entered one is current (an embedding optimizer's ``apply()`` registers
  through it).
- :class:`EmbeddingCtx`: parameter-server configuration, feature
  preparation and the eval forward.
- :class:`TrainCtx`: the hybrid train step (training lookup -> packed
  dense step on the device -> sparse update), synchronous on a raw
  batch or pipelined on a ``DataLoader``'s looked-up batch, job
  snapshots and ``resume_from`` (:mod:`persia_tpu_torch.snapshot`), and
  :func:`eval_ctx` over it. Over a mesh of ranks (``mesh=``) the dense
  step is data-parallel and the mesh's rank 0 is the sparse leader. With
  ``device_cache_capacity`` hot rows live and train on the device
  (:mod:`persia_tpu_torch.parallel.cached_engine`).
- :class:`InferCtx`: eval-mode lookups and forward for serving.

The embedding tier is reached through an
:class:`~persia_tpu_torch.worker.worker.EmbeddingWorker`. Host numpy goes
to the device through pinned buffers with asynchronous copies on the
current stream.
"""

import logging
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from persia_tpu_torch.config import EmbeddingSchema, GlobalConfig
from persia_tpu_torch.data.batch import PersiaBatch
from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.embedding import (
    EmbeddingConfig,
    get_default_embedding_config,
)
from persia_tpu_torch.worker.middleware import RawEmbedding, SumEmbedding

_logger = logging.getLogger(__name__)

_ctx_lock = threading.Lock()
_ctx_stack: List["BaseCtx"] = []


def current_ctx() -> Optional["BaseCtx"]:
    return _ctx_stack[-1] if _ctx_stack else None


class BaseCtx:
    """Contexts nest; ``current_ctx`` returns the innermost entered one."""

    def __enter__(self):
        with _ctx_lock:
            _ctx_stack.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        with _ctx_lock:
            if self in _ctx_stack:
                _ctx_stack.remove(self)
        return False


def _check_model_device(model, device: torch.device):
    for p in model.parameters():
        if p.device.type != device.type:
            raise ValueError(
                f"model parameters live on {p.device}, the context on "
                f"{device}; build the model on the same device")


class EmbeddingCtx(BaseCtx):
    def __init__(self, model=None, schema: Optional[EmbeddingSchema] = None,
                 worker=None,
                 embedding_config: Optional[EmbeddingConfig] = None,
                 global_config: Optional[GlobalConfig] = None,
                 device: DeviceLike = None):
        self.model = model
        self.schema = schema if schema is not None else (
            worker.schema if worker is not None else None)
        self.worker = worker
        self.embedding_config = (embedding_config
                                 or get_default_embedding_config())
        self.global_config = global_config or GlobalConfig()
        self.device = resolve_device(device)
        self._configured_servers = False

    def __enter__(self):
        super().__enter__()
        if self.worker is not None and not self._configured_servers:
            self.configure_embedding_parameter_servers()
        return self

    def configure_embedding_parameter_servers(self):
        """Send the initialization, admission and weight-bound
        hyperparameters to every parameter server."""
        ec = self.embedding_config
        init = self.schema.initialization if self.schema else None
        if init is not None and init.method.value != "bounded_uniform":
            method, params = init.method.value, init.to_params()
        else:
            lower, upper = ec.emb_initialization
            method, params = "bounded_uniform", {"lower": lower,
                                                 "upper": upper}
        self.worker.configure_parameter_servers(
            method, params, ec.admit_probability, ec.weight_bound,
            enable_weight_bound=True)
        self._configured_servers = True

    def register_optimizer(self, optimizer):
        """Called by an embedding optimizer's ``apply()``."""
        self.worker.register_optimizer(optimizer.config)

    def to_device(self, arr: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        t = (arr if isinstance(arr, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(arr)))
        if self.device.type == "cuda":
            # the caching host allocator keeps the pinned block alive until
            # the asynchronous copy has run
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def prepare_features(self, batch: PersiaBatch, lookup: Dict[str, Any]
                         ) -> Tuple[List[torch.Tensor], List[Any],
                                    List[torch.Tensor]]:
        """Worker lookup results -> device-ready model inputs; labels stay
        on the host."""
        non_id = [self.to_device(f.data) for f in batch.non_id_type_features]
        labels = [torch.from_numpy(l.data) for l in batch.labels]
        emb_inputs: List[Any] = []
        for f in batch.id_type_features:
            r = lookup[f.name]
            if isinstance(r, SumEmbedding):
                emb_inputs.append(self.to_device(r.embeddings))
            elif isinstance(r, RawEmbedding):
                emb_inputs.append((self.to_device(r.embeddings),
                                   self.to_device(r.index)))
            else:
                raise TypeError(f"unexpected lookup result {type(r)}")
        return non_id, emb_inputs, labels

    def forward(self, batch: PersiaBatch):
        """Eval/infer forward: direct lookup + model apply."""
        lookup = self.worker.lookup_direct(batch.id_type_features,
                                           training=False)
        return self.forward_prepared(batch, lookup)

    def forward_prepared(self, batch: PersiaBatch, lookup: Dict[str, Any]):
        """Forward from an already-performed lookup: the serving tier's
        entry point (its hot-row cache resolves the embeddings itself)."""
        non_id, emb_inputs, labels = self.prepare_features(batch, lookup)
        return self._apply_model(non_id, emb_inputs), labels

    def _apply_model(self, non_id, emb_inputs):
        raise NotImplementedError

    # --- checkpoints --------------------------------------------------------

    def dump_checkpoint(self, dst_dir: str, with_dense: bool = True):
        """The PS shards and, with ``with_dense``, the model's (and a
        training context's dense optimizer's) state as ``dense.pt``."""
        from persia_tpu_torch import checkpoint as ckpt

        ckpt.dump_checkpoint(self, dst_dir, with_dense=with_dense)

    def load_checkpoint(self, src_dir: str, with_dense: bool = True):
        from persia_tpu_torch import checkpoint as ckpt

        ckpt.load_checkpoint(self, src_dir, with_dense=with_dense)


STAGES = ("lookup", "h2d", "dense", "d2h", "update")

# what a TrainCtx over a mesh does not do yet, and the ROADMAP.md item
# each waits for
_MESH_WAITS = "ROADMAP.md queue A item 3c (the pipeline, snapshots and " \
    "checkpoints on a mesh)"


class TrainCtx(EmbeddingCtx):
    """Training context: lookup, dense step, sparse update.

    ``dense_optimizer`` is a ``torch.optim.Optimizer`` over the model's
    parameters (``torch.optim.Adam(model.parameters(), lr=1e-3)`` is the
    counterpart of ``optax.adam(1e-3)``); ``embedding_optimizer`` a
    :mod:`persia_tpu_torch.embedding.optim` config, registered on the
    parameter servers on ``__enter__``. With ``seed`` the dense weights are
    drawn anew (:func:`persia_tpu_torch.weights.init_params`); without it
    the module's current weights are the starting point. ``device``
    defaults to CUDA and must be where the model lives.

    ``stage_seconds`` accumulates the host time of each part of a step
    (:data:`STAGES`). The device runs asynchronously, so its work lands in
    whichever stage waits for it (``d2h`` at the latest); with
    ``sync_stages`` the context synchronizes the device at the end of
    each stage, which makes the split honest and the step slower. On a
    pipelined step the lookup and ``h2d`` ran in a prefetch worker and the
    ``d2h`` and sparse update run in a backward worker, so the training
    thread books ``dense`` and, for the hand-over to the backward engine,
    ``update``.

    ``loss_fn(pred, label)`` is the step's loss on the device, by default
    :func:`~persia_tpu_torch.parallel.train.bce_loss`; the label is the
    batch's first label as it is, (bs, 1) or (bs, k) for k tasks. The
    step runs the model in train mode (batch norm takes the batch's
    statistics and moves its running ones); the eval forward runs it in
    eval mode (batch norm reads the running statistics).

    ``grad_update_interval`` is stored, as the JAX package stores it; no
    step reads it there either.

    ``resume_from`` names a snapshot directory or a parent of snapshots
    (the newest complete one is taken), resolved and verified here; on
    ``__enter__`` the PS shards roll back to it, the model and
    ``dense_optimizer`` take its dense state and the step counter its
    step. ``resume_cursor`` is its data cursor, from which the caller
    resumes the batch stream. :meth:`snapshot` takes one.

    ``mesh`` (:func:`persia_tpu_torch.parallel.mesh.make_mesh`) makes the
    step data-parallel over the mesh's ranks, as the JAX package's one
    controller over many devices is. Every rank builds its context and
    calls ``train_step`` on the same global batch (checked each step).
    The mesh's rank 0 is the sparse leader: only it holds a ``worker``
    (the others pass ``worker=None``), looks the batch up, broadcasts the
    packed wire (and raw slots' index tensors) to the others, and ships
    one gradient update per global batch to the PS. The dense weights
    start as the leader's. When every slot is summed and the batch
    divides the data axis, each rank trains its own rows
    (:func:`~persia_tpu_torch.parallel.train.make_packed_train_step_ddp`,
    dense gradients averaged in f32, or ``grad_reduce_dtype="bf16"`` /
    ``"int8_ef"``) and the leader gathers the batch-major embedding
    gradients, which are the world size times the single-device step's,
    as in JAX; otherwise every rank runs the single-device step on the
    whole batch (the gradients averaged in f32, which keeps the ranks
    equal) and the leader ships its own. ``_ddp`` says which path ran.
    ``eval_ctx`` evaluates on the leader. A ``DataLoader``, snapshots,
    ``resume_from`` and checkpoints on a mesh raise
    ``NotImplementedError``.

    ``device_cache_capacity`` keeps that many hot rows, and their Adagrad
    state, on the device: each step maps its signs to cache slots, imports
    only the misses (from the victim buffer or the PS), trains the dense
    tower and the cached rows on the device, and writes evicted rows back
    to the PS on a flush thread
    (:class:`~persia_tpu_torch.parallel.cached_engine.DeviceCacheEngine`,
    built at the first batch). ``device_cache_admission`` is the mapper's
    policy, ``"lru"`` or ``"hotness"`` (default the ``PERSIA_TIER_ADMIT``
    knob). Its envelope, as the JAX package's: the client ``Adagrad``, not
    vectorwise shared; summed slots with ``pooling="sum"``; one dim for
    every slot; a batch whose features are all
    ``IDTypeFeatureWithSingleID`` takes the single-id step, any other the
    bag step; anything else raises ``NotImplementedError``. The cached
    step takes raw batches only (a ``DataLoader`` yields them over a cached
    context). The PS is made current by :meth:`flush_device_cache`, which
    :meth:`snapshot`, :meth:`dump_checkpoint`, ``eval_ctx`` and a clean
    ``__exit__`` call; a restore (``load_checkpoint``, ``resume_from``)
    drops the cache instead. In ``stage_seconds`` a cached step books the
    mapper and the miss import as ``lookup``, their upload as ``h2d``, the
    device step as ``dense`` and the evicted rows' hand-over as
    ``update``. Over a mesh of more than one rank the cache is
    single-controller state: with ``PERSIA_MULTIHOST_CACHE=off`` (the
    default) the context logs a warning and trains uncached, with
    ``refuse`` it raises ``NotImplementedError``.
    """

    def __init__(self, model, dense_optimizer: torch.optim.Optimizer,
                 embedding_optimizer, schema: EmbeddingSchema, worker,
                 embedding_config: Optional[EmbeddingConfig] = None,
                 global_config: Optional[GlobalConfig] = None,
                 seed: Optional[int] = None, device: DeviceLike = None,
                 sync_stages: bool = False, mesh=None, loss_fn=None,
                 grad_update_interval: int = 1,
                 device_cache_capacity: int = 0,
                 device_cache_admission: Optional[str] = None,
                 profiler=None, resume_from: Optional[str] = None,
                 grad_reduce_dtype: Optional[str] = None):
        if profiler is not None:
            raise NotImplementedError(
                "TrainCtx(profiler=...) is not ported yet; it waits for "
                "ROADMAP.md queue A item 8 (tooling)")
        device_cache_capacity = int(device_cache_capacity)
        if device_cache_capacity and mesh is not None and mesh.size() > 1:
            device_cache_capacity = _negotiate_multirank_cache(
                device_cache_capacity, mesh.size())
        if mesh is not None and resume_from:
            raise NotImplementedError(
                f"TrainCtx(mesh=..., resume_from=...) is not ported yet; it "
                f"waits for {_MESH_WAITS}")
        from persia_tpu_torch.parallel.train import grad_reduce_mode

        grad_reduce_mode(grad_reduce_dtype)  # raises on a bad name early
        super().__init__(model=model, schema=schema, worker=worker,
                         embedding_config=embedding_config,
                         global_config=global_config, device=device)
        from persia_tpu_torch.parallel.train import WIRE_DTYPES, bce_loss

        _check_model_device(model, self.device)
        if seed is not None:
            from persia_tpu_torch.weights import init_params

            init_params(model, seed)
        self.dense_optimizer = dense_optimizer
        self.embedding_optimizer = embedding_optimizer
        self.loss_fn = loss_fn or bce_loss
        self.grad_update_interval = grad_update_interval
        self.wire_dtype = WIRE_DTYPES[
            self.global_config.common.embedding_wire_dtype]
        self.sync_stages = sync_stages
        self.stage_seconds: Dict[str, float] = dict.fromkeys(STAGES, 0.0)
        self._train_step = None
        self._emb_shapes = None
        self._eval_step = None
        self._step_count = 0
        self.mesh = mesh
        self.grad_reduce_dtype = grad_reduce_dtype
        self._ddp = False
        self._ef_state = None  # this rank's int8_ef residual
        self.device_cache_capacity = device_cache_capacity
        self.device_cache_admission = device_cache_admission
        self._cache_engine = None
        self._cached_step = None
        self._cache_multi_id = False
        if mesh is not None:
            self._join_mesh()
        # resolved and verified here, so a torn or absent snapshot fails
        # at construction; the rollback runs on __enter__
        self.resume_manifest: Optional[dict] = None
        self.resume_cursor: Optional[dict] = None
        self._resume_snap: Optional[str] = None
        if resume_from:
            from persia_tpu_torch import snapshot as _snapshot

            self._resume_snap, self.resume_manifest = (
                _snapshot.resolve_snapshot(resume_from))
            self.resume_cursor = _snapshot.load_cursor(self._resume_snap)

    def _join_mesh(self):
        """The leader holds the worker, and every rank takes the leader's
        dense weights (as DDP broadcasts its module at construction)."""
        import torch.distributed as dist

        from persia_tpu_torch.parallel import collectives as coll
        from persia_tpu_torch.parallel.mesh import is_leader, leader_rank

        if self.mesh.device_type != self.device.type:
            raise ValueError(f"the mesh's ranks compute on "
                             f"{self.mesh.device_type}, the context on "
                             f"{self.device}")
        self._leader = is_leader(self.mesh)
        # every rank learns whether any was misconfigured, and all raise
        bad = torch.tensor(
            [float(self._leader != (self.worker is not None))],
            device=self.device)
        coll.pmax_([bad])
        if bad.item():
            raise ValueError(
                f"on a mesh only the sparse leader (global rank "
                f"{leader_rank(self.mesh)}) holds the embedding worker; "
                f"rank {dist.get_rank()} was given "
                f"{'one' if self.worker is not None else 'none'} (a rank "
                f"of the mesh was given the wrong one)")
        with torch.no_grad():
            coll.broadcast_([*self.model.parameters(), *self.model.buffers()],
                            leader_rank(self.mesh))

    def __enter__(self):
        super().__enter__()
        if self.embedding_optimizer is not None and self.worker is not None:
            self.embedding_optimizer.apply()
        if self._cache_engine is not None:
            self._cache_engine.ensure_open()  # entered again after __exit__
        if self._resume_snap is not None:
            self._restore_from_snapshot()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        # leaving leaves the PS current (an eval, a dump or another
        # context reads it) and stops the flush thread; the context leaves
        # the stack even when the flush raises
        try:
            if self._cache_engine is not None:
                try:
                    if exc_type is None:
                        self.flush_device_cache()
                finally:
                    self._cache_engine.close()
        finally:
            result = super().__exit__(exc_type, exc_val, exc_tb)
        return result

    def _restore_from_snapshot(self):
        """Roll the job back to the resolved snapshot, once: the PS
        shards are replaced by its dump (updates after it are derived
        again by replaying the batches from ``resume_cursor``), the model
        and dense optimizer take its dense state, the step counter its
        step. Entering the context again does not roll back again."""
        from persia_tpu_torch import checkpoint as ckpt
        from persia_tpu_torch import snapshot as _snapshot

        snap, self._resume_snap = self._resume_snap, None
        if self._cache_engine is not None:
            self._cache_engine.invalidate()  # the cached rows predate it
        self.worker.load(snap)
        dense = _snapshot.dense_bytes(snap)
        if dense is not None:
            ckpt.apply_dense_bytes((self.model, self.dense_optimizer), dense)
        self._step_count = int(self.resume_manifest.get("step", 0))

    def snapshot(self, snapshot_dir: str, cursor: Optional[dict] = None,
                 inc_dir: Optional[str] = None,
                 keep: Optional[int] = None) -> str:
        """One coordinated job snapshot under ``snapshot_dir``: the
        backward pipeline drained, then the PS shards, the dense state
        and ``cursor`` captured as one manifest-stamped unit. Returns its
        path."""
        from persia_tpu_torch import snapshot as _snapshot

        self._refuse_on_mesh("TrainCtx.snapshot")
        self.flush_device_cache()
        return _snapshot.snapshot_job(
            snapshot_dir, self.worker,
            state=(self.model, self.dense_optimizer), cursor=cursor,
            inc_dir=inc_dir, step=self._step_count, keep=keep)

    def _refuse_on_mesh(self, what: str):
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} on a mesh is not ported yet; it waits for "
                f"{_MESH_WAITS}")

    def dump_checkpoint(self, dst_dir: str, with_dense: bool = True):
        self._refuse_on_mesh("TrainCtx.dump_checkpoint")
        self.flush_device_cache()
        super().dump_checkpoint(dst_dir, with_dense)

    def load_checkpoint(self, src_dir: str, with_dense: bool = True):
        self._refuse_on_mesh("TrainCtx.load_checkpoint")
        # drop (not flush) the cache first: its rows predate the restore,
        # and serving or flushing them would overwrite the loaded ones
        if self._cache_engine is not None:
            self._cache_engine.invalidate()
        super().load_checkpoint(src_dir, with_dense)

    def flush_device_cache(self) -> int:
        """Write every cached row back to the PS (the cache stays valid
        for more training). Returns the rows written; 0 without a
        cache."""
        if self._cache_engine is None:
            return 0
        return self._cache_engine.flush_all()

    @contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.sync_stages and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_seconds[name] += time.perf_counter() - t0

    def _prep_train_inputs(self, batch: PersiaBatch, lookup: Dict[str, Any]):
        """Lookup results -> train-step inputs on the device, the
        embedding values as the single packed wire array. Returns
        (non_id, emb_shapes, flat_emb, emb_indices, label)."""
        from persia_tpu_torch.parallel.train import pack_embedding_values

        non_id = [self.to_device(f.data) for f in batch.non_id_type_features]
        label = self.to_device(batch.labels[0].data)
        emb_np: List[np.ndarray] = []
        emb_indices: List[Optional[torch.Tensor]] = []
        for f in batch.id_type_features:
            r = lookup[f.name]
            if isinstance(r, SumEmbedding):
                emb_np.append(r.embeddings)
                emb_indices.append(None)
            elif isinstance(r, RawEmbedding):
                emb_np.append(r.embeddings)
                emb_indices.append(self.to_device(r.index))
            else:
                raise TypeError(f"unexpected lookup result {type(r)}")
        emb_shapes = tuple(tuple(v.shape) for v in emb_np)
        flat_emb = self.to_device(pack_embedding_values(emb_np,
                                                        self.wire_dtype))
        return non_id, emb_shapes, flat_emb, emb_indices, label

    def stage_batch(self, batch: PersiaBatch, lookup: Dict[str, Any]):
        """Host-to-device staging of one looked-up batch, run by the
        forward engine's prefetch workers: the train-step inputs the next
        ``train_step`` of this batch takes. The copies are issued on the
        worker thread's current stream, the default stream, which orders
        them before any kernel the training thread issues after the batch
        reaches it."""
        self._refuse_on_mesh("a DataLoader")
        return self._prep_train_inputs(batch, lookup)

    def train_step(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One full hybrid step: training lookup -> dense forward,
        backward and update on the device -> sparse update. Embedding
        values and gradients cross the host <-> device boundary as one
        packed array in the wire dtype each way. Returns (loss, pred) on
        the device.

        ``batch`` is a raw :class:`PersiaBatch` (synchronous lookup and
        update) or a :class:`~persia_tpu_torch.pipeline.LookedUpBatch`
        from a ``DataLoader``, whose lookup and staging already ran in a
        prefetch worker; its packed gradients then go to the batch's
        backward engine still on the device."""
        from persia_tpu_torch.parallel.train import (
            make_train_step,
            unpack_embedding_grads,
        )
        from persia_tpu_torch.pipeline import LookedUpBatch

        self._step_count += 1
        if self.device_cache_capacity:
            if isinstance(batch, LookedUpBatch):
                # a DataLoader yields raw batches over a cached context,
                # so an engine was driven against this context by hand
                raise RuntimeError(
                    "device-cache context received a looked-up batch; the "
                    "cached step imports its own misses: feed raw "
                    "PersiaBatch objects (a DataLoader does so over a "
                    "cached context)")
            if not isinstance(batch, PersiaBatch):
                raise TypeError(
                    f"TrainCtx.train_step takes a PersiaBatch or a "
                    f"LookedUpBatch, not {type(batch).__name__}")
            return self._cached_train_step(batch)
        if self.mesh is not None:
            if isinstance(batch, LookedUpBatch):
                self._refuse_on_mesh("a DataLoader's looked-up batch")
            return self._mesh_train_step(batch)
        engine = staged = None
        if isinstance(batch, LookedUpBatch):
            ref_id, lookup, engine = batch.ref_id, batch.lookup, batch.engine
            staged = batch.staged
            batch = batch.batch
        elif isinstance(batch, PersiaBatch):
            with self._stage("lookup"):
                ref_id, lookup = self.worker.lookup_direct_training(
                    batch.id_type_features)
        else:
            raise TypeError(
                f"TrainCtx.train_step takes a PersiaBatch or a "
                f"LookedUpBatch, not {type(batch).__name__}")
        if staged is None:
            with self._stage("h2d"):
                staged = self._prep_train_inputs(batch, lookup)
        non_id, emb_shapes, flat_emb, emb_indices, label = staged
        if self._train_step is None or emb_shapes != self._emb_shapes:
            self._emb_shapes = emb_shapes
            self._train_step = make_train_step(
                self.model, self.dense_optimizer, emb_shapes,
                loss_fn=self.loss_fn, wire_dtype=self.wire_dtype)
        with self._stage("dense"):
            loss, flat_grads, pred = self._train_step(
                non_id, flat_emb, emb_indices, label)
        names = [f.name for f in batch.id_type_features]
        if engine is not None:
            with self._stage("update"):
                engine.backward.submit_packed(ref_id, flat_grads, emb_shapes,
                                              names)
            return loss, pred
        with self._stage("d2h"):
            per_slot = unpack_embedding_grads(flat_grads.cpu(), emb_shapes)
        with self._stage("update"):
            self.worker.update_gradients(ref_id, dict(zip(names, per_slot)))
        return loss, pred

    # --- the device cache ----------------------------------------------------

    def _ensure_cache(self, batch: PersiaBatch):
        """At the first batch: check the cache's envelope and build the
        engine and the cached step. Anything outside the envelope raises
        with its reason."""
        if self._cache_engine is not None:
            return
        from persia_tpu_torch.data.batch import IDTypeFeatureWithSingleID
        from persia_tpu_torch.embedding.optim import Adagrad
        from persia_tpu_torch.parallel.cached_engine import DeviceCacheEngine
        from persia_tpu_torch.parallel.cached_train import (
            make_cached_bag_train_step,
            make_cached_train_step,
        )

        opt = self.embedding_optimizer
        if not isinstance(opt, Adagrad) or opt.vectorwise_shared:
            raise NotImplementedError(
                "device cache mirrors non-shared Adagrad on the device; "
                f"got {type(opt).__name__}")
        # the step is chosen by the features' TYPE: a single-id feature
        # has one id a sample in every batch, so the gather path never
        # meets a later bag; a base IDTypeFeature stream takes the bag
        # step even if its first batch looks single-id
        multi_id = not all(isinstance(f, IDTypeFeatureWithSingleID)
                           for f in batch.id_type_features)
        dims = set()
        for f in batch.id_type_features:
            slot = self.schema.get_slot(f.name)
            # both steps feed the model pooled (B, D) values a slot; a raw
            # slot would be silently sum-pooled
            if not slot.embedding_summation:
                raise NotImplementedError(
                    "device cache needs summed (pooled) slots; "
                    f"{f.name} is a raw slot")
            if slot.pooling != "sum":
                raise NotImplementedError(
                    "device cache supports pooling='sum' slots only; "
                    f"{f.name} uses pooling={slot.pooling!r} (worker-tier "
                    "pooling): use the uncached hybrid path")
            dims.add(slot.dim)
        if len(dims) != 1:
            raise NotImplementedError(
                f"device cache needs one uniform slot dim, got {dims}")
        dim = dims.pop()
        num_slots = len(batch.id_type_features)
        self._cache_engine = DeviceCacheEngine(
            self.worker, self.device_cache_capacity, num_slots, dim,
            acc_init=opt.initial_accumulator_value,
            sqrt_scaling=[self.schema.get_slot(f.name).sqrt_scaling
                          for f in batch.id_type_features],
            admission=self.device_cache_admission, device=self.device)
        self._cache_multi_id = multi_id
        maker = (make_cached_bag_train_step if multi_id
                 else make_cached_train_step)
        self._cached_step = maker(
            self.model, self.dense_optimizer, num_slots, dim, lr=opt.lr,
            eps=opt.eps, g_square_momentum=opt.g_square_momentum,
            loss_fn=self.loss_fn,
            weight_bound=self.embedding_config.weight_bound,
            capacity=self.device_cache_capacity)

    def _cached_train_step(self, batch: PersiaBatch):
        self._ensure_cache(batch)
        eng = self._cache_engine
        with self._stage("lookup"):
            prep = (eng.prepare_bags if self._cache_multi_id
                    else eng.prepare)(batch.id_type_features)
        if self._cache_multi_id:
            (*idx, cold_idx, cold_vals, cold_acc, evicted, evicted_mask,
             inverse, unique_slots) = prep
        else:
            (slot_idx, cold_idx, cold_vals, cold_acc, evicted, evicted_mask,
             inverse, unique_slots) = prep
            idx = [slot_idx]
        with self._stage("h2d"):
            non_id = [self.to_device(f.data)
                      for f in batch.non_id_type_features]
            label = self.to_device(batch.labels[0].data)
            idx = [self.to_device(a) for a in idx]
            cold = [self.to_device(a) for a in (cold_idx, cold_vals,
                                                cold_acc, inverse,
                                                unique_slots)]
        with self._stage("dense"):
            loss, pred, ev_vals, ev_acc = self._cached_step(
                eng.cache_vals, eng.cache_acc, non_id, *idx, *cold, label)
        with self._stage("update"):
            eng.finish(evicted, evicted_mask, ev_vals, ev_acc)
        return loss, pred

    # --- over a mesh ---------------------------------------------------------

    def _check_same_batch(self, batch: PersiaBatch):
        """Every rank of the mesh must train on the same global batch: its
        id and row count, compared by one max-reduction, so that every
        rank raises together."""
        from persia_tpu_torch.parallel import collectives as coll

        bid = -1 if batch.batch_id is None else int(batch.batch_id)
        rows = int(batch.labels[0].data.shape[0])
        seen = torch.tensor([bid, -bid, rows, -rows], dtype=torch.int64,
                            device=self.device)
        coll.pmax_([seen])
        b_max, b_min, r_max, r_min = seen.tolist()
        if b_max != -b_min or r_max != -r_min:
            raise RuntimeError(
                f"the ranks of the mesh were given different batches "
                f"(batch ids {-b_min}..{b_max}, rows {-r_min}..{r_max}); "
                f"every rank calls train_step on the same global batch")

    def _share_lookup(self, batch: PersiaBatch, lookup, batch_major: bool):
        """The leader's lookup on every rank: the leader packs the wire
        (batch-major (bs, sum dims) when ``batch_major``, else flat) and
        the raw slots' index tensors on the device, broadcasts a header
        of their shapes and then the tensors. Returns (emb_shapes,
        flat_emb, emb_indices)."""
        from persia_tpu_torch.parallel import collectives as coll
        from persia_tpu_torch.parallel.mesh import leader_rank
        from persia_tpu_torch.parallel.train import (
            pack_embedding_values,
            pack_embedding_values_batch_major,
        )

        feats = batch.id_type_features
        header = torch.zeros(4 * len(feats), dtype=torch.int64,
                             device=self.device)
        if self._leader:
            emb_np, idx_np = [], []
            for f in feats:
                r = lookup[f.name]
                if isinstance(r, SumEmbedding):
                    idx_np.append(None)
                elif isinstance(r, RawEmbedding):
                    idx_np.append(np.asarray(r.index, np.int32))
                else:
                    raise TypeError(f"unexpected lookup result {type(r)}")
                emb_np.append(r.embeddings)
            pack = (pack_embedding_values_batch_major if batch_major
                    else pack_embedding_values)
            flat_emb = self.to_device(pack(emb_np, self.wire_dtype))
            indices = [None if i is None else self.to_device(i)
                       for i in idx_np]
            header.copy_(torch.tensor(
                [x for v, i in zip(emb_np, idx_np)
                 for x in (*v.shape, *(i.shape if i is not None else (0, 0)))],
                dtype=torch.int64))
        src = leader_rank(self.mesh)
        coll.broadcast_([header], src)
        dims = header.view(-1, 4).tolist()
        emb_shapes = tuple((r, d) for r, d, _, _ in dims)
        if not self._leader:
            n = (emb_shapes[0][0], sum(d for _, d in emb_shapes)) \
                if batch_major else (sum(r * d for r, d in emb_shapes),)
            flat_emb = torch.empty(n, dtype=self.wire_dtype,
                                   device=self.device)
            indices = [torch.empty((a, b), dtype=torch.int32,
                                   device=self.device) if a else None
                       for _, _, a, b in dims]
        coll.broadcast_([flat_emb, *(i for i in indices if i is not None)],
                        src)
        return emb_shapes, flat_emb, indices

    def _mesh_train_step(self, batch: PersiaBatch):
        """One global batch over the mesh (see the class docstring)."""
        from persia_tpu_torch.parallel import collectives as coll
        from persia_tpu_torch.parallel.mesh import (
            DATA_AXIS,
            axis_group,
            axis_size,
            shard_rows,
        )
        from persia_tpu_torch.parallel.train import (
            unpack_embedding_grads,
            unpack_embedding_grads_batch_major,
        )

        if not isinstance(batch, PersiaBatch):
            raise TypeError(
                f"TrainCtx.train_step on a mesh takes a PersiaBatch, not "
                f"{type(batch).__name__}")
        self._check_same_batch(batch)
        lookup = None
        if self._leader:
            with self._stage("lookup"):
                ref_id, lookup = self.worker.lookup_direct_training(
                    batch.id_type_features)
        data = axis_group(self.mesh, DATA_AXIS)
        world = axis_size(self.mesh, DATA_AXIS)
        summed = all(self.schema.get_slot(f.name)
                     .embedding_summation for f in batch.id_type_features)
        rows = int(batch.labels[0].data.shape[0])
        ddp = summed and rows % world == 0
        with self._stage("h2d"):
            non_id = [self.to_device(f.data)
                      for f in batch.non_id_type_features]
            label = self.to_device(batch.labels[0].data)
            emb_shapes, flat_emb, emb_indices = self._share_lookup(
                batch, lookup, ddp)
        with self._stage("dense"):
            self._ensure_mesh_step(ddp, emb_shapes, data, world)
            if ddp:
                local = ([shard_rows(x, self.mesh) for x in non_id],
                         shard_rows(flat_emb, self.mesh),
                         shard_rows(label, self.mesh))
                if self.grad_reduce_dtype == "int8_ef":
                    loss, grads, pred, self._ef_state = self._train_step(
                        *local, self._ef_state)
                else:
                    loss, grads, pred = self._train_step(*local)
                # the leader ships the whole batch's gradients
                grads = coll.all_gather(grads, data, 0)
                pred = coll.all_gather(pred, data, 0)
            else:
                loss, grads, pred = self._train_step(
                    non_id, flat_emb, emb_indices, label)
        if not self._leader:
            return loss, pred
        names = [f.name for f in batch.id_type_features]
        with self._stage("d2h"):
            per_slot = (unpack_embedding_grads_batch_major(
                grads.cpu(), [d for _, d in emb_shapes]) if ddp
                else unpack_embedding_grads(grads.cpu(), emb_shapes))
        with self._stage("update"):
            self.worker.update_gradients(ref_id, dict(zip(names, per_slot)))
        return loss, pred

    def _ensure_mesh_step(self, ddp: bool, emb_shapes, data, world: int):
        from persia_tpu_torch.parallel.train import (
            _dense_params,
            init_ef_state,
            make_packed_train_step_ddp,
            make_train_step,
            reduce_dense_grads,
        )

        if (self._train_step is not None and ddp == self._ddp
                and emb_shapes == self._emb_shapes):
            return
        self._ddp, self._emb_shapes = ddp, emb_shapes
        if ddp:
            self._train_step = make_packed_train_step_ddp(
                self.model, self.dense_optimizer,
                [d for _, d in emb_shapes], self.mesh, loss_fn=self.loss_fn,
                wire_dtype=self.wire_dtype,
                grad_reduce_dtype=self.grad_reduce_dtype)
            if (self.grad_reduce_dtype == "int8_ef"
                    and self._ef_state is None):
                self._ef_state = init_ef_state(self.model, self.mesh)
            return
        params = _dense_params(self.model)

        def reduce_grads():
            reduce_dense_grads(params, data, world)

        self._train_step = make_train_step(
            self.model, self.dense_optimizer, emb_shapes,
            loss_fn=self.loss_fn, wire_dtype=self.wire_dtype,
            reduce_grads=reduce_grads if world > 1 else None)

    def _apply_model(self, non_id, emb_inputs):
        from persia_tpu_torch.parallel.train import (
            make_eval_step,
            split_embedding_inputs,
        )

        if self._eval_step is None:
            self._eval_step = make_eval_step(self.model)
        emb_values, emb_indices = split_embedding_inputs(emb_inputs)
        return self._eval_step(non_id, emb_values, emb_indices)


def _negotiate_multirank_cache(capacity: int, world: int) -> int:
    """The cache over a mesh of ``world`` > 1 ranks, JAX's
    ``jax.process_count() > 1`` case: each rank is a process, and the
    cache's mapper, miss imports and write-backs are one process's state.
    ``PERSIA_MULTIHOST_CACHE=off`` (the default) logs a warning and
    returns 0 (train uncached), ``refuse`` raises. Returns the capacity
    to use."""
    from persia_tpu_torch import knobs

    mode = str(knobs.get("PERSIA_MULTIHOST_CACHE")).lower()
    if mode == "refuse":
        raise NotImplementedError(
            f"device cache is single-controller only: a mesh of {world} "
            f"ranks, each a process; the sign->slot mapper and the "
            f"miss/evict host transfers live in one process. Use the "
            f"uncached hybrid path (or device mode) on a mesh, or leave "
            f"PERSIA_MULTIHOST_CACHE=off to train uncached instead of "
            f"raising")
    if mode != "off":
        raise ValueError(f"PERSIA_MULTIHOST_CACHE={mode!r}: expected 'off' "
                         f"or 'refuse'")
    _logger.warning(
        "device cache requested (capacity=%d) on a mesh of %d ranks: the "
        "cache's sign->slot mapper and miss/evict host transfers are "
        "single-controller state; NEGOTIATING DOWN: device cache "
        "DISABLED, continuing on the PS-only hybrid path. Set "
        "PERSIA_MULTIHOST_CACHE=refuse to make this a hard error instead.",
        capacity, world)
    return 0


class _EvalCtx(EmbeddingCtx):
    def __init__(self, parent: TrainCtx):
        if parent.mesh is not None:
            import torch.distributed as dist

            if not parent._leader:
                raise RuntimeError(
                    f"eval_ctx over a mesh evaluates on the sparse leader; "
                    f"rank {dist.get_rank()} holds no embedding worker")
            if any(getattr(m, "context_parallel_active", False)
                   for m in parent.model.modules()):
                raise NotImplementedError(
                    f"eval_ctx of a context-parallel tower is not ported "
                    f"yet: its attention needs every rank of the mesh; it "
                    f"waits for {_MESH_WAITS}")
        super().__init__(model=parent.model, schema=parent.schema,
                         worker=parent.worker,
                         embedding_config=parent.embedding_config,
                         global_config=parent.global_config,
                         device=parent.device)
        self._parent = parent
        self._configured_servers = True  # configured by the parent
        # cached rows train on the device: the PS must be current before
        # the eval lookups read it
        parent.flush_device_cache()

    def _apply_model(self, non_id, emb_inputs):
        return self._parent._apply_model(non_id, emb_inputs)


def eval_ctx(train_ctx: Optional[TrainCtx] = None) -> _EvalCtx:
    """Evaluation context over a TrainCtx (the given one, else the
    current context): eval lookups and an eval-mode forward."""
    ctx = train_ctx or current_ctx()
    if not isinstance(ctx, TrainCtx):
        raise RuntimeError("eval_ctx requires a TrainCtx")
    return _EvalCtx(ctx)


class InferCtx(EmbeddingCtx):
    """Inference: eval-mode lookups and an eval-mode forward on
    ``device`` (default CUDA). The model's parameters must already live
    there.

    ``eval_batch_rows_seen`` records the batch-row counts the forward has
    seen: the serving tier's shape bucketing keeps it equal to the bucket
    ladder."""

    def __init__(self, model, schema: EmbeddingSchema, worker,
                 device: DeviceLike = None):
        super().__init__(model=model, schema=schema, worker=worker,
                         device=device)
        _check_model_device(model, self.device)
        self._eval_step = None
        self.eval_batch_rows_seen: set = set()

    def _apply_model(self, non_id, emb_inputs):
        from persia_tpu_torch.parallel.train import (
            make_eval_step,
            split_embedding_inputs,
        )

        if self._eval_step is None:
            self._eval_step = make_eval_step(self.model)
        emb_values, emb_indices = split_embedding_inputs(emb_inputs)
        rows = None
        if non_id:
            rows = int(non_id[0].shape[0])
        elif emb_values:
            # summed slots are (batch, dim); raw slots carry batch rows in
            # their (batch, sfs) index tensor
            v, idx = emb_values[0], emb_indices[0]
            rows = int(v.shape[0] if idx is None else idx.shape[0])
        if rows is not None and rows not in self.eval_batch_rows_seen:
            # replace-on-write: a concurrent stats reader iterating the old
            # set never sees it mutate
            self.eval_batch_rows_seen = self.eval_batch_rows_seen | {rows}
        return self._eval_step(non_id, emb_values, emb_indices)
