"""Device mode (``persia_tpu/parallel/device_mode.py``): a dense tower and
hashed embedding tables resident on the card, trained as one module.

:class:`DeviceModeModel` composes :class:`DeviceEmbeddingCollection` with
a model-zoo tower; :func:`make_device_mode_trainer` moves it to the card,
draws its weights from a seed and returns the step: forward (the pooled
lookups through kernel K1), ``loss.backward()`` (dense table gradients,
as the JAX package's scatter-add is dense), and the optimizer over tables
and tower alike. PyTorch runs eagerly, so the step updates in place where
the JAX one returns new arrays.

Over a mesh (``mesh=``) the batch is split over the data axis only: each
rank pools its own rows of the batch. The tower is replicated on every
rank. On a model axis of m > 1 ranks the tables are row-sharded over it,
as the JAX trainer places them through their ``(MODEL_AXIS, None)``
specs: a rank holds ``V / m`` rows of each table, pools them through
K1's shard window and sums the partials over the model axis
(``DeviceEmbeddingCollection.shard_``); on a model axis of 1 they are
replicated, as ``P()`` places them. The gradients of the tower and of
each table (or shard) are averaged over the data axis before the
optimizer, and nothing is reduced over the model axis, whose ranks
compute the same tower on the same rows; the loss is the data axis'
mean. Every forward is then a collective: every rank of the mesh calls
the step, and any later ``model(...)``, alike.

With tracing on (:mod:`persia_tpu_torch.tracing`) a step is one trace:
its root span ``device_mode/step`` holds ``device_mode/forward``,
``device_mode/backward`` and ``device_mode/optimizer`` on the calling
thread; ``device_mode/model`` times the model's forward (a batch's root
span when scoring), and K1's table gradients open ``k1/table_grad``
under it from whatever thread autograd runs them on.
"""

import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from persia_tpu_torch import tracing
from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.parallel.device_embedding import (
    DeviceEmbeddingBag,
    DeviceEmbeddingCollection,
)
from persia_tpu_torch.parallel.train import bce_loss

STAGES = ("forward", "backward", "optimizer")


class DeviceModeModel(nn.Module):
    """Embedding tables + dense tower, with flax's child names
    ``DeviceEmbeddingCollection_0`` and ``tower``. ``slot_specs`` is a
    sequence of (name, vocab_size, dim); ``tower`` a model-zoo module
    called as ``tower(non_id_tensors, embeddings)``. The collection keeps
    its default bf16 ``compute_dtype``, as the JAX model does, so pooled
    embeddings are rounded to bf16 even for an f32 tower."""

    def __init__(self, slot_specs: Sequence[Any], tower: nn.Module,
                 bag_impl: str = "kernel", device: DeviceLike = None):
        super().__init__()
        self.DeviceEmbeddingCollection_0 = DeviceEmbeddingCollection(
            slot_specs, bag_impl=bag_impl, device=device)
        self.tower = tower

    def forward(self, non_id_tensors: Sequence[torch.Tensor],
                id_tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        with tracing.span("device_mode/model"):
            return self.tower(non_id_tensors,
                              self.DeviceEmbeddingCollection_0(id_tensors))


class DeviceModeStep:
    """``step(non_id, ids, label) -> loss``: one training step on the
    model's device, updating the model and the optimizer in place. Inputs
    may be numpy arrays or tensors; they are moved to the device.

    ``stage_seconds`` accumulates the host time of each of
    :data:`STAGES`; the device runs asynchronously, so its work lands in
    whichever stage waits for it. With ``sync_stages`` the step
    synchronizes the device after each stage, which makes the split
    honest and the step slower. The stages' spans (module docstring)
    cover the same blocks, syncs included.

    With a ``mesh`` every rank of the mesh calls the step on the same
    global batch and trains its own rows of it along the data axis (a
    batch that does not divide the axis stays whole on every rank); the
    gradient average over the axis is booked in ``backward``, where DDP
    does it."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 loss_fn: Callable, device: torch.device, mesh=None):
        self.model = model
        self.mesh = mesh
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.device = device
        self.sync_stages = False
        self.stage_seconds: Dict[str, float] = dict.fromkeys(STAGES, 0.0)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):  # a read-only array is copied
            x = torch.from_numpy(np.require(x, requirements="W"))
        return x.to(self.device, non_blocking=True)

    def _mark(self, name: str, t0: float) -> float:
        if self.sync_stages and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.stage_seconds[name] += t1 - t0
        return t1

    def _rows(self, x) -> torch.Tensor:
        x = self._tensor(x)
        if self.mesh is None:
            return x
        from persia_tpu_torch.parallel.mesh import shard_rows

        return shard_rows(x, self.mesh)

    def __call__(self, non_id_tensors, id_tensors, label) -> torch.Tensor:
        with tracing.span("device_mode/step", root=True):
            t = time.perf_counter()
            with tracing.span("device_mode/forward"):
                non_id = [self._rows(x) for x in non_id_tensors]
                ids = {k: self._rows(v) for k, v in id_tensors.items()}
                self.model.train()
                self.optimizer.zero_grad(set_to_none=True)
                loss = self.loss_fn(self.model(non_id, ids),
                                    self._rows(label))
                t = self._mark("forward", t)
            with tracing.span("device_mode/backward"):
                loss.backward()
                if self.mesh is not None:
                    loss = self._reduce(loss)
                t = self._mark("backward", t)
            with tracing.span("device_mode/optimizer"):
                self.optimizer.step()
                self._mark("optimizer", t)
        return loss.detach()

    def _reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """Every gradient and the loss averaged over the data axis (nothing
        to do on a data axis of one rank)."""
        from persia_tpu_torch.parallel import collectives as coll
        from persia_tpu_torch.parallel.mesh import (
            DATA_AXIS,
            axis_group,
            axis_size,
        )
        from persia_tpu_torch.parallel.train import reduce_dense_grads

        world = axis_size(self.mesh, DATA_AXIS)
        if world == 1:  # a mean over one rank (tables sharded, no data axis)
            return loss.detach()
        group = axis_group(self.mesh, DATA_AXIS)
        reduce_dense_grads(list(self.model.parameters()), group, world,
                           per_tensor=True)
        return coll.pmean(loss, group)


def make_device_mode_trainer(
        model: DeviceModeModel,
        optimizer: Callable[..., torch.optim.Optimizer],
        sample_non_id, sample_ids: Dict[str, Any],
        loss_fn: Callable = bce_loss, seed: Optional[int] = 0,
        device: DeviceLike = None, mesh=None):
    """Put ``model`` on the device, draw its weights from ``seed``
    (:func:`persia_tpu_torch.weights.init_device_mode`; ``None`` keeps the
    module's current weights, e.g. transplanted ones) and build the
    optimizer by calling ``optimizer(model.parameters())`` (for
    ``optax.adagrad(0.02)``: ``lambda p: OptaxAdagrad(p, 0.02)``). The
    sample inputs run one eval forward, which checks the slots and widths
    as the JAX trainer's ``model.init`` does. Returns ``(model,
    optimizer, step)`` with ``step`` a :class:`DeviceModeStep`.

    With ``mesh`` every rank of the mesh calls this alike. On a model
    axis larger than 1 the tables are first cut to this rank's rows
    (before the move to the device, so a table the model holds on the CPU
    never sits whole on the card; a vocab that does not divide the axis
    raises ``ValueError`` naming its slot on every rank). The weights
    then are the mesh origin's for the tower and the data axis' first
    rank's for each table shard (broadcast, as DDP does at construction),
    on this rank's device."""
    from persia_tpu_torch.weights import init_device_mode

    dev = resolve_device(device)
    if mesh is not None:
        if mesh.device_type != dev.type:
            raise ValueError(f"the mesh's ranks compute on "
                             f"{mesh.device_type}, the trainer on {dev}")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        for m in model.modules():
            if isinstance(m, DeviceEmbeddingCollection):
                m.shard_(mesh)
    model = model.to(dev)
    if seed is not None:
        init_device_mode(model, seed)
    if mesh is not None:
        from persia_tpu_torch.parallel import collectives as coll
        from persia_tpu_torch.parallel.mesh import (
            DATA_AXIS,
            axis_group,
            leader_rank,
        )

        group = axis_group(mesh, DATA_AXIS)
        tables = {id(b.table) for b in model.modules()
                  if isinstance(b, DeviceEmbeddingBag)}
        with torch.no_grad():
            if coll.size(group) > 1:
                coll.broadcast_([p for p in model.parameters()
                                 if id(p) in tables],
                                coll.global_rank(group, 0), group)
            coll.broadcast_([*(p for p in model.parameters()
                               if id(p) not in tables), *model.buffers()],
                            leader_rank(mesh))
    opt = optimizer(model.parameters())
    step = DeviceModeStep(model, opt, loss_fn, dev, mesh=mesh)
    model.eval()
    with torch.inference_mode():
        model([step._tensor(x) for x in sample_non_id],
              {k: step._tensor(v) for k, v in sample_ids.items()})
    return model, opt, step


def criteo_like_specs(num_slots: int = 26, vocab: int = 1 << 16,
                      dim: int = 16):
    return [(f"slot_{i}", vocab, dim) for i in range(num_slots)]


def synthetic_device_batch(batch_size: int, num_dense: int, slot_specs,
                           sample_fixed_size: int = 1, seed=0,
                           device: DeviceLike = None):
    """The JAX package's synthetic batch, draw for draw (normal dense
    features, then one integers draw per slot, then labels), as tensors
    on ``device``: ([dense f32 (bs, num_dense)], {name: int32 (bs, sfs)},
    label f32 (bs, 1))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def put(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype)).to(dev)

    non_id = [put(rng.normal(size=(batch_size, num_dense)), np.float32)]
    ids = {name: put(rng.integers(1, 1 << 31,
                                  size=(batch_size, sample_fixed_size)),
                     np.int32)
           for name, _, _ in slot_specs}
    label = put(rng.integers(0, 2, size=(batch_size, 1)), np.float32)
    return non_id, ids, label
