"""Device mode (``persia_tpu/parallel/device_mode.py``): a dense tower and
hashed embedding tables resident on the card, trained as one module.

:class:`DeviceModeModel` composes :class:`DeviceEmbeddingCollection` with
a model-zoo tower; :func:`make_device_mode_trainer` moves it to the card,
draws its weights from a seed and returns the step: forward (the pooled
lookups through kernel K1), ``loss.backward()`` (dense table gradients,
as the JAX package's scatter-add is dense), and the optimizer over tables
and tower alike. PyTorch runs eagerly, so the step updates in place where
the JAX one returns new arrays.

Over a mesh's data axis (``mesh=``) the tables and the tower are
replicated on every rank, as ``P()`` on a model axis of size 1 places
them in JAX: each rank pools its own rows of the batch (K1 on its rows),
the gradients of tables and tower are averaged over the axis before the
optimizer, and the loss is the global mean. Row-sharded tables over a
model axis larger than 1 raise.
"""

import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.parallel.device_embedding import (
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
    honest and the step slower.

    With a ``mesh`` every rank of its data axis calls the step on the
    same global batch and trains its own rows of it (a batch that does not
    divide the axis stays whole on every rank); the gradient average over
    the axis is booked in ``backward``, where DDP does it."""

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
        t = time.perf_counter()
        non_id = [self._rows(x) for x in non_id_tensors]
        ids = {k: self._rows(v) for k, v in id_tensors.items()}
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.model(non_id, ids), self._rows(label))
        t = self._mark("forward", t)
        loss.backward()
        if self.mesh is not None:
            loss = self._reduce(loss)
        t = self._mark("backward", t)
        self.optimizer.step()
        self._mark("optimizer", t)
        return loss.detach()

    def _reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """Every gradient and the loss averaged over the data axis."""
        from persia_tpu_torch.parallel import collectives as coll
        from persia_tpu_torch.parallel.mesh import (
            DATA_AXIS,
            axis_group,
            axis_size,
        )
        from persia_tpu_torch.parallel.train import reduce_dense_grads

        group = axis_group(self.mesh, DATA_AXIS)
        reduce_dense_grads(list(self.model.parameters()), group,
                           axis_size(self.mesh, DATA_AXIS), per_tensor=True)
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

    With ``mesh`` (its model axis of size 1) every rank of the data axis
    calls this alike; the weights then are the data axis' first rank's
    (broadcast, as DDP does at construction), on this rank's device."""
    from persia_tpu_torch.weights import init_device_mode

    dev = resolve_device(device)
    if mesh is not None:
        from persia_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size

        if axis_size(mesh, MODEL_AXIS) > 1:
            raise NotImplementedError(
                "make_device_mode_trainer over a model axis larger than 1 "
                "(tables row-sharded over it) is not ported yet: K1 would "
                "have to leave out the rows outside its shard; it waits for "
                "ROADMAP.md queue A item 3d")
        if mesh.device_type != dev.type:
            raise ValueError(f"the mesh's ranks compute on "
                             f"{mesh.device_type}, the trainer on {dev}")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    model = model.to(dev)
    if seed is not None:
        init_device_mode(model, seed)
    if mesh is not None:
        from persia_tpu_torch.parallel import collectives as coll
        from persia_tpu_torch.parallel.mesh import DATA_AXIS, axis_group

        group = axis_group(mesh, DATA_AXIS)
        with torch.no_grad():
            coll.broadcast_([*model.parameters(), *model.buffers()],
                            coll.global_rank(group, 0), group)
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
