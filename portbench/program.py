"""The system under test: ``persia_tpu_torch``'s device mode at a
configuration's widths. The only module of the benchmark that imports the
program.

Training drives ``DeviceModeStep.__call__`` as ``make_device_mode_trainer``
builds it (``OptaxAdagrad`` over tables and tower); scoring drives
``DeviceModeModel.forward`` under ``torch.inference_mode()``. The
benchmark's weights are loaded into the model's own parameters, and the
trainer is built with ``seed=None`` so that it keeps them.
"""

from typing import Dict, List

import torch

from persia_tpu_torch.models.dlrm import DLRM
from persia_tpu_torch.parallel.device_mode import (
    DeviceModeModel,
    make_device_mode_trainer,
)
from persia_tpu_torch.parallel.optim import OptaxAdagrad

from portbench.arch import Arch

class Program:
    def __init__(self, a: Arch, names: List[str], device):
        self.a = a
        self.device = torch.device(device)
        tower = DLRM(a.num_dense, a.fields, embedding_dim=a.dim,
                     bottom_mlp=a.bottom, top_mlp=a.top,
                     compute_dtype=getattr(torch, a.compute_dtype),
                     device=self.device)
        self.model = DeviceModeModel(
            [(n, rows, a.dim) for n, rows in zip(names, a.rows)], tower,
            device=self.device)
        coll = self.model.DeviceEmbeddingCollection_0
        if coll.compute_dtype != tower.compute_dtype:
            raise ValueError(f"the pooled embeddings are {coll.compute_dtype}"
                             f", the tower computes in "
                             f"{tower.compute_dtype}")
        self.names = names
        self.step = None

    def leaf_tensors(self) -> List[torch.Tensor]:
        """The parameters in :func:`portbench.arch.leaves` order."""
        coll = self.model.DeviceEmbeddingCollection_0
        out = [getattr(coll, f"bag_{n}").table for n in self.names]
        for mlp in (self.model.tower.MLP_0, self.model.tower.MLP_1):
            for i in range(len(mlp.features)):
                layer = getattr(mlp, f"Dense_{i}")
                out += [layer.weight, layer.bias]
        return out

    def trainer(self, sample):
        """Build the training step; ``sample`` is one batch as the step
        takes it (its eval forward checks the widths)."""
        a = self.a
        non_id, ids, _ = sample
        self.model, self.optimizer, self.step = make_device_mode_trainer(
            self.model,
            lambda p: OptaxAdagrad(
                p, a.lr, initial_accumulator_value=a.initial_accumulator,
                eps=a.eps),
            non_id, ids, seed=None, device=self.device)
        return self.step

    def grad_norms(self) -> List[float]:
        """The norm of each leaf's gradient as the optimizer got it in the
        last step."""
        norms = []
        for p in self.leaf_tensors():
            g = p.grad
            if g is None:
                raise RuntimeError("a leaf has no gradient after the step")
            if g.is_sparse:
                g = g.coalesce().values()
            norms.append(torch.linalg.vector_norm(g.float()))
        return torch.stack(norms).tolist()

    def stage_seconds(self) -> Dict[str, float]:
        return dict(self.step.stage_seconds)

    def time_stages(self, on: bool):
        """Synchronize the device after each stage of a step (forward,
        backward, optimizer) and start their sums again."""
        self.step.sync_stages = on
        for k in self.step.stage_seconds:
            self.step.stage_seconds[k] = 0.0

    def score(self, dense: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """One batch's predictions. ``dense`` (B, num_dense) and ``ids``
        (fields, B, S) are host tensors, each moved to the card in one
        copy, as a scoring job moves a packed batch; the model takes each
        field's (B, S) ids as a view of the moved tensor."""
        dev = self.device
        ids = ids.to(dev, non_blocking=True)
        return self.model([dense.to(dev, non_blocking=True)],
                          {n: ids[k] for k, n in enumerate(self.names)})
