"""Contexts of the serving path (``persia_tpu/ctx.py``): the embedding
context's feature preparation and the inference context.

The embedding tier is reached through an
:class:`~persia_tpu_torch.worker.worker.EmbeddingWorker`. Host numpy goes
to the device through pinned buffers with asynchronous copies on the
current stream.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from persia_tpu_torch.config import EmbeddingSchema
from persia_tpu_torch.data.batch import PersiaBatch
from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.worker.middleware import RawEmbedding, SumEmbedding


class EmbeddingCtx:
    def __init__(self, model=None, schema: EmbeddingSchema = None,
                 worker=None, device: DeviceLike = None):
        self.model = model
        self.schema = schema if schema is not None else (
            worker.schema if worker is not None else None)
        self.worker = worker
        self.device = resolve_device(device)

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
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
        for p in model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"model parameters live on {p.device}, the context on "
                    f"{self.device}; build the model on the same device")
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
