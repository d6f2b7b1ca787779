"""In-process embedding worker: the lookup side of
``persia_tpu/worker/worker.py``.

The worker sits between the dense tier and the parameter servers: it
preprocesses a batch's ID features (dedup, hashstack, prefix), splits the
distinct signs by (PS shard, dim), looks each group up on its PS and
postprocesses the rows into model-ready tensors. PS calls are serialized
(one group after another); routing epochs, retries, the streaming
multiplexer and the gradient path belong to later slices of the port.
"""

from typing import Dict, List, Sequence

import numpy as np

from persia_tpu_torch.config import EmbeddingSchema
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.hashing import sign_to_shard
from persia_tpu_torch.worker import middleware as mw


class EmbeddingWorker:
    """``ps_clients`` are objects with the ``EmbeddingHolder`` interface
    (``configure``, ``lookup``, ``set_entries``); shard r owns the signs
    with ``farmhash64(sign) % len(ps_clients) == r``."""

    def __init__(self, schema: EmbeddingSchema, ps_clients: Sequence):
        self.schema = schema
        self.ps_clients = list(ps_clients)
        self.replica_size = len(self.ps_clients)
        if self.replica_size == 0:
            raise ValueError("EmbeddingWorker needs at least one PS client")

    def configure_parameter_servers(self, init_method: str,
                                    init_params: dict,
                                    admit_probability: float,
                                    weight_bound: float,
                                    enable_weight_bound: bool = True):
        for c in self.ps_clients:
            c.configure(init_method, init_params, admit_probability,
                        weight_bound, enable_weight_bound)

    def lookup_direct(self, id_type_features: List[IDTypeFeature],
                      training: bool = False) -> Dict[str, object]:
        """One-shot preprocess + lookup: the inference/eval path."""
        if training:
            raise NotImplementedError(
                "training lookups are not ported yet (see ROADMAP.md)")
        feats = mw.preprocess_batch(id_type_features, self.schema)
        groups = mw.shard_split(feats, self.schema, self.replica_size)
        mats = mw.alloc_lookup_mats(feats, self.schema)
        for g in groups:
            mw.scatter_group(
                mats, g, self.ps_clients[g.shard].lookup(g.signs, g.dim,
                                                         False))
        return {
            feat.name: mw.postprocess_feature(
                feat, self.schema.get_slot(feat.name), mat)
            for feat, mat in zip(feats, mats)
        }

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
