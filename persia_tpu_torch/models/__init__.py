"""The dense model zoo (``persia_tpu/models``). Every tower takes
``model(non_id_tensors, embedding_tensors)``: embedding_tensors holds
(bs, dim) summed slots and (embeddings, index) raw pairs."""

from persia_tpu_torch.models.common import (
    MLP,
    flatten_embeddings,
    gather_raw_embedding,
    stack_field_embeddings,
)
from persia_tpu_torch.models.dcn import DCNv2
from persia_tpu_torch.models.deepfm import DeepFM
from persia_tpu_torch.models.dlrm import DLRM
from persia_tpu_torch.models.dnn import DNN
from persia_tpu_torch.models.seq import SequenceSelfAttention, SequenceTower
from persia_tpu_torch.models.wide_deep import WideAndDeep

__all__ = [
    "MLP",
    "DNN",
    "DLRM",
    "DCNv2",
    "DeepFM",
    "SequenceTower",
    "WideAndDeep",
    "SequenceSelfAttention",
    "flatten_embeddings",
    "gather_raw_embedding",
    "stack_field_embeddings",
]
