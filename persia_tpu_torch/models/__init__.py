from persia_tpu_torch.models.common import MLP
from persia_tpu_torch.models.dlrm import DLRM
from persia_tpu_torch.models.seq import SequenceSelfAttention, SequenceTower

__all__ = ["DLRM", "MLP", "SequenceSelfAttention", "SequenceTower"]
