"""The eval step of ``persia_tpu/parallel/train.py``.

In the JAX package the eval forward is one jitted program; PyTorch runs
eagerly, so the step is the model's forward under
``torch.inference_mode()`` in eval mode. Train steps belong to the
training slice of the port.
"""

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn


def split_embedding_inputs(embedding_inputs: Sequence[Any]
                           ) -> Tuple[List[Any], List[Optional[Any]]]:
    """Split mixed [array | (array, index)] inputs into float values and
    optional index tensors (None for summed slots)."""
    values, indices = [], []
    for e in embedding_inputs:
        if isinstance(e, (tuple, list)):
            values.append(e[0])
            indices.append(e[1])
        else:
            values.append(e)
            indices.append(None)
    return values, indices


def _rebuild_embedding_inputs(emb_values, emb_indices) -> List[Any]:
    return [v if idx is None else (v, idx)
            for v, idx in zip(emb_values, emb_indices)]


def make_eval_step(model: nn.Module) -> Callable:
    """``step(non_id_tensors, emb_values, emb_indices) -> pred``: an
    eval-mode forward with autograd off."""
    model.eval()

    def step(non_id_tensors, emb_values, emb_indices):
        with torch.inference_mode():
            return model(non_id_tensors,
                         _rebuild_embedding_inputs(emb_values, emb_indices))

    return step
