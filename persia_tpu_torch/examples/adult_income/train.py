"""Adult-income training in one process (``examples/adult_income/train.py``).

Synthetic data, the embedding worker, two PS replicas (the native C++
store) and the ``DNN`` tower on ``--device`` (default ``cuda``; ``cpu``
for a machine without a card) all live in this process:

    python persia_tpu_torch/examples/adult_income/train.py --device cpu

Prints the held-out AUC. The JAX example's ``--train-npz`` path (the
reference's preprocessed UCI files, not in the repo) is not ported, nor
are the options of ``build_ctx`` that only it sets (a ``config_dir``,
slot names, a feature-index prefix); the service mode is ``nn_worker.py``
beside this file.
"""

import argparse
import logging
import os
import sys

import numpy as np

try:  # the installed package
    import persia_tpu_torch  # noqa: F401
except ImportError:  # a bare checkout: its root on the path
    sys.path.insert(0, os.path.abspath(__file__).rsplit(
        "/persia_tpu_torch/", 1)[0])

from persia_tpu_torch.examples.adult_income.data_generator import (  # noqa: E402
    NUM_DENSE,
    NUM_SLOTS,
    batches,
)

logger = logging.getLogger("adult_income")

EMBEDDING_DIM = 8


def build_ctx(n_ps: int = 2, seed: int = 42, device="cuda"):
    """The TrainCtx: ``DNN(sparse_mlp_output_size=128)``, Adam(1e-3) dense,
    Adagrad(1e-2) sparse, PS rows from U(-0.05, 0.05), ``n_ps`` replicas of
    ``make_holder(1_000_000, 8)``, weights from ``seed``."""
    import torch

    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.utils import setup_seed
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    setup_seed(seed)
    schema = EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{s}" for s in range(NUM_SLOTS)], dim=EMBEDDING_DIM))
    holders = [make_holder(1_000_000, 8) for _ in range(n_ps)]
    worker = EmbeddingWorker(schema, holders)
    model = DNN(NUM_DENSE, [s.dim for s in schema.slots_config.values()],
                sparse_mlp_output_size=128, device=device)
    return TrainCtx(
        model, torch.optim.Adam(model.parameters(), lr=1e-3),
        Adagrad(lr=1e-2), schema, worker,
        embedding_config=EmbeddingConfig(emb_initialization=(-0.05, 0.05)),
        seed=seed, device=device)


def evaluate(ctx, batch_iter=None, num_samples: int = 4096,
             seed: int = 99) -> float:
    """Test AUC over ``batch_iter`` (by default a fresh synthetic set)."""
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.utils import roc_auc

    if batch_iter is None:
        batch_iter = batches(num_samples, 512, seed=seed,
                             requires_grad=False)
    preds, labels = [], []
    with eval_ctx(ctx) as ectx:
        for batch in batch_iter:
            pred, label = ectx.forward(batch)
            preds.append(pred.float().cpu().numpy().reshape(-1))
            labels.append(np.asarray(label[0]).reshape(-1))
    return roc_auc(np.concatenate(labels), np.concatenate(preds))


def main(steps: int = 200, batch_size: int = 512, device="cuda") -> float:
    from persia_tpu_torch.data.dataloader import IterableDataset

    ctx = build_ctx(device=device)
    dataset = IterableDataset(batches(steps * batch_size, batch_size,
                                      seed=1))
    with ctx:
        for i, batch in enumerate(dataset):
            loss, _ = ctx.train_step(batch)
            if i % 50 == 0:
                logger.info("step %d loss %.4f", i, float(loss))
        auc = evaluate(ctx)
    logger.info("test auc %.4f", auc)
    return auc


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="where the tower trains (cuda, or cpu)")
    args = p.parse_args()
    from persia_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card: raise before anything
    print(f"AUC: {main(args.steps, args.batch_size, args.device)}")
