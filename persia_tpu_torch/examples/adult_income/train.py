"""Adult-income training in one process (``examples/adult_income/train.py``).

Synthetic data, the embedding worker, two PS replicas (the native C++
store) and the ``DNN`` tower on ``--device`` (default ``cuda``; ``cpu``
for a machine without a card) all live in this process:

    python persia_tpu_torch/examples/adult_income/train.py --device cpu

Prints the held-out AUC. ``--train-npz`` / ``--test-npz`` train
``--epochs`` epochs on files in the reference's preprocessed npz layout
(``data_generator.load_npz``; the UCI files themselves are not in the
repo) and print the test file's AUC:

    python persia_tpu_torch/examples/adult_income/train.py \
        --train-npz train.npz --test-npz test.npz --device cpu

The service mode is ``nn_worker.py`` beside this file.
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


def build_ctx(n_ps: int = 2, seed: int = 42, config_dir: str = None,
              slot_names=None, feature_index_prefix_bit: int = 0,
              device="cuda"):
    """The TrainCtx: ``DNN(sparse_mlp_output_size=128)``, Adam(1e-3) dense,
    Adagrad(1e-2) sparse, PS rows from U(-0.05, 0.05), weights from
    ``seed``. The schema and ``n_ps`` PS replicas come from
    ``config_dir``'s ``embedding_config.yml`` and ``global_config.yml``
    (the replicas sized by ``parameter_server.capacity`` and
    ``num_hashmap_internal_shards``); without it, ``slot_names`` (by
    default ``slot_0``..``slot_7``) of dim 8 under
    ``feature_index_prefix_bit`` and replicas of
    ``make_holder(1_000_000, 8)``."""
    import torch

    from persia_tpu_torch.config import (
        EmbeddingSchema,
        GlobalConfig,
        uniform_slots,
    )
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.utils import setup_seed
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    setup_seed(seed)
    if config_dir:
        schema = EmbeddingSchema.load(f"{config_dir}/embedding_config.yml")
        ps = GlobalConfig.load(f"{config_dir}/global_config.yml") \
            .parameter_server
        holders = [make_holder(ps.capacity, ps.num_hashmap_internal_shards)
                   for _ in range(n_ps)]
    else:
        if slot_names is None:
            slot_names = [f"slot_{s}" for s in range(NUM_SLOTS)]
        schema = EmbeddingSchema(
            slots_config=uniform_slots(slot_names, dim=EMBEDDING_DIM),
            feature_index_prefix_bit=feature_index_prefix_bit)
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


def main_npz(train_npz: str, test_npz: str, batch_size: int = 128,
             epochs: int = 5, device="cuda") -> float:
    """``epochs`` epochs over ``train_npz`` (the reference's preprocessed
    npz layout), then the AUC of ``test_npz``. The columns' codes all
    start at 0, so the schema namespaces each slot's signs with
    ``feature_index_prefix_bit`` 12, as the reference's config does."""
    from persia_tpu_torch.examples.adult_income.data_generator import (
        array_batches,
        load_npz,
    )

    train_data = load_npz(train_npz)  # one decompression for all epochs
    test_data = load_npz(test_npz)
    ctx = build_ctx(slot_names=train_data[0], feature_index_prefix_bit=12,
                    device=device)
    with ctx:
        for epoch in range(epochs):
            for batch in array_batches(*train_data, batch_size=batch_size):
                loss, _ = ctx.train_step(batch)
            logger.info("epoch %d done, last loss %.4f", epoch, float(loss))
        auc = evaluate(ctx, array_batches(*test_data, batch_size=batch_size,
                                          requires_grad=False))
    logger.info("npz test auc %.6f", auc)
    return auc


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: 512 synthetic, 128 npz (the reference "
                        "harness's batch size)")
    p.add_argument("--train-npz", default=None,
                   help="reference-format train.npz")
    p.add_argument("--test-npz", default=None,
                   help="reference-format test.npz (default: --train-npz)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="where the tower trains (cuda, or cpu)")
    args = p.parse_args()
    from persia_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card: raise before anything
    if args.train_npz:
        auc = main_npz(args.train_npz, args.test_npz or args.train_npz,
                       args.batch_size or 128, args.epochs, args.device)
    else:
        auc = main(args.steps, args.batch_size or 512, args.device)
    print(f"AUC: {auc}")
