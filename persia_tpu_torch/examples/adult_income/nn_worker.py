"""nn-worker (trainer) role of the adult-income job
(``examples/adult_income/nn_worker.py``).

Registers a dataflow receiver with the coordinator, streams the batches
the data loaders push, and trains the DNN through the remote embedding
workers, on the card unless ``--device cpu``:

    PERSIA_COORDINATOR_ADDR=... RANK=0 WORLD_SIZE=1 \
        python -m persia_tpu_torch.launcher nn-worker \
        persia_tpu_torch/examples/adult_income/nn_worker.py
"""

import argparse
import logging
import os
import sys

try:  # the installed package
    import persia_tpu_torch  # noqa: F401
except ImportError:  # a bare checkout: its root on the path
    sys.path.insert(0, os.path.abspath(__file__).rsplit(
        "/persia_tpu_torch/", 1)[0])

import torch  # noqa: E402

from persia_tpu_torch import knobs  # noqa: E402
from persia_tpu_torch.config import EmbeddingSchema, uniform_slots  # noqa: E402
from persia_tpu_torch.ctx import TrainCtx  # noqa: E402
from persia_tpu_torch.device import resolve_device  # noqa: E402
from persia_tpu_torch.data.dataloader import (  # noqa: E402
    DataLoader,
    StreamingDataset,
)
from persia_tpu_torch.embedding import EmbeddingConfig  # noqa: E402
from persia_tpu_torch.embedding.optim import Adagrad  # noqa: E402
from persia_tpu_torch.examples.adult_income.data_generator import (  # noqa: E402
    NUM_DENSE,
    NUM_SLOTS,
)
from persia_tpu_torch.models import DNN  # noqa: E402
from persia_tpu_torch.service.coordinator import (  # noqa: E402
    ROLE_TRAINER,
    ROLE_WORKER,
    CoordinatorClient,
)
from persia_tpu_torch.service.dataflow import DataflowReceiver  # noqa: E402
from persia_tpu_torch.service.worker_service import \
    RemoteEmbeddingWorker  # noqa: E402

logger = logging.getLogger("nn_worker")


def main():
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--num-workers", type=int, default=1)
    # the reference's e2e compose contract (REPRODUCIBLE=1 +
    # EMBEDDING_STALENESS=1 -> deterministic runs); empty or unset values
    # fall back
    try:
        staleness_default = int(os.environ.get("EMBEDDING_STALENESS") or 8)
    except ValueError:
        staleness_default = 8
    p.add_argument("--embedding-staleness", type=int,
                   default=staleness_default)
    p.add_argument("--reproducible", action="store_true",
                   default=os.environ.get("REPRODUCIBLE") == "1")
    p.add_argument("--device", default="cuda",
                   help="where the DNN trains (cuda, or cpu)")
    args = p.parse_args()
    device = resolve_device(args.device)  # no card: raise before anything

    rank = int(os.environ["RANK"])
    coord = CoordinatorClient(knobs.get("PERSIA_COORDINATOR_ADDR"))
    worker = RemoteEmbeddingWorker(
        coord.wait_members(ROLE_WORKER, args.num_workers, timeout=300))
    # the stream ends only after EVERY data-loader replica sends EOS
    receiver = DataflowReceiver(
        num_senders=knobs.get("PERSIA_NUM_DATALOADERS"))
    coord.register(ROLE_TRAINER, rank, receiver.addr)

    schema = EmbeddingSchema(
        slots_config=uniform_slots(
            [f"slot_{s}" for s in range(NUM_SLOTS)], dim=8))
    model = DNN(NUM_DENSE, [8] * NUM_SLOTS, device=device)
    ctx = TrainCtx(
        model=model,
        dense_optimizer=torch.optim.Adam(model.parameters(), lr=1e-3),
        embedding_optimizer=Adagrad(lr=1e-2),
        schema=schema,
        worker=worker,
        embedding_config=EmbeddingConfig(emb_initialization=(-0.05, 0.05)),
        device=device,
    )
    loader = DataLoader(StreamingDataset(receiver),
                        embedding_staleness=args.embedding_staleness,
                        reproducible=args.reproducible)
    steps = 0
    with ctx:
        for batch in loader:
            loss, _ = ctx.train_step(batch)
            if steps % 50 == 0:
                logger.info("step %d loss %.4f", steps, float(loss))
            steps += 1
    logger.info("stream ended after %d steps", steps)
    receiver.close()


if __name__ == "__main__":
    main()
