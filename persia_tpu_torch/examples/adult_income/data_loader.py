"""Data-loader role of the adult-income job
(``examples/adult_income/data_loader.py``).

Run under the launcher with a coordinator, workers and trainers up:

    PERSIA_COORDINATOR_ADDR=... python -m persia_tpu_torch.launcher \
        data-loader persia_tpu_torch/examples/adult_income/data_loader.py \
        --samples 51200
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

from persia_tpu_torch import knobs  # noqa: E402
from persia_tpu_torch.ctx import DataCtx  # noqa: E402
from persia_tpu_torch.examples.adult_income.data_generator import \
    batches  # noqa: E402
from persia_tpu_torch.service.coordinator import (  # noqa: E402
    ROLE_TRAINER,
    ROLE_WORKER,
    CoordinatorClient,
)
from persia_tpu_torch.service.dataflow import DataflowClient  # noqa: E402
from persia_tpu_torch.service.worker_service import \
    RemoteEmbeddingWorker  # noqa: E402

logger = logging.getLogger("data_loader")


def main():
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=51200)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--num-trainers", type=int, default=1)
    args = p.parse_args()

    coord = CoordinatorClient(knobs.get("PERSIA_COORDINATOR_ADDR"))
    worker = RemoteEmbeddingWorker(
        coord.wait_members(ROLE_WORKER, args.num_workers, timeout=300))
    trainers = coord.wait_members(ROLE_TRAINER, args.num_trainers,
                                  timeout=300)
    logger.info("dataflow to %d workers, %d trainers", args.num_workers,
                len(trainers))
    with DataCtx(DataflowClient(worker, trainers)) as ctx:
        for batch in batches(args.samples, args.batch_size, seed=args.seed):
            ctx.send_data(batch)
        ctx.dataflow.send_eos()
    logger.info("sent %d samples; eos", args.samples)


if __name__ == "__main__":
    main()
