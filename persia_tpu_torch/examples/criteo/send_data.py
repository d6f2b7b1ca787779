"""Data-loader role of the Criteo job (``examples/criteo/send_data.py``):
stream batches into the dataflow.

Run under the launcher with the coordinator, workers and trainers up:

    PERSIA_COORDINATOR_ADDR=... python -m persia_tpu_torch.launcher \
        data-loader persia_tpu_torch/examples/criteo/send_data.py \
        --learnable --samples 49152 --batch-size 256 --vocab 500

Replica ``REPLICA_INDEX`` of ``REPLICA_SIZE`` sends ``--samples //
REPLICA_SIZE`` samples drawn from seed ``--seed + REPLICA_INDEX``, so
replicas never stream the same data, then an end of stream that names it.
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
from persia_tpu_torch.examples.criteo.criteo_data import (  # noqa: E402
    learnable_batches,
    synthetic_batches,
)
from persia_tpu_torch.service.coordinator import (  # noqa: E402
    ROLE_TRAINER,
    ROLE_WORKER,
    CoordinatorClient,
)
from persia_tpu_torch.service.dataflow import DataflowClient  # noqa: E402
from persia_tpu_torch.service.worker_service import \
    RemoteEmbeddingWorker  # noqa: E402

logger = logging.getLogger("criteo_data_loader")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=512_000)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--vocab", type=int, default=1 << 20)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--learnable", action="store_true",
                   help="stream learnable_batches (hidden-weight labels) "
                        "instead of noise-label synthetic_batches")
    # fleet sizes come from the manifest generator's env wiring
    p.add_argument("--num-workers", type=int,
                   default=knobs.get("PERSIA_NUM_WORKERS"))
    p.add_argument("--num-trainers", type=int,
                   default=int(os.environ.get("WORLD_SIZE") or 1))
    args = p.parse_args(argv)
    replica_index = int(os.environ.get("REPLICA_INDEX") or 0)
    replica_size = int(os.environ.get("REPLICA_SIZE") or 1)

    coord = CoordinatorClient(knobs.get("PERSIA_COORDINATOR_ADDR"))
    worker = RemoteEmbeddingWorker(
        coord.wait_members(ROLE_WORKER, args.num_workers, timeout=300))
    trainers = coord.wait_members(ROLE_TRAINER, args.num_trainers,
                                  timeout=300)
    logger.info("dataflow to %d workers, %d trainers (loader %d/%d)",
                args.num_workers, len(trainers), replica_index,
                replica_size)
    make = learnable_batches if args.learnable else synthetic_batches
    batches = make(args.samples // replica_size, args.batch_size,
                   seed=args.seed + replica_index,
                   vocab_per_slot=args.vocab)
    sent = 0
    with DataCtx(DataflowClient(worker, trainers)) as ctx:
        for batch in batches:
            batch.batch_id = None  # DataCtx assigns this loader's ids
            ctx.send_data(batch)
            sent += len(batch.labels[0].data)
        # an end of stream that names its replica: a liveness monitor's
        # abort_sender() for it dedupes against the one sent here
        ctx.dataflow.send_eos(sender_id=replica_index)
    logger.info("sent %d samples; eos", sent)


if __name__ == "__main__":
    main()
