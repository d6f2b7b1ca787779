"""Data-loader role of the Criteo job (``examples/criteo/send_data.py``):
stream batches into the dataflow.

Run under the launcher with the coordinator, workers and trainers up:

    PERSIA_COORDINATOR_ADDR=... python -m persia_tpu_torch.launcher \
        data-loader persia_tpu_torch/examples/criteo/send_data.py \
        --train day_0.tsv.gz

With ``--train`` (env ``CRITEO_TRAIN``), a Criteo TSV (``.gz``) file,
replica ``REPLICA_INDEX`` of ``REPLICA_SIZE`` sends its share of the
file's first ``--samples`` lines: every ``REPLICA_SIZE``-th batch of
lines, skipped before parsing. Without it, the replica sends
``--samples // REPLICA_SIZE`` synthetic samples (``--learnable``: the
hidden-weight task) drawn from seed ``--seed + REPLICA_INDEX``. Either
way replicas never stream the same data. Each ends with an end of stream
that names it.
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
    criteo_batches,
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


def batch_source(args, replica_index: int, replica_size: int):
    """The batches replica ``replica_index`` of ``replica_size`` sends."""
    if args.train:
        return criteo_batches(args.train, args.batch_size,
                              max_samples=args.samples,
                              replica_index=replica_index,
                              replica_size=replica_size)
    if not args.learnable:
        logger.warning("no --train file; streaming synthetic batches")
    make = learnable_batches if args.learnable else synthetic_batches
    return make(args.samples // replica_size, args.batch_size,
                seed=args.seed + replica_index, vocab_per_slot=args.vocab)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train", default=os.environ.get("CRITEO_TRAIN"),
                   help="Criteo TSV (.gz) file (env CRITEO_TRAIN)")
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
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
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
    batches = batch_source(args, replica_index, replica_size)
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
