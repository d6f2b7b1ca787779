"""Criteo DLRM training (``examples/criteo/train.py``).

Two modes:

- **local** (no ``PERSIA_COORDINATOR_ADDR``, or ``--local``): the PS
  holders live in this process; trains the first ``--samples`` lines of
  the Criteo TSV (``.gz``) file ``--train`` and prints the AUC of the
  first ``--test-samples`` lines of ``--test`` (by default ``--train``).
  Without ``--train``, or with ``--synthetic``, it trains ``--samples``
  synthetic samples (``--learnable`` for the hidden-weight task) and
  scores held-out ones (seed 99). ``--mesh D,M`` brings up
  ``torch.distributed`` from torchrun's environment (or a world of one)
  and trains data-parallel over it, the holders in the leader's process,
  which alone reads the file.
- **service** (the k8s job's nnWorker entry): discover the embedding
  workers through the coordinator, register a dataflow receiver and
  train on the batches the data-loader role pushes. With ``--mesh D,M``
  the trainer group the launcher starts (``PERSIA_PROCESS_INDEX`` /
  ``PERSIA_PROCESS_COUNT``) is one ``torch.distributed`` world of D × M
  ranks, met through the coordinator's KV store under
  ``PERSIA_TRAINER_RENDEZVOUS_KEY``: gloo on the CPU or on a card the
  ranks share (NCCL refuses two ranks on one device), NCCL when each has
  its own. Only the leader (process 0) registers the receiver and holds
  the remote worker; its ``DataLoader`` hands every batch to the other
  ranks. With ``--learnable`` the leader then evaluates ``--test-samples``
  held-out samples (seed 99) and reports their AUC.

``--device`` (default ``cuda``) is where the tower trains; without a
card, ``cuda`` raises. ``--result-dir`` has each process write
``rank<i>.json`` (steps, the rows it trained, its dense parameters'
digest, samples/s, the AUC on the leader).

    python persia_tpu_torch/examples/criteo/train.py --local \
        --train day_0.tsv.gz --test day_1.tsv.gz
    python persia_tpu_torch/examples/criteo/train.py --learnable --device cpu

    PERSIA_TRAINER_PROCESSES=2 PERSIA_COORDINATOR_ADDR=... RANK=0 \
        python -m persia_tpu_torch.launcher nn-worker \
        persia_tpu_torch/examples/criteo/train.py --mesh 2,1 --learnable
"""

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

try:  # the installed package
    import persia_tpu_torch  # noqa: F401
except ImportError:  # a bare checkout: its root on the path
    sys.path.insert(0, os.path.abspath(__file__).rsplit(
        "/persia_tpu_torch/", 1)[0])

from persia_tpu_torch import knobs  # noqa: E402
from persia_tpu_torch.config import EmbeddingSchema, uniform_slots  # noqa: E402
from persia_tpu_torch.examples.criteo.criteo_data import (  # noqa: E402
    NUM_DENSE,
    NUM_SLOTS,
    SLOT_NAMES,
    criteo_batches,
    learnable_batches,
    synthetic_batches,
)

logger = logging.getLogger("criteo")

REPO = os.path.abspath(__file__).rsplit("/persia_tpu_torch/", 1)[0]
# the schema the service roles load too (the JAX example's config)
DEFAULT_SCHEMA = os.path.join(REPO, "examples", "criteo", "config",
                              "embedding_config.yml")
TOWERS = ("dcnv2", "deepfm", "dlrm", "zoo-dlrm")


def load_schema(args) -> EmbeddingSchema:
    """One schema source: the YAML the service roles also load (schemas
    defined twice would disagree on widths); ``--dim`` only when the file
    is absent."""
    if os.path.exists(args.embedding_config):
        return EmbeddingSchema.load(args.embedding_config)
    return EmbeddingSchema(
        slots_config=uniform_slots(SLOT_NAMES, dim=args.dim),
        feature_index_prefix_bit=12)


def build_model(args, schema: EmbeddingSchema):
    from persia_tpu_torch.models import DCNv2, DLRM, DeepFM
    from persia_tpu_torch.workloads.models import ZooDLRM

    dims = [schema.get_slot(n).dim for n in SLOT_NAMES]
    if args.model == "dlrm":
        return DLRM(NUM_DENSE, NUM_SLOTS, embedding_dim=dims[0],
                    device=args.device)
    if args.model == "deepfm":
        return DeepFM(NUM_DENSE, NUM_SLOTS, embedding_dim=dims[0],
                      device=args.device)
    if args.model == "dcnv2":
        return DCNv2(NUM_DENSE, dims, device=args.device)
    # the zoo's mixed-dim tower (a projection a field before the
    # interaction), for a schema whose dims ladder by cardinality
    return ZooDLRM(NUM_DENSE, dims, proj_dim=dims[0], device=args.device)


def build_ctx(args, schema: EmbeddingSchema, worker=None, mesh=None,
              leader: bool = True):
    """The TrainCtx: OptaxAdagrad(``--lr``) dense, Adagrad(``--sparse-lr``)
    sparse, rows from U(-0.01, 0.01); without ``worker`` the leader's
    in-process holders."""
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.parallel.optim import OptaxAdagrad
    from persia_tpu_torch.utils import setup_seed

    setup_seed(args.seed)
    if worker is None and leader:
        from persia_tpu_torch.ps.native import make_holder
        from persia_tpu_torch.worker.worker import EmbeddingWorker

        worker = EmbeddingWorker(schema, [
            make_holder(args.ps_capacity, args.ps_shards)
            for _ in range(args.n_ps)])
    model = build_model(args, schema)
    return TrainCtx(
        model=model,
        dense_optimizer=OptaxAdagrad(model.parameters(), args.lr),
        embedding_optimizer=Adagrad(lr=args.sparse_lr),
        schema=schema,
        worker=worker,
        embedding_config=EmbeddingConfig(emb_initialization=(-0.01, 0.01)),
        mesh=mesh,
        grad_reduce_dtype=args.grad_reduce_dtype,
        seed=args.seed,
        device=args.device,
    )


def batches_for(args, requires_grad=True, test=False):
    """The TSV file's batches with ``--train`` (the test set's from
    ``--test``, else from the train file), else the synthetic stream."""
    if args.train and not args.synthetic:
        path = (args.test or args.train) if test else args.train
        return criteo_batches(
            path, args.batch_size,
            max_samples=args.test_samples if test else args.samples,
            requires_grad=requires_grad)
    n = args.test_samples if test else args.samples
    make = learnable_batches if args.learnable else synthetic_batches
    return make(n, args.batch_size, seed=99 if test else args.seed,
                vocab_per_slot=args.vocab, requires_grad=requires_grad)


def mesh_shape(args):
    return tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None


def evaluate(args, ctx) -> float:
    """The test set's AUC (``batches_for``'s) through ``eval_ctx``."""
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.utils import roc_auc

    preds, labels = [], []
    with eval_ctx(ctx) as ectx:
        for batch in batches_for(args, requires_grad=False, test=True):
            pred, label = ectx.forward(batch)
            preds.append(pred.float().cpu().numpy().reshape(-1))
            labels.append(np.asarray(label[0]).reshape(-1))
    return roc_auc(np.concatenate(labels), np.concatenate(preds))


def train_loop(args, ctx, loader, world: int) -> dict:
    """Every step of ``loader``; returns the steps, the rows of the
    global batches, this rank's share of them (a batch's rows split over
    the data axis when they divide evenly), the loop's wall and the first
    and last losses. Raises when a loss is not finite."""
    import torch

    steps = rows = mine = 0
    t0 = time.perf_counter()
    losses = []
    for batch in loader:
        loss, _ = ctx.train_step(batch)
        losses.append(torch.as_tensor(loss).detach().float().reshape(()))
        n = int(batch.batch.labels[0].data.shape[0])
        rows += n
        mine += n // world if n % world == 0 else n
        if steps % args.log_every == 0:
            logger.info("step %d loss %.5f", steps, float(loss))
        steps += 1
    # one read of every loss after the loop: no host sync a step
    seen = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    wall = time.perf_counter() - t0
    if not np.isfinite(seen).all():
        raise RuntimeError(f"a loss is not finite: step "
                           f"{int(np.argmin(np.isfinite(seen)))} of {seen}")
    return {"steps": steps, "rows": rows, "rows_trained": mine,
            "wall_s": wall,
            "loss_first": float(seen[0]) if steps else None,
            "loss_last": float(seen[-1]) if steps else None}


def kernel_launches() -> dict:
    """The port's kernels' launch counts in this process (K1-K5)."""
    from persia_tpu_torch.ops import embedding_bag, flash_attention, probe_copy

    out = {n: flash_attention.launch_count(n) for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}
    out.update(embedding_bag=embedding_bag.launch_count(),
               probe_copy=probe_copy.launch_count())
    return out


def write_result(args, index: int, doc: dict):
    if not args.result_dir:
        return
    os.makedirs(args.result_dir, exist_ok=True)
    path = os.path.join(args.result_dir, f"rank{index}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)


def main_remote(args, schema: EmbeddingSchema) -> float:
    """Service mode (the module docstring)."""
    from persia_tpu_torch.data.dataloader import (
        DataLoader,
        IterableDataset,
        StreamingDataset,
    )
    from persia_tpu_torch.device import resolve_device
    from persia_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, is_leader
    from persia_tpu_torch.service.coordinator import (
        ROLE_TRAINER,
        ROLE_WORKER,
        CoordinatorClient,
    )
    from persia_tpu_torch.service.dataflow import DataflowReceiver
    from persia_tpu_torch.service.trainer_service import (
        _param_digest,
        mesh_up,
    )
    from persia_tpu_torch.service.worker_service import RemoteEmbeddingWorker

    t_main = time.monotonic()
    index = knobs.get("PERSIA_PROCESS_INDEX")
    count = knobs.get("PERSIA_PROCESS_COUNT")
    coord = CoordinatorClient(knobs.get("PERSIA_COORDINATOR_ADDR"))
    mesh, backend, world = None, None, 1
    if args.mesh:
        shape = mesh_shape(args)
        if shape[0] * shape[1] != count:
            raise SystemExit(f"--mesh {args.mesh} needs {shape[0] * shape[1]}"
                             f" trainer processes, the group has {count} "
                             f"(PERSIA_TRAINER_PROCESSES)")
        mesh, backend = mesh_up(
            coord, index, count, resolve_device(args.device),
            knobs.get("PERSIA_TRAINER_RENDEZVOUS_KEY"), mesh_shape=shape)
        world = axis_size(mesh, DATA_AXIS)
    leader = mesh is None or is_leader(mesh)
    worker = receiver = None
    if leader:
        worker = RemoteEmbeddingWorker(
            coord.wait_members(ROLE_WORKER, args.num_remote_workers,
                               timeout=300))
        # the stream ends only after EVERY data-loader replica sends EOS
        receiver = DataflowReceiver(
            num_senders=knobs.get("PERSIA_NUM_DATALOADERS"))
        coord.register(ROLE_TRAINER, int(os.environ["RANK"]), receiver.addr)
    ctx = build_ctx(args, schema, worker=worker, mesh=mesh, leader=leader)
    dataset = (StreamingDataset(receiver) if leader
               else IterableDataset([]))
    loader = DataLoader(dataset, num_workers=args.num_workers,
                        embedding_staleness=args.staleness,
                        forward_buffer_size=args.staleness)
    auc = float("nan")
    with ctx:
        t_ready = time.monotonic()
        run = train_loop(args, ctx, loader, world)
        if leader and args.learnable:
            auc = evaluate(args, ctx)
    sps = run["rows"] / run["wall_s"] if run["wall_s"] > 0 else 0.0
    logger.info("stream ended after %d steps (%d rows, %.1f samples/s)%s",
                run["steps"], run["rows"], sps,
                f"; held-out auc {auc:.4f}" if leader and args.learnable
                else "")
    write_result(args, index, dict(
        run, process_index=index, process_count=count, leader=leader,
        backend=backend, device=str(ctx.device), samples_per_s=sps,
        digest=_param_digest(ctx.model), auc=auc,
        startup_s=t_ready - t_main, launches=kernel_launches()))
    if receiver is not None:
        receiver.close()
    if worker is not None:
        worker.close()
    return auc


def main_local(args, schema: EmbeddingSchema) -> float:
    """Local mode (the module docstring)."""
    from persia_tpu_torch.data.dataloader import DataLoader, IterableDataset

    mesh, world, leader = None, 1, True
    if args.mesh:
        from persia_tpu_torch.distributed import DistributedOption
        from persia_tpu_torch.parallel.mesh import (
            DATA_AXIS,
            axis_size,
            is_leader,
        )

        mesh = DistributedOption(mesh_shape=mesh_shape(args),
                                 device=args.device).initialize()
        world, leader = axis_size(mesh, DATA_AXIS), is_leader(mesh)
    ctx = build_ctx(args, schema, mesh=mesh, leader=leader)
    auc = float("nan")
    with ctx:
        loader = DataLoader(
            IterableDataset(batches_for(args) if leader else []),
            num_workers=args.num_workers,
            embedding_staleness=args.staleness,
            forward_buffer_size=args.staleness)
        run = train_loop(args, ctx, loader, world)
        if leader:
            auc = evaluate(args, ctx)
            logger.info("test auc %.6f", auc)
    write_result(args, 0 if leader else 1,
                 dict(run, auc=auc, launches=kernel_launches()))
    return auc


def main(argv=None) -> float:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--train", default=None, help="Criteo TSV (.gz) file")
    p.add_argument("--test", default=None,
                   help="Criteo TSV (.gz) test file (default: --train)")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic batches even with --train")
    p.add_argument("--local", action="store_true",
                   help="in-process PS even when a coordinator address is "
                        "in the environment")
    p.add_argument("--learnable", action="store_true",
                   help="the hidden-weight task (learnable_batches) "
                        "instead of noise labels; in service mode it also "
                        "runs the held-out AUC")
    p.add_argument("--embedding-config", default=DEFAULT_SCHEMA,
                   help="schema YAML (shared with the service roles)")
    p.add_argument("--num-remote-workers", type=int,
                   default=knobs.get("PERSIA_NUM_WORKERS"),
                   help="embedding-worker replicas to wait for "
                        "(service mode)")
    p.add_argument("--model", choices=TOWERS, default="dlrm")
    p.add_argument("--dim", type=int, default=16,
                   help="dim when --embedding-config is absent")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--samples", type=int, default=512_000)
    p.add_argument("--test-samples", type=int, default=65_536)
    p.add_argument("--vocab", type=int, default=1 << 20,
                   help="synthetic sign space a slot")
    p.add_argument("--n-ps", type=int, default=2)
    p.add_argument("--ps-capacity", type=int, default=1_000_000_000)
    p.add_argument("--ps-shards", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--sparse-lr", type=float, default=0.02)
    p.add_argument("--staleness", type=int, default=8)
    p.add_argument("--num-workers", type=int, default=4)
    # persialint: ok[knob-registry] the example's own variable, read from the environment as the JAX example reads it (neither registry has it)
    p.add_argument("--mesh", default=os.environ.get("PERSIA_MESH"),
                   help="D,M ranks, e.g. 2,1 for 2-way data parallelism "
                        "(env PERSIA_MESH, which a manifest's role env "
                        "sets)")
    p.add_argument("--grad-reduce-dtype", default=None,
                   choices=[None, "bf16"], help="bf16 halves DP all-reduce")
    p.add_argument("--device", default="cuda",
                   help="where the tower trains (cuda, or cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--result-dir", default=None,
                   help="each process writes rank<i>.json here")
    args = p.parse_args(argv)
    from persia_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card: raise before anything
    schema = load_schema(args)
    if knobs.get_raw("PERSIA_COORDINATOR_ADDR") and not args.local:
        return main_remote(args, schema)
    return main_local(args, schema)


if __name__ == "__main__":
    print(f"AUC: {main()}")
