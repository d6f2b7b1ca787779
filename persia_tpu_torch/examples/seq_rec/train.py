"""Long-history sequence recommendation (``examples/seq_rec/train.py``).

A DIN/SASRec-style CTR model: summed profile slots and one raw
variable-length history slot through :class:`~persia_tpu_torch.models.
SequenceTower` (self-attention over the history, masked mean pooling),
trained through the whole hybrid stack in one process (embedding worker,
the native C++ PS, the tower on ``--device``). The synthetic task hides
the label in the history (``workloads/generator.py:seqrec_batches``), so
a model that ignores the sequence cannot beat AUC 0.5; the script exits 1
below the JAX example's bar of 0.62.

``--mesh D,M --context-parallel ring|ulysses`` brings up
``torch.distributed`` from torchrun's environment (or a world of one), as
the criteo script does, and shards the history axis over the mesh's model
axis; the PS lives in the leader's process and every rank trains the
leader's batches. ``--attn-impl pallas`` runs the flash-attention kernels
K2-K4 (``xla`` the dense reference attention), the JAX example's names
mapped by ``weights.JAX_ATTN_IMPL``.

    python persia_tpu_torch/examples/seq_rec/train.py --device cpu --steps 300
    torchrun --nproc-per-node 2 persia_tpu_torch/examples/seq_rec/train.py \\
        --mesh 1,2 --context-parallel ulysses --attn-impl pallas

The module imports only the standard library and numpy at the top, so
that its widths can be read without torch.
"""

import argparse
import logging
import os
import sys

import numpy as np

logger = logging.getLogger("seq_rec")

DIM = 16
MLP = (256, 128)
PS_CAPACITY, PS_SHARDS = 2_000_000, 8  # make_holder's, a PS replica
DENSE_LR = 1e-3  # Adam (optax.adam)
SPARSE_LR = 1e-2  # Adagrad on the PS
EMB_INIT = (-0.05, 0.05)  # new PS rows: U(lower, upper)
AUC_BAR = 0.62
EVAL_SAMPLES = 4096


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--t-hist", type=int, default=64,
                   help="max history length (the sequence axis)")
    p.add_argument("--vocab", type=int, default=50_000,
                   help="item sign space of the shared zoo generator")
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--n-ps", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mesh", default=None,
                   help="data,model e.g. 1,4: the model axis shards the "
                        "history length (context parallelism)")
    p.add_argument("--context-parallel", choices=["ring", "ulysses"],
                   default="ring")
    p.add_argument("--attn-impl", choices=["xla", "pallas"], default="xla")
    p.add_argument("--device", default="cuda",
                   help="where the tower trains (cuda, or cpu)")
    args = p.parse_args(argv)
    if args.mesh:
        shape = mesh_shape(args)
        if len(shape) != 2 or args.t_hist % shape[1]:
            p.error("--mesh is D,M and --t-hist must divide by M")
    return args


def mesh_shape(args):
    return tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None


def spec(args):
    from persia_tpu_torch.workloads.generator import SeqRecSpec

    return SeqRecSpec(item_vocab=args.vocab, t_hist=args.t_hist)


def make_batches(args, num_samples, batch_size, seed=0, requires_grad=True):
    """The workload zoo's seqrec stream, read through this example's
    schema: the history stays a raw slot for the attention tower, the
    clicks slot takes the worker's last-4 pooling."""
    from persia_tpu_torch.workloads.generator import seqrec_batches

    return seqrec_batches(num_samples, batch_size, seed=seed,
                          spec=spec(args), requires_grad=requires_grad)


def build_schema(args):
    from persia_tpu_torch.config import (
        EmbeddingSchema,
        SlotConfig,
        uniform_slots,
    )
    from persia_tpu_torch.workloads.generator import (
        SEQ_CLICKS_SLOT,
        SEQ_HISTORY_SLOT,
        SEQ_PROFILE_SLOTS,
        SEQ_TARGET_SLOT,
    )

    slots = uniform_slots([*SEQ_PROFILE_SLOTS, SEQ_TARGET_SLOT], dim=DIM)
    slots[SEQ_HISTORY_SLOT] = SlotConfig(
        name=SEQ_HISTORY_SLOT, dim=DIM, embedding_summation=False,
        sample_fixed_size=args.t_hist)
    slots[SEQ_CLICKS_SLOT] = SlotConfig(
        name=SEQ_CLICKS_SLOT, dim=DIM, pooling="last4")
    return EmbeddingSchema(slots_config=slots)


def build_model(args, num_dense=None, mesh=None, compute_dtype=None,
                attn_impl=None, device=None):
    """The tower at the example's widths (weights as the constructor draws
    them: the TrainCtx's seed redraws them). ``attn_impl`` is the port's
    name (``reference`` / ``flash``); by default ``--attn-impl`` mapped."""
    import torch

    from persia_tpu_torch.models import SequenceTower
    from persia_tpu_torch.weights import JAX_ATTN_IMPL

    if num_dense is None:
        num_dense = spec(args).num_dense
    # the batch's feature order: 2 profiles, history (raw), clicks, target
    slots = [(DIM, False), (DIM, False), (DIM, True), (DIM, False),
             (DIM, False)]
    return SequenceTower(
        num_dense, slots, mlp=MLP, num_heads=args.heads,
        attn_impl=attn_impl or JAX_ATTN_IMPL[args.attn_impl],
        compute_dtype=compute_dtype or torch.bfloat16, mesh=mesh,
        context_parallel=args.context_parallel,
        device=device or args.device)


def build_worker(args, schema, backend=None):
    """``--n-ps`` fresh PS replicas (``make_holder``: the native C++
    store, or ``backend``) behind an in-process embedding worker."""
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    return EmbeddingWorker(schema, [
        make_holder(PS_CAPACITY, PS_SHARDS, backend=backend)
        for _ in range(args.n_ps)])


def build_ctx(args, mesh=None, leader: bool = True):
    """The TrainCtx: Adam(1e-3) dense, Adagrad(1e-2) sparse, PS rows from
    U(-0.05, 0.05), the tower's weights drawn from ``--seed``; the PS in
    this process where ``leader``."""
    import torch

    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.utils import setup_seed

    setup_seed(args.seed)
    schema = build_schema(args)
    worker = build_worker(args, schema) if leader else None
    model = build_model(args, mesh=mesh)
    return TrainCtx(
        model, torch.optim.Adam(model.parameters(), lr=DENSE_LR),
        Adagrad(lr=SPARSE_LR), schema, worker,
        embedding_config=EmbeddingConfig(emb_initialization=EMB_INIT),
        seed=args.seed, device=args.device, mesh=mesh)


def evaluate(ctx, args, num_samples: int = EVAL_SAMPLES) -> float:
    """The held-out AUC (seed ``--seed`` + 1000) through ``eval_ctx``."""
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.utils import roc_auc

    preds, labels = [], []
    with eval_ctx(ctx) as ectx:
        for batch in make_batches(args, num_samples, args.batch_size,
                                  seed=args.seed + 1000,
                                  requires_grad=False):
            pred, lab = ectx.forward(batch)
            preds.append(pred.float().cpu().numpy().reshape(-1))
            labels.append(np.asarray(lab[0]).reshape(-1))
    return roc_auc(np.concatenate(labels), np.concatenate(preds))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    from persia_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card: raise before anything
    mesh, leader, evaluates = None, True, True
    if args.mesh:
        from persia_tpu_torch.distributed import DistributedOption
        from persia_tpu_torch.parallel.mesh import is_leader

        mesh = DistributedOption(mesh_shape=mesh_shape(args),
                                 device=args.device).initialize()
        leader = is_leader(mesh)
        # a context-parallel tower evaluates on every rank, a data-
        # parallel one on the sparse leader alone
        evaluates = leader or mesh_shape(args)[1] > 1
    ctx = build_ctx(args, mesh=mesh, leader=leader)
    with ctx:
        n = 0
        for step, batch in enumerate(make_batches(
                args, args.steps * args.batch_size, args.batch_size,
                seed=args.seed)):
            loss, _ = ctx.train_step(batch)
            n += 1
            if step % 50 == 0:
                logger.info("step %d: loss %.4f", step, float(loss))
        if not evaluates:
            return 0
        auc = evaluate(ctx, args)
    logger.info("trained %d steps, test AUC %.4f", n, auc)
    print(f"AUC: {auc:.4f}")
    return 0 if auc > AUC_BAR else 1


if __name__ == "__main__":
    try:  # the installed package
        import persia_tpu_torch  # noqa: F401
    except ImportError:  # a bare checkout: its root on the path
        sys.path.insert(0, os.path.abspath(__file__).rsplit(
            "/persia_tpu_torch/", 1)[0])
    sys.exit(main())
