"""Data parallelism of the PyTorch port against the JAX package, on the CPU.

The port's ranks are gloo processes on the CPU, started once a scenario
by ``test_torch_ranks`` (each group under a deadline,
so that a dead child fails the test in seconds); they import only the
port (this file, run as a script, imports JAX only inside the tests).
The references are JAX meshes over the conftest's virtual CPU devices
(``jax.devices()[:W]``). A module-scoped fixture runs each group and
the JAX side once; each case is a test of its own on the results.

Compared, with the test each mirrors in ``tests/test_models_parallel.py``
or ``tests/test_multihost.py``:

- ``_ef_int8_mean`` at W=4 and W=8, n=1000 (the padding path) and n a
  multiple of W·1024 (``test_ef_int8_mean_primitive``): the stage-1 int8
  codes bit-equal (both round half to even after the same f32 division),
  the mean within 1e-6 (the f32 shard mean sums the ranks' copies in
  another order, and XLA contracts the products into FMAs), the residual
  within 1e-6 off the rank's own shard and within W × 1e-6 on it (there
  it carries W times the stage-2 error of that shard's mean);
- ``TrainCtx(mesh=)`` with f32, bf16 and int8_ef reduction against the
  JAX ``TrainCtx(mesh=make_mesh((W, 1)))`` on the batches of
  ``test_ddp_hybrid_step_matches_single_device``, from the same DLRM
  weights and fresh PS rows, f32 compute and wire: losses and shipped
  embedding gradients within 1e-4 relative for f32 (the same math, the
  all-reduce summing in another order) and 2e-3 for bf16 and int8_ef
  (a gradient an ulp apart can round to the neighbouring bf16 value or
  int8 code, 2**-8 of the value or 1/127 of its bucket's largest, which
  Adagrad carries into the next steps); the dense parameters after the
  run within the same bounds, and bit-equal on every rank;
- the DDP step's embedding gradients are W times the single-device
  step's, in both packages (the JAX step's stated scale, ROADMAP §C);
- the partial-batch fallback (``test_ddp_partial_final_batch_falls_back``)
  and a raw slot, which both take the fallback;
- device mode at ``make_mesh((W, 1))`` against ``make_device_mode_trainer``
  with a (W, 1) mesh: losses and parameters within 1e-5, the rule of
  ``tests/test_torch_device_mode.py``;
- device mode with tables row-sharded over the model axis, at
  ``make_mesh((2, 2))`` and ``make_mesh((1, 4))`` (vocab 256, which
  divides 4) against the JAX trainer on the same mesh shapes
  (``tests/test_models_parallel.py:91``): losses, every table shard
  against the JAX table's same rows, the gathered tables against the
  whole JAX tables and the tower within 1e-5; towers bit-equal on every
  rank, shards bit-equal across the data axis;
- the refusals, and a two-process ``DistributedOption`` rendezvous over
  an explicit ``tcp://`` address (``test_two_process_distributed_rendezvous_and_collective``);
- ``gpu``: ``_ef_int8_mean`` and a DDP step at world 1 over NCCL, and the
  collectives' autograd on device tensors (run on the card with
  ``python -m pytest tests/test_torch_ddp.py -m gpu --noconftest``).
"""

import os
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
W = 4
DEADLINE_S = 240.0
BS, DIM, N_DENSE, N_SLOTS, VOCAB, STEPS = 64, 8, 13, 4, 500, 8
LR = 0.05
EF_CASES = [(4, 1000), (4, 4 * 1024 * 2), (8, 1000), (8, 8 * 1024)]
MODES = [None, "bf16", "int8_ef"]
MODE_TOL = {None: 1e-4, "bf16": 2e-3, "int8_ef": 2e-3}
# device mode, at tests/test_torch_device_mode.py's widths
DM_SLOTS, DM_VOCAB, DM_DIM, DM_BS, DM_TOL = 4, 257, 8, 32, 1e-5
# device mode with tables row-sharded over the model axis: a vocab that
# divides it (JAX's device_put refuses one that does not)
DM_SHARDED_VOCAB = 256
DM_SHARDED_MESHES = [(2, 2), (1, 4)]


def _child_env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


# --- inputs, made alike by both packages -----------------------------------


def make_batches(mod, n, bs, seed, sizes=None, raw=False):
    """The batches of ``test_ddp_hybrid_step_matches_single_device``
    (``mod`` is either package's batch module); ``sizes`` overrides the
    row count step by step, ``raw`` adds a ragged slot ``hist``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = sizes[i] if sizes else bs
        feats = [mod.IDTypeFeatureWithSingleID(
            f"s{k}", rng.integers(0, VOCAB, size=rows, dtype=np.uint64))
            for k in range(N_SLOTS)]
        if raw:
            feats.append(mod.IDTypeFeature("hist", [
                rng.integers(0, VOCAB, size=rng.integers(1, 5))
                .astype(np.uint64) for _ in range(rows)]))
        out.append(mod.PersiaBatch(
            feats, non_id_type_features=[mod.NonIDTypeFeature(
                rng.normal(size=(rows, N_DENSE)).astype(np.float32))],
            labels=[mod.Label(rng.integers(0, 2, size=(rows, 1))
                              .astype(np.float32))],
            batch_id=i))
    return out


def schema(cfg, raw=False):
    slots = cfg.uniform_slots([f"s{k}" for k in range(N_SLOTS)], dim=DIM)
    if raw:
        slots["hist"] = cfg.SlotConfig(name="hist", dim=DIM,
                                       embedding_summation=False,
                                       sample_fixed_size=4)
    return cfg.EmbeddingSchema(slots_config=slots)


FALLBACK_SIZES = [64, 62, 64]  # 62 rows do not divide W = 4


def ef_inputs(world, n):
    return np.random.default_rng(world * 7 + n).normal(
        size=(world, n)).astype(np.float32)


# --- the port's ranks (run in the children; torch and the port only) -------


def _record(worker):
    seen = []
    inner = worker.update_gradients

    def update(ref_id, grads, *a, **kw):
        seen.append({k: np.array(v) for k, v in grads.items()})
        return inner(ref_id, grads, *a, **kw)

    worker.update_gradients = update
    return seen


def port_ctx(params, mesh=None, leader=True, mode=None, raw=False,
             worker=True, **kw):
    """The port's TrainCtx on the CPU: DLRM from the flax ``params``,
    OptaxAdagrad and sparse Adagrad at LR, f32 wire; the worker (two
    per-entry numpy PS shards) only where ``leader``; ``kw`` to the
    TrainCtx."""
    from persia_tpu_torch import config as tcfg
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models.dlrm import DLRM
    from persia_tpu_torch.parallel.optim import OptaxAdagrad
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.weights import load_flax_params
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    sch = schema(tcfg, raw)
    model = DLRM(N_DENSE, len(sch.slots_config), embedding_dim=DIM,
                 compute_dtype=torch.float32, device="cpu")
    load_flax_params(model, params)
    w = (EmbeddingWorker(sch, [EmbeddingHolder(100_000, 4)
                               for _ in range(2)])
         if leader and worker else None)
    return TrainCtx(model, OptaxAdagrad(model.parameters(), LR),
                    Adagrad(lr=LR), sch, w, device="cpu", mesh=mesh,
                    grad_reduce_dtype=mode,
                    global_config=tcfg.GlobalConfig(tcfg.CommonConfig("f32")),
                    **kw)


def port_run(ctx, batches):
    """Train ``batches``; (losses, ``_ddp`` flags, shipped gradients on
    the leader, final flat parameters)."""
    from persia_tpu_torch.weights import flax_params

    grads = _record(ctx.worker) if ctx.worker is not None else None
    losses, ddp = [], []
    with ctx:
        for b in batches:
            loss, pred = ctx.train_step(b)
            assert pred.shape == (b.labels[0].data.shape[0], 1)
            losses.append(float(loss))
            ddp.append(ctx._ddp)
    return losses, ddp, grads, flat(flax_params(ctx.model)[0])


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _refusal(fn):
    try:
        fn()
    except Exception as e:  # the test asserts the type and the message
        return f"{type(e).__name__}: {e}"
    return None


def loaded_jax_modules():
    """What a rank loaded of JAX or the JAX package (must be nothing)."""
    return sorted(n for n in sys.modules if n.split(".")[0] in
                  ("jax", "jaxlib", "flax", "optax", "persia_tpu"))


def _worker_patch():
    # the middleware's numpy twin: no C++ build in a child
    from persia_tpu_torch.worker import middleware

    middleware._mw_native = lambda: None


def body_ddp(inputs):
    """Rank body of the W=4 group: the int8 mean, TrainCtx over the mesh
    in three reductions, the fallback, device mode and the refusals."""
    import torch.distributed as dist

    from persia_tpu_torch.data import batch as tb
    from persia_tpu_torch.distributed import DistributedOption
    from persia_tpu_torch.parallel.mesh import DATA_AXIS, axis_group
    from persia_tpu_torch.parallel.train import _ef_int8_mean

    torch.set_num_threads(1)
    _worker_patch()
    mesh = DistributedOption(mesh_shape=(W, 1), device="cpu",
                             timeout=60).initialize()
    me = dist.get_rank()
    leader = me == 0
    out = {"ef": {}, "runs": {}}
    group = axis_group(mesh, DATA_AXIS)
    for world, n in EF_CASES:
        if world == W:
            x = torch.from_numpy(ef_inputs(world, n)[me])
            mean, err = _ef_int8_mean(x, group, world)
            out["ef"][(world, n)] = (mean.numpy(), err.numpy())
    params = inputs["params"]
    batches = make_batches(tb, STEPS, BS, seed=11)
    for mode in MODES:
        out["runs"][mode] = port_run(
            port_ctx(params, mesh, leader, mode), batches)
    out["runs"]["fallback"] = port_run(
        port_ctx(params, mesh, leader),
        make_batches(tb, 3, BS, 5, sizes=FALLBACK_SIZES))
    out["runs"]["raw"] = port_run(
        port_ctx(inputs["raw_params"], mesh, leader, raw=True),
        make_batches(tb, 2, BS, 6, raw=True))
    out["device_mode"] = device_mode_run(inputs, mesh)
    out["device_mode_sharded"] = {
        shape: device_mode_sharded_run(inputs, shape)
        for shape in DM_SHARDED_MESHES}
    out["refusals"] = refusals(inputs, mesh, leader)
    out["jax_modules"] = loaded_jax_modules()
    return out


def device_mode_run(inputs, mesh):
    from persia_tpu_torch.models.dlrm import DLRM
    from persia_tpu_torch.parallel import device_mode as tdm
    from persia_tpu_torch.parallel.optim import OptaxAdagrad
    from persia_tpu_torch.weights import flax_params, load_flax_params

    specs = tdm.criteo_like_specs(DM_SLOTS, DM_VOCAB, DM_DIM)
    tower = DLRM(N_DENSE, DM_SLOTS, embedding_dim=DM_DIM,
                 compute_dtype=torch.float32, device="cpu")
    model = tdm.DeviceModeModel(specs, tower, device="cpu")
    load_flax_params(model, inputs["dm_params"])
    non_id, ids, label = inputs["dm_batch"]
    model, _, step = tdm.make_device_mode_trainer(
        model, lambda p: OptaxAdagrad(p, 0.02), non_id, ids, seed=None,
        device="cpu", mesh=mesh)
    losses = [float(step(non_id, ids, label)) for _ in range(3)]
    return losses, flat(flax_params(model)[0])


def device_mode_sharded_run(inputs, shape):
    """3 steps of make_device_mode_trainer over make_mesh(shape), tables
    row-sharded over its model axis, from the JAX trainer's initial
    weights; the losses, this rank's parameters (its table shards), the
    gathered tables, the windows and this rank's mesh coordinates."""
    from persia_tpu_torch.models.dlrm import DLRM
    from persia_tpu_torch.parallel import device_mode as tdm
    from persia_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        axis_index,
        make_mesh,
    )
    from persia_tpu_torch.parallel.optim import OptaxAdagrad
    from persia_tpu_torch.weights import flax_params, load_flax_params

    mesh = make_mesh(shape, device="cpu")
    init, (non_id, ids, label) = inputs["dm_sharded"][shape]
    specs = tdm.criteo_like_specs(DM_SLOTS, DM_SHARDED_VOCAB, DM_DIM)
    tower = DLRM(N_DENSE, DM_SLOTS, embedding_dim=DM_DIM,
                 compute_dtype=torch.float32, device="cpu")
    model = tdm.DeviceModeModel(specs, tower, device="cpu")
    load_flax_params(model, init)
    model, _, step = tdm.make_device_mode_trainer(
        model, lambda p: OptaxAdagrad(p, 0.02), non_id, ids, seed=None,
        device="cpu", mesh=mesh)
    losses = [float(step(non_id, ids, label)) for _ in range(3)]
    coll = model.DeviceEmbeddingCollection_0
    return {"losses": losses, "params": flat(flax_params(model)[0]),
            "gathered": flat(flax_params(model, gather_tables=True)[0]),
            "windows": {name: getattr(coll, f"bag_{name}").window
                        for name, _, _ in specs},
            "coords": (axis_index(mesh, DATA_AXIS),
                       axis_index(mesh, MODEL_AXIS)),
            "sum_grad": sharded_table_grads(mesh, specs, init, ids)}


def sharded_table_grads(mesh, specs, init, ids):
    """The table gradients of one collection forward and backward (bf16
    compute, a fixed cotangent, the whole batch on every rank), sharded
    over the model axis and gathered, against the same collection
    unsharded on this rank: (the max abs difference, the largest
    unsharded gradient, the ratio of their sums of magnitudes)."""
    from persia_tpu_torch.parallel.collectives import all_gather
    from persia_tpu_torch.parallel.device_embedding import (
        DeviceEmbeddingCollection,
    )
    from persia_tpu_torch.weights import load_flax_params

    ids = {k: torch.from_numpy(np.array(v)) for k, v in ids.items()}
    cots = [torch.from_numpy(np.random.default_rng(i).normal(
        size=(DM_BS, DM_DIM)).astype(np.float32)) for i in range(DM_SLOTS)]
    grads = []
    for shard in (False, True):
        c = DeviceEmbeddingCollection(specs, device="cpu")
        load_flax_params(c, init["DeviceEmbeddingCollection_0"])
        if shard:
            c.shard_(mesh)
        sum((o * cot).sum() for o, cot in zip(c(ids), cots)).backward()
        bags = [getattr(c, f"bag_{name}") for name, _, _ in specs]
        # a shard's gradient is gathered as the shards themselves are
        grads.append(torch.cat([
            (all_gather(b.table.grad.to_dense(), b.group, 0) if shard
             else b.table.grad.to_dense()).reshape(-1) for b in bags]))
    one, sharded = grads
    return (float((sharded - one).abs().max()), float(one.abs().max()),
            float(sharded.abs().sum() / one.abs().sum()))


def refusals(inputs, mesh, leader):
    """The refusals, and what item 3c made work where refusals stood: a
    collective snapshot, checkpoint dump and resume, and a DataLoader
    (None where the call raised nothing)."""
    from persia_tpu_torch.data import batch as tb
    from persia_tpu_torch.data.dataloader import DataLoader, IterableDataset
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.weights import flax_params
    from persia_tpu_torch.models.dlrm import DLRM
    from persia_tpu_torch.parallel import device_mode as tdm
    from persia_tpu_torch.parallel.mesh import make_mesh
    from persia_tpu_torch.parallel.optim import OptaxAdagrad

    params = inputs["params"]
    out = {}
    specs = tdm.criteo_like_specs(DM_SLOTS, DM_VOCAB, DM_DIM)
    model = tdm.DeviceModeModel(specs, DLRM(
        N_DENSE, DM_SLOTS, embedding_dim=DM_DIM, device="cpu"),
        device="cpu")
    non_id, ids, _ = inputs["dm_batch"]
    sharded = make_mesh((2, 2), device="cpu")
    out["model_axis"] = _refusal(lambda: tdm.make_device_mode_trainer(
        model, lambda p: OptaxAdagrad(p, 0.02), non_id, ids,
        device="cpu", mesh=sharded))
    out["wrong_worker"] = _refusal(lambda: port_ctx(
        params, mesh, leader=True))
    out["bad_dtype"] = _refusal(lambda: port_ctx(params, mesh, leader,
                                                 mode="fp8"))
    snaps = os.path.join(inputs["tmp"], "snaps")
    ckpt_dir = os.path.join(inputs["tmp"], "ckpt")
    cursor = {"seed": 1, "consumed": 1}
    ctx = port_ctx(params, mesh, leader)
    with ctx:
        (warm,) = make_batches(tb, 1, BS, 2)
        ctx.train_step(warm)  # the optimizer holds state to snapshot
        out["snapshot"] = _refusal(lambda: out.__setitem__(
            "snap", ctx.snapshot(snaps, cursor=cursor)))
        out["snap_params"] = flat(flax_params(ctx.model)[0])
        out["dump_checkpoint"] = _refusal(
            lambda: ctx.dump_checkpoint(ckpt_dir))

        def loader():
            out["loader_losses"] = [
                float(ctx.train_step(lb)[0])
                for lb in DataLoader(IterableDataset(
                    make_batches(tb, 2, BS, 1)), num_workers=2,
                    embedding_staleness=1)]

        out["dataloader"] = _refusal(loader)
        (mine,) = make_batches(tb, 1, BS, 1)
        mine.batch_id = ctx.mesh.get_rank()  # every rank another batch
        out["other_batches"] = _refusal(lambda: ctx.train_step(mine))
        (same,) = make_batches(tb, 1, BS, 1)
        loss, _ = ctx.train_step(same)  # the mesh still works after it
        out["after"] = float(loss)

        def evaluate():
            with eval_ctx(ctx) as e:
                pred, _ = e.forward(same)
            assert pred.shape == (BS, 1) and bool(torch.isfinite(pred).all())

        out["eval"] = _refusal(evaluate)
        out["end_params"] = flat(flax_params(ctx.model)[0])
    out["ckpt_dir"] = ckpt_dir

    def resume():
        again = port_ctx(params, mesh, leader, resume_from=snaps)
        with again:
            out["resumed"] = (again.resume_cursor, again._step_count,
                              flat(flax_params(again.model)[0]))

    out["resume_from"] = _refusal(resume)
    return out


def body_ef8(inputs):
    """Rank body of the W=8 group: the int8 mean alone."""
    import torch.distributed as dist

    from persia_tpu_torch.distributed import DistributedOption
    from persia_tpu_torch.parallel.mesh import DATA_AXIS, axis_group
    from persia_tpu_torch.parallel.train import _ef_int8_mean

    torch.set_num_threads(1)
    mesh = DistributedOption(device="cpu", timeout=60).initialize()
    out = {}
    for world, n in EF_CASES:
        if world == 8:
            x = torch.from_numpy(ef_inputs(world, n)[dist.get_rank()])
            mean, err = _ef_int8_mean(x, axis_group(mesh, DATA_AXIS), world)
            out[(world, n)] = (mean.numpy(), err.numpy())
    return out


def body_rendezvous(inputs):
    """Rank body of the two-process rendezvous over an explicit tcp://
    address: a collective, the mesh, the option's kwargs, and an int8_ef
    DDP step of a DNN over the two ranks."""
    import torch.distributed as dist

    from persia_tpu_torch.distributed import (
        DistributedOption,
        get_default_distributed_option,
    )
    from persia_tpu_torch.models.dnn import DNN
    from persia_tpu_torch.parallel.train import (
        init_ef_state,
        make_packed_train_step_ddp,
    )

    torch.set_num_threads(1)
    out = {"nccl_on_cpu": _refusal(lambda: DistributedOption(
        backend="nccl", device="cpu").initialize())}
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    opt = DistributedOption(device="cpu", grad_reduce_dtype="int8_ef",
                            init_method=addr, world_size=world, rank=rank,
                            timeout=60)
    kwargs = opt.train_ctx_kwargs()
    mesh = kwargs["mesh"]
    out.update(backend=str(dist.get_backend()), world=dist.get_world_size(),
               rank=dist.get_rank(), shape=tuple(mesh.shape),
               names=mesh.mesh_dim_names, same=opt.initialize() is mesh,
               kwargs=sorted(kwargs), reduce=kwargs["grad_reduce_dtype"],
               default=get_default_distributed_option().mesh_shape)
    total = torch.tensor([float(rank + 1)])
    dist.all_reduce(total)
    out["total"] = float(total)
    torch.manual_seed(0)  # the same DNN on both ranks
    model = DNN(5, [8, 8], device="cpu")
    opt2 = torch.optim.SGD(model.parameters(), lr=0.1)
    step = make_packed_train_step_ddp(model, opt2, [8, 8], mesh,
                                      grad_reduce_dtype="int8_ef")
    ef = init_ef_state(model, mesh)
    rng = np.random.default_rng(rank)
    args = ([torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32))],
            torch.from_numpy(rng.normal(size=(4, 16))
                             .astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(rng.integers(0, 2, size=(4, 1))
                             .astype(np.float32)))
    for _ in range(2):  # the second step takes the carried residual
        loss, _, _, ef = step(*args, ef)
    out["ef_loss"] = float(loss)
    out["ef_residual_nonzero"] = bool(ef.abs().sum() > 0)
    out["params"] = torch.cat([p.detach().reshape(-1)
                               for p in model.parameters()]).numpy()
    return out


BODIES = {"ddp": body_ddp, "ef8": body_ef8, "rendezvous": body_rendezvous}


# --- the JAX side (the pytest process) ---------------------------------------


def jax_params(raw=False):
    """The JAX DLRM's initial flax params as numpy trees."""
    import jax
    import jax.numpy as jnp

    from persia_tpu.models import DLRM

    n = N_SLOTS + (1 if raw else 0)
    variables = DLRM(embedding_dim=DIM, compute_dtype=jnp.float32).init(
        jax.random.key(3), [jnp.zeros((BS, N_DENSE))],
        [jnp.zeros((BS, DIM)) for _ in range(n)], train=False)
    return jax.tree_util.tree_map(np.asarray, dict(variables["params"]))


def jax_ctx(params, mesh=None, mode=None, raw=False):
    import jax
    import jax.numpy as jnp
    import optax

    from persia_tpu import config as jcfg
    from persia_tpu.ctx import TrainCtx
    from persia_tpu.embedding.optim import Adagrad
    from persia_tpu.models import DLRM
    from persia_tpu.parallel.train import TrainState, make_eval_step
    from persia_tpu.ps.store import EmbeddingHolder
    from persia_tpu.worker.worker import EmbeddingWorker

    gc = jcfg.GlobalConfig()
    gc.common.embedding_wire_dtype = "f32"
    sch = schema(jcfg, raw)
    model = DLRM(embedding_dim=DIM, compute_dtype=jnp.float32)
    opt = optax.adagrad(LR)
    ctx = TrainCtx(model=model, dense_optimizer=opt,
                   embedding_optimizer=Adagrad(lr=LR), schema=sch,
                   worker=EmbeddingWorker(sch, [EmbeddingHolder(100_000, 4)
                                                for _ in range(2)]),
                   global_config=gc, mesh=mesh, grad_reduce_dtype=mode)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    ctx.state = TrainState(params=p, batch_stats={}, opt_state=opt.init(p),
                           step=jnp.zeros((), jnp.int32))
    ctx._eval_step = make_eval_step(model)
    return ctx


def jax_run(ctx, batches):
    grads = _record(ctx.worker)
    losses, ddp = [], []
    with ctx:
        for b in batches:
            loss, _ = ctx.train_step(b)
            losses.append(float(loss))
            ddp.append(ctx._ddp)
    return losses, ddp, grads, flat(ctx.state.params)


def jax_ef(world, n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from persia_tpu.parallel.mesh import make_mesh
    from persia_tpu.parallel.ring_attention import _shard_map
    from persia_tpu.parallel.train import _ef_int8_mean

    mesh = make_mesh((world, 1), devices=jax.devices()[:world])

    def local(x):
        mean, err = _ef_int8_mean(x[0], "data", world)
        return mean[None], err[None]

    fn = _shard_map(local, mesh, in_specs=(P("data"),),
                    out_specs=(P("data"), P("data")))
    mean, err = jax.jit(fn)(jnp.asarray(ef_inputs(world, n)))
    return np.asarray(mean), np.asarray(err)


def jax_device_mode(mesh_shape, vocab=DM_VOCAB):
    """3 steps of the JAX device-mode trainer on a (D, M) mesh; the
    initial params, the batch, the losses and the params."""
    import jax
    import jax.numpy as jnp
    import optax

    from persia_tpu.models import DLRM as JDLRM
    from persia_tpu.parallel import device_mode as jdm
    from persia_tpu.parallel.mesh import make_mesh, shard_batch_pytree

    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:n])
    specs = jdm.criteo_like_specs(DM_SLOTS, vocab, DM_DIM)
    model = jdm.DeviceModeModel(slot_specs=specs, tower=JDLRM(
        embedding_dim=DM_DIM, compute_dtype=jnp.float32))
    non_id, ids, label = jdm.synthetic_device_batch(DM_BS, N_DENSE, specs, 3)
    ids = {k: np.array(v) for k, v in ids.items()}
    for i, v in enumerate(ids.values()):
        v[np.random.default_rng(11 + i).random(v.shape) < 0.25] = 0
    params, opt_state, step = jdm.make_device_mode_trainer(
        model, optax.adagrad(0.02), mesh, non_id, ids)
    init = jax.tree_util.tree_map(np.asarray, dict(params))
    batch = ([np.asarray(non_id[0])], ids, np.asarray(label))
    placed = shard_batch_pytree(
        {"n": [jnp.asarray(batch[0][0])],
         "i": {k: jnp.asarray(v) for k, v in ids.items()},
         "l": jnp.asarray(label)}, mesh)
    losses = []
    with mesh:
        for _ in range(3):
            params, opt_state, loss = step(params, opt_state, placed["n"],
                                           placed["i"], placed["l"])
            losses.append(float(loss))
    return init, batch, losses, flat(params)


# --- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the three rank groups, compute the JAX side meanwhile, then
    collect the groups."""
    import test_torch_ranks as launch

    params, raw_params = jax_params(), jax_params(raw=True)
    dm_init, dm_batch, dm_losses, dm_params = jax_device_mode((W, 1))
    sharded = {shape: jax_device_mode(shape, DM_SHARDED_VOCAB)
               for shape in DM_SHARDED_MESHES}
    dirs = {n: tmp_path_factory.mktemp(n) for n in BODIES}
    inputs = {"params": params, "raw_params": raw_params,
              "dm_params": dm_init, "dm_batch": dm_batch,
              "dm_sharded": {s: r[:2] for s, r in sharded.items()},
              "tmp": str(tmp_path_factory.mktemp("ddp_files"))}
    sizes = {"ddp": W, "ef8": 8, "rendezvous": 2}
    groups = {n: launch.start_ranks(__file__, n, sizes[n], inputs, dirs[n],
                                    env=_child_env()) for n in BODIES}
    try:
        with pytest.MonkeyPatch.context() as mp:
            ref = jax_side(mp, params, raw_params)
        ref["device_mode"] = (dm_losses, dm_params)
        ref["device_mode_sharded"] = {s: r[2:] for s, r in sharded.items()}
    except BaseException:
        for g in groups.values():
            g.kill()
        raise
    port = {n: launch.collect(g, dirs[n], DEADLINE_S)
            for n, g in groups.items()}
    return ref, port


def jax_side(mp, params, raw_params):
    """Every JAX reference of the module, over the JAX middleware's numpy
    twin (the children run the port's)."""
    from persia_tpu.worker import middleware as jmw

    mp.setattr(jmw, "_mw_native", lambda: None)
    ref = {"ef": {c: jax_ef(*c) for c in EF_CASES}, "runs": {},
           "params": params}
    batches = make_batches(_jax_batch(), STEPS, BS, seed=11)
    ref["runs"]["single"] = jax_run(jax_ctx(params), batches)
    mesh = _jax_mesh(W)
    for mode in MODES:
        ref["runs"][mode] = jax_run(jax_ctx(params, mesh, mode), batches)
    ref["runs"]["fallback"] = jax_run(
        jax_ctx(params, mesh),
        make_batches(_jax_batch(), 3, BS, 5, sizes=FALLBACK_SIZES))
    ref["runs"]["raw"] = jax_run(
        jax_ctx(raw_params, mesh, raw=True),
        make_batches(_jax_batch(), 2, BS, 6, raw=True))
    return ref


def _jax_batch():
    from persia_tpu.data import batch as jb

    return jb


def _jax_mesh(world):
    import jax

    from persia_tpu.parallel.mesh import make_mesh

    return make_mesh((world, 1), devices=jax.devices()[:world])


@pytest.fixture
def port_numpy_middleware(monkeypatch):
    """The port's middleware on its numpy twin, as in the children."""
    from persia_tpu_torch.worker import middleware

    monkeypatch.setattr(middleware, "_mw_native", lambda: None)


# --- _ef_int8_mean -----------------------------------------------------------


@pytest.mark.parametrize("world,n", EF_CASES)
def test_ef_int8_stage1_codes_are_bit_equal(world, n):
    """Stage 1 (pad, buckets of 1024, scale, round half to even, clip)
    against the JAX function's own expressions, on every replica."""
    import jax.numpy as jnp

    from persia_tpu.parallel.train import _EF_BUCKET as J_BUCKET
    from persia_tpu_torch.parallel.train import _EF_BUCKET, _quantize

    assert _EF_BUCKET == J_BUCKET == 1024
    for p in ef_inputs(world, n):
        pad = (-n) % (world * _EF_BUCKET)
        jb = jnp.pad(jnp.asarray(p), (0, pad)).reshape(-1, J_BUCKET)
        jscale = jnp.maximum(jnp.max(jnp.abs(jb), axis=1) / 127.0, 1e-30)
        jq = jnp.clip(jnp.round(jb / jscale[:, None]), -127,
                      127).astype(jnp.int8)
        tq, tscale = _quantize(torch.nn.functional.pad(
            torch.from_numpy(p), (0, pad)).reshape(-1, _EF_BUCKET))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("world,n", EF_CASES)
def test_ef_int8_mean_matches_jax(worlds, world, n):
    """Every rank's decoded mean (equal on all ranks) and its own
    residual against the JAX shard_map (the tolerances of the module
    docstring); the mean within two quantization steps of the true mean,
    as the JAX test bounds it."""
    ref, port = worlds
    jmean, jerr = ref["ef"][(world, n)]
    ranks = port["ddp"] if world == W else port["ef8"]
    got = [r["ef"][(world, n)] if world == W else r[(world, n)]
           for r in ranks]
    x = ef_inputs(world, n)
    tol = (np.abs(x).max() / 254.0 + np.abs(x.mean(0)).max() / 254.0) * 1.01
    chunk = (n + (-n) % (world * 1024)) // world
    for rank, (mean, err) in enumerate(got):
        assert mean.shape == err.shape == (n,)
        np.testing.assert_array_equal(mean, got[0][0])
        np.testing.assert_allclose(mean, jmean[rank], rtol=0, atol=1e-6)
        own = np.zeros(n, bool)
        own[rank * chunk:(rank + 1) * chunk] = True
        np.testing.assert_allclose(err[~own], jerr[rank][~own], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(err[own], jerr[rank][own], rtol=0,
                                   atol=world * 1e-6)
        assert np.abs(mean - x.mean(0)).max() <= tol


# --- TrainCtx over a mesh ----------------------------------------------------


def _assert_run_matches(port_run_, jax_run_, tol):
    losses, ddp, grads, params = port_run_
    jlosses, jddp, jgrads, jparams = jax_run_
    assert ddp == jddp
    np.testing.assert_allclose(losses, jlosses, rtol=tol, atol=tol)
    assert len(grads) == len(jgrads)
    for step, (g, jg) in enumerate(zip(grads, jgrads)):
        assert list(g) == list(jg)
        for name in g:
            np.testing.assert_allclose(g[name], jg[name], rtol=tol,
                                       atol=tol, err_msg=f"{step} {name}")
    assert set(params) == set(jparams)
    for k in params:
        np.testing.assert_allclose(params[k], jparams[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_train_ctx_mesh_matches_jax(worlds, mode):
    """f32 / bf16 / int8_ef reduction, 8 steps of 64 rows over W=4 ranks:
    losses (every rank), shipped gradients (the leader), parameters."""
    ref, port = worlds
    ranks = [r["runs"][mode] for r in port["ddp"]]
    assert all(d for d in ranks[0][1])  # every step took the DDP path
    assert ranks[0][2] is not None and all(r[2] is None for r in ranks[1:])
    for r in ranks[1:]:
        assert r[0] == ranks[0][0]  # the pmean'd loss, on every rank
        for k, v in r[3].items():  # dense parameters bit-equal
            np.testing.assert_array_equal(v, ranks[0][3][k], err_msg=k)
    _assert_run_matches(ranks[0], ref["runs"][mode], MODE_TOL[mode])
    assert len(set(ranks[0][0])) > 1


def test_reduced_precision_runs_differ_from_f32_and_stay_near(worlds):
    """The JAX test's own bounds, on the port: bf16 within 0.05 of the
    f32 run and different from it, int8_ef's last 4 losses within 0.08."""
    _, port = worlds
    runs = port["ddp"][0]["runs"]
    f32, bf16, ef = (runs[m][0] for m in MODES)
    np.testing.assert_allclose(bf16, f32, rtol=0.05, atol=0.05)
    assert bf16 != f32 and ef != f32
    np.testing.assert_allclose(ef[-4:], f32[-4:], rtol=0.08, atol=0.08)
    assert np.isfinite(ef).all()


def test_ddp_embedding_gradients_are_world_times_single_device(
        worlds, port_numpy_middleware):
    """The first step's shipped gradients, from the same weights and PS
    rows: the DDP step's are W times the single-device step's, in the
    JAX package and in the port (ROADMAP §C)."""
    from persia_tpu_torch.data import batch as tb

    ref, port = worlds
    (tbatch,) = make_batches(tb, 1, BS, seed=11)
    single = port_run(port_ctx(ref["params"]), [tbatch])[2][0]
    jsingle = ref["runs"]["single"][2][0]
    jddp = ref["runs"][None][2][0]
    tddp = port["ddp"][0]["runs"][None][2][0]
    for name in jddp:
        np.testing.assert_allclose(jddp[name], W * jsingle[name], rtol=1e-4,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(tddp[name], W * single[name], rtol=1e-4,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(single[name], jsingle[name], rtol=1e-4,
                                   atol=1e-7, err_msg=name)
        assert np.abs(single[name]).max() > 0


@pytest.mark.parametrize("run", ["fallback", "raw"])
def test_fallback_matches_jax(worlds, run):
    """A batch of 62 rows over 4 ranks, and a raw slot, take the
    single-device step on every rank (``_ddp`` False), as the JAX
    auto-sharded step does; the divisible batches around them DDP."""
    ref, port = worlds
    ranks = [r["runs"][run] for r in port["ddp"]]
    assert ranks[0][1] == ([True, False, True] if run == "fallback"
                           else [False, False])
    for r in ranks[1:]:
        for k, v in r[3].items():
            np.testing.assert_array_equal(v, ranks[0][3][k], err_msg=k)
    _assert_run_matches(ranks[0], ref["runs"][run], 1e-4)


def test_device_mode_over_the_data_axis_matches_jax(worlds):
    """3 steps on make_mesh((4, 1)), each rank pooling its 8 rows, against
    the JAX trainer on a (4, 1) mesh: losses and every parameter within
    1e-5, and bit-equal on every rank."""
    ref, port = worlds
    jlosses, jparams = ref["device_mode"]
    ranks = [r["device_mode"] for r in port["ddp"]]
    for losses, params in ranks:
        np.testing.assert_allclose(losses, jlosses, rtol=DM_TOL, atol=DM_TOL)
        assert set(params) == set(jparams)
        for k in params:
            np.testing.assert_array_equal(params[k], ranks[0][1][k])
            np.testing.assert_allclose(params[k], jparams[k], rtol=DM_TOL,
                                       atol=DM_TOL, err_msg=k)
    assert jlosses[-1] != jlosses[0]


@pytest.mark.parametrize("shape", DM_SHARDED_MESHES)
def test_device_mode_sharded_over_the_model_axis_matches_jax(worlds, shape):
    """3 steps with each table row-sharded over the model axis (each rank
    holds 256 / M contiguous rows, JAX's P(MODEL_AXIS, None)) against the
    JAX trainer on the same mesh shape: losses within 1e-5 on every rank;
    every table shard within 1e-5 of the JAX table's same rows, and the
    gathered tables of the whole; the tower within 1e-5 and bit-equal on
    every rank; each shard bit-equal across the data axis; the losses
    move."""
    ref, port = worlds
    jlosses, jparams = ref["device_mode_sharded"][shape]
    ranks = [r["device_mode_sharded"][shape] for r in port["ddp"]]
    n = DM_SHARDED_VOCAB // shape[1]
    by_model = {}
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=DM_TOL,
                                   atol=DM_TOL)
        d, m = r["coords"]
        assert set(r["params"]) == set(jparams) == set(r["gathered"])
        for k, v in r["params"].items():
            if k.endswith("/table"):
                assert v.shape == (n, DM_DIM), k
                np.testing.assert_allclose(
                    v, jparams[k][m * n:(m + 1) * n], rtol=DM_TOL,
                    atol=DM_TOL, err_msg=k)
                by_model.setdefault((m, k), []).append(v)
            else:
                np.testing.assert_array_equal(v, ranks[0]["params"][k])
                np.testing.assert_allclose(v, jparams[k], rtol=DM_TOL,
                                           atol=DM_TOL, err_msg=k)
            np.testing.assert_allclose(r["gathered"][k], jparams[k],
                                       rtol=DM_TOL, atol=DM_TOL, err_msg=k)
        assert set(r["windows"].values()) == {(m * n, DM_SHARDED_VOCAB)}
    assert len(by_model) == shape[1] * DM_SLOTS
    for shards in by_model.values():  # one a data-axis rank
        assert len(shards) == shape[0]
        for v in shards[1:]:
            np.testing.assert_array_equal(v, shards[0])
    assert jlosses[-1] != jlosses[0]
    assert ranks[0]["losses"][-1] != ranks[0]["losses"][0]


@pytest.mark.parametrize("shape", DM_SHARDED_MESHES)
def test_model_axis_sum_backward_is_the_identity(worlds, shape):
    """The collection's table gradients row-sharded over the model axis
    and gathered equal the unsharded collection's on one rank (the sum of
    the partials passes the cotangent through unchanged), not M times
    them, on every rank."""
    _, port = worlds
    for r in port["ddp"]:
        err, scale, ratio = r["device_mode_sharded"][shape]["sum_grad"]
        assert scale > 0
        assert err <= 1e-6 * scale, (shape, err, scale)
        assert abs(ratio - 1.0) < 1e-6, (shape, ratio)


@pytest.mark.parametrize("case,expect", [
    ("model_axis", ("ValueError", "slot slot_0: vocab 257 does not divide")),
    ("resume_from", ("ok", "every rank resumes the leader's snapshot")),
    ("wrong_worker", ("ValueError", "sparse leader")),
    ("bad_dtype", ("ValueError", "grad_reduce_dtype")),
    ("snapshot", ("ok", "every rank gets the leader's path")),
    ("dump_checkpoint", ("ok", "the leader writes, every rank returns")),
    ("dataloader", ("ok", "every rank trains the leader's batches")),
    ("other_batches", ("RuntimeError", "different batches")),
])
def test_mesh_refusals(worlds, case, expect):
    """Each refusal raises on every rank alike (so that no rank waits on
    a collective the others never reach), naming its ROADMAP item. The
    calls item 3c made work (``ok``) return on every rank: the snapshot's
    path is the same on every rank, the resumed context holds the
    snapshot's cursor, step and dense parameters on every rank (the run
    trained on after the snapshot), the checkpoint holds the leader's
    files, and the DataLoader's losses are equal on every rank."""
    _, port = worlds
    kind, words = expect
    ranks = [r["refusals"] for r in port["ddp"]]
    for rank, r in enumerate(ranks):
        got = r[case]
        if kind == "ok":
            assert got is None, (rank, case, got)
            continue
        assert got is not None, (rank, case)
        assert got.startswith(kind + ":") and words in got, (rank, got)
    if case == "snapshot":
        assert len({r["snap"] for r in ranks}) == 1
        assert os.path.exists(os.path.join(ranks[0]["snap"],
                                           "manifest.json"))
    elif case == "resume_from":
        for r in ranks:
            cursor, step, params = r["resumed"]
            assert cursor == {"seed": 1, "consumed": 1} and step == 1
            assert set(params) == set(r["snap_params"])
            for k in params:
                np.testing.assert_array_equal(params[k], r["snap_params"][k])
            assert any(not np.array_equal(r["snap_params"][k], v)
                       for k, v in r["end_params"].items())
    elif case == "dump_checkpoint":
        assert os.path.exists(os.path.join(ranks[0]["ckpt_dir"],
                                           "dense.pt"))
    elif case == "dataloader":
        losses = [r["loader_losses"] for r in ranks]
        assert len(losses[0]) == 2 and np.isfinite(losses[0]).all()
        assert all(x == losses[0] for x in losses)


def test_ranks_import_no_jax(worlds):
    _, port = worlds
    assert [r["jax_modules"] for r in port["ddp"]] == [[]] * W


def test_mesh_keeps_training_and_evaluates_on_the_leader(worlds):
    _, port = worlds
    after = [r["refusals"]["after"] for r in port["ddp"]]
    assert len(set(after)) == 1 and np.isfinite(after[0])
    assert port["ddp"][0]["refusals"]["eval"] is None
    for r in port["ddp"][1:]:
        assert r["refusals"]["eval"].startswith("RuntimeError:")
        assert "sparse leader" in r["refusals"]["eval"]


def test_two_process_rendezvous_and_int8_ef_step(worlds):
    _, port = worlds
    ranks = port["rendezvous"]
    for rank, r in enumerate(ranks):
        assert r["nccl_on_cpu"].startswith("ValueError:")
        assert (r["backend"], r["world"], r["rank"]) == ("gloo", 2, rank)
        assert r["shape"] == (2, 1) and r["names"] == ("data", "model")
        assert r["same"] and r["kwargs"] == ["grad_reduce_dtype", "mesh"]
        assert r["reduce"] == "int8_ef" and r["default"] is None
        assert r["total"] == 3.0
        assert np.isfinite(r["ef_loss"]) and r["ef_residual_nonzero"]
    assert ranks[0]["ef_loss"] == ranks[1]["ef_loss"]
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])


# --- on the card -------------------------------------------------------------


@pytest.fixture
def nccl_world():
    """A world of one rank over NCCL on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from persia_tpu_torch.distributed import DistributedOption

    mesh = DistributedOption(backend="nccl", timeout=60).initialize()
    yield mesh
    dist.destroy_process_group()


@pytest.mark.gpu
def test_ef_int8_mean_and_ddp_step_over_nccl(nccl_world):
    """At world 1 the int8 mean is the two quantizations of p, and the
    DDP step's reduction is the identity on f32; both take NCCL's
    all_to_all / all_gather / all_reduce."""
    from persia_tpu_torch.models.dnn import DNN
    from persia_tpu_torch.parallel import collectives as coll
    from persia_tpu_torch.parallel.mesh import DATA_AXIS, axis_group
    from persia_tpu_torch.parallel.train import (
        _ef_int8_mean,
        _quantize,
        make_packed_train_step_ddp,
    )

    coll.calls.clear()
    p = torch.randn(3000, device="cuda")
    mean, err = _ef_int8_mean(p, axis_group(nccl_world, DATA_AXIS), 1)
    q, s = _quantize(torch.nn.functional.pad(p, (0, 72)).reshape(-1, 1024))
    q2, s2 = _quantize((q.float() * s[:, None]))
    want = (q2.float() * s2[:, None]).reshape(-1)[:3000]
    assert torch.equal(mean, want)
    assert torch.allclose(mean + err, p, atol=1e-6)
    torch.manual_seed(0)
    model = DNN(5, [8, 8], device="cuda")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    step = make_packed_train_step_ddp(model, opt, [8, 8], nccl_world)
    loss, grads, pred = step([torch.randn(6, 5, device="cuda")],
                             torch.randn(6, 16, device="cuda"),
                             torch.ones(6, 1, device="cuda"))
    assert torch.isfinite(loss) and grads.shape == (6, 16)
    assert {"all_to_all/nccl", "all_gather/nccl",
            "all_reduce/nccl"} <= set(coll.calls)


@pytest.mark.gpu
def test_collectives_autograd_on_device_tensors(nccl_world):
    """The scatter/gather pair and the all_to_all round trip on CUDA
    tensors at world 1: values and gradients pass through unchanged."""
    from persia_tpu_torch.parallel import collectives as coll
    from persia_tpu_torch.parallel.mesh import DATA_AXIS, axis_group

    group = axis_group(nccl_world, DATA_AXIS)
    x = torch.randn(2, 4, 6, 3, device="cuda", requires_grad=True)
    y = coll.gather_from_shards(coll.scatter_to_shards(x, group, 2), group, 2)
    z = coll.all_to_all(coll.all_to_all(y, group, 1, 2), group, 2, 1)
    (g,) = torch.autograd.grad((z * z).sum(), x)
    assert torch.equal(z, x) and torch.allclose(g, 2 * x)
    assert coll.ppermute(x, group).requires_grad


if __name__ == "__main__":
    from test_torch_ranks import rank_main

    rank_main(BODIES)
