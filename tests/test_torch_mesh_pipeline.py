"""The pipeline, snapshots, checkpoints and evaluation of the PyTorch port
over a mesh of ranks, against the JAX package, on the CPU.

The port's two ranks are one gloo group started by ``test_torch_ranks``
(torch and the port only, the middleware's numpy twin, deterministic
algorithms on); the JAX references run in this process over the
conftest's virtual CPU devices meanwhile. Each case is a test of its own
on the results.

- A ``DataLoader(reproducible=True, embedding_staleness=1)`` over
  ``make_mesh((2, 1))``: the sparse leader alone reads the dataset (the
  other rank is given an empty one) and every rank trains the leader's
  batches. The DLRM of ``tests/test_torch_ddp.py`` (the data-parallel
  step, batch-major gradients through the backward engine) and the
  sequence tower (a raw slot: every rank steps the whole batch) train 4
  f32 steps each, against the JAX ``TrainCtx(mesh=make_mesh((2, 1)))``
  with its ``DataLoader`` on the same batches from the same weights and
  fresh PS rows: losses (every rank), the shipped embedding gradients (the
  leader) and the dense parameters within 1e-4
  (``test_train_ctx_mesh_matches_jax``'s f32 tolerance: the same math, the
  reductions summed in another order), and bit-equal on the ranks.
- A collective ``snapshot`` after 3 of 6 pipelined DLRM steps and a fresh
  ``TrainCtx(mesh=, resume_from=)`` on both ranks that trains the other 3
  from the cursor: losses, the dense state (model and optimizer) of each
  rank and every PS row equal the unbroken run's bit for bit; the
  manifest's step and cursor equal those of the JAX package's snapshot at
  the same point.
- ``dump_checkpoint`` after the unbroken run and ``load_checkpoint`` into a
  fresh mesh context with other weights: its dense state on each rank and
  its PS rows equal the dumped run's bit for bit.
- ``eval_ctx`` of the Ulysses sequence tower over ``make_mesh((1, 2))``:
  both ranks enter it and call ``forward`` on the same 3 batches (the PS
  rows made by one training lookup of each batch beforehand); every rank's
  predictions equal the other's and the JAX CP tower's within 1e-4 (f32).
"""

import itertools
import os

import numpy as np
import pytest
import torch

import test_torch_ddp as ddp

W = 2
DEADLINE_S = 240.0
TOL = ddp.MODE_TOL[None]
STEPS, RESUME_STEPS, RESUME_AT = 4, 6, 3
RESUME_SEED = 21
SEQ_BS, SEQ_DIM, SEQ_HEADS, SEQ_T = 16, 16, 4, 8
SEQ_SPEC = dict(item_vocab=500, t_hist=SEQ_T)
# the batch's feature order: 2 profiles, history (raw), clicks, target
SEQ_SLOTS = [(SEQ_DIM, False), (SEQ_DIM, False), (SEQ_DIM, True),
             (SEQ_DIM, False), (SEQ_DIM, False)]
EVAL_TOL = 1e-4
LOADER = dict(num_workers=2, reproducible=True, embedding_staleness=1)


def seq_schema(cfg):
    slots = cfg.uniform_slots(["user_geo", "user_device", "target_item"],
                              dim=SEQ_DIM)
    slots["recent_items"] = cfg.SlotConfig(
        name="recent_items", dim=SEQ_DIM, embedding_summation=False,
        sample_fixed_size=SEQ_T)
    slots["recent_clicks"] = cfg.SlotConfig(name="recent_clicks",
                                            dim=SEQ_DIM, pooling="last4")
    return cfg.EmbeddingSchema(slots_config=slots)


def seq_batches(gen, n, seed):
    return list(gen.seqrec_batches(n * SEQ_BS, SEQ_BS, seed=seed,
                                   spec=gen.SeqRecSpec(**SEQ_SPEC)))


# --- the port's ranks (torch and the port only) --------------------------------


def port_seq_ctx(params, mesh, leader, cp=False):
    """The port's sequence tower from the flax ``params``, f32, Adam(1e-3)
    and sparse Adagrad(1e-2) over two fresh per-entry PS shards on the
    leader; context-parallel (Ulysses, flash) over ``mesh`` with ``cp``."""
    from persia_tpu_torch import config as tcfg
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import SequenceTower
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.weights import load_flax_params, numpy_tree
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    model = SequenceTower(
        4, SEQ_SLOTS, num_heads=SEQ_HEADS, attn_impl="flash",
        compute_dtype=torch.float32, device="cpu",
        mesh=mesh if cp else None, context_parallel="ulysses")
    load_flax_params(model, numpy_tree(params))
    schema = seq_schema(tcfg)
    worker = (EmbeddingWorker(schema, [EmbeddingHolder(100_000, 4)
                                       for _ in range(2)])
              if leader else None)
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                    Adagrad(lr=1e-2), schema, worker,
                    embedding_config=EmbeddingConfig((-0.05, 0.05)),
                    global_config=tcfg.GlobalConfig(tcfg.CommonConfig("f32")),
                    device="cpu", mesh=mesh)


def port_loader_run(ctx, batches, leader):
    """Train a DataLoader's batches (the leader's; the other ranks' dataset
    is empty): losses, shipped gradients (leader), flat parameters."""
    from persia_tpu_torch.data.dataloader import DataLoader, IterableDataset
    from persia_tpu_torch.weights import flax_params

    grads = ddp._record(ctx.worker) if ctx.worker is not None else None
    losses = []
    with ctx:
        for lb in DataLoader(IterableDataset(batches if leader else []),
                             **LOADER):
            losses.append(float(ctx.train_step(lb)[0]))
    return losses, grads, ddp.flat(flax_params(ctx.model)[0])


def dense_state(ctx) -> dict:
    """The model's and the dense optimizer's tensors as numpy arrays."""
    out = {f"model.{k}": v.detach().numpy().copy()
           for k, v in ctx.model.state_dict().items()}
    for i, st in ctx.dense_optimizer.state_dict()["state"].items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                out[f"optimizer.{i}.{k}"] = v.detach().numpy().copy()
    return out


def ps_rows(worker, tmp) -> dict:
    """(shard, sign) -> the row's f32 [emb|state] bytes, from a dump of
    each shard."""
    from persia_tpu_torch.checkpoint import iter_psd_entries

    out = {}
    for r, h in enumerate(worker.ps_clients):
        path = os.path.join(tmp, f"rows_{r}.psd")
        h.dump_file(path)
        for sign, _dim, vec in iter_psd_entries(path):
            out[(r, sign)] = vec.tobytes()
        os.remove(path)
    return out


def resume_runs(inputs, mesh, leader):
    """The unbroken run (A), the run that snapshots at RESUME_AT (B), the
    resumed run (C) and a checkpoint of A loaded into a fresh context (D):
    losses, dense state, PS rows (leader), the snapshot's manifest."""
    import json

    from persia_tpu_torch.data import batch as tb
    from persia_tpu_torch.data.dataloader import DataLoader, ResumableDataset

    root = inputs["tmp"]
    snaps, ckpt_dir = os.path.join(root, "snaps"), os.path.join(root, "ckpt")

    def factory(seed):
        return iter(ddp.make_batches(tb, RESUME_STEPS, ddp.BS, seed))

    def run(ctx, ds, snapshot=False):
        losses = []
        with ctx:
            for lb in DataLoader(ds, **LOADER):
                losses.append(float(ctx.train_step(lb)[0]))
            if snapshot:
                out["snap"] = ctx.snapshot(snaps,
                                           cursor=ds.cursor(len(losses)))
        return {"losses": losses, "dense": dense_state(ctx),
                "rows": ps_rows(ctx.worker, root) if leader else None}

    out = {}
    params = inputs["params"]
    a = ddp.port_ctx(params, mesh, leader)
    out["A"] = run(a, ResumableDataset(factory, seed=RESUME_SEED))
    a.dump_checkpoint(ckpt_dir)
    out["B"] = run(ddp.port_ctx(params, mesh, leader), ResumableDataset(
        lambda s: itertools.islice(factory(s), RESUME_AT),
        seed=RESUME_SEED), snapshot=True)
    with open(os.path.join(out["snap"], "manifest.json")) as f:
        out["manifest"] = json.load(f)
    c = ddp.port_ctx(params, mesh, leader, resume_from=snaps)
    out["resume_cursor"] = c.resume_cursor
    out["C"] = run(c, ResumableDataset.from_cursor(factory, c.resume_cursor))
    d = ddp.port_ctx(inputs["other_params"], mesh, leader)
    with d:
        d.load_checkpoint(ckpt_dir)
        out["D"] = {"dense": dense_state(d),
                    "rows": ps_rows(d.worker, root) if leader else None}
    return out


def cp_eval(inputs):
    """eval_ctx of the Ulysses tower over (1, W) on every rank."""
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.parallel.mesh import is_leader, make_mesh
    from persia_tpu_torch.workloads import generator as tgen

    mesh = make_mesh((1, W), device="cpu")
    leader = is_leader(mesh)
    ctx = port_seq_ctx(inputs["seq_params"], mesh, leader, cp=True)
    batches = seq_batches(tgen, 3, seed=9)
    preds = []
    with ctx:
        if leader:  # the rows the eval reads
            for b in batches:
                ctx.worker.lookup_direct(b.id_type_features, training=True)
        with eval_ctx(ctx) as e:
            for b in batches:
                pred, labels = e.forward(b)
                assert len(labels) == 1
                preds.append(pred.numpy())
    return preds


def body_mesh(inputs):
    import torch.distributed as dist

    from persia_tpu_torch.data import batch as tb
    from persia_tpu_torch.distributed import DistributedOption
    from persia_tpu_torch.workloads import generator as tgen

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    ddp._worker_patch()
    mesh = DistributedOption(mesh_shape=(W, 1), device="cpu",
                             timeout=60).initialize()
    leader = dist.get_rank() == 0
    out = {"loader": {
        "dlrm": port_loader_run(
            ddp.port_ctx(inputs["params"], mesh, leader),
            ddp.make_batches(tb, STEPS, ddp.BS, seed=11), leader),
        "seq": port_loader_run(
            port_seq_ctx(inputs["seq_params"], mesh, leader),
            seq_batches(tgen, STEPS, seed=7), leader)}}
    out["resume"] = resume_runs(inputs, mesh, leader)
    out["cp_eval"] = cp_eval(inputs)
    out["jax_modules"] = ddp.loaded_jax_modules()
    return out


BODIES = {"mesh": body_mesh}


# --- the JAX side ----------------------------------------------------------------


def jax_seq_params():
    import jax
    import jax.numpy as jnp

    from persia_tpu import config as jcfg
    from persia_tpu.models import SequenceTower
    from persia_tpu.serving import build_state_template

    model = SequenceTower(num_heads=SEQ_HEADS, attn_impl="pallas",
                          compute_dtype=jnp.float32)
    params = build_state_template(model, seq_schema(jcfg), 4, seed=5).params
    return jax.tree_util.tree_map(np.asarray, dict(params))


def jax_seq_ctx(params, mesh, cp=False):
    import jax
    import jax.numpy as jnp
    import optax

    from persia_tpu import config as jcfg
    from persia_tpu.ctx import TrainCtx
    from persia_tpu.embedding import EmbeddingConfig
    from persia_tpu.embedding.optim import Adagrad
    from persia_tpu.models import SequenceTower
    from persia_tpu.parallel.train import TrainState, make_eval_step
    from persia_tpu.ps.store import EmbeddingHolder
    from persia_tpu.worker.worker import EmbeddingWorker

    model = SequenceTower(num_heads=SEQ_HEADS, attn_impl="pallas",
                          compute_dtype=jnp.float32,
                          mesh=mesh if cp else None,
                          context_parallel="ulysses")
    adam = optax.adam(1e-3)
    gc = jcfg.GlobalConfig()
    gc.common.embedding_wire_dtype = "f32"
    schema = seq_schema(jcfg)
    ctx = TrainCtx(model=model, dense_optimizer=adam,
                   embedding_optimizer=Adagrad(lr=1e-2), schema=schema,
                   worker=EmbeddingWorker(schema, [EmbeddingHolder(100_000, 4)
                                                   for _ in range(2)]),
                   global_config=gc, mesh=mesh,
                   embedding_config=EmbeddingConfig(
                       emb_initialization=(-0.05, 0.05)))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    ctx.state = TrainState(params=p, batch_stats={}, opt_state=adam.init(p),
                           step=jnp.zeros((), jnp.int32))
    ctx._eval_step = make_eval_step(model)
    return ctx


def jax_loader_run(ctx, batches):
    from persia_tpu.data.dataloader import DataLoader, IterableDataset

    grads = ddp._record(ctx.worker)
    losses = []
    with ctx:
        for lb in DataLoader(IterableDataset(batches), **LOADER):
            losses.append(float(ctx.train_step(lb)[0]))
    return losses, grads, ddp.flat(ctx.state.params)


def jax_snapshot_manifest(params, tmp):
    """The JAX package's snapshot after RESUME_AT pipelined DLRM steps on
    the (W, 1) mesh: its manifest."""
    from persia_tpu import snapshot as jsnap
    from persia_tpu.data import batch as jb
    from persia_tpu.data.dataloader import DataLoader, ResumableDataset

    ctx = ddp.jax_ctx(params, ddp._jax_mesh(W))
    ds = ResumableDataset(lambda s: itertools.islice(iter(ddp.make_batches(
        jb, RESUME_STEPS, ddp.BS, s)), RESUME_AT), seed=RESUME_SEED)
    n = 0
    with ctx:
        for lb in DataLoader(ds, **LOADER):
            ctx.train_step(lb)
            n += 1
        snap = ctx.snapshot(tmp, cursor=ds.cursor(n))
    return jsnap.load_manifest(snap)


def jax_cp_eval(params):
    import jax

    from persia_tpu.ctx import eval_ctx
    from persia_tpu.parallel.mesh import make_mesh
    from persia_tpu.workloads import generator as jgen

    mesh = make_mesh((1, W), devices=jax.devices()[:W])
    ctx = jax_seq_ctx(params, mesh, cp=True)
    batches = seq_batches(jgen, 3, seed=9)
    with ctx:
        for b in batches:
            ctx.worker.lookup_direct(b.id_type_features, training=True)
    with eval_ctx(ctx) as e, mesh:
        return [np.asarray(e.forward(b)[0]) for b in batches]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import test_torch_ranks as launch

    from persia_tpu.data import batch as jb
    from persia_tpu.worker import middleware as jmw
    from persia_tpu.workloads import generator as jgen

    import jax

    params, seq_params = ddp.jax_params(), jax_seq_params()
    other = jax.tree_util.tree_map(lambda v: v * np.float32(0.5), params)
    d = tmp_path_factory.mktemp("mesh")
    inputs = {"params": params, "seq_params": seq_params,
              "other_params": other,
              "tmp": str(tmp_path_factory.mktemp("mesh_files"))}
    group = launch.start_ranks(__file__, "mesh", W, inputs, d,
                               env=ddp._child_env())
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmw, "_mw_native", lambda: None)
            mesh = ddp._jax_mesh(W)
            ref = {"loader": {
                "dlrm": jax_loader_run(ddp.jax_ctx(params, mesh),
                                       ddp.make_batches(jb, STEPS, ddp.BS,
                                                        seed=11)),
                "seq": jax_loader_run(jax_seq_ctx(seq_params, mesh),
                                      seq_batches(jgen, STEPS, seed=7))},
                "manifest": jax_snapshot_manifest(
                    params, str(tmp_path_factory.mktemp("jax_snaps"))),
                "cp_eval": jax_cp_eval(seq_params)}
    except BaseException:
        group.kill()
        raise
    return ref, launch.collect(group, d, DEADLINE_S)


# --- the cases -------------------------------------------------------------------


@pytest.mark.parametrize("model", ["dlrm", "seq"])
def test_dataloader_over_the_mesh_matches_jax(world, model):
    ref, ranks = world
    runs = [r["loader"][model] for r in ranks]
    losses, grads, params = runs[0]
    jlosses, jgrads, jparams = ref["loader"][model]
    assert len(losses) == STEPS and runs[1][1] is None
    assert runs[1][0] == losses  # the non-leader read no dataset
    for k, v in runs[1][2].items():
        np.testing.assert_array_equal(v, params[k], err_msg=k)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    assert len(grads) == len(jgrads) == STEPS
    for step, (g, jg) in enumerate(zip(grads, jgrads)):
        assert list(g) == list(jg)
        for name in g:
            np.testing.assert_allclose(g[name], jg[name], rtol=TOL, atol=TOL,
                                       err_msg=f"{step} {name}")
    assert set(params) == set(jparams)
    for k in params:
        np.testing.assert_allclose(params[k], jparams[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert len(set(losses)) > 1


def _equal(a: dict, b: dict, what: str):
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_snapshot_and_resume_on_the_mesh_are_bit_equal(world):
    """Run C (resumed at RESUME_AT) equals run A: the suffix losses, each
    rank's dense state, every PS row; the manifest's step and cursor are
    the JAX snapshot's."""
    ref, ranks = world
    for r in ranks:
        res = r["resume"]
        a, b, c = res["A"], res["B"], res["C"]
        assert b["losses"] == a["losses"][:RESUME_AT]
        assert c["losses"] == a["losses"][RESUME_AT:]
        _equal(a["dense"], c["dense"], "dense")
        assert res["resume_cursor"] == {"seed": RESUME_SEED,
                                        "consumed": RESUME_AT}
    a, c = ranks[0]["resume"]["A"], ranks[0]["resume"]["C"]
    assert a["rows"] and a["rows"] == c["rows"]
    assert ranks[1]["resume"]["snap"] == ranks[0]["resume"]["snap"]
    manifest, jmanifest = ranks[0]["resume"]["manifest"], ref["manifest"]
    assert manifest["step"] == jmanifest["step"] == RESUME_AT
    assert manifest["cursor"] == jmanifest["cursor"] == {
        "seed": RESUME_SEED, "consumed": RESUME_AT}


def test_checkpoint_round_trip_on_the_mesh(world):
    _, ranks = world
    for r in ranks:
        res = r["resume"]
        _equal(res["A"]["dense"], res["D"]["dense"], "dense")
    res = ranks[0]["resume"]
    assert res["D"]["rows"] == res["A"]["rows"]


def test_context_parallel_eval_matches_jax(world):
    ref, ranks = world
    for r in ranks:
        assert len(r["cp_eval"]) == len(ref["cp_eval"]) == 3
        for p, p0, jp in zip(r["cp_eval"], ranks[0]["cp_eval"],
                             ref["cp_eval"]):
            assert p.shape == (SEQ_BS, 1)
            np.testing.assert_array_equal(p, p0)
            np.testing.assert_allclose(p, jp, rtol=EVAL_TOL, atol=EVAL_TOL)
    assert np.std(np.concatenate(ref["cp_eval"])) > 1e-3


def test_ranks_import_no_jax(world):
    _, ranks = world
    assert [r["jax_modules"] for r in ranks] == [[]] * W


if __name__ == "__main__":
    from test_torch_ranks import rank_main

    rank_main(BODIES)
