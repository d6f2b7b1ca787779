"""The hot-row device cache over a mesh of ranks on one host, against the
JAX package's GSPMD mesh cache and the port's one-rank runs, on the CPU.

Two gloo groups start once, together (``test_torch_ranks``; torch and the
port only, deterministic algorithms on, one thread a rank): two ranks for
the (2, 1) and (1, 2) meshes and the collective entry points, four for
(2, 2). The JAX references run in this process over the conftest's
virtual CPU devices meanwhile. Each case is a test of its own on the
results.

- (a) The JAX test's single-id and bag streams (``tests/test_device_cache
  .py``'s ``_zipf_batches`` / ``_bag_batches``, 8 batches of 64) from the
  same flax weights on meshes (2, 1), (1, 2) and (2, 2), against JAX's
  cached ``TrainCtx`` on ``make_mesh(shape, devices=jax.devices()[:W])``:
  losses and flushed PS rows within ``MESH_TOL``.
- (b) Eviction churn, capacities 280 (single id) and 160 (bags), on (2, 1)
  and (2, 2) against the port's one-rank uncached run: within 1e-3, more
  than 100 evictions and write-backs (``test_cached_run_matches_uncached``).
- (c) On (1, 2) the run equals the one-rank cached run bit for bit:
  losses, dense parameters, every flushed PS row, and the mesh form of
  ``make_cached_eval_step``.
- (d) The layout (``tests/test_device_cache.py:425``'s counterpart): W
  disjoint blocks covering the padded rows, each rank holding its block
  and a sink row.
- (e) On (2, 1): the flush's count on every rank, ``eval_ctx`` on every
  rank against one rank's, a snapshot plus resume equal to the unbroken
  run, ``load_checkpoint`` clearing every rank's block, a ``DataLoader``
  run equal to the synchronous one, the envelope's refusals raising on
  every rank alike, and the host rule (ranks that report two hosts
  negotiate the cache down, or refuse). A DNN tower (two batch norms)
  keeps every rank's state bit-equal, running buffers included, so its
  snapshot passes the ranks' agreement check.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_ddp as ddp
import test_torch_device_cache as tdc
from persia_tpu_torch.data import batch as tbatch

DEADLINE_S = 240.0
DIM, NUM_DENSE, LR = tdc.DIM, tdc.NUM_DENSE, tdc.LR
# (a): the JAX mesh cache's loss is the global batch's mean, the port's
# the mean of its data shards' means, and its dense gradients are averaged
# over the data axis: the same math summed in another order, ~1e-7 an
# operation; 1e-5 is test_cached_run_matches_jax's own bound
MESH_TOL = 1e-5
CACHE_TOL = tdc.CACHE_TOL
CAP = {False: 4096, True: 2048}  # (a), (c): no eviction
CHURN = {False: 280, True: 160}  # (b)
CHURN_STEPS = {False: 10, True: 8}
STEPS, BS = 8, 64
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
REFUSALS = ["sgd", "raw_slot", "mean_pooling", "mixed_dims", "no_rows"]


def stream(bags):
    return tdc._bag_batches if bags else tdc._zipf_batches


# --- the port's ranks (torch and the port only) ------------------------------


def port_ctx(params, mesh, cap, bags, schema=None, worker=None, model=None,
             **kw):
    """The JAX test's stack from the flax ``params``: f32 DLRM (or
    ``model``), OptaxAdagrad dense and Adagrad sparse at 0.05, two fresh
    per-entry PS shards on the leader (``mesh=None``: one rank)."""
    from persia_tpu_torch import config as tcfg
    from persia_tpu_torch import models as tm
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.parallel.mesh import is_leader
    from persia_tpu_torch.parallel.optim import OptaxAdagrad
    from persia_tpu_torch.weights import load_flax_params

    schema = schema or tdc._schema(tcfg, bags)
    if model is None:
        model = load_flax_params(tm.DLRM(
            NUM_DENSE, len(schema.slots_config), embedding_dim=DIM,
            compute_dtype=torch.float32, device="cpu"), params)
    if worker is None and (mesh is None or is_leader(mesh)):
        worker = tdc.TWorker(schema, [tdc.THolder(100_000, 2)
                                      for _ in range(2)])
    kw.setdefault("embedding_optimizer", Adagrad(lr=LR))
    return TrainCtx(
        model, OptaxAdagrad(model.parameters(), LR), schema=schema,
        worker=worker,
        embedding_config=EmbeddingConfig(emb_initialization=(-0.05, 0.05)),
        global_config=tcfg.GlobalConfig(tcfg.CommonConfig("f32")),
        device="cpu", device_cache_capacity=cap, mesh=mesh, **kw)


def dense(ctx) -> dict:
    return {n: p.detach().numpy().copy()
            for n, p in ctx.model.named_parameters()}


def port_run(params, mesh, cap, bags, n=STEPS):
    """Train ``n`` batches and flush: losses, the flush's count, dense
    parameters, the PS rows (leader), counters (leader) and the cache's
    layout on this rank."""
    ctx = port_ctx(params, mesh, cap, bags)
    with ctx:
        losses = [float(ctx.train_step(b)[0])
                  for b in stream(bags)(tbatch, n, BS)]
        flushed = ctx.flush_device_cache()
    eng = ctx._cache_engine
    out = {"losses": losses, "flushed": flushed, "dense": dense(ctx),
           "tables": None if ctx.worker is None else tdc._tables(ctx.worker)}
    if eng is not None:
        out.update(stats=eng.stats(), window=eng._rows.window,
                   shape=tuple(eng.cache_vals.shape), leader=eng.leader)
    return out, ctx


def eval_step_preds(ctx, mesh):
    """The cached eval step over the trained cache on the first batch's
    signs (all resident): the slots are the leader's mapper's, sent to
    every rank."""
    from persia_tpu_torch.parallel.cached_train import make_cached_eval_step

    b = next(tdc._zipf_batches(tbatch, 1, BS))
    signs = np.stack([f.signs for f in b.id_type_features], axis=1)

    def slots() -> bytes:
        res, at = ctx._cache_engine.mapper.signs_and_slots()
        where = dict(zip(res.tolist(), at.tolist()))
        return np.vectorize(where.__getitem__)(signs).astype(
            np.int32).tobytes()

    raw = slots() if mesh is None else ctx._from_leader(slots)
    idx = torch.from_numpy(np.frombuffer(raw, np.int32).reshape(
        signs.shape).copy())
    step = make_cached_eval_step(ctx.model, signs.shape[1], mesh=mesh,
                                 capacity=CAP[False])
    non_id = [torch.from_numpy(f.data) for f in b.non_id_type_features]
    return step(ctx._cache_engine.cache_vals, non_id, idx).numpy()


def entry_points(params, mesh, tmp):
    """(e) on ``mesh``, every entry point collective."""
    import torch.distributed as dist

    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.data.dataloader import DataLoader, IterableDataset

    out = {}
    batches = list(tdc._zipf_batches(tbatch, 6, BS))
    evals = list(tdc._zipf_batches(tbatch, 8, BS, seed=5))[6:]
    for b in evals:
        b.requires_grad = False
    # eval_ctx on every rank; the leader also runs one rank's
    for where in (mesh, None):
        if where is None and dist.get_rank() != 0:
            continue
        ctx = port_ctx(params, where, 1024, False)
        with ctx:
            for b in batches:
                ctx.train_step(b)
            with eval_ctx(ctx) as e:
                preds = [e.forward(b)[0].numpy() for b in evals]
        out["eval" if where is not None else "eval_one"] = preds
    # a DataLoader over the cached mesh context: each rank's own dataset
    sync, _ = port_run(params, mesh, 1024, False, n=6)
    ctx = port_ctx(params, mesh, 1024, False)
    loader = DataLoader(IterableDataset(tdc._zipf_batches(tbatch, 6, BS)),
                        num_workers=4, embedding_staleness=2)
    with ctx:
        seen = list(loader)
        out["loader_types"] = sorted({type(b).__name__ for b in seen})
        out["loader"] = [float(ctx.train_step(b)[0]) for b in seen]
    out["loader_engine"] = loader._engine is None
    out["sync"] = sync["losses"]
    # snapshot after 4 of 8 evicting steps, resumed in a fresh context
    all8 = list(tdc._zipf_batches(tbatch, 8, BS))
    straight = port_ctx(params, mesh, 512, False)
    with straight:
        sl = [float(straight.train_step(b)[0]) for b in all8]
    first = port_ctx(params, mesh, 512, False)
    snaps = os.path.join(tmp, "snaps")
    with first:
        fl = [float(first.train_step(b)[0]) for b in all8[:4]]
        first.snapshot(snaps, cursor={"step": 4})
    resumed = port_ctx(params, mesh, 512, False, resume_from=snaps)
    with resumed:
        rl = [float(resumed.train_step(b)[0]) for b in all8[4:]]
    out["resume"] = {
        "straight": sl, "split": fl + rl, "cursor": resumed.resume_cursor,
        "dense": (dense(straight), dense(resumed)),
        "tables": (None if straight.worker is None else
                   (tdc._tables(straight.worker),
                    tdc._tables(resumed.worker)))}
    # load_checkpoint drops every rank's block
    ckpt = os.path.join(tmp, "ckpt")
    ctx = port_ctx(params, mesh, 4096, False)
    with ctx:
        for b in batches[:4]:
            ctx.train_step(b)
        ctx.dump_checkpoint(ckpt, with_dense=False)
        saved = None if ctx.worker is None else tdc._tables(ctx.worker)
        for b in batches[4:]:
            ctx.train_step(b)
        eng = ctx._cache_engine
        before = float(eng.cache_vals.abs().sum())
        ctx.load_checkpoint(ckpt, with_dense=False)
        out["load"] = {
            "before": before,
            "vals_zero": bool((eng.cache_vals == 0).all()),
            "acc_init": bool((eng.cache_acc == eng.acc_init).all()),
            "mapper": None if eng.mapper is None else len(eng.mapper),
            "victims": len(eng.victims),
            "restored": (None if saved is None else
                         _tables_equal(tdc._tables(ctx.worker), saved)),
            "after": float(ctx.train_step(batches[0])[0])}
    out["bn"] = batch_norm_run(mesh, tmp)
    out["refusals"] = {case: refusal(params, mesh, case)
                       for case in REFUSALS}
    out["hosts"] = host_rule(params, mesh)
    return out


def batch_norm_run(mesh, tmp):
    """A DNN tower (batch norms after its first two layers) trained on
    evicting steps, then snapshotted: this rank's state dict, buffers
    included, and the snapshot's path (or why it failed)."""
    from persia_tpu_torch import models as tm

    torch.manual_seed(7)
    model = tm.DNN(NUM_DENSE, [DIM] * tdc.NUM_SLOTS,
                   compute_dtype=torch.float32, device="cpu")
    ctx = port_ctx(None, mesh, 512, False, model=model)
    with ctx:
        losses = [float(ctx.train_step(b)[0])
                  for b in tdc._zipf_batches(tbatch, 6, BS)]
        try:
            path = ctx.snapshot(os.path.join(tmp, "bn_snaps"))
        except RuntimeError as e:  # the ranks disagreed: raised on each
            path = f"failed: {e}"
    return {"losses": losses, "path": path,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()}}


def _tables_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


class _NoRows:
    """An embedding worker without row access (as a remote one)."""

    def __init__(self, worker):
        self._worker = worker

    def __getattr__(self, name):
        if name == "lookup_rows_with_state":
            raise AttributeError(name)
        return getattr(self._worker, name)


def refusal(params, mesh, case):
    """The first step of a context outside the envelope: (the exception's
    type, its message) on this rank."""
    from persia_tpu_torch import config as tcfg
    from persia_tpu_torch.embedding.optim import SGD
    from persia_tpu_torch.parallel.mesh import is_leader

    slots = tcfg.uniform_slots(tdc.SLOTS, dim=DIM)
    kw = {}
    if case == "sgd":
        kw["embedding_optimizer"] = SGD(lr=LR)
    elif case == "raw_slot":
        slots["s1"] = tcfg.SlotConfig(name="s1", dim=DIM,
                                      embedding_summation=False,
                                      sample_fixed_size=2)
    elif case == "mean_pooling":
        slots["s2"] = tcfg.SlotConfig(name="s2", dim=DIM, pooling="mean")
    elif case == "mixed_dims":
        slots["s3"] = tcfg.SlotConfig(name="s3", dim=2 * DIM)
    schema = tcfg.EmbeddingSchema(slots_config=slots)
    worker = None
    if case == "no_rows" and is_leader(mesh):
        worker = _NoRows(tdc.TWorker(schema, [tdc.THolder(1000, 2)]))
    ctx = port_ctx(params, mesh, 64, False, schema=schema, worker=worker,
                   **kw)
    with ctx:
        try:
            ctx.train_step(next(tdc._zipf_batches(tbatch, 1, 8)))
        except Exception as e:
            return type(e).__name__, str(e), ctx._cache_engine is None
    return None


def host_rule(params, mesh):
    """Ranks that report two hosts: the knob's three answers on this
    rank; then the real host (one) caches."""
    import torch.distributed as dist

    from persia_tpu_torch import ctx as ctx_mod

    out = {}
    real = ctx_mod._host_name
    ctx_mod._host_name = lambda: f"host{dist.get_rank()}"
    try:
        for mode in ("off", "refuse", "maybe"):
            os.environ["PERSIA_MULTIHOST_CACHE"] = mode
            try:
                out[mode] = port_ctx(params, mesh, 64,
                                     False).device_cache_capacity
            except Exception as e:
                out[mode] = type(e).__name__
    finally:
        ctx_mod._host_name = real
        os.environ.pop("PERSIA_MULTIHOST_CACHE")
    out["one_host"] = port_ctx(params, mesh, 64, False).device_cache_capacity
    return out


def body(inputs):
    import torch.distributed as dist

    from persia_tpu_torch.distributed import DistributedOption
    from persia_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    world = int(os.environ["WORLD_SIZE"])
    DistributedOption(mesh_shape=(world, 1), device="cpu",
                      timeout=60).initialize()
    rank = dist.get_rank()
    params = inputs["params"]
    out = {"a": {}, "b": {}}
    for shape in MESHES[world]:
        mesh = make_mesh(shape, device="cpu")
        for bags in (False, True):
            out["a"][shape, bags] = port_run(params[bags], mesh, CAP[bags],
                                             bags)[0]
            if shape != (1, 2):
                out["b"][shape, bags] = port_run(
                    params[bags], mesh, CHURN[bags], bags,
                    CHURN_STEPS[bags])[0]
        if shape == (1, 2):
            _, ctx = port_run(params[False], mesh, CAP[False], False)
            out["eval_step"] = eval_step_preds(ctx, mesh)
    if world == 2:
        if rank == 0:
            out["one"] = {bags: port_run(params[bags], None, CAP[bags],
                                         bags)[0] for bags in (False, True)}
            _, ctx = port_run(params[False], None, CAP[False], False)
            out["one_eval_step"] = eval_step_preds(ctx, None)
            out["uncached"] = {bags: port_run(params[bags], None, 0, bags,
                                              CHURN_STEPS[bags])[0]
                               for bags in (False, True)}
        dist.barrier()
        out["e"] = entry_points(params[False], make_mesh((2, 1),
                                                         device="cpu"),
                                inputs["tmp"])
    out["jax_modules"] = ddp.loaded_jax_modules()
    return out


BODIES = {"cached": body}


# --- the JAX side -----------------------------------------------------------


def jax_params(bags):
    import jax
    import jax.numpy as jnp

    from persia_tpu import models as jm

    variables = jm.DLRM(embedding_dim=DIM, compute_dtype=jnp.float32).init(
        jax.random.key(3), [jnp.zeros((4, NUM_DENSE), jnp.float32)],
        [jnp.zeros((4, DIM), jnp.float32)] * (3 if bags else 4),
        train=False)
    return jax.tree_util.tree_map(np.asarray, dict(variables["params"]))


def jax_mesh_run(params, shape, bags):
    """JAX's cached TrainCtx on ``make_mesh(shape, devices=
    jax.devices()[:W])``: losses and the flushed PS rows."""
    import jax
    import jax.numpy as jnp
    import optax

    from persia_tpu import config as jcfg
    from persia_tpu import models as jm
    from persia_tpu.ctx import TrainCtx
    from persia_tpu.data import batch as jbatch
    from persia_tpu.embedding import EmbeddingConfig
    from persia_tpu.embedding.optim import Adagrad
    from persia_tpu.parallel.mesh import make_mesh
    from persia_tpu.ps.store import EmbeddingHolder
    from persia_tpu.worker.worker import EmbeddingWorker

    mesh = make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    opt = optax.adagrad(LR)
    schema = tdc._schema(jcfg, bags)
    ctx = TrainCtx(
        model=jm.DLRM(embedding_dim=DIM, compute_dtype=jnp.float32),
        dense_optimizer=opt, embedding_optimizer=Adagrad(lr=LR),
        schema=schema, worker=EmbeddingWorker(
            schema, [EmbeddingHolder(100_000, 2) for _ in range(2)]),
        embedding_config=EmbeddingConfig(emb_initialization=(-0.05, 0.05)),
        global_config=jcfg.GlobalConfig(
            common=jcfg.CommonConfig(embedding_wire_dtype="f32")),
        device_cache_capacity=CAP[bags], mesh=mesh)
    ctx.state = tdc._jax_state(params, opt)
    with ctx:
        losses = [float(ctx.train_step(b)[0])
                  for b in stream(bags)(jbatch, STEPS, BS)]
        ctx.flush_device_cache()
    want = {}
    for h in ctx.worker.ps_clients:
        for shard in h._shards:
            for sign, (d, vec) in shard._map.items():
                want[sign] = np.asarray(vec[:2 * d])
    return losses, want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import test_torch_ranks as launch

    params = {bags: jax_params(bags) for bags in (False, True)}
    dirs = {w: tmp_path_factory.mktemp(f"cached{w}") for w in MESHES}
    inputs = {"params": params,
              "tmp": str(tmp_path_factory.mktemp("cached_files"))}
    groups = {w: launch.start_ranks(__file__, "cached", w, inputs, dirs[w],
                                    env=ddp._child_env()) for w in MESHES}
    try:
        ref = {(shape, bags): jax_mesh_run(params[bags], shape, bags)
               for shapes in MESHES.values() for shape in shapes
               for bags in (False, True)}
    except BaseException:
        for g in groups.values():
            g.kill()
        raise
    return ref, {w: launch.collect(g, dirs[w], DEADLINE_S)
                 for w, g in groups.items()}


def _leader(ranks):
    return ranks[0]


# --- the cases --------------------------------------------------------------


ALL = [(w, s) for w, shapes in MESHES.items() for s in shapes]


@pytest.mark.parametrize("bags", [False, True], ids=["single_id", "bags"])
@pytest.mark.parametrize("world_size,shape", ALL,
                         ids=[f"{d}x{m}" for _, (d, m) in ALL])
def test_mesh_cache_matches_jax(world, world_size, shape, bags):
    ref, port = world
    ranks = port[world_size]
    runs = [r["a"][shape, bags] for r in ranks]
    jl, jtables = ref[shape, bags]
    for r in runs:
        assert r["losses"] == runs[0]["losses"]
        assert r["flushed"] == runs[0]["flushed"] > 0
        for k, v in r["dense"].items():
            np.testing.assert_array_equal(v, runs[0]["dense"][k], err_msg=k)
    np.testing.assert_allclose(runs[0]["losses"], jl, rtol=MESH_TOL,
                               atol=MESH_TOL)
    tdc._assert_tables_close(runs[0]["tables"], jtables, MESH_TOL)
    assert all(r["tables"] is None for r in runs[1:])
    st = runs[0]["stats"]
    assert st["hits"] + st["misses"] == st["probes"] > 0
    assert st["evictions"] == 0 and st["resident_rows"] > 100
    assert all(r["stats"]["probes"] == 0 for r in runs[1:])


CHURN_CASES = [(2, (2, 1)), (4, (2, 2))]


@pytest.mark.parametrize("bags", [False, True], ids=["single_id", "bags"])
@pytest.mark.parametrize("world_size,shape", CHURN_CASES,
                         ids=["2x1", "2x2"])
def test_mesh_cache_with_eviction_matches_uncached(world, world_size, shape,
                                                    bags):
    _, port = world
    ref = port[2][0]["uncached"][bags]
    runs = [r["b"][shape, bags] for r in port[world_size]]
    got = runs[0]
    for r in runs:
        assert r["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=CACHE_TOL,
                               atol=CACHE_TOL)
    tdc._assert_tables_close(got["tables"], ref["tables"], CACHE_TOL)
    st = got["stats"]
    assert st["evictions"] > 100 and st["writeback_rows"] > 100


@pytest.mark.parametrize("bags", [False, True], ids=["single_id", "bags"])
def test_model_axis_mesh_is_bit_equal_to_one_rank(world, bags):
    """(1, 2): the data axis is one rank, so the tower sees the whole
    batch as one rank does, and the summed rows are exact."""
    _, port = world
    one = port[2][0]["one"][bags]
    for r in port[2]:
        run = r["a"][(1, 2), bags]
        assert run["losses"] == one["losses"]
        assert run["dense"].keys() == one["dense"].keys()
        for k, v in run["dense"].items():
            np.testing.assert_array_equal(v, one["dense"][k], err_msg=k)
    tables = port[2][0]["a"][(1, 2), bags]["tables"]
    assert tables.keys() == one["tables"].keys() and len(tables) > 50
    for s, v in one["tables"].items():
        np.testing.assert_array_equal(tables[s], v)


def test_mesh_eval_step_is_bit_equal_to_one_rank(world):
    _, port = world
    one = port[2][0]["one_eval_step"]
    assert one.shape == (BS, 1) and np.std(one) > 1e-4
    for r in port[2]:
        np.testing.assert_array_equal(r["eval_step"], one)


@pytest.mark.parametrize("world_size,shape", ALL,
                         ids=[f"{d}x{m}" for _, (d, m) in ALL])
def test_cache_rows_are_sharded_over_every_rank(world, world_size, shape):
    from persia_tpu_torch.parallel.mesh import cache_rows

    _, port = world
    for bags in (False, True):
        cap = CAP[bags]
        rows = cache_rows(cap, world_size)
        assert rows % world_size == 0 and rows >= cap + 1
        windows = [r["a"][shape, bags]["window"] for r in port[world_size]]
        assert len(set(windows)) == world_size
        n = rows // world_size
        assert sorted(windows) == [(i * n, n) for i in range(world_size)]
        d, m = shape
        # data-major: rank (i, j) holds block i * m + j
        assert [lo // n for lo, _ in windows] == list(range(world_size))
        for r in port[world_size]:
            assert r["a"][shape, bags]["shape"] == (n + 1, DIM)
        assert sum(lo <= cap < lo + n for lo, n in windows) == 1


def test_flush_and_eval_ctx_are_collective(world):
    _, port = world
    ranks = port[2]
    preds = [r["e"]["eval"] for r in ranks]
    one = ranks[0]["e"]["eval_one"]
    assert len(one) == 2
    for p in preds:
        for a, b, c in zip(p, preds[0], one):
            assert a.shape == (BS, 1)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, c, rtol=MESH_TOL, atol=MESH_TOL)


def test_snapshot_and_resume_on_the_cached_mesh_are_bit_equal(world):
    _, port = world
    for r in port[2]:
        res = r["e"]["resume"]
        assert res["split"] == res["straight"]
        assert res["cursor"] == {"step": 4}
        a, b = res["dense"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a, b = port[2][0]["e"]["resume"]["tables"]
    assert len(a) > 50 and _tables_equal(a, b)


def test_batch_norm_tower_keeps_the_ranks_equal(world):
    """The data axis's shards give the batch norms different statistics;
    their running buffers are averaged after each step, so the ranks'
    states stay bit-equal and the snapshot's agreement check passes."""
    _, port = world
    runs = [r["e"]["bn"] for r in port[2]]
    first = runs[0]
    assert all(np.isfinite(first["losses"]))
    assert first["path"] and not first["path"].startswith("failed")
    mean = first["state"]["BatchNorm_0.mean"]
    assert np.abs(mean).max() > 1e-4  # the buffers moved
    for r in runs[1:]:
        assert r["losses"] == first["losses"] and r["path"] == first["path"]
        assert r["state"].keys() == first["state"].keys()
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, first["state"][k], err_msg=k)


def test_load_checkpoint_invalidates_every_rank(world):
    _, port = world
    for r in port[2]:
        ld = r["e"]["load"]
        assert ld["before"] > 0 and ld["vals_zero"] and ld["acc_init"]
        assert ld["victims"] == 0 and np.isfinite(ld["after"])
    assert port[2][0]["e"]["load"]["mapper"] == 0
    assert port[2][0]["e"]["load"]["restored"]
    assert port[2][1]["e"]["load"]["mapper"] is None


def test_dataloader_over_the_cached_mesh_equals_the_synchronous_run(world):
    _, port = world
    for r in port[2]:
        e = r["e"]
        assert e["loader_types"] == ["PersiaBatch"] and e["loader_engine"]
        assert e["loader"] == e["sync"] == port[2][0]["e"]["sync"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_raise_on_every_rank_alike(world, case):
    _, port = world
    seen = [r["e"]["refusals"][case] for r in port[2]]
    assert seen[0] is not None and seen[0][0] == "NotImplementedError"
    assert all(s == seen[0] for s in seen)
    assert seen[0][2]  # no engine was built
    match = {"sgd": "Adagrad", "raw_slot": "raw slot",
             "mean_pooling": "pooling", "mixed_dims": "uniform",
             "no_rows": "row access"}[case]
    assert match in seen[0][1]


def test_ranks_on_two_hosts_follow_the_multihost_knob(world):
    _, port = world
    for r in port[2]:
        assert r["e"]["hosts"] == {"off": 0, "refuse": "NotImplementedError",
                                   "maybe": "ValueError", "one_host": 64}


def test_ranks_import_no_jax(world):
    _, port = world
    assert [r["jax_modules"] for w in port for r in port[w]] == [[]] * 6


if __name__ == "__main__":
    from test_torch_ranks import rank_main

    rank_main(BODIES)
