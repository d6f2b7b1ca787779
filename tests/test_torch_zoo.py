"""The port's dense model zoo against the JAX package, on the CPU.

Each tower (``DNN``, ``DLRM``, ``DCNv2``, ``DeepFM`` with and without
dense features, ``WideAndDeep``) starts from the JAX package's flax
weights, carried across by ``load_flax_params`` (the DNN's batch norms
with random scale, bias and running statistics, so that eval reads
them), and takes 3 ``TrainCtx.train_step``s in both packages over fresh
two-shard numpy PS; then both score a held-out batch through
``eval_ctx``. Compared: loss, predictions, each slot's embedding
gradient after the wire, the updated dense parameters, the batch norms'
``batch_stats`` and the PS rows. Tolerances, as in
``tests/test_torch_train.py``: f32 compute and f32 wire 1e-5 (parameters
and statistics 2e-5), the same math in another summation order carried
through the optimizer; bf16 compute and wire 2e-2 (parameters 3e-3), the
two frameworks rounding to bf16 at different places.

``FlaxBatchNorm`` alone is held to flax's ``nn.BatchNorm``: the running
update (momentum 0.99, the biased fast variance), the clipping of that
variance at 0 on a constant column, the gradient through the batch
statistics, and eval reading the running statistics.

The DNN's pipelined steps (reproducible, staleness 1) equal its
synchronous steps on the CPU and, as a ``gpu`` test, on the card (run
there with ``python -m pytest tests/test_torch_zoo.py -m gpu
--noconftest``); this file imports JAX only inside the tests that
compare with it.
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch import config as tcfg
from persia_tpu_torch.ps.store import EmbeddingHolder as THolder
from persia_tpu_torch.worker.worker import EmbeddingWorker as TWorker

D, NUM_DENSE, BS, VOCAB = 8, 5, 32, 40
SUMMED = ("s0", "s1", "s2")
RAW = "hist"


@pytest.fixture
def jax_numpy_middleware(monkeypatch):
    """The JAX middleware's numpy twin (its C++ kernels may be built)."""
    from persia_tpu.worker import middleware as jmw

    monkeypatch.setattr(jmw, "_mw_native", lambda: None)
    return jmw


def _schema(cfg):
    slots = cfg.uniform_slots(list(SUMMED), dim=D)
    slots[RAW] = cfg.SlotConfig(name=RAW, dim=D, embedding_summation=False,
                                sample_fixed_size=4)
    return cfg.EmbeddingSchema(slots_config=slots)


def _stream(mod, steps, seed, num_dense=NUM_DENSE, requires_grad=True):
    """Seeded batches of the batch module ``mod`` (either package's): 3
    single-id slots and one ragged slot over small vocabularies, so rows
    repeat across steps."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        feats = [mod.IDTypeFeatureWithSingleID(
            name, (rng.integers(0, VOCAB, size=BS) + 1 + i * VOCAB)
            .astype(np.uint64)) for i, name in enumerate(SUMMED)]
        feats.append(mod.IDTypeFeature(RAW, [
            (rng.integers(0, VOCAB, size=rng.integers(1, 7))
             + 1 + 3 * VOCAB).astype(np.uint64) for _ in range(BS)]))
        non_id = ([mod.NonIDTypeFeature(rng.normal(
            size=(BS, num_dense)).astype(np.float32))] if num_dense else [])
        yield mod.PersiaBatch(
            feats, non_id_type_features=non_id,
            labels=[mod.Label((rng.random((BS, 1)) < 0.5)
                              .astype(np.float32))],
            requires_grad=requires_grad, batch_id=step)


def _towers(name, compute_dtype):
    """(JAX module, port module on the CPU, num_dense) of one tower."""
    import jax.numpy as jnp

    from persia_tpu import models as jm
    from persia_tpu_torch import models as tm

    jdt, tdt = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    dims = [D] * (len(SUMMED) + 1)
    kw = dict(compute_dtype=tdt, device="cpu")
    if name == "dnn":
        return (jm.DNN(compute_dtype=jdt),
                tm.DNN(NUM_DENSE, dims, **kw), NUM_DENSE)
    if name == "dlrm":
        return (jm.DLRM(embedding_dim=D, compute_dtype=jdt),
                tm.DLRM(NUM_DENSE, len(dims), embedding_dim=D, **kw),
                NUM_DENSE)
    if name == "dcnv2":
        return (jm.DCNv2(compute_dtype=jdt),
                tm.DCNv2(NUM_DENSE, dims, **kw), NUM_DENSE)
    if name.startswith("deepfm"):
        nd = 0 if name.endswith("no_dense") else NUM_DENSE
        return (jm.DeepFM(compute_dtype=jdt),
                tm.DeepFM(nd, len(dims), embedding_dim=D, **kw), nd)
    assert name == "wide_deep"
    return (jm.WideAndDeep(compute_dtype=jdt),
            tm.WideAndDeep(NUM_DENSE, dims, **kw), NUM_DENSE)


def jax_variables(jmodel, num_dense, seed=5, n_slots=len(SUMMED) + 1,
                  dims=None):
    """flax params and batch_stats of ``jmodel`` as numpy trees; every
    batch norm's scale, bias and running statistics drawn at random so
    that a transplant or an eval that ignored them would show."""
    import jax
    import jax.numpy as jnp

    dims = dims or [D] * n_slots
    non_id = [jnp.zeros((BS, num_dense), jnp.float32)] if num_dense else []
    emb = [jnp.zeros((BS, d), jnp.float32) for d in dims]
    variables = jmodel.init(jax.random.key(seed), non_id, emb, train=False)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    stats = jax.tree_util.tree_map(
        np.asarray, dict(variables.get("batch_stats", {})))
    rng = np.random.default_rng(seed)
    for name, st in stats.items():
        n = st["mean"].shape[0]
        st["mean"] = rng.normal(0.0, 0.3, n).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        params[name] = {
            "scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
            "bias": rng.normal(0.0, 0.1, n).astype(np.float32)}
    return params, stats


def jax_train_ctx(jmodel, params, stats, schema, dense_optimizer,
                  sparse_lr=1e-2, wire="f32", loss_fn=None,
                  emb_init=(-0.05, 0.05)):
    """A JAX TrainCtx over two fresh per-entry numpy PS shards, its state
    set from ``params`` / ``stats``."""
    import jax
    import jax.numpy as jnp

    from persia_tpu import config as jcfg
    from persia_tpu.ctx import TrainCtx
    from persia_tpu.embedding import EmbeddingConfig
    from persia_tpu.embedding.optim import Adagrad
    from persia_tpu.parallel.train import TrainState, make_eval_step
    from persia_tpu.ps.store import EmbeddingHolder
    from persia_tpu.worker.worker import EmbeddingWorker

    gc = jcfg.GlobalConfig()
    gc.common.embedding_wire_dtype = wire
    worker = EmbeddingWorker(schema, [EmbeddingHolder(100_000, 4)
                                      for _ in range(2)])
    ctx = TrainCtx(model=jmodel, dense_optimizer=dense_optimizer,
                   embedding_optimizer=Adagrad(lr=sparse_lr), schema=schema,
                   worker=worker, global_config=gc, loss_fn=loss_fn,
                   embedding_config=EmbeddingConfig(emb_init))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    stats = jax.tree_util.tree_map(jnp.asarray, stats)
    ctx.state = TrainState(params=params, batch_stats=stats,
                           opt_state=dense_optimizer.init(params),
                           step=jnp.zeros((), jnp.int32))
    ctx._eval_step = make_eval_step(jmodel)
    assert jax.default_backend() == "cpu"
    return ctx


def port_train_ctx(tmodel, params, stats, schema, dense_optimizer,
                   sparse_lr=1e-2, wire="f32", loss_fn=None,
                   emb_init=(-0.05, 0.05)):
    """The port's TrainCtx over two fresh per-entry numpy PS shards, the
    model's weights transplanted from the flax trees."""
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.weights import load_flax_params

    load_flax_params(tmodel, params, stats)
    worker = TWorker(schema, [THolder(100_000, 4) for _ in range(2)])
    return TrainCtx(tmodel, dense_optimizer(tmodel.parameters()),
                    Adagrad(lr=sparse_lr), schema, worker, loss_fn=loss_fn,
                    embedding_config=EmbeddingConfig(emb_init),
                    global_config=tcfg.GlobalConfig(tcfg.CommonConfig(wire)),
                    device="cpu")


def record_grads(worker):
    """Keep each step's per-slot gradients after the wire."""
    seen = []
    inner = worker.update_gradients

    def update(ref_id, grads, *a, **kw):
        seen.append({k: np.array(v) for k, v in grads.items()})
        return inner(ref_id, grads, *a, **kw)

    worker.update_gradients = update
    return seen


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def assert_trees_close(got, want, tol):
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


def assert_ps_rows_close(jctx, tctx, widths, tol):
    """Every PS row of both contexts, [embedding | optimizer state] at
    each of ``widths``: the same signs at the same widths, the values
    within ``tol``."""
    for jh, th in zip(jctx.worker.ps_clients, tctx.worker.ps_clients):
        assert len(jh) == len(th) > 0
        signs = np.array([s for shard in th._shards for s in sorted(shard)],
                         np.uint64)
        found = np.zeros(len(signs), int)
        for width in widths:
            (jf, jv), (tf, tv) = (h.get_entries(signs, width)
                                  for h in (jh, th))
            np.testing.assert_array_equal(tf, jf)
            np.testing.assert_allclose(tv[tf], jv[jf], rtol=tol, atol=tol)
            found += tf
        assert (found == 1).all()


def run_and_compare(jctx, tctx, jbatches, tbatches, tol, ptol, widths):
    """3 train steps of both contexts on the paired batches, compared
    after each step; returns the port's per-step gradients."""
    from persia_tpu_torch.weights import flax_params

    jgrads, tgrads = record_grads(jctx.worker), record_grads(tctx.worker)
    for step, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jloss, jpred = jctx.train_step(jb)
        tloss, tpred = tctx.train_step(tb)
        assert tpred.dtype == torch.float32
        assert tuple(tpred.shape) == np.asarray(jpred).shape
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                                   rtol=tol, atol=tol)
        assert list(jgrads[step]) == list(tgrads[step])
        for name, g in tgrads[step].items():
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, jgrads[step][name], rtol=tol,
                                       atol=tol, err_msg=name)
        params, stats = flax_params(tctx.model)
        assert_trees_close(params, jctx.state.params, ptol)
        assert_trees_close(stats, jctx.state.batch_stats, ptol)
        assert_ps_rows_close(jctx, tctx, widths, tol)
    assert len(tgrads) == 3
    return tgrads


def eval_both(jctx, tctx, jbatch, tbatch):
    from persia_tpu.ctx import eval_ctx as jeval
    from persia_tpu_torch.ctx import eval_ctx as teval

    with jeval(jctx) as e:
        jpred, jlab = e.forward(jbatch)
    with teval(tctx) as e:
        tpred, tlab = e.forward(tbatch)
    np.testing.assert_array_equal(tlab[0].numpy(), np.asarray(jlab[0]))
    return tpred.numpy(), np.asarray(jpred)


TOWERS = ["dnn", "dlrm", "dcnv2", "deepfm", "deepfm_no_dense", "wide_deep"]


@pytest.mark.parametrize("tower,compute_dtype,wire,tol", [
    *[(t, "float32", "f32", 1e-5) for t in TOWERS],
    ("dnn", "bfloat16", "bf16", 2e-2),
    ("dlrm", "bfloat16", "bf16", 2e-2),
])
def test_tower_train_steps_match_jax(tower, compute_dtype, wire, tol,
                                     jax_numpy_middleware):
    """Eval forward and 3 train steps of each tower in both packages,
    from the same weights and fresh PS rows. DLRM trains with
    ``optax.adagrad(0.02)`` against the port's ``OptaxAdagrad``
    (``bench_hybrid``'s pair), the others with Adam, but for the DNN: the
    bias of a ``Dense`` that feeds a train-mode batch norm has a zero
    gradient in exact arithmetic (the norm subtracts the batch mean), and
    Adam, dividing a gradient by its own magnitude, moves it by +-lr on
    the rounding noise of either framework; Adagrad moves it by that
    noise times lr / sqrt(0.1)."""
    import optax

    from persia_tpu import config as jcfg
    from persia_tpu.data import batch as jbatch
    from persia_tpu_torch.data import batch as tbatch
    from persia_tpu_torch.parallel.optim import OptaxAdagrad

    jmodel, tmodel, nd = _towers(tower, compute_dtype)
    params, stats = jax_variables(jmodel, nd)
    assert bool(stats) == (tower == "dnn")
    if tower in ("dlrm", "dnn"):
        jopt, topt = optax.adagrad(0.02), (lambda p: OptaxAdagrad(p, 0.02))
    else:
        jopt, topt = optax.adam(1e-3), (lambda p: torch.optim.Adam(p,
                                                                  lr=1e-3))
    jctx = jax_train_ctx(jmodel, params, stats, _schema(jcfg), jopt,
                         wire=wire)
    tctx = port_train_ctx(tmodel, params, stats, _schema(tcfg), topt,
                          wire=wire)
    ptol = 2e-5 if tol == 1e-5 else 3e-3
    try:
        with jctx, tctx:
            grads = run_and_compare(
                jctx, tctx, _stream(jbatch, 3, seed=7, num_dense=nd),
                _stream(tbatch, 3, seed=7, num_dense=nd), tol, ptol, [2 * D])
            held = [next(_stream(m, 1, seed=8, num_dense=nd,
                                 requires_grad=False))
                    for m in (jbatch, tbatch)]
            tpred, jpred = eval_both(jctx, tctx, *held)
        np.testing.assert_allclose(tpred, jpred, rtol=tol, atol=tol)
        assert ((tpred > 0) & (tpred < 1)).all()
        # every slot's rows move, the raw slot's too
        assert all(np.abs(g).max() > 0 for g in grads[0].values())
    finally:
        jctx.worker.close()


@pytest.mark.parametrize("tower", TOWERS)
def test_flax_names_round_trip(tower):
    """``load_flax_params`` takes the JAX tower's whole tree (a renamed
    key raises) and ``flax_params`` gives it back;
    ``init_params`` resets every batch norm to flax's init; a DeepFM
    built without dense features refuses them."""
    from persia_tpu_torch.models.common import FlaxBatchNorm
    from persia_tpu_torch.weights import (
        flax_params,
        init_params,
        load_flax_params,
    )

    jmodel, tmodel, nd = _towers(tower, "float32")
    params, stats = jax_variables(jmodel, nd)
    load_flax_params(tmodel, params, stats)
    got_params, got_stats = flax_params(tmodel)
    assert_trees_close(got_params, params, 0)
    assert_trees_close(got_stats, stats, 0)
    bad = {k: v for k, v in params.items() if k != "MLP_0"}
    bad["MLP_9"] = params.get("MLP_0", {})
    with pytest.raises(KeyError):
        load_flax_params(tmodel, bad, stats)
    if tower == "deepfm_no_dense":  # built without dense features
        emb = [torch.zeros(2, D) for _ in range(len(SUMMED) + 1)]
        with pytest.raises(ValueError, match="num_dense=0"):
            tmodel([torch.zeros(2, NUM_DENSE)], emb)
    init_params(tmodel, 3)
    for m in tmodel.modules():
        if isinstance(m, FlaxBatchNorm):
            for t, v in ((m.scale, 1.0), (m.bias, 0.0), (m.mean, 0.0),
                         (m.var, 1.0)):
                assert torch.equal(t, torch.full_like(t, v))


def test_batch_norm_follows_flax():
    """``FlaxBatchNorm`` against flax's ``nn.BatchNorm`` over two train
    steps and an eval: outputs, gradients (input, scale, bias) through
    the batch statistics, the running update (momentum 0.99 on the
    biased fast variance), and a constant column whose variance clips at
    0 (its E[x^2] - E[x]^2 rounds below 0 here)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from persia_tpu_torch.models.common import FlaxBatchNorm

    n, f = 48, 6
    rng = np.random.default_rng(0)
    xs = [rng.normal(1.0, 2.0, size=(n, f)).astype(np.float32)
          for _ in range(2)]
    for x in xs:
        x[:, 0] = np.float32(1.1)  # constant: fast variance rounds < 0
        t = torch.from_numpy(x)
        assert float(((t * t).mean(0) - t.mean(0) * t.mean(0))[0]) < 0
    cot = rng.normal(size=(n, f)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, f).astype(np.float32)
    bias = rng.normal(0.0, 0.1, f).astype(np.float32)

    bn = nn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    variables = bn.init(jax.random.key(0), jnp.asarray(xs[0]))
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = variables["batch_stats"]
    tbn = FlaxBatchNorm(f)
    with torch.no_grad():
        tbn.scale.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
    for x in xs:
        def f_jax(p, x, stats=stats):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, upd["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(
            f_jax, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        tbn.train()
        ty = tbn(tx)
        (ty * torch.from_numpy(cot)).sum().backward()
        ty, y = ty.detach().numpy(), np.asarray(y)
        np.testing.assert_allclose(ty[:, 1:], y[:, 1:], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tbn.bias.grad.numpy(),
                                   np.asarray(gp["bias"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tbn.scale.grad.numpy()[1:],
                                   np.asarray(gp["scale"])[1:], rtol=1e-5,
                                   atol=1e-5)
        # the constant column: x - mean is 0 in exact arithmetic, and the
        # batch mean may round an ulp apart in the two frameworks, which
        # rsqrt(0 + eps) carries 316-fold into the output (and the scale's
        # gradient, which is 0 in exact arithmetic)
        noise = 2 * np.spacing(np.float32(1.1)) / np.sqrt(1e-5)
        np.testing.assert_allclose(ty[:, 0], y[:, 0], rtol=0,
                                   atol=noise * scale[0])
        for g in (tbn.scale.grad[0], gp["scale"][0]):
            assert abs(float(g)) <= noise * np.abs(cot[:, 0]).sum()
        tbn.scale.grad = tbn.bias.grad = None
        for name in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(tbn, name).numpy(), np.asarray(stats[name]),
                rtol=1e-6, atol=1e-7)
    # the constant column: batch variance 0, running var 0.99^2 + 0
    assert float(tbn.var[0]) == pytest.approx(0.99 ** 2, rel=1e-6)
    assert float(tbn.mean[0]) == pytest.approx(
        1.1 * (1 - 0.99 ** 2), rel=1e-5)
    # eval reads the running statistics, and moves nothing
    before = (tbn.mean.clone(), tbn.var.clone())
    tbn.eval()
    with torch.no_grad():
        ty = tbn(torch.from_numpy(xs[1]))
    y = nn.BatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(xs[1]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(before[0], tbn.mean) and torch.equal(before[1],
                                                           tbn.var)


def test_train_ctx_loss_fn_and_batch_norm_modes():
    """``TrainCtx(loss_fn=)`` reaches the step (a doubled loss doubles
    every gradient), the default is ``bce_loss``, and a train step moves
    the DNN's running statistics while an eval forward does not."""
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.data import batch as tbatch
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.parallel.train import bce_loss

    def make(loss_fn):
        from persia_tpu_torch.ctx import TrainCtx
        from persia_tpu_torch.embedding.optim import SGD

        model = DNN(NUM_DENSE, [D] * 4, compute_dtype=torch.float32,
                    device="cpu")
        worker = TWorker(_schema(tcfg), [THolder(10_000, 2)
                                         for _ in range(2)])
        ctx = TrainCtx(model, torch.optim.SGD(model.parameters(), lr=0.0),
                       SGD(lr=0.0), _schema(tcfg), worker, seed=1,
                       loss_fn=loss_fn, device="cpu",
                       global_config=tcfg.GlobalConfig(
                           tcfg.CommonConfig("f32")))
        return ctx, record_grads(worker)

    (one, g1), (two, g2) = make(None), make(lambda p, l: 2 * bce_loss(p, l))
    assert one.loss_fn is bce_loss
    batch = next(_stream(tbatch, 1, seed=3))
    with one, two:
        l1, _ = one.train_step(batch)
        l2, _ = two.train_step(batch)
        stats = one.model.BatchNorm_0.mean.clone()
        assert not torch.equal(stats, torch.zeros_like(stats))
        with eval_ctx(one) as e:
            e.forward(next(_stream(tbatch, 1, seed=4, requires_grad=False)))
        assert torch.equal(stats, one.model.BatchNorm_0.mean)
    assert float(l2) == pytest.approx(2 * float(l1), rel=1e-6)
    for name in g1[0]:
        np.testing.assert_allclose(g2[0][name], 2 * g1[0][name], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_dnn_pipelined_steps_match_sync_steps(device):
    """10 pipelined steps of the DNN (reproducible, staleness 1, 4
    prefetch workers staging on their own threads) against 10
    synchronous steps from the same weights, f32 tower and wire, on the
    native PS: equal losses, predictions, running statistics and PS rows,
    on the CPU and on the card (where the copies and kernels the training
    thread issues must be ordered after the prefetch threads' copies)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.data import batch as tbatch
    from persia_tpu_torch.data.dataloader import DataLoader, IterableDataset
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.ps.native import make_holder

    torch.backends.cuda.matmul.allow_tf32 = False

    def ctx():
        model = DNN(NUM_DENSE, [D] * 4, compute_dtype=torch.float32,
                    device=device)
        worker = TWorker(_schema(tcfg), [make_holder(100_000, 4)
                                         for _ in range(2)])
        return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                        Adagrad(lr=1e-2), _schema(tcfg), worker, seed=3,
                        embedding_config=EmbeddingConfig(
                            emb_initialization=(-0.05, 0.05)),
                        global_config=tcfg.GlobalConfig(
                            tcfg.CommonConfig("f32")), device=device)

    runs = []
    for pipelined in (False, True):
        c = ctx()
        batches = _stream(tbatch, 10, seed=9)
        out = []
        with c:
            it = (DataLoader(IterableDataset(batches), num_workers=4,
                             reproducible=True, embedding_staleness=1)
                  if pipelined else batches)
            for b in it:
                loss, pred = c.train_step(b)
                out.append((float(loss), pred.cpu().numpy()))
        stats = [t.cpu().numpy() for t in (c.model.BatchNorm_0.mean,
                                           c.model.BatchNorm_1.var)]
        rows = [h.get_entries(np.arange(1, 4 * VOCAB + 1, dtype=np.uint64),
                              2 * D) for h in c.worker.ps_clients]
        c.worker.close()
        runs.append((out, stats, rows))
    (sync, sstats, srows), (pipe, pstats, prows) = runs
    assert len(pipe) == len(sync) == 10
    for (sl, sp), (pl, pp) in zip(sync, pipe):
        assert sl == pl
        np.testing.assert_array_equal(sp, pp)
    for a, b in zip(sstats, pstats):
        np.testing.assert_array_equal(a, b)
    for (sf, sv), (pf, pv) in zip(srows, prows):
        np.testing.assert_array_equal(sf, pf)
        np.testing.assert_array_equal(sv, pv)
