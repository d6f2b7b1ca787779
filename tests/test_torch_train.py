"""The PyTorch port's training slice against the JAX package, on the CPU.

Host side, bit-exact (the port keeps numpy copies of the same arithmetic):
the sparse optimizers, the PS store's training lookup and gradient update,
the worker middleware's gradient aggregation and the worker's
lookup -> update round trip.

Whole step: ``TrainCtx.train_step`` of both packages from transplanted
dense weights over fresh two-shard numpy PS (the PS rows grow from the
same seeded init), one step and then three, compared on loss,
predictions, the per-slot embedding gradients after the wire, the updated
dense parameters and the updated PS rows. Tolerances:

- f32 compute and f32 wire, 1e-5 (parameters 2e-5): the same math with
  another matmul blocking and summation order; Adam divides each
  gradient by its own magnitude, so a parameter moves by ~lr whatever
  the gradient's size and carries the gradients' relative error times lr.
- bf16 compute and bf16 wire, 2e-2: the serving tests' bound. The two
  frameworks round to bf16 at different places (flax's bf16 dot rounds
  its product, PyTorch accumulates in f32 first, the Pallas kernels round
  p and ds), each worth 2**-8 relative, through five bf16 layers; the
  wire rounds the embedding gradients once more. Adam's first steps move
  a parameter by up to lr = 1e-3, so a gradient whose sign differs
  between the two moves it 2e-3 apart.
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch import config as tcfg
from persia_tpu_torch.ps import optim as toptim
from persia_tpu_torch.ps.store import EmbeddingHolder as THolder
from persia_tpu_torch.worker import middleware as tmw
from persia_tpu_torch.worker.worker import EmbeddingWorker as TWorker
from persia_tpu_torch.workloads import generator as tgen


@pytest.fixture
def jax_numpy_middleware(monkeypatch):
    """The JAX package's middleware takes its C++ kernels when they are
    built; the bit-exact comparisons hold the port to its numpy twin."""
    from persia_tpu.worker import middleware as jmw

    monkeypatch.setattr(jmw, "_mw_native", lambda: None)
    return jmw


# --- sparse optimizers ------------------------------------------------------


@pytest.mark.parametrize("config", [
    {"type": "sgd", "lr": 0.05, "wd": 0.01},
    {"type": "adagrad", "lr": 0.02, "wd": 0.0, "g_square_momentum": 0.9,
     "initialization": 0.01, "eps": 1e-10, "vectorwise_shared": False},
    {"type": "adagrad", "lr": 0.02, "wd": 0.0, "g_square_momentum": 1.0,
     "initialization": 0.05, "eps": 1e-10, "vectorwise_shared": True},
    {"type": "adam", "lr": 0.01, "beta1": 0.9, "beta2": 0.99, "eps": 1e-8},
], ids=["sgd", "adagrad", "adagrad_shared", "adam"])
def test_sparse_optimizers_are_bit_exact(config):
    from persia_tpu.ps import optim as joptim

    dim, n = 6, 40
    rng = np.random.default_rng(0)
    # signs under four feature-group prefixes (the top 4 bits): Adam keeps
    # one pair of beta powers per prefix
    signs = (rng.integers(0, 2**40, size=n, dtype=np.uint64)
             | (rng.integers(0, 4, size=n).astype(np.uint64)
                << np.uint64(60)))
    opts = [m.SparseOptimizer.from_config(config, feature_index_prefix_bit=4)
            for m in (joptim, toptim)]
    space = opts[0].require_space(dim)
    assert opts[1].require_space(dim) == space
    entries = []
    for opt in opts:
        e = np.zeros((n, dim + space), np.float32)
        e[:, :dim] = rng.normal(size=(n, dim)).astype(np.float32) if \
            not entries else entries[0][:, :dim]
        opt.state_initialization(e, dim)
        entries.append(e)
    np.testing.assert_array_equal(*entries)
    for step in range(4):
        grads = rng.normal(size=(n, dim)).astype(np.float32)
        sel = rng.random(n) < 0.7  # not every group steps every batch
        for opt, e in zip(opts, entries):
            st = opt.batch_level_state(signs[sel])
            sub = e[sel]
            opt.update(sub, grads[sel], dim, st)
            e[sel] = sub
        np.testing.assert_array_equal(*entries)
    for m, e in zip((joptim, toptim), entries):
        m.apply_weight_bound(e[:, :dim], 0.5)
    np.testing.assert_array_equal(*entries)


# --- PS store ---------------------------------------------------------------


def test_store_training_lookup_and_update_are_bit_exact():
    """Admission below 1, duplicate signs in one lookup and one update,
    eviction at a small capacity, a dim mismatch, gradient-id misses."""
    from persia_tpu.ps.store import EmbeddingHolder as JHolder

    # 6 rows per internal shard against 80 signs: every round evicts, and
    # which rows go depends on the recency that training hits refresh
    holders = [JHolder(24, 4), THolder(24, 4)]
    adagrad = {"type": "adagrad", "lr": 0.05, "wd": 0.0,
               "g_square_momentum": 1.0, "initialization": 0.01,
               "eps": 1e-10, "vectorwise_shared": False}
    for h in holders:
        h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1},
                    admit_probability=0.7, weight_bound=0.3)
        h.register_optimizer(adagrad)
    rng = np.random.default_rng(1)
    universe = rng.integers(1, 2**63, size=80, dtype=np.uint64)
    seen = set()
    for rnd in range(10):
        signs = rng.choice(universe, size=30)  # with duplicates
        dim = 4 if rnd == 3 else 8  # round 3 re-initializes at dim 4
        outs = [h.lookup(signs, dim, True) for h in holders]
        np.testing.assert_array_equal(*outs)
        grads = rng.normal(size=(len(signs), dim)).astype(np.float32)
        if rnd % 2:
            # distinct signs: the batched path
            signs, idx = np.unique(signs, return_index=True)
            grads = grads[idx]
        for h in holders:
            h.update_gradients(signs, grads, dim)
        seen.update(int(s) for s in signs)
        assert [len(h) for h in holders][0] == len(holders[1]) <= 24
        found = 0
        for width in (8, 16):  # [emb | adagrad state] at dims 4 and 8
            got = [h.get_entries(np.array(sorted(seen), np.uint64), width)
                   for h in holders]
            np.testing.assert_array_equal(got[0][0], got[1][0])
            np.testing.assert_array_equal(got[0][1], got[1][1])
            found += int(got[1][0].sum())
        assert 0 < found <= 24
        # eval lookups create nothing and agree
        outs = [h.lookup(universe, 8, False) for h in holders]
        np.testing.assert_array_equal(*outs)
    for attr in ("index_miss_count", "gradient_id_miss_count"):
        assert getattr(holders[0], attr) == getattr(holders[1], attr) > 0


def test_store_training_requires_optimizer_and_config():
    h = THolder(100, 2)
    with pytest.raises(RuntimeError, match="optimizer"):
        h.lookup(np.array([1], np.uint64), 4, True)
    h.register_optimizer({"type": "sgd", "lr": 0.1})
    with pytest.raises(RuntimeError, match="configured"):
        h.lookup(np.array([1], np.uint64), 4, True)
    # the eval lookup needs neither and reads zeros
    assert not h.lookup(np.array([1], np.uint64), 4, False).any()


# --- worker middleware and worker -----------------------------------------


def _schemas(prefix_bit=8):
    """A schema reaching every gradient transform: sum, mean, last4 and
    sqrt pooling, raw slots with and without hashstack."""
    from persia_tpu import config as jcfg

    out = []
    for cfg in (jcfg, tcfg):
        hs = cfg.HashStackConfig(hash_stack_rounds=2, embedding_size=300)
        slots = {
            "user_geo": cfg.SlotConfig(name="user_geo", dim=8),
            "user_device": cfg.SlotConfig(name="user_device", dim=8,
                                          pooling="mean"),
            "recent_items": cfg.SlotConfig(
                name="recent_items", dim=8, embedding_summation=False,
                sample_fixed_size=8, sqrt_scaling=True,
                hash_stack_config=hs),
            "recent_clicks": cfg.SlotConfig(name="recent_clicks", dim=8,
                                            pooling="last4"),
            "target_item": cfg.SlotConfig(name="target_item", dim=4,
                                          sqrt_scaling=True),
        }
        out.append(cfg.EmbeddingSchema(
            slots_config=slots, feature_index_prefix_bit=prefix_bit,
            feature_groups={"profile": ["user_geo", "user_device"]}))
    return out


def _batch_pairs(n=48, bs=16, seed=3, vocab=3000, t_hist=12):
    from persia_tpu.workloads import generator as jgen

    return list(zip(
        jgen.seqrec_batches(n, bs, seed=seed, spec=jgen.SeqRecSpec(
            item_vocab=vocab, t_hist=t_hist)),
        tgen.seqrec_batches(n, bs, seed=seed, spec=tgen.SeqRecSpec(
            item_vocab=vocab, t_hist=t_hist))))


def _model_grads(rng, lookup):
    """A made-up model gradient per feature, shaped like its lookup
    result, with non-finite values the aggregation must zero."""
    out = {}
    for name, r in lookup.items():
        g = rng.normal(size=r.embeddings.shape).astype(np.float32)
        g.flat[::37] = np.nan
        g.flat[5::41] = np.inf
        out[name] = g
    return out


def test_aggregate_and_shard_gradients_are_bit_exact(jax_numpy_middleware):
    jmw = jax_numpy_middleware
    jschema, tschema = _schemas()
    rng = np.random.default_rng(2)
    for jb, tb in _batch_pairs():
        jf = jmw.preprocess_batch(jb.id_type_features, jschema)
        tf = tmw.preprocess_batch(tb.id_type_features, tschema)
        lookup = {f.name: tmw.postprocess_feature(
            f, tschema.get_slot(f.name),
            np.zeros((f.num_distinct, tschema.get_slot(f.name).dim),
                     np.float32)) for f in tf}
        grads = _model_grads(rng, lookup)
        per = []
        for mw, feats, schema in ((jmw, jf, jschema), (tmw, tf, tschema)):
            per.append([mw.aggregate_gradients(
                f, schema.get_slot(f.name), grads[f.name], loss_scale=4.0)
                for f in feats])
        for a, b in zip(*per):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            assert np.isfinite(b).all()
        ja = jmw.shard_gradients(jf, jschema, per[0], 3)
        ta = tmw.shard_gradients(tf, tschema, per[1], 3)
        assert len(ja) == len(ta)
        for x, y in zip(ja, ta):
            assert x[:2] == y[:2]
            np.testing.assert_array_equal(x[2], y[2])
            np.testing.assert_array_equal(x[3], y[3])


def test_worker_training_round_trip_is_bit_exact(jax_numpy_middleware):
    """lookup_direct_training -> update_gradients through both workers
    over two PS shards each: the looked-up rows and the updated PS rows
    agree bit for bit; a ref_id is consumed once."""
    from persia_tpu.ps.store import EmbeddingHolder as JHolder
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    jschema, tschema = _schemas()
    jw = JWorker(jschema, [JHolder(100_000, 4) for _ in range(2)])
    tw = TWorker(tschema, [THolder(100_000, 4) for _ in range(2)])
    try:
        for w in (jw, tw):
            w.configure_parameter_servers(
                "bounded_uniform", {"lower": -0.05, "upper": 0.05}, 0.9, 1.0)
            w.register_optimizer({"type": "adam", "lr": 0.01, "beta1": 0.9,
                                  "beta2": 0.999, "eps": 1e-8})
        rng = np.random.default_rng(4)
        all_signs = {4: set(), 8: set()}
        for jb, tb in _batch_pairs(n=64):
            jref, jl = jw.lookup_direct_training(jb.id_type_features)
            tref, tl = tw.lookup_direct_training(tb.id_type_features)
            assert list(jl) == list(tl)
            for name in tl:
                np.testing.assert_array_equal(jl[name].embeddings,
                                              tl[name].embeddings)
            grads = _model_grads(rng, tl)
            jw.update_gradients(jref, grads)
            tw.update_gradients(tref, grads)
            with pytest.raises(KeyError):
                tw.update_gradients(tref, grads)
            for f in tmw.preprocess_batch(tb.id_type_features, tschema):
                all_signs[tschema.get_slot(f.name).dim].update(
                    int(s) for s in f.distinct_signs)
        for dim, signs in all_signs.items():
            signs = np.array(sorted(signs), np.uint64)
            for jh, th in zip(jw.ps_clients, tw.ps_clients):
                a, b = jh.get_entries(signs, 3 * dim), th.get_entries(
                    signs, 3 * dim)
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
                assert b[0].any()
    finally:
        jw.close()


def test_embedding_wire_is_bit_exact():
    """The packed wire of both packages: f32 -> bf16 rounds to nearest
    even (ties, subnormals, infinities, values past bf16's largest finite
    value) bit for bit as ml_dtypes does, and the gradient unpack widens
    exactly."""
    import jax.numpy as jnp

    from persia_tpu.parallel import train as jtrain
    from persia_tpu_torch.parallel import train as ttrain

    rng = np.random.default_rng(6)
    ties = (np.arange(1, 200, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32)
    specials = np.array([0.0, -0.0, 1e-40, -3e-39, np.inf, -np.inf,
                         3.4e38, 65504.0, 1.0 + 2.0**-8], np.float32)
    values = [rng.normal(size=(7, 3)).astype(np.float32), ties,
              specials, (rng.normal(size=(5, 4)) * 1e-3).astype(np.float32)]
    want = jtrain.pack_embedding_values(values, jnp.bfloat16)
    got = ttrain.pack_embedding_values(values, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    shapes = [v.shape for v in values]
    for a, b in zip(jtrain.unpack_embedding_grads(want, shapes),
                    ttrain.unpack_embedding_grads(got, shapes)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    f32 = ttrain.pack_embedding_values(values, torch.float32)
    np.testing.assert_array_equal(
        f32.numpy(), jtrain.pack_embedding_values(values, jnp.float32))


def test_bce_loss_matches_jax():
    import jax.numpy as jnp

    from persia_tpu.parallel.train import bce_loss as jbce
    from persia_tpu_torch.parallel.train import bce_loss

    pred = np.array([[0.0], [1e-9], [0.3], [1.0 - 1e-9], [1.0]], np.float32)
    label = np.array([[0.0], [1.0], [1.0], [0.0], [1.0]], np.float32)
    np.testing.assert_allclose(
        float(bce_loss(torch.from_numpy(pred), torch.from_numpy(label))),
        float(jbce(jnp.asarray(pred), jnp.asarray(label))), rtol=1e-6)


# --- the whole train step ---------------------------------------------------

DIM, HEADS, T_HIST, NUM_DENSE, BS = 16, 4, 16, 4, 16
SPEC = dict(item_vocab=2000, t_hist=T_HIST)
SLOTS = [(DIM, False), (DIM, False), (DIM, True), (DIM, False),
         (DIM, False)]


def _seq_schema(cfg):
    slots = cfg.uniform_slots(["user_geo", "user_device", "target_item"],
                              dim=DIM)
    slots["recent_items"] = cfg.SlotConfig(
        name="recent_items", dim=DIM, embedding_summation=False,
        sample_fixed_size=T_HIST)
    slots["recent_clicks"] = cfg.SlotConfig(name="recent_clicks", dim=DIM,
                                            pooling="last4")
    return cfg.EmbeddingSchema(slots_config=slots)


def _jax_ctx(attn_impl, compute_dtype, wire):
    import jax
    import jax.numpy as jnp
    import optax

    from persia_tpu import config as jcfg
    from persia_tpu.ctx import TrainCtx
    from persia_tpu.embedding import EmbeddingConfig
    from persia_tpu.embedding.optim import Adagrad
    from persia_tpu.models import SequenceTower
    from persia_tpu.parallel.train import TrainState
    from persia_tpu.ps.store import EmbeddingHolder
    from persia_tpu.serving import build_state_template
    from persia_tpu.worker.worker import EmbeddingWorker

    schema = _seq_schema(jcfg)
    model = SequenceTower(num_heads=HEADS, attn_impl=attn_impl,
                          compute_dtype=getattr(jnp, compute_dtype))
    params = build_state_template(model, schema, NUM_DENSE, seed=5).params
    adam = optax.adam(1e-3)
    gc = jcfg.GlobalConfig()
    gc.common.embedding_wire_dtype = wire
    worker = EmbeddingWorker(schema, [EmbeddingHolder(100_000, 4)
                                      for _ in range(2)])
    ctx = TrainCtx(model=model, dense_optimizer=adam,
                   embedding_optimizer=Adagrad(lr=1e-2), schema=schema,
                   worker=worker, global_config=gc,
                   embedding_config=EmbeddingConfig(
                       emb_initialization=(-0.05, 0.05)))
    ctx.state = TrainState(params=params, batch_stats={},
                           opt_state=adam.init(params),
                           step=jnp.zeros((), jnp.int32))
    assert jax.default_backend() == "cpu"
    return ctx


def _port_ctx(attn_impl, compute_dtype, wire, jparams):
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import SequenceTower
    from persia_tpu_torch.weights import (
        JAX_ATTN_IMPL,
        load_flax_params,
        numpy_tree,
    )

    model = SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                          attn_impl=JAX_ATTN_IMPL[attn_impl],
                          compute_dtype=getattr(torch, compute_dtype),
                          device="cpu")
    load_flax_params(model, numpy_tree(jparams))
    schema = _seq_schema(tcfg)
    worker = TWorker(schema, [THolder(100_000, 4) for _ in range(2)])
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                    Adagrad(lr=1e-2), schema, worker,
                    embedding_config=EmbeddingConfig(
                        emb_initialization=(-0.05, 0.05)),
                    global_config=tcfg.GlobalConfig(tcfg.CommonConfig(wire)),
                    device="cpu")


def _record_grads(worker):
    """Wrap ``worker.update_gradients`` to keep each step's per-slot
    gradients after the wire."""
    seen = []
    inner = worker.update_gradients

    def update(ref_id, grads, *a, **kw):
        seen.append({k: np.array(v) for k, v in grads.items()})
        return inner(ref_id, grads, *a, **kw)

    worker.update_gradients = update
    return seen


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("attn_impl,compute_dtype,wire,tol", [
    ("pallas", "float32", "f32", 1e-5),
    ("xla", "float32", "f32", 1e-5),
    ("pallas", "bfloat16", "bf16", 2e-2),
])
def test_train_steps_match_jax(attn_impl, compute_dtype, wire, tol,
                               jax_numpy_middleware):
    from persia_tpu.workloads import generator as jgen
    from persia_tpu_torch.weights import flax_params

    jctx = _jax_ctx(attn_impl, compute_dtype, wire)
    tctx = _port_ctx(attn_impl, compute_dtype, wire, jctx.state.params)
    jgrads, tgrads = _record_grads(jctx.worker), _record_grads(tctx.worker)
    batches = zip(
        jgen.seqrec_batches(3 * BS, BS, seed=7,
                            spec=jgen.SeqRecSpec(**SPEC)),
        tgen.seqrec_batches(3 * BS, BS, seed=7,
                            spec=tgen.SeqRecSpec(**SPEC)))
    ptol = 2e-5 if tol == 1e-5 else 3e-3
    try:
        with jctx, tctx:
            for step, (jb, tb) in enumerate(batches):
                jloss, jpred = jctx.train_step(jb)
                tloss, tpred = tctx.train_step(tb)
                assert tpred.shape == (BS, 1) and tpred.dtype == torch.float32
                np.testing.assert_allclose(float(tloss), float(jloss),
                                           rtol=tol, atol=tol)
                np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                                           rtol=tol, atol=tol)
                assert list(jgrads[step]) == list(tgrads[step])
                for name, g in tgrads[step].items():
                    assert g.dtype == np.float32
                    np.testing.assert_allclose(g, jgrads[step][name],
                                               rtol=tol, atol=tol)
                if step in (0, 2):  # after one step, and after three
                    want = _flat(jctx.state.params)
                    got = _flat(flax_params(tctx.model)[0])
                    assert set(got) == set(want)
                    for k in want:
                        np.testing.assert_allclose(got[k], want[k],
                                                   rtol=ptol, atol=ptol,
                                                   err_msg=k)
                    for jh, th in zip(jctx.worker.ps_clients,
                                      tctx.worker.ps_clients):
                        assert len(jh) == len(th) > 0
                        signs = np.array(sorted(th._shards[0]) + sorted(
                            th._shards[1]), np.uint64)
                        a, b = (h.get_entries(signs, 2 * DIM)
                                for h in (jh, th))
                        assert a[0].all() and b[0].all()
                        np.testing.assert_allclose(b[1], a[1], rtol=tol,
                                                   atol=tol)
        assert len(tgrads) == 3
        # the slot gradients are real: the raw slot's rows move
        assert np.abs(tgrads[0]["recent_items"]).max() > 0
    finally:
        jctx.worker.close()


def test_train_ctx_eval_ctx_and_auc():
    """A few port steps on the CPU, then eval_ctx predictions and the AUC
    helper against the JAX package's."""
    from persia_tpu.utils import roc_auc as jauc
    from persia_tpu_torch.ctx import current_ctx, eval_ctx
    from persia_tpu_torch.utils import roc_auc
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import SequenceTower
    from persia_tpu_torch.weights import init_params

    model = SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                          attn_impl="flash", device="cpu")
    schema = _seq_schema(tcfg)
    worker = TWorker(schema, [THolder(100_000, 4) for _ in range(2)])
    tctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                    Adagrad(lr=1e-2), schema, worker, seed=3, device="cpu")
    ref = init_params(SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                                    device="cpu"), 3)
    assert torch.equal(ref.Dense_0.weight, model.Dense_0.weight)
    spec = tgen.SeqRecSpec(**SPEC)
    with tctx:
        assert current_ctx() is tctx
        assert all(h.optimizer is not None for h in worker.ps_clients)
        for b in tgen.seqrec_batches(4 * BS, BS, seed=1, spec=spec):
            loss, _ = tctx.train_step(b)
            assert np.isfinite(float(loss))
    assert current_ctx() is None
    assert all(v > 0 for v in tctx.stage_seconds.values())
    preds, labels = [], []
    with eval_ctx(tctx) as ectx:
        for b in tgen.seqrec_batches(4 * BS, BS, seed=2, spec=spec,
                                     requires_grad=False):
            pred, lab = ectx.forward(b)
            preds.append(pred.numpy().reshape(-1))
            labels.append(lab[0].numpy().reshape(-1))
    preds, labels = np.concatenate(preds), np.concatenate(labels)
    assert np.isfinite(preds).all() and ((preds > 0) & (preds < 1)).all()
    assert roc_auc(labels, preds) == jauc(labels, preds)
    tied = np.round(preds, 1)  # the tie branch
    assert roc_auc(labels, tied) == jauc(labels, tied)


def test_train_ctx_refusals(monkeypatch):
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.models import SequenceTower

    model = SequenceTower(NUM_DENSE, SLOTS, device="cpu")
    opt = torch.optim.Adam(model.parameters())
    schema = _seq_schema(tcfg)
    worker = TWorker(schema, [THolder(1000, 2)])
    if not torch.cuda.is_available():
        # the default device is CUDA: without a card it raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TrainCtx(model, opt, None, schema, worker)
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                      mesh_dim_names=("data", "model"), _init_backend=False,
                      _rank=0)
    for kw in (dict(mesh=mesh, resume_from="snap"),
               dict(profiler=object())):
        with pytest.raises(NotImplementedError, match="queue A"):
            TrainCtx(model, opt, None, schema, worker, device="cpu", **kw)
    # the device cache over a mesh of two ranks (two processes), refused
    # on request before the context joins the mesh
    monkeypatch.setenv("PERSIA_MULTIHOST_CACHE", "refuse")
    with pytest.raises(NotImplementedError, match="single-controller"):
        TrainCtx(model, opt, None, schema, worker, device="cpu", mesh=mesh,
                 device_cache_capacity=8)
    # stored, as the JAX TrainCtx stores it
    assert TrainCtx(model, opt, None, schema, worker, device="cpu",
                    grad_update_interval=2).grad_update_interval == 2
    ctx = TrainCtx(model, opt, None, schema, worker, device="cpu")
    # a raw PersiaBatch or a DataLoader's LookedUpBatch; nothing else
    with pytest.raises(TypeError, match="PersiaBatch or a LookedUpBatch"):
        ctx.train_step(object())
    with pytest.raises(ValueError, match="wire"):
        tcfg.CommonConfig("fp8")
