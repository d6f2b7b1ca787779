"""The port's training pipeline (``persia_tpu_torch.pipeline``,
``persia_tpu_torch.data.dataloader`` and ``TrainCtx`` on looked-up
batches), on the CPU, mirroring ``tests/test_pipeline.py`` with the
sequence tower of ``tests/test_torch_train.py`` at its small widths, over
arena PS holders (and the native store where a test says so).

- ``reproducible=True`` with staleness 1 equals the port's synchronous
  run bit for bit: the same lookups, steps and updates in the same order,
  on either holder, and the thread-stress run lands every update once.
- The same pipelined run against the JAX package's pipelined run, from
  transplanted weights on both packages' arena holders: f32 compute and
  f32 wire, 1e-5 on losses and predictions and 2e-5 on PS rows, the
  tolerances of ``test_train_steps_match_jax`` (the same math in another
  summation order, carried through Adam steps).
- Failure handling: permits come back after a failed lookup, a
  connection failure is retried with the batch still found, an update
  that keeps failing counts as lost and releases its permit, any other
  error reaches the trainer.

One ``gpu`` test holds 10 pipelined steps against 10 synchronous steps on
the card, on each holder (run there with ``python -m pytest tests/test_torch_pipeline.py
-m gpu --noconftest``).
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from persia_tpu_torch import config as tcfg
from persia_tpu_torch import pipeline as tpipe
from persia_tpu_torch.data.dataloader import (
    DataLoader,
    IterableDataset,
    ResumableDataset,
    StreamingDataset,
)
from persia_tpu_torch.pipeline import (
    BackwardEngine,
    ForwardEngine,
    LookedUpBatch,
    flush_backward_engines,
)
from persia_tpu_torch.ps.native import make_holder
from persia_tpu_torch.worker.worker import EmbeddingWorker as TWorker
from persia_tpu_torch.workloads import generator as tgen

DIM, HEADS, T_HIST, NUM_DENSE, BS = 16, 4, 16, 4, 16
SPEC = dict(item_vocab=2000, t_hist=T_HIST)
SLOTS = [(DIM, False), (DIM, False), (DIM, True), (DIM, False),
         (DIM, False)]
TOL, PTOL = 1e-5, 2e-5


def _seq_schema(cfg):
    slots = cfg.uniform_slots(["user_geo", "user_device", "target_item"],
                              dim=DIM)
    slots["recent_items"] = cfg.SlotConfig(
        name="recent_items", dim=DIM, embedding_summation=False,
        sample_fixed_size=T_HIST)
    slots["recent_clicks"] = cfg.SlotConfig(name="recent_clicks", dim=DIM,
                                            pooling="last4")
    return cfg.EmbeddingSchema(slots_config=slots)


def _batches(n_steps, seed=9, bs=BS, requires_grad=True):
    return tgen.seqrec_batches(n_steps * bs, bs, seed=seed,
                               spec=tgen.SeqRecSpec(**SPEC),
                               requires_grad=requires_grad)


def _port_ctx(device="cpu", seed=3, jparams=None, holders=None, lr=1e-3,
              backend="arena"):
    """An f32 seq tower (f32 wire) over two fresh PS shards (arena
    holders unless ``backend`` says otherwise), seeded or with
    transplanted flax weights."""
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import SequenceTower

    model = SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                          attn_impl="flash", device=device,
                          compute_dtype=torch.float32)
    if jparams is not None:
        from persia_tpu_torch.weights import load_flax_params, numpy_tree

        load_flax_params(model, numpy_tree(jparams))
        seed = None
    schema = _seq_schema(tcfg)
    worker = TWorker(schema, holders or [
        make_holder(100_000, 4, backend=backend) for _ in range(2)])
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=lr),
                    Adagrad(lr=1e-2), schema, worker, seed=seed,
                    embedding_config=EmbeddingConfig(
                        emb_initialization=(-0.05, 0.05)),
                    global_config=tcfg.GlobalConfig(tcfg.CommonConfig("f32")),
                    device=device)


def _run_sync(ctx, batches):
    out = []
    with ctx:
        for b in batches:
            loss, pred = ctx.train_step(b)
            out.append((float(loss), pred.cpu().numpy()))
    return out


def _run_pipelined(ctx, batches, **loader_kw):
    loader = DataLoader(IterableDataset(batches), **loader_kw)
    out = []
    with ctx:
        for lb in loader:
            assert isinstance(lb, LookedUpBatch) and lb.staged is not None
            loss, pred = ctx.train_step(lb)
            out.append((float(loss), pred.cpu().numpy()))
    assert ctx.worker.staleness == 0
    engine = loader._engine
    if loader_kw.get("embedding_staleness"):
        assert engine.staleness_sem._value == loader_kw["embedding_staleness"]
    assert engine.backward.lost_updates == 0
    engine.shutdown()
    return out


def _ps_bytes(ctx):
    """Each PS holder's PSD dump (the native store's through a file)."""
    import tempfile
    from pathlib import Path

    out = []
    for h in ctx.worker.ps_clients:
        if hasattr(h, "dump_bytes"):
            out.append(h.dump_bytes())
            continue
        with tempfile.TemporaryDirectory() as d:
            h.dump_file(str(Path(d) / "ps.psd"))
            out.append((Path(d) / "ps.psd").read_bytes())
    return out


@pytest.mark.parametrize("backend", ["arena", "native"])
def test_reproducible_pipeline_equals_sync_bit_for_bit(backend):
    sync_ctx, pipe_ctx = (_port_ctx(backend=backend),
                          _port_ctx(backend=backend))
    sync = _run_sync(sync_ctx, _batches(8))
    pipe = _run_pipelined(pipe_ctx, _batches(8), num_workers=4,
                          reproducible=True, embedding_staleness=1)
    assert len(sync) == len(pipe) == 8
    for (sl, sp), (pl, pp) in zip(sync, pipe):
        assert sl == pl
        np.testing.assert_array_equal(sp, pp)
    assert _ps_bytes(sync_ctx) == _ps_bytes(pipe_ctx)
    for name, p in sync_ctx.model.named_parameters():
        assert torch.equal(p, dict(pipe_ctx.model.named_parameters())[name])
    # the training thread booked no lookup and no host copy on this path
    assert pipe_ctx.stage_seconds["lookup"] == 0.0
    assert pipe_ctx.stage_seconds["h2d"] == 0.0
    assert pipe_ctx.stage_seconds["dense"] > 0


def test_pipelined_training_learns():
    """200 steps of batch 64 with 4 lookup workers and staleness 4: the
    loss falls and held-out AUC passes the seq_rec example's bar."""
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.utils import roc_auc

    ctx = _port_ctx(lr=1e-2)
    out = _run_pipelined(ctx, _batches(200, seed=2, bs=64), num_workers=4,
                         embedding_staleness=4, forward_buffer_size=8)
    losses = [loss for loss, _ in out]
    assert len(losses) == 200 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.05
    preds, labels = [], []
    with eval_ctx(ctx) as ectx:
        for b in _batches(8, seed=77, bs=128, requires_grad=False):
            pred, lab = ectx.forward(b)
            preds.append(pred.numpy().ravel())
            labels.append(lab[0].numpy().ravel())
    assert roc_auc(np.concatenate(labels), np.concatenate(preds)) > 0.62
    stats = ctx.worker.ps_clients[0].arena_stats()
    assert stats["lookup_rounds"] > 0 and stats["update_rounds"] > 0


def _jax_ctx():
    import jax.numpy as jnp
    import optax

    from persia_tpu import config as jcfg
    from persia_tpu.ctx import TrainCtx
    from persia_tpu.embedding import EmbeddingConfig
    from persia_tpu.embedding.optim import Adagrad
    from persia_tpu.models import SequenceTower
    from persia_tpu.parallel.train import TrainState
    from persia_tpu.ps.arena import ArenaEmbeddingHolder
    from persia_tpu.serving import build_state_template
    from persia_tpu.worker.worker import EmbeddingWorker

    schema = _seq_schema(jcfg)
    model = SequenceTower(num_heads=HEADS, attn_impl="pallas",
                          compute_dtype=jnp.float32)
    params = build_state_template(model, schema, NUM_DENSE, seed=5).params
    adam = optax.adam(1e-3)
    gc = jcfg.GlobalConfig()
    gc.common.embedding_wire_dtype = "f32"
    worker = EmbeddingWorker(schema, [ArenaEmbeddingHolder(100_000, 4)
                                      for _ in range(2)])
    ctx = TrainCtx(model=model, dense_optimizer=adam,
                   embedding_optimizer=Adagrad(lr=1e-2), schema=schema,
                   worker=worker, global_config=gc,
                   embedding_config=EmbeddingConfig(
                       emb_initialization=(-0.05, 0.05)))
    ctx.state = TrainState(params=params, batch_stats={},
                           opt_state=adam.init(params),
                           step=jnp.zeros((), jnp.int32))
    return ctx


def _psd_rows(blob):
    import io

    from persia_tpu_torch.ps.store import iter_psd_records, read_psd_header

    r = io.BytesIO(blob)
    version, count = read_psd_header(r)
    return {s: (d, v) for s, d, v in iter_psd_records(r.read, version,
                                                       count)}


def test_pipelined_run_matches_jax_pipelined_run(monkeypatch):
    from persia_tpu.data.dataloader import DataLoader as JLoader
    from persia_tpu.data.dataloader import IterableDataset as JDataset
    from persia_tpu.worker import middleware as jmw
    from persia_tpu.workloads import generator as jgen

    monkeypatch.setattr(jmw, "_mw_native", lambda: None)
    jctx = _jax_ctx()
    tctx = _port_ctx(jparams=jctx.state.params)
    jloader = JLoader(JDataset(jgen.seqrec_batches(
        4 * BS, BS, seed=7, spec=jgen.SeqRecSpec(**SPEC))), num_workers=4,
        reproducible=True, embedding_staleness=1)
    jout = []
    try:
        with jctx:
            for lb in jloader:
                loss, pred = jctx.train_step(lb)
                jout.append((float(loss), np.asarray(pred)))
        assert jctx.worker.staleness == 0
        tout = _run_pipelined(tctx, _batches(4, seed=7), num_workers=4,
                              reproducible=True, embedding_staleness=1)
        assert len(jout) == len(tout) == 4
        for (jl, jp), (tl, tp) in zip(jout, tout):
            np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
        for jh, th in zip(jctx.worker.ps_clients, tctx.worker.ps_clients):
            want, got = _psd_rows(jh.dump_bytes()), _psd_rows(th.dump_bytes())
            assert set(want) == set(got) and len(got) > 0
            for s, (d, v) in want.items():
                assert got[s][0] == d
                np.testing.assert_allclose(got[s][1], v, rtol=PTOL,
                                           atol=PTOL)
    finally:
        jctx.worker.close()


def test_forward_engine_preserves_order_and_eval_batches():
    ctx = _port_ctx()
    with ctx:
        engine = ForwardEngine(ctx, num_workers=4)
        out = list(engine.run(_batches(8, requires_grad=False)))
        engine.shutdown()
    assert [lb.batch.batch_id for lb in out] == list(range(8))
    assert all(lb.ref_id is None and lb.staged is None for lb in out)
    assert ctx.worker.staleness == 0


def test_backward_engine_propagates_errors_and_flush():
    ctx = _port_ctx()
    with ctx:
        engine = ForwardEngine(ctx, num_workers=1)
        engine.backward.submit(424242, {})  # unknown ref_id
        with pytest.raises(KeyError):
            flush_backward_engines(ctx.worker, timeout=10)
        engine.shutdown()


def test_dataset_buffer_and_producer_error():
    class Boom:
        def __iter__(self):
            yield from _batches(2)
            raise RuntimeError("boom")

    ds = IterableDataset(Boom(), buffer_size=2)
    with pytest.raises(RuntimeError, match="boom"):
        list(ds)


def test_streaming_dataset_reads_its_receiver():
    class Receiver:
        def __init__(self, items):
            self.items = list(items)

        def get(self):
            return self.items.pop(0) if self.items else None

    with pytest.raises(RuntimeError, match="receiver"):
        list(StreamingDataset())
    ds = StreamingDataset()
    ds.bind_receiver(Receiver(_batches(3)))
    assert [b.batch_id for b in ds] == [0, 1, 2]


class _Flaky:
    """A PS holder that raises ``ConnectionError`` on the first ``fail``
    training lookups and gradient updates, before touching anything."""

    def __init__(self, inner, fail=1):
        self.inner = inner
        self.lookup_fails = self.update_fails = fail

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def lookup(self, signs, dim, training):
        if training and self.lookup_fails:
            self.lookup_fails -= 1
            raise ConnectionError("PS restarting")
        return self.inner.lookup(signs, dim, training)

    def update_gradients(self, signs, grads, dim):
        if self.update_fails:
            self.update_fails -= 1
            raise ConnectionError("PS restarting")
        return self.inner.update_gradients(signs, grads, dim)


@pytest.fixture
def no_pause(monkeypatch):
    """The retry loop's pauses, skipped."""
    monkeypatch.setattr(tpipe, "time", types.SimpleNamespace(
        sleep=lambda s: None, monotonic=time.monotonic))


@pytest.mark.parametrize("failing", [(0,), (1,), (0, 1)])
def test_connection_failures_are_retried_and_the_batch_found(no_pause,
                                                             failing):
    """A lookup and an update that fail once on the ``failing`` shards are
    retried; the worker put each batch back, so the run equals the
    synchronous one. With one shard failing, the other's groups have
    landed when the failure comes back (the worker calls the shards at
    once): the retry ships only the groups that had not landed, so none
    applies twice (the JAX worker re-applies them, ROADMAP.md section C)."""
    holders = [_Flaky(make_holder(100_000, 4, backend="arena"),
                      fail=int(r in failing)) for r in range(2)]
    sync_ctx, pipe_ctx = _port_ctx(), _port_ctx(holders=holders)
    sync = _run_sync(sync_ctx, _batches(4))
    pipe = _run_pipelined(pipe_ctx, _batches(4), num_workers=2,
                          reproducible=True, embedding_staleness=1)
    assert all(h.lookup_fails == h.update_fails == 0 for h in holders)
    assert [loss for loss, _ in sync] == [loss for loss, _ in pipe]
    assert _ps_bytes(sync_ctx) == _ps_bytes(pipe_ctx)


def test_permits_released_after_a_lookup_worker_fails(no_pause):
    """A lookup that keeps failing ends the iteration with its error, and
    every permit (the failed batch's, queued and looked-up batches') comes
    back; the worker holds the failed batch for a retry."""
    holders = [_Flaky(make_holder(100_000, 4, backend="arena"), fail=10**6)
               for _ in range(2)]
    ctx = _port_ctx(holders=holders)
    with ctx:
        engine = ForwardEngine(ctx, num_workers=2, embedding_staleness=3)
        with pytest.raises(ConnectionError):
            list(engine.run(_batches(6)))
        deadline = time.monotonic() + 5
        while engine.staleness_sem._value < 3 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert engine.staleness_sem._value == 3
        engine.shutdown()
    assert ctx.worker.staleness == 0
    assert len(ctx.worker._forward_id_buffer) >= 1


class _DeadWorker:
    def __init__(self, error):
        self.error = error
        self.updates = 0

    def update_gradients(self, ref, grads, loss_scale=1.0):
        self.updates += 1
        raise self.error


def test_permanently_failed_update_is_a_lost_update(no_pause):
    w = _DeadWorker(ConnectionResetError("PS gone"))
    sem = threading.Semaphore(2)
    sem.acquire()  # the permit the lookup took for this batch
    engine = BackwardEngine(w, num_workers=1, staleness_sem=sem)
    engine.submit(1, {"a": np.zeros((4, DIM), np.float32)})
    engine.flush(timeout=30)  # completes: the loss is counted, not raised
    assert (engine.lost_updates, w.updates, sem._value) == (1, 5, 2)
    sem.acquire()  # the engine is not poisoned
    engine.submit(2, {"a": np.zeros((4, DIM), np.float32)})
    engine.flush(timeout=30)
    assert (engine.lost_updates, sem._value) == (2, 2)
    engine.shutdown()


def test_fatal_backward_error_propagates_and_frees_permits():
    w = _DeadWorker(ValueError("boom"))
    sem = threading.Semaphore(2)
    sem.acquire()
    engine = BackwardEngine(w, num_workers=1, staleness_sem=sem)
    engine.submit(1, {"a": np.zeros((1, DIM), np.float32)})
    with pytest.raises(ValueError, match="boom"):
        engine.flush(timeout=30)
    assert (engine.lost_updates, w.updates, sem._value) == (0, 1, 2)
    sem.acquire()
    with pytest.raises(ValueError, match="boom"):
        engine.submit(2, {"a": np.zeros((1, DIM), np.float32)})
    assert sem._value == 2  # the rejected batch's permit came back too
    engine.shutdown()


def test_worker_staleness_and_restores():
    """``staleness`` counts training lookups awaiting gradients; a failed
    lookup or update puts the batch back for a retry by ref_id."""
    holders = [_Flaky(make_holder(100_000, 4, backend="arena")),
               make_holder(100_000, 4, backend="arena")]
    ctx = _port_ctx(holders=holders)
    w = ctx.worker
    with ctx:
        b = next(iter(_batches(1)))
        ref = w.put_batch(b.id_type_features)
        with pytest.raises(ConnectionError):
            w.lookup(ref, training=True)
        assert w.staleness == 0
        lookup = w.lookup(ref, training=True)
        assert w.staleness == 1
        grads = {n: np.ones_like(r.embeddings) for n, r in lookup.items()}
        with pytest.raises(KeyError, match="missing gradients"):
            w.update_gradients(ref, {})
        assert w.staleness == 1
        with pytest.raises(ConnectionError):
            w.update_gradients(ref, grads)
        assert w.staleness == 1
        w.update_gradients(ref, grads)
        assert w.staleness == 0
        with pytest.raises(KeyError):
            w.update_gradients(ref, grads)


def test_resumable_dataset_matches_jax():
    """Cursors, resumption and process shards equal the JAX package's on
    the same factory."""
    from persia_tpu.data.dataloader import ResumableDataset as JResumable

    def factory(seed):
        return _batches(9, seed=seed)

    def ids(ds):
        return [b.to_bytes() for b in ds]

    full = ids(ResumableDataset(factory, seed=4))
    assert ids(JResumable(factory, seed=4)) == full
    shards = [ids(ResumableDataset(factory, seed=4, process_index=p,
                                   process_count=3)) for p in range(3)]
    assert sorted(sum(shards, [])) == sorted(full)
    assert shards[1] == full[1::3]
    for kw in ({}, dict(process_index=1, process_count=3)):
        t, j = ResumableDataset(factory, seed=4, **kw), JResumable(
            factory, seed=4, **kw)
        assert ids(t) == ids(j)
        assert t.cursor() == j.cursor() and t.cursor(trained=1) == \
            j.cursor(trained=1)
        cur = t.cursor(trained=1)
        resumed = ResumableDataset.from_cursor(factory, cur)
        assert ids(resumed) == ids(JResumable.from_cursor(factory, cur))
        assert resumed.cursor() == JResumable.from_cursor(
            factory, cur).cursor(trained=resumed.produced)
    with pytest.raises(ValueError, match="shard"):
        ResumableDataset.from_cursor(factory, {
            "seed": 4, "consumed": 1, "process_index": 1,
            "process_count": 3}, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="outside"):
        ResumableDataset(factory, process_index=2, process_count=2)


def test_dataloader_needs_a_context():
    with pytest.raises(RuntimeError, match="active"):
        list(DataLoader(IterableDataset(_batches(1))))


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["arena", "native"])
def test_pipelined_steps_match_sync_steps_on_the_card(backend):
    """10 pipelined steps (reproducible, staleness 1, prefetch workers
    staging on their own threads) against 10 synchronous steps from the
    same weights, on the card: the copies and kernels the training thread
    issues are ordered after the prefetch threads' copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    sync_ctx, pipe_ctx = (_port_ctx("cuda", backend=backend),
                          _port_ctx("cuda", backend=backend))
    sync = _run_sync(sync_ctx, _batches(10))
    pipe = _run_pipelined(pipe_ctx, _batches(10), num_workers=4,
                          reproducible=True, embedding_staleness=1)
    for (sl, sp), (pl, pp) in zip(sync, pipe):
        assert sl == pl
        np.testing.assert_array_equal(sp, pp)
    assert _ps_bytes(sync_ctx) == _ps_bytes(pipe_ctx)


@pytest.mark.parametrize("backend", ["arena", "native"])
def test_engines_under_thread_stress(backend):
    """12 lookup workers (more than this host's cores) and staleness 5,
    with a 10 µs interpreter switch interval, over one worker and two PS
    shards of each holder: every batch's update lands exactly once. With SGD
    and all-ones gradients each row's final value depends only on how
    often its sign was updated, so the rows must equal a synchronous
    run's (to f32 rounding of the reordered subtractions; one lost or
    doubled update moves a row by 1e-3)."""
    import sys
    from types import SimpleNamespace

    def make_worker():
        w = TWorker(_seq_schema(tcfg), [
            make_holder(100_000, 4, backend=backend) for _ in range(2)])
        w.configure_parameter_servers(
            "bounded_uniform", {"lower": -0.05, "upper": 0.05}, 1.0, 10.0)
        w.register_optimizer({"type": "sgd", "lr": 1e-3})
        return w

    def ones(lookup):
        return {n: np.ones_like(r.embeddings) for n, r in lookup.items()}

    sync_w = make_worker()
    for b in _batches(60, seed=4, bs=8):
        ref, lookup = sync_w.lookup_direct_training(b.id_type_features)
        sync_w.update_gradients(ref, ones(lookup))
    w = make_worker()
    updates = []
    inner = w.update_gradients

    def counted(ref_id, grads, loss_scale=1.0):
        inner(ref_id, grads, loss_scale)
        updates.append(ref_id)

    w.update_gradients = counted
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        engine = ForwardEngine(SimpleNamespace(worker=w), num_workers=12,
                               embedding_staleness=5)
        for lb in engine.run(_batches(60, seed=4, bs=8)):
            engine.backward.submit(lb.ref_id, ones(lb.lookup))
        engine.flush(timeout=60)
    finally:
        sys.setswitchinterval(old)
        engine.shutdown()
    assert sorted(updates) == list(range(60))
    assert (w.staleness, engine.staleness_sem._value) == (0, 5)
    assert not w._forward_id_buffer and not w._post_forward_buffer
    for a, b in zip(_ps_bytes(types.SimpleNamespace(worker=sync_w)),
                    _ps_bytes(types.SimpleNamespace(worker=w))):
        want, got = _psd_rows(a), _psd_rows(b)
        assert set(want) == set(got)
        for s, (d, v) in want.items():
            np.testing.assert_allclose(got[s][1], v, rtol=0, atol=1e-5)
