"""The port's tooling half of ``persia_tpu/tracing.py`` against the JAX
package's, on the CPU.

- The step profiler: the window of ``tests/test_observability.py``'s
  ``test_step_profiler_window`` with ``torch.profiler`` faked, and
  ``profiler_from_env``; one real CPU window through ``TrainCtx``, whose
  Chrome trace holds exactly ``num_steps`` ``trainer/train_step`` ranges.
- Spans: ``test_worker_ps_cycle_shares_one_trace`` and
  ``test_pipeline_batch_carries_trace`` on the port, and one pipelined
  batch through each package (an in-process worker over two PS services
  whose calls split by internal shard, tracing on, a ``DataLoader``
  and a ``TrainCtx``): the same span names with the same parent name, as
  multisets, for a schema of one dim (the worker aggregates, then ships),
  of two (it ships while it aggregates) and of three (a replica's three
  lookups multiplex on one connection).
- The stall watchdog: ``tests/test_aux_subsystems.py``'s two cases, and a
  pipeline stalled in a lookup under ``PERSIA_DEADLOCK_DETECTION=1``
  dumps stacks that name the blocked lookup thread.
- The four knobs (``PERSIA_PROFILE_DIR`` / ``_START_STEP`` /
  ``_NUM_STEPS``, ``PERSIA_DEADLOCK_DETECTION``) unset, ``""``, ``" 1"``
  and a value of their own, at the sites that read them, against the JAX
  sites.

Tolerance: equality everywhere (names, counts, values).
"""

import collections
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from persia_tpu import tracing as jtracing
from persia_tpu_torch import knobs as tknobs
from persia_tpu_torch import tracing

DIM = 8
N_DENSE = 5


@pytest.fixture
def traced():
    """Tracing on (both packages) with clean collectors for one test,
    restored after: other tests assert the untraced wire."""
    was = (tracing.tracing_enabled(), jtracing.tracing_enabled())
    tracing.enable_tracing(True)
    jtracing.enable_tracing(True)
    tracing.default_collector().clear()
    jtracing.default_collector().clear()
    try:
        yield tracing.default_collector()
    finally:
        tracing.enable_tracing(was[0])
        jtracing.enable_tracing(was[1])


@pytest.fixture
def no_watchdog():
    """No watchdog of the port runs before or after the test."""
    def stop():
        wd = tracing._watchdog
        if wd is not None:
            wd.stop()
            wd.join(5)
            tracing._watchdog = None

    stop()
    try:
        yield
    finally:
        stop()


def _spans_named(collector, name):
    return [s for s in collector.recent() if s.name == name]


# --- the step profiler --------------------------------------------------------


def test_step_profiler_window(tmp_path, monkeypatch):
    """JAX's window on the port, ``torch.profiler.profile`` faked: the
    capture starts at step 3, stops at the boundary of step 5 and writes
    one trace under the logdir; ``close`` after that does nothing; CPU
    only unless bound to a CUDA device."""
    from torch import profiler as tp

    from persia_tpu_torch.tracing import StepProfiler, profiler_from_env

    calls = []

    class FakeProfile:
        def __init__(self, activities):
            calls.append(("new", tuple(activities)))

        def start(self):
            calls.append(("start",))

        def stop(self):
            calls.append(("stop",))

        def export_chrome_trace(self, path):
            calls.append(("export", path))

    monkeypatch.setattr(tp, "profile", FakeProfile)
    p = StepProfiler(str(tmp_path), start_step=3, num_steps=2)
    seen = []
    for i in range(1, 8):
        p.on_step(i)
        seen.append(p.active)
    assert seen == [False, False, True, True, False, False, False]
    path = str(tmp_path / f"trace_{os.getpid()}_step3.json")
    assert calls == [("new", (tp.ProfilerActivity.CPU,)), ("start",),
                     ("stop",), ("export", path)]
    assert p.trace_path == path
    p.close()  # once the window closed, nothing more
    assert len(calls) == 4
    cuda = StepProfiler(str(tmp_path), start_step=1, num_steps=1)
    cuda.bind_device(torch.device("cuda", 0))
    cuda.on_step(1)
    assert calls[-2][1] == (tp.ProfilerActivity.CPU,
                            tp.ProfilerActivity.CUDA)
    cuda.close()
    cuda.close()
    assert calls[-1][0] == "export" and calls.count(("stop",)) == 2

    monkeypatch.setenv("PERSIA_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("PERSIA_PROFILE_START_STEP", "1")
    monkeypatch.setenv("PERSIA_PROFILE_NUM_STEPS", "1")
    env_p = profiler_from_env()
    assert env_p is not None and env_p.start_step == 1
    monkeypatch.delenv("PERSIA_PROFILE_DIR")
    assert profiler_from_env() is None


def test_step_profiler_failure_never_stops_training(tmp_path, monkeypatch,
                                                    caplog):
    """A start that raises logs a warning and ends the window for good;
    the steps go on."""
    from torch import profiler as tp

    from persia_tpu_torch.tracing import StepProfiler

    def broken(**kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tp, "profile", broken)
    p = StepProfiler(str(tmp_path), start_step=1, num_steps=2)
    for i in range(1, 5):
        p.on_step(i)
        assert not p.active
    p.close()
    assert "start failed" in caplog.text and p.trace_path is None


def _dnn_ctx(pkg, dims, worker, **kw):
    """A TrainCtx of ``pkg`` over ``worker``: the DNN tower, f32, Adam and
    sparse Adagrad."""
    if pkg == "jax":
        import jax.numpy as jnp
        import optax

        from persia_tpu.ctx import TrainCtx
        from persia_tpu.embedding.optim import Adagrad
        from persia_tpu.models import DNN

        return TrainCtx(model=DNN(compute_dtype=jnp.float32),
                        dense_optimizer=optax.adam(1e-3),
                        embedding_optimizer=Adagrad(lr=0.01),
                        schema=worker.schema, worker=worker, **kw)
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DNN

    model = DNN(N_DENSE, dims, compute_dtype=torch.float32, device="cpu")
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                    Adagrad(lr=0.01), worker.schema, worker, seed=0,
                    device="cpu", **kw)


def _schema(cfg, dims):
    return cfg.EmbeddingSchema(slots_config={
        f"s{i}": cfg.SlotConfig(name=f"s{i}", dim=d)
        for i, d in enumerate(dims)})


def _batches(mod, n, bs, n_slots, seed, vocab=1 << 30):
    rng = np.random.default_rng(seed)
    return [mod.PersiaBatch(
        [mod.IDTypeFeatureWithSingleID(
            f"s{k}", rng.integers(0, vocab, size=bs, dtype=np.uint64))
         for k in range(n_slots)],
        non_id_type_features=[mod.NonIDTypeFeature(
            rng.normal(size=(bs, N_DENSE)).astype(np.float32))],
        labels=[mod.Label(rng.integers(0, 2, size=(bs, 1))
                          .astype(np.float32))],
        batch_id=i) for i in range(n)]


def test_real_cpu_window_holds_exactly_its_steps(tmp_path, monkeypatch):
    """Seven steps through a port TrainCtx whose profiler comes from the
    ``PERSIA_PROFILE_*`` knobs (start 3, 3 steps): the Chrome trace
    parses and holds exactly 3 ``trainer/train_step`` ranges, and the
    window closed before the context's exit."""
    from persia_tpu_torch import config as tcfg
    from persia_tpu_torch.data import batch as tb
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    monkeypatch.setenv("PERSIA_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setenv("PERSIA_PROFILE_START_STEP", "3")
    monkeypatch.setenv("PERSIA_PROFILE_NUM_STEPS", "3")
    dims = [DIM, DIM]
    worker = EmbeddingWorker(_schema(tcfg, dims),
                             [make_holder(10_000, 2, backend="arena")])
    ctx = _dnn_ctx("port", dims, worker)
    assert isinstance(ctx.profiler, tracing.StepProfiler)
    with ctx:
        for b in _batches(tb, 7, 32, 2, seed=1):
            ctx.train_step(b)
        assert ctx.profiler.trace_path is not None  # closed at step 6
    worker.close()
    with open(ctx.profiler.trace_path) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "trainer/train_step"
             and e.get("ph") == "X"]
    assert len(steps) == 3, [e.get("cat") for e in steps]


# --- spans --------------------------------------------------------------------


def _services(pkg, n, holder_fn):
    if pkg == "jax":
        from persia_tpu.service.ps_service import PsClient, PsService
    else:
        from persia_tpu_torch.service.ps_service import PsClient, PsService
    services = [PsService(holder_fn()) for _ in range(n)]
    for s in services:
        s.server.serve_background()
    return services, [PsClient(s.addr) for s in services]


def _stop(worker, clients, services):
    worker.close()
    for c in clients:
        c.client.close()
    for s in services:
        s.stop()


def test_worker_ps_cycle_shares_one_trace(traced):
    """One traced worker cycle (put, lookup, update) over two PS services:
    the worker's stage spans and both replicas' handler spans share the
    root's trace id with the JAX test's parentage."""
    from persia_tpu_torch.config import EmbeddingSchema, SlotConfig
    from persia_tpu_torch.data.batch import IDTypeFeatureWithSingleID
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    schema = EmbeddingSchema(slots_config={
        f"s{i}": SlotConfig(name=f"s{i}", dim=8 * (1 + i % 2))
        for i in range(6)})
    services, clients = _services("port", 2, lambda: make_holder(10_000, 4))
    worker = EmbeddingWorker(schema, clients)
    try:
        worker.configure_parameter_servers(
            "bounded_uniform", {"lower": -0.01, "upper": 0.01}, 1.0, 10.0)
        worker.register_optimizer({
            "type": "adagrad", "lr": 0.02, "initial_accumulator_value": 0.1,
            "g_square_momentum": 1.0, "vectorwise_shared": False})
        traced.clear()
        rng = np.random.default_rng(0)
        feats = [IDTypeFeatureWithSingleID(
            f"s{i}", rng.integers(0, 1 << 30, size=64, dtype=np.uint64))
            for i in range(6)]
        with tracing.span("trainer/step", root=True) as root:
            ref = worker.put_batch(feats)
            lk = worker.lookup(ref)
            worker.update_gradients(
                ref, {k: v.embeddings for k, v in lk.items()})
        spans = traced.recent()
        by_id = {s.span_id: s for s in spans}
        lookups = [s for s in spans if s.name == "rpc/lookup"]
        updates = [s for s in spans if s.name == "rpc/update_gradients"]
        assert lookups and updates
        for s in spans:
            assert s.trace_id == root.trace_id, s.name
        for s in lookups:
            parent = by_id[s.parent_id]
            assert parent.name in ("worker/ps_lookup", "worker/ps_lookup_mux")
            grand = by_id[parent.parent_id]
            assert grand.name == "worker/rpc"
            assert by_id[grand.parent_id].name == "trainer/step"
        for s in updates:
            assert by_id[s.parent_id].name == "worker/ps_update"
        assert {"worker/preprocess", "worker/rpc",
                "worker/postprocess"} <= {s.name for s in spans}
    finally:
        _stop(worker, clients, services)


def test_pipeline_batch_carries_trace(traced):
    """The forward engine opens one root a batch and hands its context to
    the LookedUpBatch; the queue-depth gauges return to zero."""
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.data.batch import (
        IDTypeFeatureWithSingleID,
        PersiaBatch,
    )
    from persia_tpu_torch.metrics import default_registry
    from persia_tpu_torch.pipeline import ForwardEngine
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    schema = EmbeddingSchema(slots_config=uniform_slots(["a"], dim=8))
    worker = EmbeddingWorker(schema, [make_holder(1000, 2)])
    worker.configure_parameter_servers(
        "bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0)
    worker.register_optimizer({
        "type": "adagrad", "lr": 0.02, "initial_accumulator_value": 0.1,
        "g_square_momentum": 1.0, "vectorwise_shared": False})

    class DummyCtx:
        pass

    ctx = DummyCtx()
    ctx.worker = worker
    engine = ForwardEngine(ctx, num_workers=2)
    rng = np.random.default_rng(0)
    batches = [PersiaBatch([IDTypeFeatureWithSingleID(
        "a", rng.integers(1, 1 << 20, size=16, dtype=np.uint64))],
        requires_grad=False) for _ in range(4)]
    try:
        out = list(engine.run(iter(batches)))
        assert len(out) == 4
        traces = {lb.trace for lb in out}
        assert None not in traces and len(traces) == 4
        roots = _spans_named(traced, "pipeline/lookup")
        assert {s.ctx for s in roots} == traces
        reg = default_registry()
        assert reg.gauge("pipeline_lookup_queue_depth").value == 0
        assert reg.gauge("pipeline_ready_queue_depth").value == 0
    finally:
        engine.shutdown()
        worker.close()


def _span_tree(pkg, dims, rows):
    """One pipelined batch through ``pkg``'s DataLoader and TrainCtx over
    an in-process worker and two PS services (arena holders): the
    multiset of (span name, parent span name)."""
    if pkg == "jax":
        from persia_tpu import config as cfg
        from persia_tpu.data import batch as bmod
        from persia_tpu.data.dataloader import DataLoader, IterableDataset
        from persia_tpu.ps.native import make_holder
        from persia_tpu.worker.worker import EmbeddingWorker
        mod = jtracing
    else:
        from persia_tpu_torch import config as cfg
        from persia_tpu_torch.data import batch as bmod
        from persia_tpu_torch.data.dataloader import (
            DataLoader,
            IterableDataset,
        )
        from persia_tpu_torch.ps.native import make_holder
        from persia_tpu_torch.worker.worker import EmbeddingWorker
        mod = tracing
    services, clients = _services(
        pkg, 2, lambda: make_holder(100_000, 4, backend="arena"))
    split = [s._dispatch.mode for s in services]
    worker = EmbeddingWorker(_schema(cfg, dims), clients)
    try:
        ctx = _dnn_ctx(pkg, dims, worker)
        with ctx:
            mod.default_collector().clear()
            loader = DataLoader(IterableDataset(
                _batches(bmod, 1, rows, len(dims), seed=7)), num_workers=2,
                embedding_staleness=1)
            for lb in loader:
                ctx.train_step(lb)
        spans = mod.default_collector().recent()
    finally:
        _stop(worker, clients, services)
    names = {s.span_id: s.name for s in spans}
    assert all(s.parent_id in names for s in spans if s.parent_id)
    # the arena computes under the interpreter lock: each call is the
    # holder's own in both packages (the JAX package's thread-pool split,
    # and its ps/shard_* spans, only on request)
    assert split == ["serial"] * 2
    return collections.Counter(
        (s.name, names.get(s.parent_id)) for s in spans)


@pytest.mark.parametrize("dims", [(DIM, DIM, DIM), (DIM, 2 * DIM, DIM),
                                  (DIM, 2 * DIM, 3 * DIM)],
                         ids=["one_dim", "two_dims", "three_dims"])
def test_pipelined_span_tree_matches_jax(traced, dims):
    """The same span names, each under the same parent name, as often in
    each package; the tree holds every tier: the pipeline's root, the
    trainer's step, the backward update, the worker's stages, the PS's
    handlers."""
    import jax

    mine = _span_tree("port", list(dims), 1024)
    ref = _span_tree("jax", list(dims), 1024)
    jax.clear_caches()
    assert mine == ref, (mine - ref, ref - mine)
    names = {n for n, _ in mine}
    assert {"pipeline/lookup", "trainer/train_step",
            "pipeline/backward_update", "worker/preprocess", "worker/rpc",
            "worker/postprocess", "worker/ps_update", "ps/lookup",
            "ps/update"} <= names
    assert ("trainer/train_step", "pipeline/lookup") in mine
    assert ("pipeline/backward_update", "trainer/train_step") in mine
    plane = ({"worker/aggregate", "worker/ship"} if len(set(dims)) == 1
             else {"worker/update_stream"})
    assert plane <= names
    # three groups a replica multiplex on one connection
    assert (("worker/ps_lookup_mux", "worker/rpc") in mine) == (
        len(set(dims)) == 3)


# --- the stall watchdog --------------------------------------------------------


def test_deadlock_watchdog_disabled_by_default(monkeypatch, no_watchdog):
    monkeypatch.delenv("PERSIA_DEADLOCK_DETECTION", raising=False)
    assert tracing.start_deadlock_detection() is None


def test_dump_all_stacks_smoke():
    buf = io.StringIO()
    tracing.dump_all_stacks(out=buf)
    assert "thread dump" in buf.getvalue()
    assert "MainThread" in buf.getvalue()


def test_stalled_pipeline_dumps_the_blocked_thread(monkeypatch, capsys,
                                                   no_watchdog):
    """A lookup that blocks: with work in flight and no heartbeat the
    watchdog (0.2 s) dumps every stack to stderr, naming the lookup
    thread and the call it blocks in; once the lookup returns the
    pipeline ends and one watchdog served the engine's own call too."""
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.data.batch import (
        IDTypeFeatureWithSingleID,
        PersiaBatch,
    )
    from persia_tpu_torch.pipeline import ForwardEngine
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    monkeypatch.setenv("PERSIA_DEADLOCK_DETECTION", "1")
    wd = tracing.start_deadlock_detection(0.2)
    assert wd is not None and wd.is_alive()
    schema = EmbeddingSchema(slots_config=uniform_slots(["a"], dim=8))
    worker = EmbeddingWorker(schema, [make_holder(1000, 2)])
    release = threading.Event()
    inner = worker.lookup_direct

    def wedged_lookup_direct(*a, **kw):
        release.wait(30)
        return inner(*a, **kw)

    worker.lookup_direct = wedged_lookup_direct

    class DummyCtx:
        pass

    ctx = DummyCtx()
    ctx.worker = worker
    engine = ForwardEngine(ctx, num_workers=1)
    assert tracing.start_deadlock_detection() is wd  # one a process
    batches = [PersiaBatch([IDTypeFeatureWithSingleID(
        "a", np.arange(1, 9, dtype=np.uint64))], requires_grad=False)]
    out = []
    runner = threading.Thread(target=lambda: out.extend(
        engine.run(iter(batches))))
    runner.start()
    try:
        deadline = time.monotonic() + 20
        while wd.dumps == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        text = capsys.readouterr().err
        assert wd.dumps >= 1
        assert "--- thread forward-worker-0 ---" in text
        assert "wedged_lookup_direct" in text
    finally:
        release.set()
        runner.join(20)
        engine.shutdown()
        worker.close()
    assert len(out) == 1


# --- the knobs ------------------------------------------------------------------

UNSET = object()
OWN = {
    "PERSIA_PROFILE_DIR": "profiles",
    "PERSIA_PROFILE_START_STEP": "7",
    "PERSIA_PROFILE_NUM_STEPS": "2",
    "PERSIA_DEADLOCK_DETECTION": "TRUE",
}


def _values(name):
    return [pytest.param(
        name, v, id=f"{name}-{'unset' if v is UNSET else repr(v)}")
        for v in (UNSET, "", " 1", OWN[name])]


@pytest.mark.parametrize("name", sorted(OWN))
def test_knob_is_registered_as_in_jax(name):
    from persia_tpu import knobs as jknobs

    mine, ref = tknobs.REGISTRY[name], jknobs.REGISTRY[name]
    assert (mine.type, mine.default) == (ref.type, ref.default)


@pytest.mark.parametrize(
    "name,value", _values("PERSIA_PROFILE_DIR")
    + _values("PERSIA_PROFILE_START_STEP")
    + _values("PERSIA_PROFILE_NUM_STEPS"))
def test_profile_knobs(name, value, monkeypatch, tmp_path):
    """``profiler_from_env`` (the site ``TrainCtx(profiler=None)`` reads):
    None or the same window in both packages."""
    monkeypatch.chdir(tmp_path)
    if name != "PERSIA_PROFILE_DIR":
        monkeypatch.setenv("PERSIA_PROFILE_DIR", str(tmp_path))
    if value is UNSET:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)

    def window(mod):
        try:
            p = mod.profiler_from_env()
        except Exception as e:  # noqa: BLE001 — the error is the result
            return type(e).__name__
        return None if p is None else (p.logdir, p.start_step, p.num_steps)

    assert window(tracing) == window(jtracing)


@pytest.mark.parametrize("name,value", _values("PERSIA_DEADLOCK_DETECTION"))
def test_deadlock_knob(name, value, monkeypatch, no_watchdog):
    """``start_deadlock_detection``: a watchdog thread in both packages,
    or None in both."""
    if value is UNSET:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    mine = tracing.start_deadlock_detection(3600)
    ref = jtracing.start_deadlock_detection(3600)  # sleeps past the run
    assert (mine is None) == (ref is None)
    if mine is not None:
        assert isinstance(mine, threading.Thread) and mine.is_alive()
