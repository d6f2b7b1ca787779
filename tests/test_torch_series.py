"""The port's registry series against the JAX package's, on the CPU: the
PS service's, the worker's, the pipeline engines' and the device-cache
engine's, after the same seeded traffic through both packages.

A component's series are the registry entries it adds. Between the
packages they must match in name, label keys, kind and help text; label
values match too, but for the per-instance ones (a PS's ``server`` port,
the ``worker`` and ``engine`` sequence numbers). Counters, gauges and
histogram counts are equal where the traffic fixes them (tolerance 0:
they count rows, requests and calls); the histograms' sums are times.

Also ``DistinctIdMonitor`` against JAX's (``tests/test_aux_subsystems.py:33``),
the backward engine's staleness histogram (``tests/test_telemetry.py:454``)
and the device-cache engine's counters under two threads.
"""

import threading

import numpy as np
import pytest
import torch

from persia_tpu_torch.metrics import default_registry

DIM = 8
PER_INSTANCE = ("server", "worker", "engine")


def _keys(reg) -> set:
    with reg._lock:
        return set(reg._metrics)


def _masked(key) -> tuple:
    """(name, labels with the per-instance values masked)."""
    name, labels = key
    return name, tuple((k, "*" if k in PER_INSTANCE else v)
                       for k, v in labels)


def _new_series(reg, before: set) -> dict:
    """{(name, labels with the per-instance values masked): (kind, help,
    metric)} of the entries added since ``before``."""
    out = {}
    with reg._lock:
        for key, metric in reg._metrics.items():
            if key in before:
                continue
            out[_masked(key)] = (reg._kinds[key[0]], reg._help.get(key[0]),
                                 metric)
    return out


def _value(kind, metric):
    if kind == "histogram":
        return metric.count
    return metric.value


def _assert_same_series(mine: dict, ref: dict, values=None):
    """Same names, labels, kinds and help; equal values for the names in
    ``values`` (all when None)."""
    assert set(mine) == set(ref), set(mine) ^ set(ref)
    for key in mine:
        kind, help_text, m = mine[key]
        jkind, jhelp, jm = ref[key]
        assert (kind, help_text) == (jkind, jhelp), key
        if values is None or key[0] in values:
            assert _value(kind, m) == _value(jkind, jm), key


# --- the PS ----------------------------------------------------------------


def _ps_traffic(pkg, tmp_path):
    """A PS over an arena holder with the spill tier armed (every series
    family registers), seeded lookups and updates through the package's
    client, then a refresh. Returns the service's new series and its
    health doc."""
    if pkg == "jax":
        from persia_tpu.metrics import default_registry as reg_fn
        from persia_tpu.ps.native import make_holder
        from persia_tpu.service.ps_service import PsClient, PsService
    else:
        reg_fn = default_registry
        from persia_tpu_torch.ps.native import make_holder
        from persia_tpu_torch.service.ps_service import PsClient, PsService
    reg = reg_fn()
    before = _keys(reg)
    holder = make_holder(64, 2, backend="arena",
                         spill_dir=str(tmp_path / pkg))
    svc = PsService(holder, port=0)
    svc.server.serve_background()
    try:
        client = PsClient(svc.addr, circuit_breaker=False)
        client.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1},
                         admit_probability=1.0, weight_bound=10.0)
        client.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
        rng = np.random.default_rng(6)
        rows = 0
        for _ in range(5):
            signs = np.unique(rng.integers(0, 400, 96, dtype=np.uint64))
            out = client.lookup(signs, DIM, True)
            rows += len(signs)
            client.update_gradients(signs, np.ones_like(out), DIM)
        client.lookup(signs, DIM, False)
        rows += len(signs)
        svc._refresh_mem_gauges()
        health = client.health()
        series = _new_series(reg, before)
    finally:
        svc.stop()
    return series, health, rows


def test_ps_series_equal_jax(tmp_path):
    from persia_tpu.metrics import default_registry as jax_registry

    # the registries are the process's: a series that an earlier test in
    # this process registered in one package alone is not new there, so
    # it is held to exist in that registry and left out of the comparison
    had = {"port": {_masked(k) for k in _keys(default_registry())},
           "jax": {_masked(k) for k in _keys(jax_registry())}}
    mine, health, rows = _ps_traffic("port", tmp_path)
    ref, jhealth, _ = _ps_traffic("jax", tmp_path)
    for key in set(mine) - set(ref):
        if key in had["jax"]:
            del mine[key]
    for key in set(ref) - set(mine):
        if key in had["port"]:
            del ref[key]
    # served_rpcs counts this client's calls up to the health read
    _assert_same_series(mine, ref)
    names = {k[0] for k in mine}
    for n in ("ps_lookup_rows_total", "ps_served_requests_total",
              "ps_lookup_row_rate", "ps_arena_slab_bytes",
              "ps_spill_demotions_total", "ps_spill_fault_ins_total",
              "ps_simd_path", "ps_dispatch_mode", "ps_frozen_slot_age_sec",
              "ps_reshard_lease_expired_total",
              "ps_gradient_staleness_steps", "ps_resident_bytes"):
        assert n in names, n
    lookup_rows = [m for (n, _), (_k, _h, m) in mine.items()
                   if n == "ps_lookup_rows_total"][0]
    assert lookup_rows.value == rows
    spilled = [m for (n, _), (_k, _h, m) in mine.items()
               if n == "ps_spill_demotions_total"][0]
    assert spilled.value > 0
    assert health["routing_epoch"] == jhealth["routing_epoch"] == 0
    assert "reshard" not in health


def test_ps_served_requests_mirror_the_health_doc():
    """``ps_served_requests_total`` is the health doc's ``served_rpcs``
    at the refresh, and ``ps_frozen_slot_age_sec`` grows while a
    migration holds its slots frozen, then reads 0."""
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service.ps_service import PsClient, PsService

    reg = default_registry()
    before = _keys(reg)
    svc = PsService(EmbeddingHolder(capacity=10_000), port=0)
    svc.server.serve_background()
    try:
        client = PsClient(svc.addr, circuit_breaker=False)
        client.configure("bounded_uniform", {"lower": 0.0, "upper": 0.0})
        client.register_optimizer({"type": "sgd", "lr": 1.0, "wd": 0.0})
        for _ in range(3):
            client.lookup(np.arange(10, dtype=np.uint64), DIM, True)
        series = {k[0]: v[2] for k, v in _new_series(reg, before).items()}
        svc._refresh_mem_gauges()
        served = svc.server.health()["served_rpcs"]
        assert series["ps_served_requests_total"].value == served > 0
        t = RoutingTable.uniform(1, 4)
        client.reshard_begin([0, 1, 2, 3], t.num_slots, epoch=2)
        client.reshard_freeze(epoch=2)
        import time

        time.sleep(0.05)
        svc._refresh_mem_gauges()
        assert series["ps_frozen_slot_age_sec"].value > 0
        assert client.health()["reshard"]["frozen"] is True
        client.reshard_finish()
        svc._refresh_mem_gauges()
        assert series["ps_frozen_slot_age_sec"].value == 0
    finally:
        svc.stop()


# --- the worker --------------------------------------------------------------


def _worker_traffic(pkg):
    if pkg == "jax":
        from persia_tpu.config import EmbeddingSchema, uniform_slots
        from persia_tpu.data.batch import IDTypeFeature
        from persia_tpu.metrics import default_registry as reg_fn
        from persia_tpu.ps.store import EmbeddingHolder
        from persia_tpu.worker.worker import EmbeddingWorker
    else:
        reg_fn = default_registry
        from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
        from persia_tpu_torch.data.batch import IDTypeFeature
        from persia_tpu_torch.ps.store import EmbeddingHolder
        from persia_tpu_torch.worker.worker import EmbeddingWorker
    reg = reg_fn()
    before = _keys(reg)
    holders = [EmbeddingHolder(capacity=10_000) for _ in range(2)]
    for h in holders:
        h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1},
                    admit_probability=1.0, weight_bound=10.0)
        h.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
    schema = EmbeddingSchema(slots_config=uniform_slots(
        ["a", "b"], dim=DIM))
    w = EmbeddingWorker(schema, holders, enable_monitor=True)
    rng = np.random.default_rng(8)
    snap = w.stage_snapshot()
    refs = []
    for _ in range(4):
        feats = [IDTypeFeature(n, [rng.integers(0, 300, 3, dtype=np.uint64)
                                   for _ in range(16)]) for n in "ab"]
        ref, out = w.lookup_direct_training(feats)
        refs.append((ref, out))
    depth = (w.staleness, len(w._post_forward_buffer))
    for ref, out in refs[:3]:
        w.update_gradients(ref, {k: np.ones_like(v.embeddings)
                                 for k, v in out.items()})
    w.put_batch([IDTypeFeature(n, [np.array([1], np.uint64)])
                 for n in "ab"])
    breakdown = w.stage_breakdown(snap, w.stage_snapshot())
    series = _new_series(reg, before)
    est = w.monitor.estimate("a")
    w.close()
    return series, breakdown, depth, est


def test_worker_series_equal_jax():
    mine, breakdown, depth, est = _worker_traffic("port")
    ref, jbreakdown, jdepth, jest = _worker_traffic("jax")
    # the gauges' and histograms' values are fixed by the traffic; the
    # estimated_distinct_id gauge is shared by name across workers
    _assert_same_series(mine, ref)
    assert depth == jdepth == (4, 4)
    assert {k: v["count"] for k, v in breakdown.items()} \
        == {k: v["count"] for k, v in jbreakdown.items()} \
        == {"preprocess": 4, "rpc": 4, "postprocess": 4, "aggregate": 3,
            "ship": 3}
    gauges = {k[0]: v[2].value for k, v in mine.items()
              if v[0] == "gauge" and k[0].startswith("worker_")}
    assert gauges == {"worker_forward_buffer_depth": 1,
                      "worker_post_forward_buffer_depth": 1,
                      "worker_staleness": 1}
    assert est == jest


def test_distinct_id_monitor_gauge():
    from persia_tpu.worker.monitor import DistinctIdMonitor as JMonitor
    from persia_tpu_torch.worker.monitor import DistinctIdMonitor

    mon, jmon = DistinctIdMonitor(), JMonitor()
    for m in (mon, jmon):
        m.observe("clicks", np.arange(1000, dtype=np.uint64))
        m.observe("clicks", np.arange(500, 1500, dtype=np.uint64))
    est = mon.estimate("clicks")
    assert abs(est - 1500) / 1500 < 0.1
    assert est == jmon.estimate("clicks")
    assert mon.estimate("absent") == 0.0
    assert "estimated_distinct_id" in default_registry().render()


# --- the pipeline ------------------------------------------------------------


class _FakeWorker:
    def update_gradients(self, ref_id, grads, loss_scale=1.0):
        pass


def test_pipeline_staleness_histogram():
    """``tests/test_telemetry.py:454`` on the port's engine: four
    submissions, four observations; nothing pending after the flush."""
    from persia_tpu_torch.pipeline import BackwardEngine

    reg = default_registry()
    h = reg.histogram("pipeline_gradient_staleness_steps")
    t0 = h.count
    eng = BackwardEngine(_FakeWorker(), num_workers=1)
    try:
        for i in range(4):
            eng.submit(i, {"slot": np.zeros((2, DIM), np.float32)})
        eng.flush(timeout=30)
    finally:
        eng.shutdown()
    assert h.count - t0 == 4
    assert reg.gauge("pipeline_backward_pending_updates").value == 0


def _pipeline_traffic(pkg):
    """The forward and backward engines over an in-process worker: 6
    training batches at staleness 2, each gradient submitted as its
    batch arrives."""
    if pkg == "jax":
        from persia_tpu.config import EmbeddingSchema, uniform_slots
        from persia_tpu.data.batch import IDTypeFeature, PersiaBatch
        from persia_tpu.metrics import default_registry as reg_fn
        from persia_tpu.pipeline import ForwardEngine
        from persia_tpu.ps.store import EmbeddingHolder
        from persia_tpu.worker.worker import EmbeddingWorker
    else:
        reg_fn = default_registry
        from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
        from persia_tpu_torch.data.batch import IDTypeFeature, PersiaBatch
        from persia_tpu_torch.pipeline import ForwardEngine
        from persia_tpu_torch.ps.store import EmbeddingHolder
        from persia_tpu_torch.worker.worker import EmbeddingWorker

    reg = reg_fn()
    h = EmbeddingHolder(capacity=10_000)
    h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1})
    h.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
    worker = EmbeddingWorker(EmbeddingSchema(
        slots_config=uniform_slots(["a"], dim=DIM)), [h])

    class Ctx:
        pass

    ctx = Ctx()
    ctx.worker = worker
    stale = reg.histogram("pipeline_gradient_staleness_steps")
    lost = reg.counter("pipeline_lost_updates_total")
    t0, l0 = stale.count, lost.value
    rng = np.random.default_rng(2)
    batches = [PersiaBatch([IDTypeFeature(
        "a", [rng.integers(0, 50, 2, dtype=np.uint64) for _ in range(8)])],
        requires_grad=True) for _ in range(6)]
    eng = ForwardEngine(ctx, num_workers=2, embedding_staleness=2)
    steps = 0
    for lb in eng.run(iter(batches)):
        eng.backward.submit(lb.ref_id, {
            "a": np.ones_like(lb.lookup["a"].embeddings)})
        steps += 1
    eng.flush(timeout=30)
    at_rest = {n: reg.gauge(n).value for n in (
        "pipeline_staleness_permits_in_use", "pipeline_lookup_queue_depth",
        "pipeline_ready_queue_depth", "pipeline_backward_pending_updates")}
    out = (steps, stale.count - t0, lost.value - l0, at_rest,
           eng.staleness_sem._value)
    eng.shutdown()
    worker.close()
    return out


def test_pipeline_series_at_rest_equal_jax():
    """After the engines drain: every permit back (in use 0), both queues
    empty, no update pending or lost, one staleness observation a step —
    as JAX's engines end."""
    mine = _pipeline_traffic("port")
    assert mine == _pipeline_traffic("jax")
    assert mine[:3] == (6, 6, 0) and mine[4] == 2
    assert set(mine[3].values()) == {0}


# --- the device cache ---------------------------------------------------------


def test_device_cache_series_equal_jax():
    """Both engines over equally seeded holders, the same batches and
    evictions: the ``device_cache_*`` series match, and the counters
    equal each other, the mapper's and ``stats()``."""
    from persia_tpu import config as jcfg
    from persia_tpu.data import batch as jbatch
    from persia_tpu.metrics import default_registry as jreg_fn
    from persia_tpu.parallel.cached_engine import DeviceCacheEngine as JEng
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker
    from persia_tpu_torch import config as tcfg
    from persia_tpu_torch.data import batch as tbatch
    from persia_tpu_torch.parallel.cached_engine import DeviceCacheEngine
    from persia_tpu_torch.worker.worker import EmbeddingWorker
    from test_torch_device_cache import (
        DIM as DC_DIM,
        NUM_SLOTS,
        _holders,
        _schema,
        _zipf_batches,
    )

    reg, jreg = default_registry(), jreg_fn()
    before, jbefore = _keys(reg), _keys(jreg)
    jw = JWorker(_schema(jcfg), _holders("jax"))
    tw = EmbeddingWorker(_schema(tcfg), _holders("port"))
    je = JEng(jw, 200, NUM_SLOTS, DC_DIM, 0.01)
    te = DeviceCacheEngine(tw, 200, NUM_SLOTS, DC_DIM, 0.01, device="cpu")
    rng = np.random.default_rng(9)
    for jb, tb in zip(_zipf_batches(jbatch, 8, 64),
                      _zipf_batches(tbatch, 8, 64)):
        je.prepare(jb.id_type_features)
        out = te.prepare(tb.id_type_features)
        evicted, mask = out[-4], out[-3]
        ev = rng.uniform(-0.1, 0.1, (len(mask), 2, DC_DIM)).astype(
            np.float32)
        je.finish(evicted, mask, ev[:, 0], ev[:, 1])
        te.finish(evicted, mask, torch.from_numpy(ev[:, 0]),
                  torch.from_numpy(ev[:, 1]))
        # each batch's write-backs land before the next batch's misses,
        # so no miss takes a victim back first: the written-back rows
        # do not depend on the flush threads' timing
        je._drain_flush_queue()
        te._drain_flush_queue()
    assert je.flush_all() == te.flush_all() > 0
    mine, ref = _new_series(reg, before), _new_series(jreg, jbefore)
    mine = {k: v for k, v in mine.items() if k[0].startswith("device_cache")}
    ref = {k: v for k, v in ref.items() if k[0].startswith("device_cache")}
    _assert_same_series(mine, ref)
    st = te.stats()
    by_name = {k[0]: v[2].value for k, v in mine.items()}
    for name in ("probes", "hits", "misses", "evictions", "promotions",
                 "writeback_rows"):
        assert by_name[f"device_cache_{name}_total"] == st[name]
    assert by_name["device_cache_probes_total"] \
        == st["hits"] + st["misses"] == te.mapper.hits + te.mapper.misses
    assert st["evictions"] > 0 and st["writeback_rows"] > 0
    assert by_name["device_cache_resident_rows"] == st["resident_rows"]
    te.close()
    je.close()
    tw.close()
    jw.close()


def test_device_cache_counts_exact_under_two_threads():
    """``wire_bytes_saved`` and the flush token change under the counts'
    lock: two threads adding 20,000 times each lose no increment."""
    from persia_tpu_torch import config as tcfg
    from persia_tpu_torch.parallel.cached_engine import DeviceCacheEngine
    from persia_tpu_torch.worker.worker import EmbeddingWorker
    from test_torch_device_cache import DIM as DC_DIM
    from test_torch_device_cache import NUM_SLOTS, _holders, _schema

    tw = EmbeddingWorker(_schema(tcfg), _holders("port"))
    te = DeviceCacheEngine(tw, 64, NUM_SLOTS, DC_DIM, 0.01, device="cpu")
    n = 20_000
    mask = np.zeros(4, bool)

    def hammer():
        for _ in range(n):
            te._save_wire_bytes(3, 1)
            te._count("hits", 1)

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert te.wire_bytes_saved == 2 * n * 2
    assert te.stats()["hits"] == 2 * n
    te.finish(np.zeros(4, np.uint64), mask, torch.zeros(4, DC_DIM),
              torch.zeros(4, DC_DIM))  # no real eviction: no token
    assert te._flush_token == 0
    te.close()
    tw.close()


@pytest.mark.parametrize("routing_wire", [False, True])
def test_remote_worker_routing_epoch(routing_wire):
    """The worker service reports its ``routing_epoch`` in its health
    doc; a ``RemoteEmbeddingWorker`` learns the fleet's from its complete
    broadcast (what a snapshot manifest records), and a repeated publish
    is refused but leaves the epoch."""
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service.ps_service import PsService
    from persia_tpu_torch.service.worker_service import (
        RemoteEmbeddingWorker,
        WorkerService,
    )
    from persia_tpu_torch.service.ps_service import PsClient
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    pss = [PsService(EmbeddingHolder(capacity=1000), port=0)
           for _ in range(3)]
    for p in pss:
        p.server.serve_background()
    w = EmbeddingWorker(EmbeddingSchema(slots_config=uniform_slots(
        ["a"], dim=DIM)), [PsClient(p.addr, routing_wire=routing_wire)
                           for p in pss[:2]])
    ws = WorkerService(w, port=0)
    ws.server.serve_background()
    remote = RemoteEmbeddingWorker([ws.addr])
    try:
        assert remote.routing_epoch is None
        assert ws._health()["routing_epoch"] == 1
        t = RoutingTable.uniform(2)
        t2 = t.derive(t.replica_of_slot.copy(), 3)
        assert remote.apply_routing(t2, ps_addrs=[p.addr for p in pss])
        assert remote.routing_epoch == w.routing_epoch == 2
        assert w.replica_size == 3 and ws._health()["routing_epoch"] == 2
        assert not remote.apply_routing(t2)
        assert remote.routing_epoch == 2
        remote.close_routing_window()
        assert w.routing_window[1] is None
    finally:
        remote.close()
        ws.stop()
        w.close()
        for p in pss:
            p.stop()
