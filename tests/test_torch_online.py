"""The port's online loop against the JAX package's, on the CPU
(``tests/test_online.py``'s online cases).

- The versioned hot-row cache (``:46-115``): the fetch-vs-delta version
  guard, the tuple swap, the TTL refresh, never inserting or evicting;
  each case also run on the JAX cache, which must end the same.
- The write-rate governor on a fake clock (``:117``), against JAX's.
- The delta subscriber: resident rows only (``:167``) and the routing
  filter across an epoch (``:195``; the cut-over table is built with
  ``RoutingTable(epoch, replica_of_slot, num_replicas)``), the port's and
  the JAX subscriber fed the same packets, their caches compared.
- The server: health with ``online`` (``:360``), and
  ``attach_delta_subscriber`` on the port's server against the JAX
  server fed the same packets: the two caches hold the same rows bit for
  bit, the port's prediction after the delta equals, bit for bit, a
  fresh cacheless port server over a PS that loaded the packets (the
  infer PS's path), and the two packages' predictions agree within
  ``test_torch_serving_rpc.py``'s cross-package f32 tolerance (1e-5:
  the same math, other GEMM summation orders).

Host code is held bit for bit (tolerance 0.0).
"""

import os
import time

import numpy as np
import pytest

from persia_tpu_torch.inc_update import IncrementalUpdateDumper, \
    IncrementalUpdateLoader
from persia_tpu_torch.online import LAG_BUCKETS, DeltaSubscriber, \
    RateGovernor
from persia_tpu_torch.ps.store import EmbeddingHolder
from persia_tpu_torch.routing import RoutingTable
from persia_tpu_torch.serving import HotRowCache, InferenceServer
from test_torch_serving_rpc import TOL, _request, world  # noqa: F401

DIM = 8


def _rows(n, val):
    return np.full((n, DIM), float(val), np.float32)


def _caches(ttl, capacity=100):
    from persia_tpu.serving import HotRowCache as JCache

    return HotRowCache(capacity, ttl_sec=ttl), JCache(capacity, ttl_sec=ttl)


def _jax_predict(server, batch):
    """The JAX server's predict, in process (its ``predict`` handler)."""
    from persia_tpu.rpc import unpack_arrays

    return unpack_arrays(server._predict(batch.to_bytes()))[1][0]


def _contents(cache):
    """(key, row bytes, version) of every entry, in LRU order."""
    return [(k, v[0].tobytes(), v[2]) for k, v in cache._od.items()]


# --- the versioned cache -----------------------------------------------------


def test_cache_put_respects_delta_version_deterministic_interleaving():
    """A predict misses an expired resident row, a delta lands while its
    fetch is in flight, and the older fetched row arrives last: the
    version guard keeps the delta's row."""
    for cache in _caches(0.05):
        signs = np.array([1, 2], np.uint64)
        cache.put(signs, DIM, _rows(2, 1.0))
        time.sleep(0.08)  # both expire
        out = np.zeros((2, DIM), np.float32)
        seen_ver = cache.version
        assert list(cache.gather(signs, DIM, out)) == [0, 1]
        assert cache.apply_delta(signs, DIM, _rows(2, 7.0)) == 2
        cache.put(signs, DIM, _rows(2, 1.0), seen_ver=seen_ver)
        out2 = np.zeros((2, DIM), np.float32)
        assert len(cache.gather(signs, DIM, out2)) == 0
        np.testing.assert_array_equal(out2, _rows(2, 7.0))
        # a later fetch (a fresh snapshot) may overwrite again
        cache.put(signs, DIM, _rows(2, 9.0), seen_ver=cache.version)
        out3 = np.zeros((2, DIM), np.float32)
        cache.gather(signs, DIM, out3)
        np.testing.assert_array_equal(out3, _rows(2, 9.0))
        assert cache.version == 1 and cache.delta_rows_applied == 2


def test_cache_apply_delta_swaps_tuple_never_mutates_row():
    for cache in _caches(60.0, capacity=10):
        cache.put(np.array([5], np.uint64), DIM, _rows(1, 3.0))
        old_row = cache._od[(DIM, 5)][0]
        cache.apply_delta(np.array([5], np.uint64), DIM, _rows(1, 4.0))
        new_row = cache._od[(DIM, 5)][0]
        assert new_row is not old_row
        np.testing.assert_array_equal(old_row, _rows(1, 3.0)[0])
        np.testing.assert_array_equal(new_row, _rows(1, 4.0)[0])


def test_cache_apply_delta_refreshes_ttl_atomically():
    for cache in _caches(0.2, capacity=10):
        s = np.array([9], np.uint64)
        cache.put(s, DIM, _rows(1, 1.0))
        time.sleep(0.1)
        cache.apply_delta(s, DIM, _rows(1, 2.0))
        time.sleep(0.15)  # past the first expiry, inside the refreshed one
        out = np.zeros((1, DIM), np.float32)
        assert len(cache.gather(s, DIM, out)) == 0
        np.testing.assert_array_equal(out, _rows(1, 2.0))


def test_cache_apply_delta_never_inserts_or_evicts():
    mine, ref = _caches(60.0, capacity=3)
    for cache in (mine, ref):
        cache.put(np.array([1, 2, 3], np.uint64), DIM, _rows(3, 1.0))
        lru = list(cache._od)
        assert cache.apply_delta(np.array([2, 99, 100], np.uint64), DIM,
                                 _rows(3, 5.0)) == 1
        assert len(cache) == 3 and list(cache._od) == lru
    assert [(k, r) for k, r, _ in _contents(mine)] == \
        [(k, r) for k, r, _ in _contents(ref)]
    # a cacheless cache applies nothing
    assert HotRowCache(0, 1.0).apply_delta(np.array([1], np.uint64), DIM,
                                           _rows(1, 1.0)) == 0


# --- the governor ------------------------------------------------------------


def test_governor_token_bucket_fake_clock():
    from persia_tpu.online import RateGovernor as JGovernor

    runs = []
    for cls in (RateGovernor, JGovernor):
        t, slept = [0.0], []

        def sleep(s, t=t, slept=slept):
            slept.append(s)
            t[0] += s

        g = cls(1000, clock=lambda t=t: t[0], sleep=sleep)
        waits = [g.spend(500), g.spend(500), g.spend(250)]
        assert waits[:2] == [0.0, 0.0]
        assert waits[2] == pytest.approx(0.25)
        t[0] += 10.0  # a long idle: the bucket refills, capped
        waits.append(g.spend(1000))
        g0 = cls(0, clock=lambda t=t: t[0], sleep=sleep)
        waits.append(g0.spend(10 ** 9))
        runs.append((waits, slept, g.throttled_sec))
    assert runs[0] == runs[1]
    assert runs[0][1] == [pytest.approx(0.25)]


# --- the subscriber ----------------------------------------------------------


def _holder_with(signs, val):
    h = EmbeddingHolder(100_000, 2)
    for s in signs:
        h.set_entry(int(s), DIM, np.full(2 * DIM, float(val), np.float32))
    return h


_PKT_SEQ = iter(range(1, 10_000))


def _dump_packet(holder, inc_dir, signs, replica=0):
    d = IncrementalUpdateDumper(holder, inc_dir, buffer_size=1 << 30,
                                replica_index=replica)
    # a throwaway dumper a call: distinct seqs keep two flushes of one
    # (replica, pid) in one second from sharing a name
    d._seq = next(_PKT_SEQ)
    d.commit(np.asarray(signs, np.uint64))
    d.flush()


def test_subscriber_applies_resident_rows_only(tmp_path):
    from persia_tpu.online import DeltaSubscriber as JSub

    inc_dir = str(tmp_path / "inc")
    signs = np.arange(1, 11, dtype=np.uint64)
    mine, ref = _caches(600.0)
    for cache in (mine, ref):
        cache.put(signs[:4], DIM, _rows(4, 1.0))  # 4 of 10 resident
    sub, jsub = DeltaSubscriber(mine, inc_dir, rows_per_sec=0), \
        JSub(ref, inc_dir, rows_per_sec=0)
    assert sub.scan_once() == jsub.scan_once() == 0  # no directory yet
    _dump_packet(_holder_with(signs, 4.0), inc_dir, signs)
    assert sub.scan_once() == jsub.scan_once() == 4
    assert (sub.packets_applied, sub.rows_skipped, sub.rows_filtered) \
        == (jsub.packets_applied, jsub.rows_skipped, jsub.rows_filtered) \
        == (1, 6, 0)
    out = np.zeros((4, DIM), np.float32)
    assert len(mine.gather(signs[:4], DIM, out)) == 0
    np.testing.assert_array_equal(out, _rows(4, 4.0))
    assert _contents(mine) == _contents(ref)
    assert sub.scan_once() == 0 and sub.packets_applied == 1
    h, jh = sub.health(), jsub.health()
    assert set(h) == set(jh)
    for k in ("last_packet", "last_packet_seq", "packets_applied",
              "rows_applied", "rows_skipped", "rows_filtered", "inc_dir"):
        assert h[k] == jh[k], k
    assert h["last_packet_seq"] == int(h["last_packet"].split("_")[2]) >= 1
    assert h["sec_since_last_apply"] < 5.0
    assert LAG_BUCKETS[0] == 0.05


def test_subscriber_routing_filter_across_epoch(tmp_path):
    """A packet lands only the rows its dumping replica owns under the
    live table or the open window's predecessor; once the window closes
    a donor's late packet is filtered and the new owner's applies."""
    from persia_tpu.online import DeltaSubscriber as JSub
    from persia_tpu.routing import RoutingTable as JTable

    inc_dir = str(tmp_path / "inc")
    assign = np.arange(32, dtype=np.int32) % 2
    moved = assign.copy()
    moved[moved == 0] = 2
    tables = {"port": (RoutingTable(1, assign, 2),
                       RoutingTable(2, moved, 3)),
              "jax": (JTable(1, assign, 2), JTable(2, moved, 3))}
    signs = np.arange(1, 201, dtype=np.uint64)
    mine0 = signs[tables["port"][0].replica_of(signs) == 0]
    assert 0 < len(mine0) < len(signs)
    window = {tag: {"table": t[0], "prev": None}
              for tag, t in tables.items()}
    mine, ref = _caches(600.0, capacity=1000)
    subs = []
    for tag, cache, cls in (("port", mine, DeltaSubscriber),
                            ("jax", ref, JSub)):
        cache.put(signs, DIM, _rows(len(signs), 1.0))
        w = window[tag]
        subs.append(cls(cache, inc_dir, rows_per_sec=0,
                        routing_fn=lambda w=w: (w["table"], w["prev"])))

    def scan():
        got = [s.scan_once() for s in subs]
        assert got[0] == got[1]
        assert _contents(mine) == _contents(ref)
        return got[0]

    _dump_packet(_holder_with(signs, 2.0), inc_dir, signs, replica=0)
    assert scan() == len(mine0)
    assert subs[0].rows_filtered == subs[1].rows_filtered \
        == len(signs) - len(mine0)
    for tag, t in tables.items():  # cut over, the window open
        window[tag]["table"], window[tag]["prev"] = t[1], t[0]
    _dump_packet(_holder_with(mine0, 3.0), inc_dir, mine0, replica=0)
    assert scan() == len(mine0)
    for tag in tables:  # the window closed
        window[tag]["prev"] = None
    _dump_packet(_holder_with(mine0, 9.9), inc_dir, mine0, replica=0)
    assert scan() == 0
    _dump_packet(_holder_with(mine0, 5.0), inc_dir, mine0, replica=2)
    assert scan() == len(mine0)
    out = np.zeros((len(mine0), DIM), np.float32)
    assert len(mine.gather(mine0, DIM, out)) == 0
    np.testing.assert_array_equal(out, _rows(len(mine0), 5.0))


def test_subscriber_thread_batches_and_series(tmp_path):
    """The scanner thread applies in ``batch_rows`` chunks through the
    governor and publishes its series; ``stop`` joins it."""
    from persia_tpu_torch.metrics import default_registry

    inc_dir = str(tmp_path / "inc")
    signs = np.arange(1, 101, dtype=np.uint64)
    cache = HotRowCache(1000, 600.0)
    cache.put(signs, DIM, _rows(100, 1.0))
    calls = []
    apply = cache.apply_delta
    cache.apply_delta = lambda s, d, r: calls.append(len(s)) or apply(s, d,
                                                                      r)
    sub = DeltaSubscriber(cache, inc_dir, scan_interval_sec=0.02,
                          batch_rows=30, rows_per_sec=0,
                          consumer="test_online").start()
    try:
        _dump_packet(_holder_with(signs, 6.0), inc_dir, signs)
        deadline = time.monotonic() + 10
        while sub.packets_applied < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        sub.stop()
    assert not sub._thread.is_alive()
    assert calls == [30, 30, 30, 10] and sub.rows_applied == 100
    text = default_registry().render()
    for series in ("serving_sign_to_servable_lag_sec_bucket",
                   "serving_delta_packets_applied_total",
                   "serving_delta_rows_applied_total",
                   "serving_delta_rows_skipped_total",
                   "serving_delta_rows_filtered_total",
                   "serving_delta_throttled_sec_total"):
        assert f'{series}{{consumer="test_online"' in text, series


# --- the server --------------------------------------------------------------


def test_server_healthz_surfaces_online(world, tmp_path):  # noqa: F811
    inc_dir = str(tmp_path / "inc")
    os.makedirs(inc_dir)
    server = InferenceServer(world["model"], world["schema"],
                             world["worker"], device="cpu",
                             cache_rows=10_000, cache_ttl_sec=600.0)
    try:
        assert "online" not in server._healthz()
        sub = server.attach_delta_subscriber(inc_dir,
                                             scan_interval_sec=30.0)
        doc = server._healthz()
        assert doc["online"]["sec_since_last_apply"] >= 0.0
        assert doc["online"]["last_packet_seq"] == 0
        assert doc["online"]["packets_applied"] == 0
        assert [v["name"] for v in doc["variants"]] == ["default"]
        _dump_packet(_holder_with(np.array([7], np.uint64), 1.0), inc_dir,
                     [7])
        sub.scan_once()
        doc = server._healthz()
        assert doc["online"]["packets_applied"] == 1
        assert doc["online"]["last_packet_seq"] >= 1
        with pytest.raises(RuntimeError):
            server.attach_delta_subscriber(inc_dir)  # already attached
    finally:
        server.stop()


def test_attach_delta_subscriber_against_the_jax_server(
        world, tmp_path):  # noqa: F811
    """Both servers cache a request's rows, then subscribe to the same
    packets of new rows for them."""
    from persia_tpu.ps.store import EmbeddingHolder as JHolder
    from persia_tpu.serving import InferenceServer as JServer
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    from persia_tpu_torch.worker.worker import EmbeddingWorker

    inc_dir = str(tmp_path / "inc")
    req = _request(8, 3)
    jreq = _request(8, 3, world["jbatch"])
    mine = InferenceServer(world["model"], world["schema"], world["worker"],
                           device="cpu", cache_rows=10_000,
                           cache_ttl_sec=3600.0)
    ref = JServer(world["jmodel"], world["state"], world["jschema"],
                  worker=world["jworker"], cache_rows=10_000,
                  cache_ttl_sec=3600.0)
    try:
        before = mine.predict(req)
        np.testing.assert_allclose(before, _jax_predict(ref, jreq), rtol=TOL,
                                   atol=TOL)
        assert _contents(mine.cache) == _contents(ref.cache)
        keys = np.array([s for _, s in mine.cache._od], np.uint64)
        rng = np.random.default_rng(11)
        trained = EmbeddingHolder(100_000, 2)
        for s in keys:
            trained.set_entry(int(s), DIM, rng.standard_normal(
                DIM).astype(np.float32))
        # each replica dumps the rows it owns: the JAX server's worker
        # filters the packets by its routing window
        owner = RoutingTable.uniform(2).replica_of(keys)
        for r in range(2):
            _dump_packet(trained, inc_dir, keys[owner == r], replica=r)
        sub = mine.attach_delta_subscriber(inc_dir, scan_interval_sec=30.0)
        jsub = ref.attach_delta_subscriber(inc_dir, scan_interval_sec=30.0)
        assert sub.scan_once() == jsub.scan_once() == len(keys)
        assert _contents(mine.cache) == _contents(ref.cache)
        after = mine.predict(req)
        assert not np.array_equal(after, before)
        np.testing.assert_allclose(after, _jax_predict(ref, jreq), rtol=TOL,
                                   atol=TOL)
        # the infer PS's path: fresh holders load the same packets, and a
        # cacheless server over them serves the delta's prediction
        holders = [EmbeddingHolder(100_000, 2) for _ in range(2)]
        for h in holders:
            IncrementalUpdateLoader(h, inc_dir).scan_once()
        infer = EmbeddingWorker(world["schema"], holders)
        fresh = InferenceServer(world["model"], world["schema"], infer,
                                device="cpu")
        try:
            np.testing.assert_array_equal(fresh.predict(req), after)
        finally:
            fresh.stop()
            infer.close()
        jholders = [JHolder(100_000, 2) for _ in range(2)]
        from persia_tpu.inc_update import IncrementalUpdateLoader as JLoader

        for h in jholders:
            JLoader(h, inc_dir).scan_once()
        jinfer = JWorker(world["jschema"], jholders)
        jfresh = JServer(world["jmodel"], world["state"], world["jschema"],
                         worker=jinfer)
        try:
            np.testing.assert_array_equal(_jax_predict(jfresh, jreq),
                                          _jax_predict(ref, jreq))
        finally:
            jfresh.stop()
        assert mine.stats()["cache_delta_rows_applied"] == len(keys)
    finally:
        mine.stop()
        ref.stop()
