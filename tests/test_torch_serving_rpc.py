"""The port's InferenceServer over the RPC wire, on the CPU.

- ``tests/test_serving_perf.py``'s cases against the port's server over
  sockets (``device="cpu"``): micro-batched = serialized (bit for bit at
  a request's own shape, within an ulp merged), concurrent clients, the hot-row cache's TTL, bucket padding, the
  ``lookup_signs`` miss path.
- The degraded cases of ``tests/test_faults.py``: a worker whose lookups
  fail with a transport error makes the server serve zero rows, counted,
  and never cached.
- Cross-package: a JAX ``InferenceClient`` against the port's server and
  the port's client against the JAX server, from transplanted weights and
  identical PS rows. Predictions agree within 1e-5 in f32 (the same math
  with other summation orders, as ``tests/test_torch_serving.py``), before
  and after the hot-row cache fills; the port's ``predict`` reply is the
  JAX ``pack_arrays`` bytes of its array; ``stats`` carries every JAX key.
- Variants: ``VariantRegistry`` routes as the JAX one does, key for key;
  the non-online cases of ``tests/test_online.py``; ``variant_admin``
  add (from a ``dense.pt`` directory) / remove / promote over the wire.
- What is not ported raises, naming its ROADMAP item.

Every server binds port 0 on 127.0.0.1 and is stopped in ``finally``;
every join is bounded.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from persia_tpu_torch import checkpoint as ckpt
from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
from persia_tpu_torch.data.batch import (
    IDTypeFeatureWithSingleID,
    NonIDTypeFeature,
    PersiaBatch,
)
from persia_tpu_torch.models import DNN
from persia_tpu_torch.ps.store import EmbeddingHolder
from persia_tpu_torch.rpc import RpcCircuitOpen, RpcError, pack_arrays, \
    unpack_arrays
from persia_tpu_torch.serving import InferenceClient, InferenceServer
from persia_tpu_torch.variants import VariantRegistry, route_bucket
from persia_tpu_torch.weights import load_flax_params, numpy_tree
from persia_tpu_torch.worker.worker import EmbeddingWorker

N_SLOTS = 4
DIM = 8
N_DENSE = 5
TOL = 1e-5
# a merged (or padded) forward against a request's own: PyTorch's CPU GEMM
# picks its blocking by row count, so one f32 product can round apart by
# an ulp; a request forwarded at its own shape stays bit-equal
MERGED_TOL = 1e-6


def _slots(mod):
    return mod.uniform_slots([f"slot_{s}" for s in range(N_SLOTS)], dim=DIM)


def _make_worker(schema_mod, holder_cls, worker_cls):
    schema = schema_mod.EmbeddingSchema(slots_config=_slots(schema_mod))
    worker = worker_cls(schema, [holder_cls(100_000, 2) for _ in range(2)])
    worker.configure_parameter_servers(
        "bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0)
    worker.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
    return schema, worker


def _request(rows, seed, batch_mod=None, vocab=3000):
    """``rows`` Zipf-free single-id requests, made from a seed with numpy
    (the same bytes from either package's batch module)."""
    if batch_mod is None:
        cls = (IDTypeFeatureWithSingleID, NonIDTypeFeature, PersiaBatch)
    else:
        cls = (batch_mod.IDTypeFeatureWithSingleID,
               batch_mod.NonIDTypeFeature, batch_mod.PersiaBatch)
    rng = np.random.default_rng(seed)
    return cls[2](
        [cls[0](f"slot_{s}",
                rng.integers(1, vocab, size=rows).astype(np.uint64))
         for s in range(N_SLOTS)],
        non_id_type_features=[cls[1](
            rng.normal(size=(rows, N_DENSE)).astype(np.float32))],
        requires_grad=False)


@pytest.fixture(scope="module")
def world():
    """The port's worker with rows for 12 requests, and an f32 DNN whose
    weights come from the JAX tower's seeded template; the JAX side of
    the same (worker, model, state) for the cross-package tests."""
    from persia_tpu import config as jcfg
    from persia_tpu.data import batch as jbatch
    from persia_tpu.models import DNN as JDNN
    from persia_tpu.ps.store import EmbeddingHolder as JHolder
    from persia_tpu.serving import build_state_template
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker
    import jax.numpy as jnp

    from persia_tpu_torch import config as tcfg

    schema, worker = _make_worker(tcfg, EmbeddingHolder, EmbeddingWorker)
    jschema, jworker = _make_worker(jcfg, JHolder, JWorker)
    requests = [_request(8, i) for i in range(12)]
    for i, b in enumerate(requests):
        # training lookups create and initialize the rows (the PS rng is
        # the same in both packages, so the rows are too)
        worker.lookup_direct(b.id_type_features, training=True)
        jworker.lookup_direct(_request(8, i, jbatch).id_type_features,
                              training=True)
    jmodel = JDNN(compute_dtype=jnp.float32)
    state = build_state_template(jmodel, jschema, N_DENSE, seed=3)
    model = _port_dnn(numpy_tree(state.params),
                      numpy_tree(state.batch_stats))
    yield {"schema": schema, "worker": worker, "model": model,
           "requests": requests, "jschema": jschema, "jworker": jworker,
           "jmodel": jmodel, "state": state, "jbatch": jbatch}
    worker.close()
    jworker.close()


def _port_dnn(params=None, stats=None, shift=0.0):
    model = DNN(N_DENSE, [DIM] * N_SLOTS, compute_dtype=torch.float32,
                device="cpu")
    if params is not None:
        load_flax_params(model, params, stats)
    if shift:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(shift)
    return model.eval()


def _server(world, model=None, **kw):
    s = InferenceServer(model or world["model"], world["schema"],
                        world["worker"], device="cpu", **kw)
    s.serve_background()
    return s


def _stop(*servers):
    for s in servers:
        s.stop()


# --- tests/test_serving_perf.py over sockets --------------------------------


def test_microbatched_matches_serialized(world):
    requests = world["requests"]
    plain = _server(world)
    micro = _server(world, max_batch_rows=64, max_wait_us=5000,
                    cache_rows=50_000, cache_ttl_sec=300.0)
    pc, mc = InferenceClient(plain.addr), InferenceClient(micro.addr)
    try:
        ref = [pc.predict(b) for b in requests]
        many = mc.predict_many(requests)
        solo = [mc.predict(b) for b in requests]
        for r, m, s in zip(ref, many, solo):
            assert r.shape == (8, 1) and r.dtype == np.float32
            np.testing.assert_allclose(m, r, rtol=MERGED_TOL,
                                       atol=MERGED_TOL)
            np.testing.assert_array_equal(r, s)  # 8 rows: bucket 8
        stats = mc.stats()
        assert stats["requests"] == 2 * len(requests)
        assert stats["cache_hits"] > 0
        assert pc.healthy() and mc.healthy()
    finally:
        pc.close()
        mc.close()
        _stop(plain, micro)


def test_concurrent_clients_one_server(world):
    requests = world["requests"]
    plain = _server(world)
    micro = _server(world, max_batch_rows=96, max_wait_us=3000,
                    cache_rows=50_000, cache_ttl_sec=300.0)
    n_clients, per_client = 8, 6
    pc = InferenceClient(plain.addr)
    try:
        ref = [pc.predict(b) for b in requests]
        errors = []

        def run(ci):
            cl = InferenceClient(micro.addr, timeout=60)
            try:
                for k in range(per_client):
                    idx = (ci + k) % len(requests)
                    np.testing.assert_allclose(
                        cl.predict(requests[idx]), ref[idx],
                        rtol=MERGED_TOL, atol=MERGED_TOL)
            except BaseException as e:  # re-raised below
                errors.append(e)
            finally:
                cl.close()

        threads = [threading.Thread(target=run, args=(ci,))
                   for ci in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[0]
        stats = micro.stats()
        assert stats["requests"] == n_clients * per_client
        assert stats["batches"] <= stats["requests"]
    finally:
        pc.close()
        _stop(plain, micro)


def test_cache_ttl_expiry_sees_updates(world):
    """A cached row lags the PS by at most one TTL: an update is invisible
    while the TTL holds and visible after it expires. (Its own worker:
    the update must not reach the rows the cross-package tests share.)"""
    from persia_tpu_torch import config as tcfg

    _, worker = _make_worker(tcfg, EmbeddingHolder, EmbeddingWorker)
    world = dict(world, worker=worker)
    server = _server(world, cache_rows=10_000, cache_ttl_sec=1.0)
    plain = _server(world)
    client, pc = InferenceClient(server.addr), InferenceClient(plain.addr)
    try:
        b = _request(4, 777)
        worker.lookup_direct(b.id_type_features, training=True)
        p1 = client.predict(b)
        ref, lk = worker.lookup_direct_training(b.id_type_features)
        worker.update_gradients(ref, {
            f.name: np.ones_like(lk[f.name].embeddings)
            for f in b.id_type_features})
        p2 = client.predict(b)  # within the TTL: cached rows, unchanged
        np.testing.assert_array_equal(p1, p2)
        time.sleep(1.1)  # the TTL expires
        p3 = client.predict(b)
        assert not np.array_equal(p1, p3)
        np.testing.assert_array_equal(p3, pc.predict(b))
    finally:
        client.close()
        pc.close()
        _stop(server, plain)
        worker.close()


def test_bucket_padding_never_leaks(world):
    worker = world["worker"]
    plain = _server(world)
    micro = _server(world, max_batch_rows=16, buckets=(8, 16))
    pc, mc = InferenceClient(plain.addr), InferenceClient(micro.addr)
    try:
        for rows, seed in ((3, 50), (5, 51), (7, 52), (11, 53)):
            b = _request(rows, seed)
            worker.lookup_direct(b.id_type_features, training=True)
            got = mc.predict(b)
            assert got.shape == (rows, 1)
            np.testing.assert_allclose(got, pc.predict(b), rtol=MERGED_TOL,
                                       atol=MERGED_TOL)
        assert micro.ctx.eval_batch_rows_seen <= {8, 16}
        stats = mc.stats()
        assert stats["padded_rows"] > 0
        assert 0.0 < stats["batch_fill_ratio"] <= 1.0
        assert set(stats["compiled_buckets"]) <= {8, 16}
    finally:
        pc.close()
        mc.close()
        _stop(plain, micro)


def test_lookup_signs_parity(world):
    """The serving-miss entry point returns exactly the rows the full
    lookup scatters, and absent signs read zeros without being created."""
    from persia_tpu_torch.worker import middleware as mw

    schema, worker = world["schema"], world["worker"]
    b = _request(16, 99)
    worker.lookup_direct(b.id_type_features, training=True)
    feats = mw.preprocess_batch(b.id_type_features, schema)
    lookup = worker.lookup_direct(b.id_type_features, training=False)
    for f in feats:
        rows = worker.lookup_signs(f.distinct_signs, DIM)
        np.testing.assert_array_equal(lookup[f.name].embeddings,
                                      rows[f.elem_distinct])
    absent = np.array([10**15 + 1, 10**15 + 2], np.uint64)
    before = sum(len(h) for h in worker.ps_clients)
    assert (worker.lookup_signs(absent, DIM) == 0).all()
    assert sum(len(h) for h in worker.ps_clients) == before


@pytest.mark.parametrize("micro", [False, True])
def test_wire_replies_equal_in_process_predicts(world, micro):
    """Over the wire, a reply is bit for bit the same server's in-process
    prediction of the same payload, packed as the JAX server packs it."""
    kw = dict(max_batch_rows=64, cache_rows=10_000) if micro else {}
    server = _server(world, **kw)
    cl = InferenceClient(server.addr)
    try:
        for b in world["requests"]:
            payload = b.to_bytes()
            reply = bytes(cl.client.call("predict", payload))
            local = server.predict_bytes(payload)
            assert reply == pack_arrays({}, [local])
        assert server.stats()["requests"] == 2 * len(world["requests"])
    finally:
        cl.close()
        server.stop()


# --- degraded fallback (tests/test_faults.py) -------------------------------


class _FailingLookupWorker:
    """Delegates to a real worker; lookups fail on demand with a
    degradable (circuit-open) error."""

    def __init__(self, inner):
        self.inner = inner
        self.schema = inner.schema
        self.failing = False

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def lookup_signs(self, signs, dim):
        if self.failing:
            raise RpcCircuitOpen("synthetic: replica circuit open")
        return self.inner.lookup_signs(signs, dim)

    def lookup_direct(self, feats, training=False):
        if self.failing:
            raise RpcCircuitOpen("synthetic: replica circuit open")
        return self.inner.lookup_direct(feats, training=training)


def _degraded_world():
    schema = EmbeddingSchema(slots_config=uniform_slots(
        ["slot_a", "slot_b"], dim=8))
    worker = EmbeddingWorker(schema, [EmbeddingHolder(100_000, 2)])
    worker.configure_parameter_servers(
        "bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0)
    worker.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
    model = DNN(5, [8, 8], compute_dtype=torch.float32, device="cpu")
    from persia_tpu_torch.weights import init_params

    return schema, worker, init_params(model, 0).eval()


def _infer_request(rows, seed, vocab=512):
    rng = np.random.default_rng(seed)
    feats = [IDTypeFeatureWithSingleID(
        n, rng.integers(1, vocab, size=rows).astype(np.uint64))
        for n in ("slot_a", "slot_b")]
    dense = [NonIDTypeFeature(rng.normal(size=(rows, 5)).astype(np.float32))]
    return PersiaBatch(feats, non_id_type_features=dense,
                       requires_grad=False)


def test_serving_zero_vector_fallback_parity_on_unaffected_signs():
    schema, inner, model = _degraded_world()
    worker = _FailingLookupWorker(inner)
    req = _infer_request(8, seed=1)
    inner.lookup_direct(req.id_type_features, training=True)
    server = InferenceServer(model, schema, worker, device="cpu",
                             cache_rows=10_000, cache_ttl_sec=300.0)
    server.serve_background()
    cl = InferenceClient(server.addr)
    try:
        healthy = cl.predict(req)  # primes the cache
        worker.failing = True
        np.testing.assert_array_equal(healthy, cl.predict(req))
        assert server._m_degraded.value == 0

        fresh = _infer_request(8, seed=2, vocab=100_000)  # cache misses
        pred = cl.predict(fresh)
        assert pred.shape[0] == 8
        assert server._m_degraded.value >= 1
        assert server._m_zero_rows.value >= 1

        worker.failing = False
        inner.lookup_direct(fresh.id_type_features, training=True)
        degraded_total = server._m_degraded.value
        recovered = cl.predict(fresh)  # zero rows were not cached
        assert server._m_degraded.value == degraded_total
        assert not np.array_equal(pred, recovered)
    finally:
        cl.close()
        server.stop()
        inner.close()


def test_serving_uncached_path_degrades_whole_lookup():
    schema, inner, model = _degraded_world()
    worker = _FailingLookupWorker(inner)
    server = InferenceServer(model, schema, worker, device="cpu")
    server.serve_background()
    cl = InferenceClient(server.addr)
    try:
        req = _infer_request(4, seed=3)
        cl.predict(req)
        worker.failing = True
        assert cl.predict(req).shape[0] == 4
        assert server._m_degraded.value == 1
        stats = cl.stats()
        assert stats["degraded_lookups"] == 1
        assert stats["zero_fallback_rows"] >= 1
        doc = {v["name"]: v for v in server._variants_doc()}
        assert doc["default"]["degraded"] == 1
    finally:
        cl.close()
        server.stop()
        inner.close()


def test_serving_degradation_opt_out():
    schema, inner, model = _degraded_world()
    worker = _FailingLookupWorker(inner)
    worker.failing = True
    server = InferenceServer(model, schema, worker, device="cpu",
                             degraded_fallback=False)
    server.serve_background()
    cl = InferenceClient(server.addr)
    try:
        with pytest.raises(RpcError):
            cl.predict(_infer_request(4, seed=4))
    finally:
        cl.close()
        server.stop()
        inner.close()


# --- cross-package ----------------------------------------------------------


def _jax_server(world, **kw):
    from persia_tpu.serving import InferenceServer as JServer

    s = JServer(world["jmodel"], world["state"], world["jschema"],
                worker=world["jworker"], **kw)
    s.serve_background()
    return s


_CONFIGS = {"serialized": {},
            "microbatched": dict(max_batch_rows=64, cache_rows=10_000)}


@pytest.mark.parametrize("config", list(_CONFIGS))
def test_jax_client_and_port_server_agree_with_jax(world, config):
    """A JAX client reads the port's server, and the port's client the
    JAX server; both agree with the JAX server read by the JAX client,
    before and after the hot-row cache fills."""
    from persia_tpu.serving import InferenceClient as JClient

    kw = _CONFIGS[config]
    tserver, jserver = _server(world, **kw), _jax_server(world, **kw)
    jj, jt = JClient(jserver.addr), JClient(tserver.addr)
    tj = InferenceClient(jserver.addr)
    payloads = [b.to_bytes() for b in world["requests"]]
    assert payloads == [_request(8, i, world["jbatch"]).to_bytes()
                        for i in range(len(payloads))]
    try:
        for _ in range(2):  # cache misses, then cache hits
            want = [jj.predict_bytes(p) for p in payloads]
            got_port = jt.predict_many(payloads)
            got_jax = [tj.predict_bytes(p) for p in payloads]
            for w, g, j in zip(want, got_port, got_jax):
                assert g.shape == w.shape == (8, 1)
                assert g.dtype == np.float32
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
                np.testing.assert_array_equal(j, w)
        # the port's reply is the JAX packing of its array, and its head
        # (meta, dtype, shape) equals the JAX server's
        rt = bytes(jt.client.call("predict", payloads[0]))
        rj = bytes(jj.client.call("predict", payloads[0]))
        assert rt == pack_arrays({}, [unpack_arrays(rt)[1][0]])
        head = 4 + int.from_bytes(rj[:4], "little")
        assert rt[:head] == rj[:head] and len(rt) == len(rj)
        # stats: every JAX key, the port's medians beside them
        tstats, jstats = jt.stats(), tj.stats()
        assert set(jstats) <= set(tstats)
        assert {"lookup_p50_ms", "forward_p50_ms"} <= set(tstats)
        n = len(payloads)  # two rounds, and one raw call each
        assert (tstats["requests"], jstats["requests"]) == (2 * n + 1,
                                                            4 * n + 1)
        assert set(tstats["compiled_buckets"]) <= set(
            tserver.buckets or [8])
    finally:
        for c in (jj, jt):
            c.client.close()
        tj.close()
        _stop(tserver, jserver)


def test_stats_keys_with_variants_match_jax(world):
    jserver = _jax_server(world, cache_rows=100)
    tserver = _server(world, cache_rows=100)
    try:
        jserver.add_variant("canary", state=world["state"], weight=0.5)
        tserver.add_variant("canary", _port_dnn(), weight=0.5)
        for s in (jserver, tserver):
            s._predict(world["requests"][0].to_bytes())
        tstats, jstats = tserver.stats(), InferenceClient(
            jserver.addr).stats()
        assert set(jstats) <= set(tstats)
        assert set(jstats["variants"][0]) <= set(tstats["variants"][0])
    finally:
        _stop(tserver, jserver)


# --- variants ---------------------------------------------------------------


@pytest.mark.parametrize("weights", [
    {"base": 0.75, "canary": 0.25},
    {"a": 1.0, "b": 2.0, "c": 0.5},
    {"only": 1.0, "zero": 0.0},
])
def test_variant_registry_routes_as_jax(weights):
    from persia_tpu.variants import VariantRegistry as JRegistry
    from persia_tpu.variants import route_bucket as jroute_bucket

    keys = [f"user-{i}".encode() for i in range(10_000)]
    regs = []
    for cls in (VariantRegistry, JRegistry):
        reg = cls()
        for i, (name, w) in enumerate(weights.items()):
            reg.add(name, weight=w, default=i == 0)
        regs.append(reg)
    treg, jreg = regs
    assert [treg.route(key=k) for k in keys] == [jreg.route(key=k)
                                                 for k in keys]
    assert [route_bucket(k) for k in keys] == [jroute_bucket(k)
                                               for k in keys]
    assert treg.expected_split(keys) == jreg.expected_split(keys)


def test_variant_registry_deterministic_split():
    reg = VariantRegistry()
    reg.add("base", weight=0.75, default=True)
    reg.add("canary", weight=0.25)
    keys = [f"k{i}".encode() for i in range(500)]
    expected = reg.expected_split(keys)
    for k in keys:
        assert reg.route(key=k) == reg.route(key=k)
    assert sum(expected.values()) == len(keys)
    reg2 = VariantRegistry()
    reg2.add("canary", weight=0.25)
    reg2.add("base", weight=0.75, default=True)
    assert reg2.expected_split(keys) == expected
    assert 0.15 < expected["canary"] / len(keys) < 0.35
    assert reg.route() == "base"
    assert reg.route(key=b"x", explicit="canary") == "canary"
    reg.set_status("canary", "draining")
    assert all(reg.route(key=k) == "base" for k in keys[:50])
    assert reg.route(explicit="canary") == "canary"
    reg.promote("canary")
    assert reg.default == "canary"
    assert reg.get("canary").status == "live"
    with pytest.raises(ValueError):
        reg.remove("canary")
    reg.promote("base")
    reg.remove("canary")
    with pytest.raises(KeyError):
        reg.route(explicit="canary")
    with pytest.raises(KeyError):
        reg.reweight({"base": 1.0, "ghost": 1.0})
    assert route_bucket(b"stable-key", 1000) == route_bucket(
        b"stable-key", 1000)


def test_predict_variant_rpc_and_admin(world):
    b = world["requests"][0]
    canary = _port_dnn(shift=0.25)
    server = _server(world, variant_name="base")
    server.add_variant("canary", canary, weight=1.0)
    solo = _server(world, model=canary)
    cl, sc = InferenceClient(server.addr), InferenceClient(solo.addr)
    try:
        meta, (pred_base,) = unpack_arrays(cl.client.call("predict",
                                                          b.to_bytes()))
        assert meta == {}
        pred_canary, served = cl.predict_variant(b, variant="canary")
        assert served == "canary"
        np.testing.assert_array_equal(pred_canary, sc.predict(b))
        assert not np.array_equal(pred_canary, pred_base)
        doc = {v["name"]: v for v in server._variants_doc()}
        assert doc["base"]["requests"] == 1
        assert doc["canary"]["requests"] == 1
        out = cl.variant_admin("list")
        assert {v["name"] for v in out["variants"]} == {"base", "canary"}
        cl.variant_admin("weight", name="canary", weight=0.5)
        assert server.variants.get("canary").weight == 0.5
        cl.variant_admin("promote", name="canary")
        assert server.variants.default == "canary"
        np.testing.assert_array_equal(cl.predict(b), pred_canary)
        cl.variant_admin("promote", name="base")
        cl.variant_admin("drain", name="canary")
        assert server.variants.get("canary").status == "draining"
        cl.variant_admin("resume", name="canary")
        assert server.variants.get("canary").status == "live"
        cl.variant_admin("remove", name="canary")
        assert "canary" not in server.variants
        with pytest.raises(RpcError, match="not registered"):
            cl.predict_variant(b, variant="canary")
        with pytest.raises(RpcError, match="unknown variant_admin op"):
            cl.variant_admin("explode", name="base")
    finally:
        cl.close()
        sc.close()
        _stop(server, solo)


def test_variant_split_over_microbatcher(world):
    """The weighted split through the coalescing path: merged batches are
    single-variant, so every reply equals its variant's serialized
    server."""
    canary = _port_dnn(shift=-0.2)
    micro = _server(world, max_batch_rows=64, max_wait_us=4000,
                    variant_name="base")
    micro.add_variant("canary", canary, weight=0.5)
    micro.variants.set_weight("base", 0.5)
    plain = {"base": _server(world), "canary": _server(world, model=canary)}
    reqs = [_request(4, 900 + i) for i in range(10)]
    for b in reqs:
        world["worker"].lookup_direct(b.id_type_features, training=True)
    mc = InferenceClient(micro.addr)
    refs = {k: InferenceClient(s.addr) for k, s in plain.items()}
    errors = []
    served_by = []

    def run(i):
        try:
            key = f"user{i}".encode()
            expect = micro.variants.route(key=key)
            got, served = mc.predict_variant(reqs[i], key=key)
            assert served == expect, (served, expect)
            served_by.append(served)
            np.testing.assert_allclose(got, refs[expect].predict(reqs[i]),
                                       rtol=MERGED_TOL, atol=MERGED_TOL)
        except BaseException as e:  # re-raised below
            errors.append(e)

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[0]
        assert set(served_by) == {"base", "canary"}
    finally:
        mc.close()
        for c in refs.values():
            c.close()
        _stop(micro, *plain.values())


def test_route_feature_routes_plain_predicts(world, monkeypatch):
    """``PERSIA_VARIANT_ROUTE_FEATURE``: a plain predict's route key is
    the named feature's first sign, as in the JAX server."""
    monkeypatch.setenv("PERSIA_VARIANT_ROUTE_FEATURE", "slot_0")
    server = _server(world, variant_name="base")
    server.add_variant("canary", _port_dnn(shift=0.1), weight=1.0)
    try:
        for b in world["requests"]:
            key = int(b.id_type_features[0].signs[0]).to_bytes(8, "little")
            assert server._route_key_from_batch(b) == key
            before = server._served_variants[
                server.variants.route(key=key)].m_requests.value
            server.predict(b)
            after = server._served_variants[
                server.variants.route(key=key)].m_requests.value
            assert after == before + 1
    finally:
        server.stop()


def test_variant_admin_add_from_dense_pt(world, tmp_path):
    """``add`` over the wire builds the zoo tower and reads ``dense.pt``
    from a checkpoint directory; a directory with only the JAX package's
    ``dense.msgpack`` is refused."""
    donor = _port_dnn(shift=0.15)
    good = tmp_path / "ckpt"
    good.mkdir()
    (good / ckpt.DENSE_FILE).write_bytes(ckpt.dense_state_bytes(
        (donor, None)))
    jax_only = tmp_path / "jax_ckpt"
    jax_only.mkdir()
    (jax_only / ckpt.JAX_DENSE_FILE).write_bytes(b"\x80")
    server = _server(world, variant_name="base")
    solo = _server(world, model=donor)
    cl, sc = InferenceClient(server.addr), InferenceClient(solo.addr)
    b = world["requests"][3]
    try:
        out = cl.variant_admin("add", name="v2", model="dnn",
                               dense_checkpoint=str(good),
                               num_dense=N_DENSE, weight=0.0)
        assert {v["name"] for v in out["variants"]} == {"base", "v2"}
        pred, served = cl.predict_variant(b, variant="v2")
        assert served == "v2"
        np.testing.assert_array_equal(pred, sc.predict(b))
        cl.variant_admin("promote", name="v2")
        np.testing.assert_array_equal(cl.predict(b), pred)
        cl.variant_admin("promote", name="base")
        cl.variant_admin("remove", name="v2")
        with pytest.raises(RpcError, match="dense.msgpack"):
            cl.variant_admin("add", name="v3", model="dnn",
                             dense_checkpoint=str(jax_only),
                             num_dense=N_DENSE)
        assert "v3" not in server.variants
    finally:
        cl.close()
        sc.close()
        _stop(server, solo)


@pytest.mark.parametrize("name", ["dnn", "dlrm", "dcnv2", "deepfm",
                                  "wide_deep"])
def test_model_zoo_builds_each_tower_from_the_schema(world, name, tmp_path):
    """``variant_admin``'s zoo names build the port's towers at the
    schema's widths in the boot model's dtype; each loads the
    ``dense.pt`` of a same-width tower and serves it."""
    from persia_tpu_torch import models
    from persia_tpu_torch.ctx import InferCtx
    from persia_tpu_torch.serving import _model_zoo
    from persia_tpu_torch.weights import init_params

    cls = {"dnn": models.DNN, "dlrm": models.DLRM, "dcnv2": models.DCNv2,
           "deepfm": models.DeepFM, "wide_deep": models.WideAndDeep}[name]
    tower = _model_zoo()[name](N_DENSE, world["schema"],
                               compute_dtype=torch.float32, device="cpu")
    assert type(tower) is cls
    donor = init_params(_model_zoo()[name](
        N_DENSE, world["schema"], compute_dtype=torch.float32,
        device="cpu"), 7).eval()
    (tmp_path / ckpt.DENSE_FILE).write_bytes(ckpt.dense_state_bytes(
        (donor, None)))
    server = InferenceServer(world["model"], world["schema"],
                             world["worker"], device="cpu")
    try:
        server.add_variant_from_checkpoint(
            "v", name, str(tmp_path / ckpt.DENSE_FILE), num_dense=N_DENSE)
        b = world["requests"][5]
        lookup = world["worker"].lookup_direct(b.id_type_features,
                                               training=False)
        want, _ = InferCtx(donor, world["schema"], world["worker"],
                           device="cpu").forward_prepared(b, lookup)
        got = server._serve(b.to_bytes(), "v", None, reply_variant=True)
        meta, (pred,) = unpack_arrays(got)
        assert meta == {"variant": "v"}
        np.testing.assert_array_equal(pred, want.float().numpy())
    finally:
        server.stop()


def test_obs_http_variants_endpoint(world):
    server = InferenceServer(world["model"], world["schema"],
                             world["worker"], device="cpu", http_port=0,
                             variant_name="prod")
    try:
        with urllib.request.urlopen(
                f"http://{server.http.addr}/variants", timeout=5) as r:
            doc = json.loads(r.read())
        assert doc["enabled"] is True
        assert [v["name"] for v in doc["variants"]] == ["prod"]
        with urllib.request.urlopen(
                f"http://{server.http.addr}/healthz?ready=1",
                timeout=5) as r:
            assert r.status == 200
            hz = json.loads(r.read())
        assert hz["variants"][0]["name"] == "prod" and hz["ready"] is True
    finally:
        server.stop()


# --- what is not ported ----------------------------------------------------


def test_unported_paths_raise_naming_their_item(world, tmp_path):
    from persia_tpu_torch.service.worker_service import (
        RemoteEmbeddingWorker,
    )

    # remote workers are served since the service tier came over; a
    # server with no way to find them says so
    remote = InferenceServer(world["model"], world["schema"],
                             worker_addrs=["127.0.0.1:1"], device="cpu")
    assert isinstance(remote.worker, RemoteEmbeddingWorker)
    assert remote.worker.addrs == ["127.0.0.1:1"]
    remote.stop()
    with pytest.raises(ValueError, match="worker_addrs="):
        InferenceServer(world["model"], world["schema"], None, device="cpu")
    # the online delta subscriber is ported: a cacheless server refuses
    # it as the JAX server does, a cached one attaches once, reports it in
    # its stats and stops it with itself
    cacheless = InferenceServer(world["model"], world["schema"],
                                world["worker"], device="cpu")
    with pytest.raises(ValueError, match="cache_rows"):
        cacheless.attach_delta_subscriber(os.fspath(tmp_path))
    cacheless.stop()
    server = InferenceServer(world["model"], world["schema"],
                             world["worker"], device="cpu", cache_rows=10)
    try:
        sub = server.attach_delta_subscriber(os.fspath(tmp_path),
                                             scan_interval_sec=30.0)
        online = server.stats()["online"]
        assert online["inc_dir"] == os.fspath(tmp_path)
        assert online["packets_applied"] == 0 and online["rows_applied"] == 0
        with pytest.raises(RuntimeError, match="already attached"):
            server.attach_delta_subscriber(os.fspath(tmp_path))
    finally:
        server.stop()
    assert not sub._thread.is_alive()
