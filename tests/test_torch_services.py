"""The port's service tier against the JAX package's, on the CPU.

Host code and wire bytes are held bit for bit (tolerance 0.0): the wire
codec, the worker's serialization and the int8 error-feedback residuals
against the JAX modules; RPC across the packages in both directions
(each server a thread on port 0), whose lookups and updates give rows
equal to an in-process holder under the codec off, fp16 and fp16+int8,
and with a server that refuses the codec; the port's worker over
``PsClient`` s against the in-process worker; recovery from a PS
restarted on its address or on another one.

The slice as a whole runs through subprocesses: a port
``ServiceCtx(n_workers=1, n_ps=2)`` under a port ``TrainCtx`` on a small
f32 seq_rec (the flash path through K2-K4's plain versions) equals the
port's in-process run bit for bit (with deterministic algorithms on,
since the CPU gather backward sums repeated rows in a thread-dependent
order otherwise), and matches the JAX in-process ``TrainCtx`` from
transplanted weights within ``tests/test_torch_train.py``'s f32
tolerance (1e-5, parameters 2e-5).

JAX is imported inside the tests only: the ``gpu`` test runs on the card
with ``--noconftest``, where there is no JAX.
"""

import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from persia_tpu_torch import config as tcfg
from persia_tpu_torch import wire_codec as twc
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.ps.native import make_holder
from persia_tpu_torch.service import serialization as tser
from persia_tpu_torch.service.coordinator import (
    Coordinator,
    CoordinatorClient,
)
from persia_tpu_torch.service.ps_service import (
    PsClient,
    PsService,
    ShardParallelDispatcher,
)
from persia_tpu_torch.service.worker_service import (
    RemoteEmbeddingWorker,
    WorkerService,
)
from persia_tpu_torch.worker.middleware import (
    GradErrorFeedback,
    RawEmbedding,
    SumEmbedding,
)
from persia_tpu_torch.worker.worker import EmbeddingWorker
from persia_tpu_torch.workloads import generator as tgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT = ("bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0, True)
ADAGRAD = {"type": "adagrad", "lr": 0.05, "wd": 0.0,
           "g_square_momentum": 1.0, "initialization": 0.01, "eps": 1e-10,
           "vectorwise_shared": False}


@pytest.fixture
def deterministic_torch():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@contextlib.contextmanager
def _serving(*services):
    for s in services:
        s.server.serve_background()
    try:
        yield services
    finally:
        for s in services:
            s.stop()


def _port_ps(n=2, cap=100_000, shards=4):
    return [PsService(make_holder(cap, shards)) for _ in range(n)]


# --- codec, serialization, error feedback -----------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_codec_matches_jax(seed):
    from persia_tpu import wire_codec as jwc

    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((257, 16)) * 3).astype(np.float32)
    rows[3] = 0.0
    rows[7, 5] = 9.99
    for name in ("encode_fp16_rows",):
        a, b = getattr(twc, name)(rows), getattr(jwc, name)(rows)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    half = twc.encode_fp16_rows(rows)
    np.testing.assert_array_equal(twc.decode_fp16_rows(half),
                                  jwc.decode_fp16_rows(half))
    tq = twc.quantize_int8_rows(rows)
    jq = jwc.quantize_int8_rows(rows)
    for a, b in zip(tq, jq):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(twc.dequantize_int8_rows(*tq[:2]),
                                  jwc.dequantize_int8_rows(*jq[:2]))


def test_grad_error_feedback_matches_jax():
    """Residuals applied and stored over several shipments (duplicate
    signs, an overflowing store) equal the JAX store's."""
    from persia_tpu import wire_codec as jwc
    from persia_tpu.worker.middleware import GradErrorFeedback as JEF

    rng = np.random.default_rng(4)
    t, j = GradErrorFeedback(capacity_rows=300), JEF(capacity_rows=300)
    for step in range(6):
        signs = rng.integers(1, 500, 200).astype(np.uint64)
        grads = rng.standard_normal((200, 8)).astype(np.float32)
        tg, jg = grads.copy(), grads.copy()
        t.apply(signs, tg, 8)
        j.apply(signs, jg, 8)
        np.testing.assert_array_equal(tg, jg)
        tq, jq = twc.quantize_int8_rows(tg), jwc.quantize_int8_rows(jg)
        t.store(signs, tq[2], 8)
        j.store(signs, jq[2], 8)
        assert len(t) == len(j) <= 300
    assert list(t._by_dim[8]) == list(j._by_dim[8])
    for k, v in t._by_dim[8].items():
        np.testing.assert_array_equal(v, j._by_dim[8][k])


def _features(pkg, rng, names, bs=6, vocab=50):
    cls = IDTypeFeature
    if pkg == "jax":
        from persia_tpu.data.batch import IDTypeFeature as cls
    return [cls(n, [rng.integers(1, vocab, rng.integers(0, 5)).astype(
        np.uint64) for _ in range(bs)]) for n in names]


def test_serialization_bytes_match_jax():
    from persia_tpu.service import serialization as jser
    from persia_tpu.worker.middleware import RawEmbedding as JRaw
    from persia_tpu.worker.middleware import SumEmbedding as JSum

    names = ["a", "b", "c"]
    tf = _features("port", np.random.default_rng(1), names)
    jf = _features("jax", np.random.default_rng(1), names)
    meta = {"training": True}
    assert tser.pack_id_features(tf, meta) == jser.pack_id_features(jf, meta)
    m, back = tser.unpack_id_features(tser.pack_id_features(tf))
    assert m["names"] == names
    for a, b in zip(back, tf):
        np.testing.assert_array_equal(a.signs, b.signs)
        np.testing.assert_array_equal(a.offsets, b.offsets)
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((6, 8)).astype(np.float32)
    raw = (rng.standard_normal((13, 8)).astype(np.float32),
           rng.integers(0, 13, (6, 2)).astype(np.int32),
           rng.integers(0, 3, 6).astype(np.int32))
    tres = {"s": SumEmbedding("s", emb), "r": RawEmbedding("r", *raw)}
    jres = {"s": JSum("s", emb), "r": JRaw("r", *raw)}
    assert tser.pack_lookup_result(tres) == jser.pack_lookup_result(jres)
    out = tser.unpack_lookup_result(jser.pack_lookup_result(jres))
    np.testing.assert_array_equal(out["s"].embeddings, emb)
    np.testing.assert_array_equal(out["r"].index, raw[1])
    grads = {"s": emb, "r": raw[0]}
    gmeta = {"ref_id": 3, "loss_scale": 2.0}
    assert tser.pack_gradients(grads, gmeta) == jser.pack_gradients(
        grads, gmeta)
    m, g = tser.unpack_gradients(tser.pack_gradients(grads, gmeta))
    assert m["ref_id"] == 3 and list(g) == ["s", "r"]


# --- the PS wire across the packages ----------------------------------------


def _ps_server(pkg, accept_codec=True):
    """A PS service of ``pkg`` (a thread) and a fresh holder of the same
    kind to replay its operations on."""
    if pkg == "port":
        svc, ref = PsService(make_holder(100_000, 4)), make_holder(100_000, 4)
    else:
        from persia_tpu.ps.native import make_holder as jmake
        from persia_tpu.service.ps_service import PsService as JPs

        svc = JPs(jmake(100_000, 4, backend="arena"))
        ref = jmake(100_000, 4, backend="arena")
    svc.server._enable_codec = accept_codec
    return svc, ref


def _ps_client(pkg, addr, codec):
    if pkg == "port":
        return PsClient(addr, wire_codec=codec, circuit_breaker=False,
                        hotness=False)
    from persia_tpu.service.ps_service import PsClient as JClient

    return JClient(addr, wire_codec=codec, circuit_breaker=False,
                   hotness=False, routing_wire=False)


# policy the client asks for, and whether the server accepts the codec
CODECS = {"off": ("off", True), "fp16": ("fp16", True),
          "fp16+int8": ("fp16+int8", True),
          "refused": ("fp16+int8", False)}


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("server", ["jax", "port"])
@pytest.mark.parametrize("client", ["jax", "port"])
def test_ps_wire_across_packages(client, server, codec):
    policy, accept = CODECS[codec]
    fp16 = accept and "fp16" in policy
    int8 = accept and "int8" in policy
    svc, ref = _ps_server(server, accept)
    with _serving(svc):
        c = _ps_client(client, svc.addr, policy)
        ef = GradErrorFeedback()
        for h in (c, ref):
            h.configure(*INIT)
            h.register_optimizer(ADAGRAD, feature_index_prefix_bit=0)
        rng = np.random.default_rng(5)
        for _ in range(4):
            signs = rng.integers(1, 400, 300).astype(np.uint64)
            got = c.lookup(signs, 8, True)
            want = ref.lookup(signs, 8, True)
            if fp16:
                want = want.astype(np.float16).astype(np.float32)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            grads = rng.standard_normal((300, 8)).astype(np.float32)
            c.update_gradients(signs, grads, 8)
            if int8:
                grads = grads.copy()
                ef.apply(signs, grads, 8)
                q, scales, residual = twc.quantize_int8_rows(grads)
                ef.store(signs, residual, 8)
                grads = twc.dequantize_int8_rows(q, scales)
            ref.update_gradients(signs, grads, 8)
        probe = np.arange(1, 400, dtype=np.uint64)
        (f1, v1), (f2, v2) = (c.get_entries(probe, 16),
                              ref.get_entries(probe, 16))
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(v1, v2)
        assert len(c) == len(ref) > 0
        want = ref.lookup(probe, 8, False)
        if fp16:
            want = want.astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(c.lookup(probe, 8, False), want)
        assert c.get_entry(int(probe[0]))[0] == 8
        assert c.ready_for_serving() and c.model_manager_status() == "Idle"
        assert c.client.codec_active() == (accept and policy != "off")


def test_lookup_futures_multiplex_and_the_version_rides_when_asked():
    with _serving(*_port_ps(1)) as (svc,):
        plain = PsClient(svc.addr, hotness=False)
        armed = PsClient(svc.addr, hotness=True)
        for c in (plain, armed):
            c.configure(*INIT)
            c.register_optimizer(ADAGRAD)
        signs = [np.arange(i * 10, i * 10 + 10, dtype=np.uint64)
                 for i in range(4)]
        futs = [armed.lookup_future(s, 8, True) for s in signs]
        rows = [f() for f in futs]
        for s, r in zip(signs, rows):
            np.testing.assert_array_equal(r, plain.lookup(s, 8, True))
        assert armed._last_hver == 0 and plain._last_hver is None
        armed.update_gradients(signs[0], np.ones((10, 8), np.float32), 8)
        armed.update_gradients_future(signs[1], np.ones((10, 8),
                                                        np.float32), 8)()
        armed.lookup(signs[0], 8, False)
        assert armed._last_hver == 2
        armed.set_entries(signs[2], 8, np.zeros((10, 16), np.float32))
        assert armed.last_writeback_ver == 3
        doc = plain.health()
        assert doc["update_version"] == 3 and doc["ready"] is True
        assert doc["dispatch"]["mode"] == "native"
        assert plain.hotness()["enabled"] is False
        assert plain.wire_stats()["sent"] > 0


def test_dispatcher_tunes_the_native_store_and_keeps_its_rows(monkeypatch):
    """Native mode tunes the store to fan out from 512 signs; its rows
    equal an untuned store's bit for bit. A holder under the interpreter
    lock, or the knob at 0, stays serial."""
    from persia_tpu_torch.ps.arena import ArenaEmbeddingHolder

    a, b = make_holder(100_000, 8), make_holder(100_000, 8)
    native = ShardParallelDispatcher(a)
    assert native.mode == "native" and native.enabled
    assert native.info()["native_min_batch"] == native.MIN_PARALLEL
    assert a.parallel_info()["min_batch"] == native.MIN_PARALLEL
    assert b.parallel_info()["min_batch"] != native.MIN_PARALLEL
    for h in (a, b):
        h.configure(*INIT)
        h.register_optimizer(ADAGRAD)
    rng = np.random.default_rng(8)
    for _ in range(3):
        signs = rng.integers(1, 5000, 3000).astype(np.uint64)
        np.testing.assert_array_equal(a.lookup(signs, 8, True),
                                      b.lookup(signs, 8, True))
        g = rng.standard_normal((3000, 8)).astype(np.float32)
        a.update_gradients(signs, g, 8)
        b.update_gradients(signs, g, 8)
    probe = np.arange(1, 5000, dtype=np.uint64)
    np.testing.assert_array_equal(a.get_entries(probe, 16)[1],
                                  b.get_entries(probe, 16)[1])
    assert ShardParallelDispatcher(ArenaEmbeddingHolder(1000, 8)).mode == \
        "serial"
    monkeypatch.setenv("PERSIA_PS_SHARD_PARALLEL", "0")
    assert ShardParallelDispatcher(make_holder(1000, 8)).mode == "serial"


def _reshard_surface(client_pkg, ps_pkg):
    """One migration's calls from ``client_pkg``'s ``PsClient`` against
    ``ps_pkg``'s ``PsService`` (both on the native store): the replies,
    with the frozen age masked, and the drained and installed rows."""
    import importlib

    ps = importlib.import_module(f"{ps_pkg}.service.ps_service")
    cl = importlib.import_module(f"{client_pkg}.service.ps_service")
    rs = importlib.import_module(f"{client_pkg}.reshard")
    holders = importlib.import_module(f"{ps_pkg}.ps.native")
    with _serving(*[ps.PsService(holders.make_holder(100_000, 4))
                    for _ in range(2)]) as (donor, target):
        c, t = (cl.PsClient(s.addr, circuit_breaker=False,
                            routing_wire=True) for s in (donor, target))
        for x in (c, t):
            x.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1},
                        admit_probability=1.0, weight_bound=10.0)
            x.register_optimizer({"type": "sgd", "lr": 0.5, "wd": 0.0})
        signs = np.arange(1, 257, dtype=np.uint64)
        c.lookup(signs, 8, True)
        out = [c.reshard_begin([0, 1, 5], 8, epoch=2, fence=(2, 0),
                               mig_id="m")]
        blob, done = c.reshard_extract(1 << 20, fence=(2, 0))
        out += [done, t.reshard_install(blob, fence=(2, 0), mig_id="m")]
        c.update_gradients(signs[:16], np.ones((16, 8), np.float32), 8)
        drained = c.reshard_drain(fence=(2, 0))
        out.append(sorted((s, v.tobytes())
                          for s, _d, v in rs.unpack_rows(drained)))
        t.reshard_install(drained, fence=(2, 0))
        c.reshard_freeze(epoch=2, fence=(2, 0), mig_id="m")
        st = c.reshard_status(fence=(2, 0))
        st.pop("frozen_age_sec")
        out.append(st)
        for x in (c, t):
            x.set_routing_epoch(2)
        out += [c.reshard_finish(fence=(2, 0), mig_id="m"),
                c.reshard_status(), c.health()["routing_epoch"]]
        found, rows = t.get_entries(signs, 8)
        out += [found.tobytes(), rows[found].tobytes(), blob]
    return out


@pytest.mark.parametrize("client,server", [("persia_tpu", "persia_tpu_torch"),
                                           ("persia_tpu_torch", "persia_tpu")])
def test_reshard_surface_across_packages(client, server):
    """The PS's reshard surface answers a client of the other package as
    a server of the client's own does: the same snapshot, drain and
    install, the same fencing and status replies, the same rows on the
    target."""
    mixed = _reshard_surface(client, server)
    same = _reshard_surface(client, client)
    assert mixed == same
    assert mixed[0] > 0 and mixed[1] is True and mixed[2] == mixed[0]
    assert len(mixed[3]) > 0
    assert mixed[4]["frozen"] is True and mixed[4]["token"] == [2, 0]
    assert mixed[5]["was_active"] is True
    assert mixed[6]["active"] is False and mixed[7] == 2


# --- the coordinator --------------------------------------------------------


@pytest.mark.parametrize("client,server", [("jax", "port"),
                                           ("port", "jax")])
def test_coordinator_across_packages(client, server):
    from persia_tpu.service import coordinator as jco

    coord = (Coordinator() if server == "port" else jco.Coordinator())
    coord.server.serve_background()
    try:
        cli = (CoordinatorClient(coord.addr) if client == "port"
               else jco.CoordinatorClient(coord.addr))
        assert cli.ping()
        cli.register("embedding-parameter-server", 1, "h:2",
                     http_addr="h:9")
        cli.register("embedding-parameter-server", 0, "h:1")
        assert cli.wait_members("embedding-parameter-server", 2,
                                timeout=5) == ["h:1", "h:2"]
        assert cli.topology() == [
            {"role": "embedding-parameter-server", "replica": 0,
             "addr": "h:1", "http_addr": None},
            {"role": "embedding-parameter-server", "replica": 1,
             "addr": "h:2", "http_addr": "h:9"}]
        cli.register("embedding-parameter-server", 1, "h:3")
        assert cli.topology()[1]["http_addr"] is None
        cli.deregister("embedding-parameter-server", 0)
        assert cli.list("embedding-parameter-server") == ["h:3"]
        assert cli.kv_get("k") is None
        cli.kv_put("k", b"\x00v")
        assert cli.wait_kv("k", timeout=5) == b"\x00v"
        with pytest.raises(TimeoutError):
            cli.wait_members("embedding-worker", 1, timeout=0.2)
    finally:
        coord.server.stop()


# --- the worker over PS clients, and the worker service ---------------------


def _mixed_schema():
    slots = {
        "a": tcfg.SlotConfig(name="a", dim=4),
        "b": tcfg.SlotConfig(name="b", dim=8),
        "c": tcfg.SlotConfig(name="c", dim=16),
        "d": tcfg.SlotConfig(name="d", dim=8, embedding_summation=False,
                             sample_fixed_size=3),
        "e": tcfg.SlotConfig(name="e", dim=4, pooling="mean"),
    }
    return tcfg.EmbeddingSchema(slots_config=slots,
                                feature_index_prefix_bit=8)


def _summed_schema():
    return tcfg.EmbeddingSchema(slots_config=tcfg.uniform_slots(
        ["a", "b"], dim=8))


def _grads(rng, lookup):
    return {n: rng.standard_normal(r.embeddings.shape).astype(np.float32)
            for n, r in lookup.items()}


def _assert_lookup_equal(a, b):
    assert list(a) == list(b)
    for n in a:
        np.testing.assert_array_equal(a[n].embeddings, b[n].embeddings)
        if isinstance(b[n], RawEmbedding):
            np.testing.assert_array_equal(a[n].index, b[n].index)


def _rows(holders, tmp, tag):
    """Every row of each holder (or PsClient) by sign, through a PSD
    dump."""
    from persia_tpu_torch.checkpoint import iter_psd_entries

    out = []
    for i, h in enumerate(holders):
        path = os.fspath(tmp / f"{tag}_{i}.psd")
        h.dump_file(path)
        out.append({s: (d, v.tobytes()) for s, d, v in
                    iter_psd_entries(path)})
    return out


@pytest.mark.parametrize("streaming", [True, False])
def test_worker_over_ps_clients_equals_in_process(streaming, tmp_path):
    schema = _mixed_schema()
    with _serving(*_port_ps(2)) as svcs:
        clients = [PsClient(s.addr) for s in svcs]
        muxed = []
        for c in clients:
            inner = c.lookup_future

            def counted(*a, _inner=inner, **kw):
                muxed.append(1)
                return _inner(*a, **kw)

            c.lookup_future = counted
        remote = EmbeddingWorker(schema, clients, streaming=streaming)
        local = EmbeddingWorker(schema, [make_holder(100_000, 4)
                                         for _ in range(2)],
                                streaming=streaming)
        try:
            for w in (remote, local):
                w.configure_parameter_servers(*INIT)
                w.register_optimizer(ADAGRAD)
            rng = np.random.default_rng(11)
            for step in range(4):
                feats = _features("port", np.random.default_rng(step),
                                  list("abcde"), bs=8, vocab=300)
                rref, rout = remote.lookup_direct_training(feats)
                lref, lout = local.lookup_direct_training(feats)
                _assert_lookup_equal(rout, lout)
                grads = _grads(rng, lout)
                remote.update_gradients(rref, grads)
                local.update_gradients(lref, grads)
                _assert_lookup_equal(remote.lookup_direct(feats),
                                     local.lookup_direct(feats))
            assert remote.staleness == local.staleness == 0
            assert _rows(clients, tmp_path, "r") == _rows(
                local.ps_clients, tmp_path, "l")
            distinct = np.unique(np.concatenate([f.signs for f in feats]))
            np.testing.assert_array_equal(remote.lookup_signs(distinct, 8),
                                          local.lookup_signs(distinct, 8))
        finally:
            remote.close()
            local.close()
    # three dims a shard: the streaming plane multiplexes each shard's
    # groups on one connection; the serialized plane never does
    assert bool(muxed) == streaming


@pytest.mark.parametrize("client", ["jax", "port"])
def test_remote_worker_against_port_worker_service(client, tmp_path):
    """A remote worker of either package against the port's worker
    service over two port PS services: lookups, updates, the serving
    miss fetch, staleness and a dump loaded back all equal the in-process
    worker's."""
    schema = _mixed_schema()
    with _serving(*_port_ps(2)) as svcs:
        w = EmbeddingWorker(schema, [PsClient(s.addr) for s in svcs])
        ws = WorkerService(w)
        local = EmbeddingWorker(schema, [make_holder(100_000, 4)
                                         for _ in range(2)])
        with _serving(ws):
            if client == "jax":
                from persia_tpu.service.worker_service import (
                    RemoteEmbeddingWorker as JRemote,
                )

                rw = JRemote([ws.addr])
            else:
                rw = RemoteEmbeddingWorker([ws.addr])
            try:
                for x in (rw, local):
                    x.configure_parameter_servers(*INIT[:4])
                    x.register_optimizer(ADAGRAD)
                rng = np.random.default_rng(12)
                for step in range(3):
                    feats = _features(client, np.random.default_rng(step),
                                      list("abcde"), bs=8, vocab=300)
                    lfeats = _features("port", np.random.default_rng(step),
                                       list("abcde"), bs=8, vocab=300)
                    ref, out = rw.lookup_direct_training(feats)
                    assert ref[0] == ws.addr
                    lref, lout = local.lookup_direct_training(lfeats)
                    _assert_lookup_equal(out, lout)
                    grads = _grads(rng, lout)
                    rw.update_gradients(ref, grads)
                    local.update_gradients(lref, grads)
                _assert_lookup_equal(rw.lookup_direct(feats),
                                     local.lookup_direct(lfeats))
                distinct = np.unique(np.concatenate(
                    [f.signs for f in lfeats]))
                np.testing.assert_array_equal(
                    rw.lookup_signs(distinct, 8),
                    local.lookup_signs(distinct, 8))
                assert rw.staleness == 0 and rw.ready_for_serving()
                rw.dump(os.fspath(tmp_path / "ckpt"))
                before = _rows(w.ps_clients, tmp_path, "a")
                for c in w.ps_clients:
                    c.clear()
                rw.load(os.fspath(tmp_path / "ckpt"))
                assert _rows(w.ps_clients, tmp_path, "b") == before
                assert before == _rows(local.ps_clients, tmp_path, "l")
                assert ws._health()["staleness"] == 0
            finally:
                w.close()
                local.close()


# --- recovery ---------------------------------------------------------------


def _count_registrations(svc, calls):
    inner = svc.holder.register_optimizer

    def counted(*a, **kw):
        calls.append(svc.addr)
        return inner(*a, **kw)

    svc.holder.register_optimizer = counted


def _small_feats(seed):
    return _features("port", np.random.default_rng(seed), list("abc"),
                     bs=4, vocab=200)


def _ps_process(port, tmp, tag):
    """A PS service process bound to ``port`` (0: any), registering
    nowhere; returns (process, address)."""
    from persia_tpu_torch.utils import dump_yaml, wait_addr_file

    gc_path, addr_file = tmp / f"{tag}.yml", tmp / f"{tag}.addr"
    dump_yaml({"embedding_parameter_server_config": {
        "capacity": 100_000, "num_hashmap_internal_shards": 4}},
        os.fspath(gc_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "persia_tpu_torch.service.ps_service",
         "--port", str(port), "--addr-file", os.fspath(addr_file),
         "--coordinator", "", "--http-port", "-1",
         "--global-config", os.fspath(gc_path)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    try:
        return proc, wait_addr_file(os.fspath(addr_file), 120, proc)
    except BaseException:
        proc.kill()
        proc.wait(timeout=10)
        raise


@pytest.mark.parametrize("same_address", [True, False])
def test_restarted_ps_is_rearmed_and_a_healthy_one_is_not(same_address,
                                                          tmp_path):
    """Replica 0 is a process that is killed and started again blank, on
    its address (re-armed in place) or on another one (taken up from the
    resolver); replica 1 stays healthy and never takes an optimizer
    again."""
    schema = _mixed_schema()
    calls = []
    healthy = _port_ps(1)[0]
    _count_registrations(healthy, calls)
    procs = []
    with _serving(healthy):
        try:
            proc, addr0 = _ps_process(0, tmp_path, "first")
            procs.append(proc)
            current = {"addr0": addr0}

            def client(addr):
                c = PsClient(addr, circuit_breaker=False)
                c.client.max_retries = 1
                return c

            w = EmbeddingWorker(
                schema, [client(addr0), client(healthy.addr)],
                ps_resolver=None if same_address else lambda: [
                    client(current["addr0"]), w.ps_clients[1]])
            w.configure_parameter_servers(*INIT)
            w.register_optimizer(ADAGRAD)
            ref, out = w.lookup_direct_training(_small_feats(0))
            w.update_gradients(ref, _grads(np.random.default_rng(0), out))
            assert calls == [healthy.addr]
            proc.kill()
            proc.wait(timeout=10)
            port = int(addr0.rsplit(":", 1)[1]) if same_address else 0
            proc, addr = _ps_process(port, tmp_path, "second")
            procs.append(proc)
            current["addr0"] = addr
            assert (addr == addr0) == same_address
            assert not PsClient(addr).ready_for_serving()
            ref, out = w.lookup_direct_training(_small_feats(1))
            w.update_gradients(ref, _grads(np.random.default_rng(1), out))
            assert w.ps_clients[0].addr == addr
            assert PsClient(addr).ready_for_serving()
            assert len(PsClient(addr)) > 0 and w.staleness == 0
            # the healthy replica was never registered again
            assert calls == [healthy.addr]
            w.close()
        finally:
            for p in procs:
                p.kill()
                p.wait(timeout=10)


def test_retried_update_ships_only_unlanded_groups_after_a_new_client_list(
        tmp_path):
    """Shard 1's first gradient shipment fails on the connection; the
    worker takes the resolver's new clients and ships only the groups
    that had not landed: every row equals one clean update's."""
    schema = _mixed_schema()
    with _serving(*_port_ps(2)) as svcs:
        clients = [PsClient(s.addr, circuit_breaker=False) for s in svcs]
        failed = []
        inner = clients[1].update_gradients

        def flaky(*a, **kw):
            if not failed:
                failed.append(1)
                raise ConnectionError("shard 1 lost")
            return inner(*a, **kw)

        clients[1].update_gradients = flaky
        fresh = [PsClient(s.addr, circuit_breaker=False) for s in svcs]
        w = EmbeddingWorker(schema, clients, ps_resolver=lambda: fresh)
        local = EmbeddingWorker(schema, [make_holder(100_000, 4)
                                         for _ in range(2)])
        try:
            for x in (w, local):
                x.configure_parameter_servers(*INIT)
                x.register_optimizer(ADAGRAD)
            feats = _features("port", np.random.default_rng(3),
                              list("abcde"), bs=8, vocab=300)
            ref, out = w.lookup_direct_training(feats)
            lref, _ = local.lookup_direct_training(feats)
            grads = _grads(np.random.default_rng(9), out)
            w.update_gradients(ref, grads)
            local.update_gradients(lref, grads)
            assert failed and w.ps_clients == fresh
            assert _rows(fresh, tmp_path, "r") == _rows(local.ps_clients,
                                                         tmp_path, "l")
        finally:
            w.close()
            local.close()


# --- refusals ---------------------------------------------------------------


@pytest.mark.parametrize("kw,error,match", [pytest.param(*case, id=next(
    iter(case[0]))) for case in [
        # the native binaries are taken (no error): each replica starts
        # with the JAX package's command line
        ({"native_ps": True, "ps_capacity": 5000, "ps_num_shards": 3},
         None, "--capacity"),
        ({"native_worker": True}, None, "--forward-buffer-size"),
        # supervision is ported; what is refused is its pairing with a
        # native binary (a ValueError, as in the JAX package) ...
        ({"supervise_ps": True, "native_ps": True}, ValueError,
         "native_ps"),
        ({"supervise_workers": True, "native_worker": True}, ValueError,
         "native workers"),
        ({"supervise_trainer": True, "n_trainers": 0}, ValueError,
         "n_trainers"),
        # ... and the incremental-update replay of a restored PS is taken
        # (no error): a restart passes --replay-inc-dir
        ({"postmortem_dir": "pm", "ps_inc_dir": "inc"}, None,
         "--replay-inc-dir")]])
def test_service_ctx_refusals_name_item_9b(kw, error, match, tmp_path,
                                           monkeypatch):
    """The native binaries, once refused and now started with the JAX
    package's command lines (``service/helper.py:270-305``: the PS's
    capacity and shards, the worker's buffer flags from the global
    config), the JAX package's ValueError pairs, and ``ps_inc_dir``,
    which a PS's restore start passes on as the JAX supervisor does."""
    from persia_tpu_torch.service.helper import ServiceCtx
    from persia_tpu_torch.utils import dump_yaml

    monkeypatch.chdir(tmp_path)
    if error is not None:
        with pytest.raises(error, match=match):
            ServiceCtx(_mixed_schema(), **kw)
        return
    gc_path = os.fspath(tmp_path / "global.yml")
    dump_yaml({"embedding_worker_config": {
        "forward_buffer_size": 7, "buffered_data_expired_sec": 9}}, gc_path)
    # the C++ worker has no mean pooling: its schema sums every slot
    schema = (_summed_schema() if "native_worker" in kw
              else _mixed_schema())
    svc = ServiceCtx(schema, global_config_path=gc_path, **kw)
    svc.coordinator_addr = "127.0.0.1:1"
    if "native_ps" in kw or "native_worker" in kw:
        svc._binaries = {"persia-embedding-ps": "/bin/ps",
                         "persia-embedding-worker": "/bin/worker"}
        cmds = []
        monkeypatch.setattr(svc, "_spawn_raw", lambda cmd, name, i, n, **k:
                            cmds.append((cmd, name, i, n)))
        if "native_ps" in kw:
            svc._spawn_native_ps(1)
            assert cmds == [(["/bin/ps", "--replica-index", "1",
                              "--capacity", "5000", "--num-shards", "3",
                              "--coordinator", "127.0.0.1:1"], "ps-1", 1,
                             1)]
        else:
            svc._spawn_native_worker(0, "schema.yml")
            assert cmds == [(["/bin/worker", "--replica-index", "0",
                              "--embedding-config", "schema.yml",
                              "--coordinator", "127.0.0.1:1", "--num-ps",
                              "1", match, "7",
                              "--buffered-data-expired-sec", "9"],
                             "worker-0", 0, 1)]
        return
    spawned = []
    monkeypatch.setattr(svc, "_spawn", lambda args, *a, **k: spawned.append(
        args) or type("P", (), {})())
    svc._spawn_ps(1)
    svc._spawn_ps(1, restore=True)
    first, restart = spawned
    assert match not in first
    assert restart[restart.index(match) + 1] == "inc"
    assert restart[restart.index("--replica-index") + 1] == "1"


def _run_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


@pytest.mark.parametrize("case", ["train_inc", "infer_inc", "replay"])
def test_ps_service_refuses_the_incremental_tier(case, tmp_path,
                                                 monkeypatch):
    """The incremental-update tier of ``ps_service.main`` (once refused,
    now taken): a training job's replica dumps packets, an infer job's
    hot-loads them on a scanner thread, and ``--replay-inc-dir`` replays
    the replica's own packets over its checkpoint before it serves; each
    as the JAX ``main`` (``persia_tpu/service/ps_service.py:2036-2066``)."""
    from persia_tpu.inc_update import IncrementalUpdateDumper as JDumper
    from persia_tpu.ps.store import EmbeddingHolder as JHolder

    from persia_tpu_torch.inc_update import (
        IncrementalUpdateDumper,
        IncrementalUpdateLoader,
    )
    from persia_tpu_torch.rpc import RpcServer
    from persia_tpu_torch.service import ps_service
    from persia_tpu_torch.utils import dump_yaml

    inc = os.fspath(tmp_path / "inc")
    path = os.fspath(tmp_path / "global.yml")
    doc = {"embedding_parameter_server_config": {
        "capacity": 1000, "num_hashmap_internal_shards": 2,
        "enable_incremental_update": case != "replay",
        "incremental_buffer_size": 7, "incremental_dir": inc}}
    if case == "infer_inc":
        doc["common_config"] = {"job_type": "Infer"}
    dump_yaml(doc, path)
    # packets of replicas 0 and 1, dumped by the JAX package
    jh = JHolder(1000, 2)
    jh.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1})
    jh.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
    for r in (0, 1):
        signs = np.arange(1 + 10 * r, 6 + 10 * r, dtype=np.uint64)
        jh.lookup(signs, 4, True)
        d = JDumper(jh, inc, buffer_size=1, replica_index=r)
        d.commit(signs)
    served = []
    monkeypatch.setattr(RpcServer, "serve_forever",
                        lambda self: served.append(self))
    made = []

    class Recorded(ps_service.PsService):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(ps_service, "PsService", Recorded)
    argv = ["--global-config", path, "--coordinator", "",
            "--replica-index", "1"]
    if case == "replay":
        argv += ["--replay-inc-dir", inc]
    _run_main(ps_service, argv, monkeypatch)
    (svc,) = made
    try:
        assert served == [svc.server]
        if case == "train_inc":
            assert isinstance(svc.inc_dumper, IncrementalUpdateDumper)
            assert svc.inc_loader is None
            assert (svc.inc_dumper.buffer_size,
                    svc.inc_dumper.replica_index) == (7, 1)
            assert len(svc.holder) == 0
        elif case == "infer_inc":
            assert svc.inc_dumper is None
            assert isinstance(svc.inc_loader, IncrementalUpdateLoader)
            assert svc.inc_loader._thread.is_alive()
            assert svc.inc_loader.scan_once() == 10
            assert svc._health()["inc_update_packets_applied"] == 2
        else:
            assert svc.inc_dumper is None and svc.inc_loader is None
            assert svc.status == "Idle"
            # replica 1's packet alone
            assert sorted(svc.holder.get_entries(
                np.arange(1, 16, dtype=np.uint64), 4)[0].nonzero()[0]) \
                == list(range(10, 15))
            for s in range(11, 16):
                np.testing.assert_array_equal(
                    svc.holder.get_entry(s)[1], jh.get_entry(s)[1])
    finally:
        if svc.inc_loader is not None:
            svc.inc_loader.stop()
        svc.stop()
    # restore() without a checkpoint replays every replica's packets
    ps = PsService(make_holder(100, 1))
    assert ps.restore(None, inc) == 10
    assert ps.status == "Idle" and len(ps.holder) == 10
    ps.stop()


def test_routing_and_monitor_refusals_name_their_items(tmp_path,
                                                       monkeypatch):
    """Once refused, now taken: a routing table published over the wire
    (``apply_routing`` with the PS addresses, ``close_routing_window``),
    ``--enable-monitor``, the native binaries and the fleet monitor
    (built over the cluster's coordinator, not started)."""
    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service import worker_service
    from persia_tpu_torch.service.helper import ServiceCtx
    from persia_tpu_torch.worker import worker as worker_mod

    with _serving(*_port_ps(2)) as svcs:
        w = EmbeddingWorker(_mixed_schema(), [PsClient(svcs[0].addr)])
        with _serving(WorkerService(w)) as (ws,):
            rw = RemoteEmbeddingWorker([ws.addr])
            t = RoutingTable.uniform(1)
            t2 = t.derive(np.arange(t.num_slots) % 2, 2)
            assert rw.apply_routing(t2, ps_addrs=[s.addr for s in svcs])
            assert (rw.routing_epoch, w.routing_epoch, w.replica_size) \
                == (2, 2, 2)
            assert w.routing_window[1] is not None
            rw.close_routing_window()
            assert w.routing_window[1] is None
            assert rw._clients[ws.addr].call_msg(
                "apply_routing", table=t2.to_bytes()) == {
                    "applied": False, "epoch": 2}
        w.close()
    seen = {}

    class Stop(Exception):
        pass

    def fake_worker(*a, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(worker_mod, "EmbeddingWorker", fake_worker)
    schema_path = str(tmp_path / "schema.yml")
    from persia_tpu_torch.utils import dump_yaml
    from persia_tpu_torch.service.helper import _schema_to_yaml_dict

    dump_yaml(_schema_to_yaml_dict(_mixed_schema()), schema_path)
    with pytest.raises(Stop):
        _run_main(worker_service, ["--embedding-config", schema_path,
                                   "--ps-addrs", "127.0.0.1:1",
                                   "--enable-monitor"], monkeypatch)
    assert seen["enable_monitor"] is True
    assert seen["routing_fetch"] is None  # fixed addresses: no pull
    from persia_tpu_torch.fleet import FleetMonitor

    for kw in ({"native_ps": True}, {"native_worker": True}):
        svc = ServiceCtx(_summed_schema(), **kw)
        assert (svc.native_ps, svc.native_worker) == (
            "native_ps" in kw, "native_worker" in kw)
    svc = ServiceCtx(_mixed_schema())
    svc.coordinator_addr = "127.0.0.1:1"  # nothing listens: no target
    mon = svc.fleet_monitor(scrape_interval=0.5)
    assert isinstance(mon, FleetMonitor) and mon._thread is None
    assert (mon.coordinator_addr, mon.scrape_interval) == ("127.0.0.1:1",
                                                           0.5)
    assert mon.targets() == []


def test_device_cache_refuses_a_remote_worker():
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models.dlrm import DLRM
    from persia_tpu_torch.workloads import generator as gen

    schema = tcfg.EmbeddingSchema(slots_config=tcfg.uniform_slots(
        [f"slot_{i}" for i in range(26)], dim=16))
    rw = RemoteEmbeddingWorker(["127.0.0.1:1"])
    rw.schema = schema
    model = DLRM(13, 26, device="cpu")
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters()),
                   Adagrad(lr=1e-2), schema, rw, device="cpu",
                   device_cache_capacity=64)
    batch = next(iter(gen.hybrid_bench_batches(1, 8)))
    with pytest.raises(NotImplementedError, match="in-process"):
        ctx._ensure_cache(batch)


# --- the slice through subprocesses -----------------------------------------

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


def _global_config(tmp):
    from persia_tpu_torch.utils import dump_yaml

    path = os.fspath(tmp / "global_config.yml")
    dump_yaml({"embedding_parameter_server_config": {
        "capacity": 100_000, "num_hashmap_internal_shards": 4}}, path)
    return path


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from persia_tpu_torch.service.helper import ServiceCtx

    path = _global_config(tmp_path_factory.mktemp("svc"))
    with ServiceCtx(_seq_schema(tcfg), n_workers=1, n_ps=2,
                    global_config_path=path, startup_timeout=240) as svc:
        yield svc


def _fresh(cluster):
    """The cluster's PS replicas cleared, and a remote worker on it."""
    for a in cluster.ps_addrs:
        PsClient(a).clear()
    return cluster.remote_worker()


def _seq_ctx(worker, device="cpu", seed=3, jparams=None,
             attn_impl="flash"):
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import SequenceTower

    model = SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                          attn_impl=attn_impl, device=device,
                          compute_dtype=torch.float32)
    if jparams is not None:
        from persia_tpu_torch.weights import load_flax_params, numpy_tree

        load_flax_params(model, numpy_tree(jparams))
        seed = None
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                    Adagrad(lr=1e-2), _seq_schema(tcfg), worker, seed=seed,
                    embedding_config=EmbeddingConfig(
                        emb_initialization=(-0.05, 0.05)),
                    global_config=tcfg.GlobalConfig(tcfg.CommonConfig("f32")),
                    device=device)


def _local_worker():
    return EmbeddingWorker(_seq_schema(tcfg), [make_holder(100_000, 4)
                                              for _ in range(2)])


def _train(ctx, n, seed=9):
    out = []
    with ctx:
        for b in tgen.seqrec_batches(n * BS, BS, seed=seed,
                                     spec=tgen.SeqRecSpec(**SPEC)):
            loss, pred = ctx.train_step(b)
            out.append((float(loss), pred.detach().cpu().numpy()))
    return out


def _dense_state(ctx):
    params = {k: v.detach().cpu().numpy()
              for k, v in ctx.model.state_dict().items()}
    opt = [(k, t.detach().cpu().numpy()) for st in
           ctx.dense_optimizer.state_dict()["state"].values()
           for k, t in sorted(st.items()) if torch.is_tensor(t)]
    return params, opt


def _assert_runs_equal(a, b):
    assert len(a) == len(b)
    for (la, pa), (lb, pb) in zip(a, b):
        assert la == lb
        np.testing.assert_array_equal(pa, pb)


def test_service_training_equals_in_process(cluster, deterministic_torch,
                                            tmp_path):
    svc_ctx = _seq_ctx(_fresh(cluster))
    loc_ctx = _seq_ctx(_local_worker())
    try:
        _assert_runs_equal(_train(svc_ctx, 4), _train(loc_ctx, 4))
        (pa, oa), (pb, ob) = _dense_state(svc_ctx), _dense_state(loc_ctx)
        assert pa.keys() == pb.keys() and len(oa) == len(ob) > 0
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
        for (ka, a), (kb, b) in zip(oa, ob):
            assert ka == kb
            np.testing.assert_array_equal(a, b)
        clients = [PsClient(a) for a in cluster.ps_addrs]
        rows = _rows(clients, tmp_path, "svc")
        assert rows == _rows(loc_ctx.worker.ps_clients, tmp_path, "loc")
        assert all(len(r) > 0 for r in rows)
        assert svc_ctx.worker.staleness == 0
    finally:
        loc_ctx.worker.close()


def test_service_training_matches_jax(cluster, monkeypatch, tmp_path):
    """The same run against the JAX package's in-process TrainCtx from
    transplanted weights: f32 within 1e-5, parameters within 2e-5 (the
    JAX middleware on its numpy path, as in tests/test_torch_train.py)."""
    import jax.numpy as jnp
    import optax

    from persia_tpu import config as jcfg
    from persia_tpu.ctx import TrainCtx as JTrainCtx
    from persia_tpu.embedding import EmbeddingConfig as JEC
    from persia_tpu.embedding.optim import Adagrad as JAdagrad
    from persia_tpu.models import SequenceTower as JTower
    from persia_tpu.parallel.train import TrainState
    from persia_tpu.ps.store import EmbeddingHolder
    from persia_tpu.serving import build_state_template
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker
    from persia_tpu.worker import middleware as jmw
    from persia_tpu.workloads import generator as jgen
    from persia_tpu_torch.weights import flax_params

    monkeypatch.setattr(jmw, "_mw_native", lambda: None)
    jschema = _seq_schema(jcfg)
    jmodel = JTower(num_heads=HEADS, attn_impl="pallas",
                    compute_dtype=jnp.float32)
    params = build_state_template(jmodel, jschema, NUM_DENSE, seed=5).params
    adam = optax.adam(1e-3)
    gc = jcfg.GlobalConfig()
    gc.common.embedding_wire_dtype = "f32"
    jworker = JWorker(jschema, [EmbeddingHolder(100_000, 4)
                                for _ in range(2)])
    jctx = JTrainCtx(model=jmodel, dense_optimizer=adam,
                     embedding_optimizer=JAdagrad(lr=1e-2), schema=jschema,
                     worker=jworker, global_config=gc,
                     embedding_config=JEC(emb_initialization=(-0.05, 0.05)))
    jctx.state = TrainState(params=params, batch_stats={},
                            opt_state=adam.init(params),
                            step=jnp.zeros((), jnp.int32))
    tctx = _seq_ctx(_fresh(cluster), jparams=params)
    try:
        got = _train(tctx, 3, seed=7)
        want = []
        with jctx:
            for b in jgen.seqrec_batches(3 * BS, BS, seed=7,
                                         spec=jgen.SeqRecSpec(**SPEC)):
                loss, pred = jctx.train_step(b)
                want.append((float(loss), np.asarray(pred)))
        for (tl, tp), (jl, jp) in zip(got, want):
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)

        def flat(tree, prefix=""):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out.update(flat(v, f"{prefix}{k}/"))
                else:
                    out[prefix + k] = np.asarray(v, np.float32)
            return out

        a, b = flat(flax_params(tctx.model)[0]), flat(jctx.state.params)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-5,
                                       err_msg=k)
        clients = [PsClient(x) for x in cluster.ps_addrs]
        for jh, c, rows in zip(jworker.ps_clients, clients,
                               _rows(clients, tmp_path, "svc")):
            signs = np.array(sorted(rows), np.uint64)
            assert len(jh) == len(signs) > 0
            (fa, va), (fb, vb) = (c.get_entries(signs, 2 * DIM),
                                  jh.get_entries(signs, 2 * DIM))
            assert fa.all() and fb.all()
            np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-5)
    finally:
        jworker.close()


def test_checkpoint_over_rpc_loads_back_equal(cluster, tmp_path):
    ctx = _seq_ctx(_fresh(cluster))
    _train(ctx, 2)
    clients = [PsClient(a) for a in cluster.ps_addrs]
    before = _rows(clients, tmp_path, "before")
    dense = _dense_state(ctx)[0]
    ctx.dump_checkpoint(os.fspath(tmp_path / "ckpt"))
    _train(ctx, 2, seed=21)
    assert _rows(clients, tmp_path, "moved") != before
    ctx.load_checkpoint(os.fspath(tmp_path / "ckpt"))
    assert _rows(clients, tmp_path, "after") == before
    for k, v in _dense_state(ctx)[0].items():
        np.testing.assert_array_equal(v, dense[k])


def test_remote_serving_equals_in_process_over_the_same_ps(cluster):
    """``InferenceServer(worker_addrs=)`` dials the worker tier; its
    predictions equal an in-process server whose worker reads the same PS
    processes through PsClients."""
    from persia_tpu_torch.serving import InferenceClient, InferenceServer

    ctx = _seq_ctx(_fresh(cluster))
    _train(ctx, 2)
    schema = _seq_schema(tcfg)
    local = EmbeddingWorker(schema, [PsClient(a) for a in cluster.ps_addrs])
    remote = InferenceServer(ctx.model, schema,
                             worker_addrs=cluster.worker_addrs,
                             device="cpu")
    inproc = InferenceServer(ctx.model, schema, local, device="cpu")
    remote.serve_background()
    try:
        client = InferenceClient(remote.addr)
        for b in tgen.seqrec_batches(3 * BS, BS, seed=33,
                                     spec=tgen.SeqRecSpec(**SPEC),
                                     requires_grad=False):
            got = client.predict(b)
            np.testing.assert_array_equal(got, inproc.predict(b))
            assert got.shape == (BS, 1) and np.isfinite(got).all()
    finally:
        remote.stop()
        inproc.stop()
        local.close()


def test_crash_detection():
    """A PS child killed: the monitor tears the group down and names it."""
    from persia_tpu_torch.service.helper import ServiceCtx

    with ServiceCtx(_mixed_schema(), n_workers=1, n_ps=1,
                    startup_timeout=240) as svc:
        pids = [p.pid for p in svc.procs]
        ps = next(p for p in svc.procs if p._persia_name == "ps-0")
        ps.kill()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not svc.crashed:
            time.sleep(0.1)
        assert svc.crashed and svc.crashed[0].startswith("ps-0")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(
                p.poll() is None for p in svc.procs):
            time.sleep(0.1)
        assert all(p.poll() is not None for p in svc.procs)
    assert len(pids) == 3


@pytest.mark.gpu
def test_service_training_matches_in_process_on_the_card(tmp_path):
    """3 steps of seq_rec over a ServiceCtx on the card equal the
    in-process run bit for bit, through K2, K3 and K4 once a step each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.service.helper import ServiceCtx

    torch.backends.cuda.matmul.allow_tf32 = False
    with ServiceCtx(_seq_schema(tcfg), n_workers=1, n_ps=2,
                    global_config_path=_global_config(tmp_path),
                    startup_timeout=240) as svc:
        svc_ctx = _seq_ctx(svc.remote_worker(), device="cuda")
        loc_ctx = _seq_ctx(_local_worker(), device="cuda")
        fa.reset_launch_count()
        got = _train(svc_ctx, 3)
        counts = [fa.launch_count(n) for n in (
            fa.FWD_KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL)]
        _assert_runs_equal(got, _train(loc_ctx, 3))
        assert counts == [3, 3, 3]
        clients = [PsClient(a) for a in svc.ps_addrs]
        assert _rows(clients, tmp_path, "svc") == _rows(
            loc_ctx.worker.ps_clients, tmp_path, "loc")
        loc_ctx.worker.close()
