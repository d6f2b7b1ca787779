"""The port's RPC wire against the JAX package's, on the CPU.

- The port's MessagePack codec (``persia_tpu_torch._msgpack``) against
  ``msgpack.packb(obj, use_bin_type=True)`` / ``unpackb(raw=False)``, byte
  for byte both ways: hypothesis over the subset the wire uses, and fixed
  cases at every size boundary.
- ``tests/test_rpc.py``'s cases against the port's ``RpcServer`` /
  ``RpcClient``; the retry ladders run on injected sleeps, not real
  backoff.
- Cross-package on loopback: a JAX ``RpcClient`` against the port's
  ``RpcServer`` and the port's client against a JAX server, with every
  envelope extension negotiated on, and each one refused by the server.
- Frame bytes: ``_send_msg`` of both packages over a ``socketpair``.
- The stated difference: a zstd-compressed frame is refused when
  ``zstandard`` is not installed.

Every socket binds port 0 on 127.0.0.1; every wait is bounded.
"""

import socket
import threading
import time

import msgpack
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from persia_tpu import rpc as jrpc
from persia_tpu import tracing as jtracing
from persia_tpu_torch import _msgpack
from persia_tpu_torch import rpc as trpc
from persia_tpu_torch import tracing as ttracing
from persia_tpu_torch.rpc import (
    RpcClient,
    RpcError,
    RpcServer,
    pack_arrays,
    unpack_arrays,
)

# --- the codec -------------------------------------------------------------


def _ref_pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _ref_unpack(buf):
    return msgpack.unpackb(buf, raw=False)


_keys = st.one_of(st.text(max_size=40), st.binary(max_size=40))
_scalars = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1),
    st.floats(allow_nan=False), st.text(max_size=300),
    st.binary(max_size=300))
_values = st.recursive(
    _scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.tuples(inner, inner),
        st.dictionaries(_keys, inner, max_size=20)),
    max_leaves=60)


def _as_read(obj):
    """What unpackb returns for ``obj``: tuples read back as lists."""
    if isinstance(obj, (list, tuple)):
        return [_as_read(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _as_read(v) for k, v in obj.items()}
    return obj


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_values)
def test_codec_equals_msgpack_on_the_subset(obj):
    packed = _ref_pack(obj)
    assert _msgpack.packb(obj) == packed
    assert _msgpack.unpackb(packed) == _ref_unpack(packed) == _as_read(obj)
    assert _msgpack.unpackb(memoryview(packed)) == _as_read(obj)


@settings(max_examples=100, deadline=None)
@given(st.floats(allow_nan=True, width=32))
def test_codec_reads_float32_as_msgpack(x):
    packed = msgpack.packb(x, use_single_float=True)
    got, want = _msgpack.unpackb(packed), _ref_unpack(packed)
    assert got == want or (got != got and want != want)


def _boundaries():
    cases = [None, True, False, 0.0, -2.5, float("inf")]
    # fixint / uint8 / uint16 / uint32 / uint64, and the negative side
    for edge in (0x7F, 0xFF, 0xFFFF, 0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF):
        cases += [edge, edge + 1] if edge < 0xFFFFFFFFFFFFFFFF else [edge]
    for edge in (-0x20, -0x80, -0x8000, -0x80000000, -0x8000000000000000):
        cases += [edge, edge - 1] if edge > -0x8000000000000000 else [edge]
    # fixstr / str8 / str16 / str32 (lengths in utf-8 bytes)
    for n in (0, 31, 32, 0xFF, 0x100, 0xFFFF, 0x10000):
        cases.append("s" * n)
    cases.append("é" * 16)  # 32 utf-8 bytes: str8, not fixstr
    # bin8 / bin16 / bin32, from every bytes-like type the wire sends
    for n in (0, 0xFF, 0x100, 0xFFFF, 0x10000):
        cases.append(b"b" * n)
    cases += [bytearray(b"ba"), memoryview(b"mv")]
    # fixarray / array16 / array32, and tuples as arrays
    for n in (0, 15, 16, 0xFFFF, 0x10000):
        cases.append(list(range(n % 7)) * (n // 7) + list(range(n % 7)))
    cases.append((1, "two", b"3"))
    # fixmap / map16 / map32, in insertion order
    for n in (0, 15, 16, 0xFFFF, 0x10000):
        cases.append({f"k{i}": i for i in range(n)})
    cases.append({b"bin": 1, "str": [None]})
    return cases


@pytest.mark.parametrize("obj", _boundaries(),
                         ids=lambda o: f"{type(o).__name__}-"
                         f"{len(o) if hasattr(o, '__len__') else o}")
def test_codec_size_boundaries(obj):
    packed = _ref_pack(obj)
    assert _msgpack.packb(obj) == packed
    assert _msgpack.unpackb(packed) == _ref_unpack(packed)


def test_codec_refuses_what_msgpack_refuses():
    for bad in (1 << 64, -(1 << 63) - 1):
        with pytest.raises(OverflowError):
            _msgpack.packb(bad)
        with pytest.raises(OverflowError):
            _ref_pack(bad)
    with pytest.raises(TypeError):
        _msgpack.packb({1, 2})
    with pytest.raises(TypeError):
        _msgpack.packb(np.int64(3))  # msgpack refuses numpy ints too
    for raw in (_ref_pack({1: 2}), _ref_pack({None: 1})):
        with pytest.raises(ValueError, match="strict_map_key"):
            _msgpack.unpackb(raw)
        with pytest.raises(ValueError):
            _ref_unpack(raw)
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(_ref_pack(1) + b"\x01")
    for cut in (_ref_pack("abc")[:-1], _ref_pack([1, 2])[:-1], b"\xcd\x01",
                b""):
        with pytest.raises(ValueError, match="incomplete"):
            _msgpack.unpackb(cut)
    with pytest.raises(ValueError, match="unsupported"):
        _msgpack.unpackb(b"\xd4\x01\x00")  # fixext1


# --- tests/test_rpc.py against the port -------------------------------------


def test_roundtrip_and_compression():
    srv = RpcServer()
    srv.register("echo", lambda p: p)
    srv.serve_background()
    try:
        c = RpcClient(srv.addr)
        small = b"x" * 10
        big = b"y" * 500_000
        assert c.call("echo", small) == small
        assert c.call("echo", big) == big
        c.close()
    finally:
        srv.stop()


def test_array_framing_zero_copy():
    meta = {"dim": 7, "training": True}
    arrays = [np.arange(10, dtype=np.uint64),
              np.random.default_rng(0).normal(size=(4, 7)).astype(np.float32)]
    m2, a2 = unpack_arrays(pack_arrays(meta, arrays))
    assert m2 == meta
    for a, b in zip(arrays, a2):
        np.testing.assert_array_equal(a, b)
    # the scatter list carries the same bytes, and both equal the JAX ones
    sg = b"".join(bytes(b) for b in trpc.pack_arrays_sg(meta, arrays))
    assert sg == pack_arrays(meta, arrays) == jrpc.pack_arrays(meta, arrays)
    m3, a3 = jrpc.unpack_arrays(sg)
    assert m3 == meta and all(np.array_equal(a, b)
                              for a, b in zip(arrays, a3))


def test_application_error_no_retry():
    srv = RpcServer()
    calls = []

    def boom(p):
        calls.append(1)
        raise ValueError("nope")

    srv.register("boom", boom)
    srv.serve_background()
    try:
        c = RpcClient(srv.addr)
        with pytest.raises(RpcError, match="nope"):
            c.call("boom")
        assert len(calls) == 1
        c.close()
    finally:
        srv.stop()


def test_reconnect_after_server_restart():
    """The client's retry ladder bridges a restart; the restart happens
    inside the injected sleep, so no real backoff is slept."""
    srv = RpcServer()
    srv.register("ping", lambda p: b"1")
    srv.serve_background()
    host, port = srv.addr.rsplit(":", 1)
    c = RpcClient(srv.addr, retry_backoff=0.1)
    assert c.call("ping") == b"1"
    srv.stop()
    c.close()
    restarted = []

    def sleep_then_restart(delay):
        if not restarted:
            srv2 = RpcServer(host, int(port))
            srv2.register("ping", lambda p: b"2")
            srv2.serve_background()
            restarted.append(srv2)

    c._retry_sleep = sleep_then_restart
    try:
        assert c.call("ping") == b"2"
        assert len(restarted) == 1
    finally:
        c.close()
        for s in restarted:
            s.stop()


def test_exhausted_retries_raise():
    srv = RpcServer()
    addr = srv.addr
    srv.stop()
    c = RpcClient(addr, max_retries=1, retry_backoff=0.05)
    sleeps = []
    c._retry_sleep = sleeps.append
    with pytest.raises(OSError):
        c.call("ping")
    assert len(sleeps) == 1


def _raw_conn(addr):
    host, port = addr.rsplit(":", 1)
    return socket.create_connection((host, int(port)), timeout=30)


def test_rpc_request_dedup_at_most_once():
    calls = []
    server = RpcServer()
    server.register(
        "bump", lambda p: (calls.append(1), b"%d" % len(calls))[1])
    server.serve_background()
    try:
        with _raw_conn(server.addr) as conn:
            req_id = b"x" * 12
            trpc._send_msg(conn, ["bump", req_id], b"", False)
            env1, r1 = trpc._recv_msg(conn)
            trpc._send_msg(conn, ["bump", req_id], b"", False)
            env2, r2 = trpc._recv_msg(conn)
            assert env1[0] == env2[0] == "ok"
            assert r1 == r2 == b"1"
            assert len(calls) == 1
            trpc._send_msg(conn, ["bump", b"y" * 12], b"", False)
            _, r3 = trpc._recv_msg(conn)
            assert r3 == b"2" and len(calls) == 2
    finally:
        server.stop()


@pytest.mark.parametrize("streams", [1, 8])
def test_call_many_pipelined_in_order(streams):
    srv = RpcServer(concurrent_streams=streams)
    srv.register("echo", lambda p: p)
    srv.serve_background()
    try:
        c = RpcClient(srv.addr)
        payloads = [b"m%03d" % i for i in range(40)]
        assert c.call_many("echo", payloads, window=8) == payloads
        assert c.call("echo", b"tail") == b"tail"
        c.close()
    finally:
        srv.stop()


def test_concurrent_streams_ordering_under_skew():
    """Read-ahead executes requests concurrently: a slow first request
    holds no fast one back on a tagged connection, and results still
    come back in request order."""
    srv = RpcServer(concurrent_streams=8)
    release = threading.Event()
    done_order = []

    def handler(p):
        if p == b"slow":
            release.wait(timeout=10)
        done_order.append(bytes(p))
        if len(done_order) == 10:
            release.set()  # every fast request finished while slow waited
        return p

    srv.register("work", handler)
    srv.serve_background()
    try:
        c = RpcClient(srv.addr)
        payloads = [b"slow"] + [b"f%d" % i for i in range(10)]
        assert c.call_many("work", payloads, window=16) == payloads
        assert done_order[-1] == b"slow"
        c.close()
    finally:
        srv.stop()


def test_call_many_app_error_keeps_connection_in_sync():
    srv = RpcServer(concurrent_streams=4)

    def maybe(p):
        if p == b"bad":
            raise ValueError("poisoned")
        return p

    srv.register("maybe", maybe)
    srv.serve_background()
    try:
        c = RpcClient(srv.addr)
        with pytest.raises(RpcError, match="poisoned"):
            c.call_many("maybe", [b"a", b"bad", b"c", b"d"], window=4)
        assert c.call("maybe", b"after") == b"after"
        assert c.call_many("maybe", [b"x", b"y"]) == [b"x", b"y"]
        c.close()
    finally:
        srv.stop()


def test_concurrent_streams_error_and_dedup_still_work():
    calls = []
    srv = RpcServer(concurrent_streams=4)
    srv.register("bump", lambda p: (calls.append(1), b"%d" % len(calls))[1])
    srv.register("boom", lambda p: (_ for _ in ()).throw(ValueError("no")))
    srv.serve_background()
    try:
        c = RpcClient(srv.addr)
        with pytest.raises(RpcError, match="no"):
            c.call("boom")
        c.close()
        with _raw_conn(srv.addr) as conn:
            rid = b"z" * 12
            trpc._send_msg(conn, ["bump", rid], b"", False)
            trpc._send_msg(conn, ["bump", rid], b"", False)
            _, r1 = trpc._recv_msg(conn)
            _, r2 = trpc._recv_msg(conn)
            assert r1 == r2 == b"1" and len(calls) == 1
    finally:
        srv.stop()


def test_dedup_concurrent_duplicate_waits_for_inflight():
    calls = []
    entered = threading.Event()
    release = threading.Event()

    def slow_handler(payload):
        calls.append(bytes(payload))
        entered.set()
        release.wait(timeout=10)
        return b"result-%d" % len(calls)

    server = RpcServer()
    server.register("slow", slow_handler)
    server.serve_background()
    results = []

    def raw_call():
        with _raw_conn(server.addr) as conn:
            trpc._send_msg(conn, ["slow", b"x" * 12], b"p", False)
            env, payload = trpc._recv_msg(conn)
            assert env[0] == "ok"
            results.append(bytes(payload))

    try:
        t1 = threading.Thread(target=raw_call)
        t1.start()
        assert entered.wait(timeout=10)  # first delivery is in flight
        t2 = threading.Thread(target=raw_call)
        t2.start()
        time.sleep(0.2)  # the duplicate arrives and parks on the id
        release.set()
        t1.join(timeout=15)
        t2.join(timeout=15)
        assert not t1.is_alive() and not t2.is_alive()
        assert len(calls) == 1
        assert results == [b"result-1", b"result-1"]
    finally:
        server.stop()


def test_decorrelated_jitter_bounds_and_spread():
    base, cap = 0.2, 5.0
    for r in (0.0, 0.25, 0.9999):
        for prev in (0.0, base, 1.7, 100.0):
            d = trpc.decorrelated_jitter(base, cap, prev, rand=lambda r=r: r)
            assert base <= d <= cap, (r, prev, d)
            assert d == jrpc.decorrelated_jitter(base, cap, prev,
                                                 rand=lambda r=r: r)
    d_small = trpc.decorrelated_jitter(base, cap, 0.3, rand=lambda: 0.5)
    d_large = trpc.decorrelated_jitter(base, cap, 1.2, rand=lambda: 0.5)
    assert d_small != d_large
    assert d_small == pytest.approx(base + 0.5 * (0.9 - base))
    assert trpc.decorrelated_jitter(base, cap, 1e9, rand=lambda: 1.0) == cap
    assert trpc.decorrelated_jitter(base, cap, 0.0, rand=lambda: 0.0) == base


def test_retry_budget_fake_clock():
    now = [100.0]
    b = trpc.RetryBudget(capacity=3.0, refill_per_sec=2.0,
                         clock=lambda: now[0])
    assert b.acquire() and b.acquire() and b.acquire()
    assert not b.acquire()
    now[0] += 1.0
    assert b.acquire()
    assert b.acquire()
    assert not b.acquire()
    now[0] += 10.0
    assert b.tokens == pytest.approx(3.0)


def test_retry_ladder_spends_budget_and_jitters():
    with socket.socket() as s:  # a port nobody listens on
        s.bind(("127.0.0.1", 0))
        dead_addr = "127.0.0.1:%d" % s.getsockname()[1]
    now = [0.0]
    budget = trpc.RetryBudget(capacity=2.0, refill_per_sec=0.0,
                              clock=lambda: now[0])
    c = RpcClient(dead_addr, max_retries=10, retry_backoff=0.2,
                  retry_budget=budget)
    sleeps = []
    c._retry_sleep = sleeps.append
    c._retry_rand = lambda: 0.5
    with pytest.raises((RpcError, ConnectionError, OSError)):
        c.call("ping", b"")
    assert len(sleeps) == 2
    assert budget.tokens == 0.0
    d0 = trpc.decorrelated_jitter(0.2, 5.0, 0.2, rand=lambda: 0.5)
    d1 = trpc.decorrelated_jitter(0.2, 5.0, d0, rand=lambda: 0.5)
    assert sleeps == [pytest.approx(d0), pytest.approx(d1)]


def test_circuit_breaker_opens_and_probe_recloses():
    """Threshold failures open the breaker; the probe (a fake, run on
    the breaker's thread with an injected sleep) arms the half-open
    trial, whose success closes it."""
    probe_ok = threading.Event()
    br = trpc.CircuitBreaker(threshold=2, cooldown=1e9,
                             probe=probe_ok.is_set, probe_interval=0.01)
    br._sleep = lambda s: probe_ok.wait(timeout=5)
    assert br.allow()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    probe_ok.set()
    br._probe_thread.join(timeout=5)
    assert not br._probe_thread.is_alive()
    assert br.state == "half_open"
    assert br.allow() and not br.allow()  # one trial at a time
    br.record_success()
    assert br.state == "closed"


def test_typed_errors_match_the_jax_mapping():
    for msg in ("RpcDeadlineExceeded: late", "ConnectionResetError: x",
                "TimeoutError: y", "ValueError: z", "OSError: disk"):
        t = trpc._typed_call_error("a:1", "m", msg)
        j = jrpc._typed_call_error("a:1", "m", msg)
        assert type(t).__name__ == type(j).__name__ and str(t) == str(j)
    assert issubclass(trpc.RpcCircuitOpen, ConnectionError)
    assert issubclass(trpc.RpcTimeout, TimeoutError)


def test_unknown_dunder_method_refused():
    srv = RpcServer()
    try:
        with pytest.raises(ValueError, match="wire extension"):
            srv.register("__nope__", lambda p: p)
        assert set(trpc.ENVELOPE_EXTENSIONS) == set(jrpc.ENVELOPE_EXTENSIONS)
    finally:
        srv.stop()


# --- cross-package on loopback ----------------------------------------------

# server kwargs: every extension on, then each refused in turn
_EXTENSIONS = [{}, {"enable_tags": False}, {"enable_trace": False},
               {"enable_deadline": False}, {"enable_codec": False}]


@pytest.fixture
def both_traced():
    """Tracing on in both packages for one test (the client probes
    ``__trace__`` only when its process traces), restored after."""
    was = (jtracing.tracing_enabled(), ttracing.tracing_enabled())
    jtracing.enable_tracing(True)
    ttracing.enable_tracing(True)
    jtracing.default_collector().clear()
    ttracing.default_collector().clear()
    try:
        yield
    finally:
        jtracing.enable_tracing(was[0])
        ttracing.enable_tracing(was[1])


@pytest.fixture
def force_block(monkeypatch):
    """Block compression on loopback in both packages (the frozen
    ``PERSIA_RPC_FORCE_BLOCK`` knob)."""
    monkeypatch.setattr(jrpc, "_FORCE_BLOCK", True)
    monkeypatch.setattr(trpc, "_FORCE_BLOCK", True)


@pytest.mark.parametrize("server_kw", _EXTENSIONS,
                         ids=lambda kw: ",".join(kw) or "all-on")
@pytest.mark.parametrize("direction", ["jax-client->port-server",
                                       "port-client->jax-server"])
def test_cross_package_rpc(direction, server_kw, both_traced, force_block):
    if direction == "jax-client->port-server":
        srv_mod, cl_mod, srv_tracing, cl_tracing = (trpc, jrpc, ttracing,
                                                    jtracing)
    else:
        srv_mod, cl_mod, srv_tracing, cl_tracing = (jrpc, trpc, jtracing,
                                                    ttracing)
    srv = srv_mod.RpcServer(concurrent_streams=4, **server_kw)
    seen = []

    def echo(p):
        seen.append(srv_tracing.current_context())
        return p

    srv.register("echo", echo)
    srv.register("late", lambda p: b"never")
    srv.serve_background()
    big = bytes(range(256)) * 1024  # compressible, above the block floor
    try:
        c = cl_mod.RpcClient(srv.addr, deadline=30.0, enable_codec=True)
        with cl_tracing.span("client/root") as root:
            assert c.call("echo", b"x") == b"x"
            assert c.call("echo", big) == big
            assert c.call_many("echo", [b"a", b"b", big]) == [b"a", b"b",
                                                              big]
            futs = [c.call_future("echo", bytes([i])) for i in range(3)]
            assert [f.result() for f in futs] == [bytes([i])
                                                 for i in range(3)]
        cs = c._conn()
        assert cs.tagged == server_kw.get("enable_tags", True)
        assert cs.trace == server_kw.get("enable_trace", True)
        assert cs.deadline == server_kw.get("enable_deadline", True)
        assert cs.codec == server_kw.get("enable_codec", True)
        assert cs.block == ("zlib" if cs.codec else None)
        # the handler ran under a child of the client's span when the
        # trace slot was negotiated, and under no span otherwise
        if cs.trace:
            assert {ctx[0] for ctx in seen} == {root.trace_id}
        else:
            assert seen == [None] * len(seen)
        # a spent deadline is shed by the server when the slot exists
        if cs.deadline:
            with pytest.raises(cl_mod.RpcDeadlineExceeded):
                c.call("late", b"", deadline=-1.0)
        # plain dict calls (the codec both ways) and app errors
        with pytest.raises(cl_mod.RpcError, match="no such method"):
            c.call_msg("missing", a=1)
        c.close()
    finally:
        srv.stop()


def test_cross_package_untraced_wire_counts_no_probe():
    """With tracing off and no deadline or codec, a client of either
    package sends exactly its calls: no probe reaches the server."""
    assert not jtracing.tracing_enabled() and not ttracing.tracing_enabled()
    for srv_mod, cl_mod in ((trpc, jrpc), (jrpc, trpc)):
        srv = srv_mod.RpcServer()
        srv.register("echo", lambda p: p)
        srv.serve_background()
        try:
            c = cl_mod.RpcClient(srv.addr, enable_tags=False)
            assert c.call("echo", b"z") == b"z"
            assert srv.health()["served_rpcs"] == 1
            c.close()
        finally:
            srv.stop()


# --- frame bytes ------------------------------------------------------------


def _frame_bytes(mod, envelope, payload, **kw) -> bytes:
    """The bytes ``mod._send_msg`` writes for one frame (sent from a
    thread: a large frame outgrows the socket buffer)."""
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(30)
        err = []

        def send():
            try:
                mod._send_msg(a, list(envelope), payload, **kw)
            except OSError as e:
                err.append(e)
            finally:
                a.shutdown(socket.SHUT_WR)

        t = threading.Thread(target=send)
        t.start()
        chunks = []
        while True:
            chunk = b.recv(1 << 20)
            if not chunk:
                break
            chunks.append(chunk)
        t.join(timeout=30)
        assert not t.is_alive() and not err
    return b"".join(chunks)


_ARRAYS = [np.arange(50_000, dtype=np.uint64),
           np.linspace(0, 1, 4096, dtype=np.float32).reshape(256, 16)]


def _sg(mod):
    return mod.pack_arrays_sg({"dim": 16, "n": 256}, _ARRAYS)


_FRAMES = {
    "small": (["echo"], b"hello", dict(compress=False)),
    "tagged": (["echo"], b"hello", dict(compress=False, tag=7)),
    "tag-wraps": (["echo"], b"", dict(compress=False, tag=(1 << 32) + 3)),
    "pipelined-dedup": (["bump", b"r" * 12], b"x" * 20_000,
                        dict(compress=False, tag=9, pipelined=True)),
    "err": (["err", "ValueError: nope"], b"", dict(compress=False)),
    "traced-deadline": (["echo", None, [123, 456], 2.5], b"p",
                        dict(compress=False, tag=1)),
    "zstd": (["echo"], bytes(range(256)) * 1024, dict(compress=True)),
    "block-zlib": (["echo"], bytes(range(256)) * 1024,
                   dict(compress=False, block="zlib")),
    "block-incompressible": (["echo"], np.random.default_rng(0).bytes(
        1 << 17), dict(compress=False, block="zlib")),
    "scatter-list": (["lookup"], "sg", dict(compress=False, tag=2)),
}


@pytest.mark.parametrize("name", list(_FRAMES))
def test_send_msg_frames_are_byte_identical(name, force_block):
    envelope, payload, kw = _FRAMES[name]
    if name == "zstd" and jrpc.zstandard is None:
        pytest.skip("zstandard is not installed")
    jp = _sg(jrpc) if payload == "sg" else payload
    tp = _sg(trpc) if payload == "sg" else payload
    jbytes = _frame_bytes(jrpc, envelope, jp, **kw)
    tbytes = _frame_bytes(trpc, envelope, tp, **kw)
    assert tbytes == jbytes
    # and each package reads the other's frame back to the same parts
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(30)
        t = threading.Thread(target=a.sendall, args=(jbytes,))
        t.start()
        env, body, tag, flags = trpc._recv_msg_full(b)
        t.join(timeout=30)
    want = payload if payload != "sg" else b"".join(
        bytes(x) for x in _sg(jrpc))
    assert env[:-1] == _as_read(envelope)
    assert bytes(body) == bytes(want)
    assert tag == (kw["tag"] & 0xFFFFFFFF if "tag" in kw else None)


def test_zstd_frame_refused_without_zstandard(monkeypatch):
    """The stated difference: a zstd frame (which a JAX peer with
    zstandard sends past 64 KiB on a non-loopback link, before any
    negotiation) raises RpcError when the port's host lacks the
    library."""
    if jrpc.zstandard is None:
        pytest.skip("zstandard is not installed: no zstd frame to send")
    frame = _frame_bytes(jrpc, ["echo"], bytes(range(256)) * 1024,
                         compress=True)
    assert frame[4] & trpc._FLAG_COMPRESSED
    monkeypatch.setattr(trpc, "zstandard", None)
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(30)
        t = threading.Thread(target=a.sendall, args=(frame,))
        t.start()
        with pytest.raises(RpcError, match="zstandard unavailable"):
            trpc._recv_msg_full(b)
        t.join(timeout=30)
    # and a port sender without it ships the payload raw
    raw = _frame_bytes(trpc, ["echo"], b"q" * 100_000, compress=True)
    assert not raw[4] & trpc._FLAG_COMPRESSED
