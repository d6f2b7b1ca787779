"""The port's observability stack against the JAX package's, on the CPU.

- The metrics registry: the exposition text equals the JAX registry's for
  the same series (label values with escapes, HELP text, histograms), and
  each package's ``parse_exposition`` reads the other's; the
  registry's thread-safety cases of ``tests/test_observability.py``.
- Spans: the non-service cases of ``tests/test_observability.py`` against
  the port (a span crossing a tagged RPC keeps its trace id, on the
  out-of-order path too; a legacy peer negotiates the slot away; disabled
  tracing sends no probe), and a trace crossing between the packages.
- The sidecar: ``/metrics``, ``/healthz`` (``?ready=``), ``/trace``,
  ``/flight``, ``/hotness`` (the report equals the JAX one for the same
  snapshot), ``/variants``, and its fault site.
- Fault injection: the rule grammar and ``describe()`` against the JAX
  injector, the transport sites, and ``__faults__`` remote control.

Every socket binds port 0 on 127.0.0.1; every wait is bounded.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from persia_tpu import faults as jfaults
from persia_tpu import metrics as jmetrics
from persia_tpu import rpc as jrpc
from persia_tpu import tracing as jtracing
from persia_tpu_torch import faults, tracing
from persia_tpu_torch import metrics as tmetrics
from persia_tpu_torch.metrics import MetricsRegistry, parse_exposition
from persia_tpu_torch.obs_http import ObservabilityServer
from persia_tpu_torch.rpc import RpcClient, RpcError, RpcServer


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
def no_faults():
    faults.reset_faults()
    try:
        yield
    finally:
        faults.reset_faults()


def _spans_named(collector, name):
    return [s for s in collector.recent() if s.name == name]


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


# --- the metrics registry ---------------------------------------------------


def _fill(mod):
    reg = mod.MetricsRegistry(const_labels={"job": "serving"})
    reg.counter("req_total", {"svc": "a"}, help_text="requests served").inc(5)
    reg.counter("req_total", {"svc": 'q"uo\\te\nnl'}).inc(2)
    reg.gauge("depth", help_text="queue\\depth\nline two").set(3.5)
    g = reg.gauge("depth", {"q": "b"})
    g.add(4)
    g.dec(1.5)
    for buckets, name in ((None, "lat_sec"),
                          (mod.COUNT_BUCKETS, "rows_per_batch")):
        h = reg.histogram(name, {"server": "8501"}, buckets=buckets)
        for v in (0.0003, 0.002, 7.0, 11.0, 1.0, 0.05, 2500, 10**7):
            h.observe(v)
    return reg


def test_exposition_equals_the_jax_registry():
    text, jtext = _fill(tmetrics).render(), _fill(jmetrics).render()
    assert text == jtext
    assert 'req_total{job="serving",svc="q\\"uo\\\\te\\nnl"} 2.0' in text
    assert "# HELP depth queue\\\\depth\\nline two" in text
    for parse in (parse_exposition, jmetrics.parse_exposition):
        assert parse(text) == jmetrics.parse_exposition(jtext)
    samples, families = parse_exposition(jtext)
    d = {(n, tuple(sorted(lab.items()))): v for n, lab, v in samples}
    assert d[("req_total", (("job", "serving"),
                            ("svc", 'q"uo\\te\nnl')))] == 2.0
    assert d[("lat_sec_count", (("job", "serving"), ("server", "8501")))] \
        == 8.0
    assert families["rows_per_batch"]["type"] == "histogram"
    assert families["req_total"]["help"] == "requests served"


def test_histogram_percentiles_equal_the_jax_ones():
    rng = np.random.default_rng(0)
    vals = rng.lognormal(-6, 2, size=2000)
    th, jh = tmetrics.Histogram(), jmetrics.Histogram()
    for v in vals:
        th.observe(float(v))
        jh.observe(float(v))
    for q in (1, 50, 90, 99, 99.9):
        assert th.percentile(q) == jh.percentile(q)
    assert th.snapshot_full() == jh.snapshot_full()
    with pytest.raises(ValueError, match="strictly"):
        tmetrics.Histogram((1.0, 1.0))
    reg = MetricsRegistry()
    reg.counter("kind_clash")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("kind_clash")


def test_parse_exposition_rejects_garbage():
    with pytest.raises(ValueError):
        parse_exposition("no_value_here\n")
    with pytest.raises(ValueError):
        parse_exposition('x{a=unquoted} 1\n')
    assert parse_exposition("x +Inf\ny -Inf\n")[0] == [
        ("x", {}, float("inf")), ("y", {}, float("-inf"))]


def test_render_vs_observe_race_is_consistent():
    reg = MetricsRegistry()
    hist = reg.histogram("race_sec")
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            hist.observe(0.0001 * (i % 100))
            i += 1

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(50):
            out = reg.render().splitlines()
            inf = [ln for ln in out if ln.startswith("race_sec_bucket")
                   and 'le="+Inf"' in ln][0]
            count = [ln for ln in out if ln.startswith("race_sec_count")][0]
            assert inf.rsplit(" ", 1)[1] == count.rsplit(" ", 1)[1]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


def test_gauge_and_counter_threadsafe():
    reg = MetricsRegistry()
    g, c = reg.gauge("depth"), reg.counter("n_total")

    def work():
        for _ in range(2000):
            g.add(1)
            g.dec(1)
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert g.value == 0.0 and c.value == 16000.0


def test_push_loop_stop_event(monkeypatch):
    reg = MetricsRegistry()
    reg.counter("push_total").inc()
    monkeypatch.delenv("PERSIA_METRICS_GATEWAY_ADDR", raising=False)
    with pytest.raises(ValueError, match="gateway"):
        reg.push_loop("job")
    # the knob names the gateway; a closed port fails the pushes quietly
    monkeypatch.setenv("PERSIA_METRICS_GATEWAY_ADDR", "127.0.0.1:9")
    thread, stop = reg.push_loop("job", interval_sec=0.05)
    assert thread.is_alive()
    stop.set()
    thread.join(timeout=5)
    assert not thread.is_alive()


# --- spans over the wire ----------------------------------------------------


def test_trace_propagates_over_tagged_rpc(traced):
    srv = RpcServer(concurrent_streams=4)
    srv.register("echo", lambda p: p)
    srv.serve_background()
    cl = RpcClient(srv.addr)
    try:
        with tracing.span("client/root") as root:
            assert cl.call("echo", b"x") == b"x"
            futs = [cl.call_future("echo", bytes([i])) for i in range(4)]
            assert [f.result() for f in futs] == [bytes([i])
                                                 for i in range(4)]
        spans = _spans_named(traced, "rpc/echo")
        assert len(spans) == 5
        assert all(s.trace_id == root.trace_id for s in spans)
        assert all(s.parent_id == root.span_id for s in spans)
    finally:
        cl.close()
        srv.stop()


def test_trace_parentage_across_ooo_multiplexed_path(traced):
    release = threading.Event()
    done_order = []

    def handler(p):
        if p == b"slow":
            release.wait(timeout=10)
        done_order.append(bytes(p))
        if len(done_order) == 3:
            release.set()
        return p

    srv = RpcServer(concurrent_streams=8)
    srv.register("work", handler)
    srv.serve_background()
    cl = RpcClient(srv.addr)
    try:
        with tracing.span("client/burst") as root:
            payloads = [b"slow", b"a", b"b", b"c"]
            assert cl.call_many("work", payloads, window=4) == payloads
        assert done_order[-1] == b"slow"
        spans = _spans_named(traced, "rpc/work")
        assert len(spans) == 4
        assert {s.trace_id for s in spans} == {root.trace_id}
        assert {s.parent_id for s in spans} == {root.span_id}
    finally:
        cl.close()
        srv.stop()


def test_legacy_peer_negotiates_down(traced):
    srv = RpcServer(enable_tags=False, enable_trace=False)
    srv.register("echo", lambda p: p)
    srv.serve_background()
    cl = RpcClient(srv.addr)
    try:
        with tracing.span("client/legacy"):
            assert cl.call("echo", b"y") == b"y"
        assert not _spans_named(traced, "rpc/echo")
    finally:
        cl.close()
        srv.stop()


def test_disabled_tracing_sends_no_probe():
    assert not tracing.tracing_enabled()
    srv = RpcServer()
    srv.register("echo", lambda p: p)
    srv.serve_background()
    try:
        cl = RpcClient(srv.addr, enable_tags=False)
        assert cl.call("echo", b"z") == b"z"
        assert srv.health()["served_rpcs"] == 1
        cl.close()
        tracing.enable_tracing(True)
        try:
            cl2 = RpcClient(srv.addr, enable_tags=False)
            assert cl2.call("echo", b"z") == b"z"
            assert srv.health()["served_rpcs"] == 3  # probe + call
            cl2.close()
        finally:
            tracing.enable_tracing(False)
    finally:
        srv.stop()


def test_server_span_records_handler_error(traced):
    srv = RpcServer()
    srv.register("boom", lambda p: (_ for _ in ()).throw(ValueError("nope")))
    srv.serve_background()
    cl = RpcClient(srv.addr)
    try:
        with tracing.span("client/err"):
            with pytest.raises(RpcError):
                cl.call("boom")
        (sp,) = _spans_named(traced, "rpc/boom")
        assert "ValueError" in sp.tags["error"]
    finally:
        cl.close()
        srv.stop()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_trace_crosses_between_the_packages(traced, server_pkg):
    """A span opened in one package parents the handler span in the
    other: the trace id rides the envelope across."""
    if server_pkg == "port":
        srv, cl = RpcServer(), jrpc.RpcClient
        client_tracing, collector = jtracing, tracing.default_collector()
    else:
        srv, cl = jrpc.RpcServer(), RpcClient
        client_tracing, collector = tracing, jtracing.default_collector()
    srv.register("echo", lambda p: p)
    srv.serve_background()
    c = cl(srv.addr)
    try:
        with client_tracing.span("client/x") as root:
            assert c.call("echo", b"q") == b"q"
        (sp,) = _spans_named(collector, "rpc/echo")
        assert (sp.trace_id, sp.parent_id) == (root.trace_id, root.span_id)
    finally:
        c.close()
        srv.stop()


def test_chrome_trace_export_validity(traced, tmp_path):
    with tracing.span("outer", root=True):
        with tracing.span("inner", k="v"):
            pass
    path = tracing.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"outer", "inner"}
    for e in xs:
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
        int(e["args"]["trace_id"], 16)
        int(e["args"]["span_id"], 16)
    inner = next(e for e in xs if e["name"] == "inner")
    outer = next(e for e in xs if e["name"] == "outer")
    assert inner["args"]["parent_id"] == outer["args"]["span_id"]
    assert inner["args"]["k"] == "v"
    assert any(e["ph"] == "M" and e["name"] == "process_name"
               for e in doc["traceEvents"])
    # the span-dict helpers agree with the JAX ones on the same capture
    dicts = tracing.as_span_dicts({"spans": [s.to_dict() for s in
                                             traced.recent()]})
    partial = [d for d in dicts if d["name"] == "inner"]
    assert tracing.promote_remote_parents(partial) == \
        jtracing.promote_remote_parents(partial)
    assert tracing.validate_span_dicts(dicts) == \
        jtracing.validate_span_dicts(dicts)
    assert tracing.merge_span_dicts([dicts], dicts[0]["trace_id"]) == \
        jtracing.merge_span_dicts([dicts], dicts[0]["trace_id"])


def test_trace_ring_counts_drops(traced):
    coll = tracing.TraceCollector(capacity=8)
    for i in range(20):
        with tracing.span(f"drop/span{i}"):
            pass
        coll.add(tracing.default_collector().recent(1)[0])
    assert coll.dropped_total == 12
    sidecar = ObservabilityServer(collector=coll, service="dropper").start()
    try:
        raw = json.loads(_get(f"http://{sidecar.addr}/trace?format=raw")[1])
        assert raw["dropped_total"] == 12 and len(raw["spans"]) == 8
        chrome = json.loads(_get(f"http://{sidecar.addr}/trace")[1])
        assert chrome["otherData"]["spans_dropped_total"] == 12
    finally:
        sidecar.stop()


# --- the sidecar --------------------------------------------------------------


def test_sidecar_endpoints(traced, no_faults):
    from persia_tpu_torch import __version__

    reg = MetricsRegistry()
    reg.counter("obs_test_requests_total", {"svc": "t"}).inc(3)
    ready = [True]
    with tracing.span("sidecar/span"):
        pass
    faults.add("rpc.client.send", "delay", arg=0.0, method="never")
    sidecar = ObservabilityServer(
        registry=reg, service="testsvc",
        health_fn=lambda: {"queue_depth": 7, "ready": ready[0]}).start()
    base = f"http://{sidecar.addr}"
    try:
        status, metrics = _get(f"{base}/metrics")
        assert 'obs_test_requests_total{svc="t"} 3.0' in metrics
        samples, _ = parse_exposition(metrics)
        assert any(n == "obs_http_request_sec_count" for n, _, _ in samples)
        status, body = _get(f"{base}/healthz")
        health = json.loads(body)
        assert (status, health["status"], health["service"]) == (
            200, "ok", "testsvc")
        assert health["queue_depth"] == 7 and health["uptime_sec"] >= 0
        assert health["version"] == __version__
        ready[0] = False  # alive but not ready: 503 only when asked
        assert _get(f"{base}/healthz")[0] == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/healthz?ready=1")
        assert e.value.code == 503
        e.value.close()
        trace = json.loads(_get(f"{base}/trace?n=10")[1])
        assert "sidecar/span" in [e["name"] for e in trace["traceEvents"]
                                  if e["ph"] == "X"]
        raw = json.loads(_get(f"{base}/trace?n=5&format=raw")[1])
        assert any(s["name"] == "sidecar/span" for s in raw["spans"])
        flight = json.loads(_get(f"{base}/flight")[1])
        assert flight["health"]["queue_depth"] == 7
        assert 'obs_test_requests_total{svc="t"} 3.0' in flight["metrics"]
        assert flight["faults"][0]["site"] == "rpc.client.send"
        assert json.loads(_get(f"{base}/variants")[1]) == {
            "enabled": False, "variants": []}
        assert json.loads(_get(f"{base}/hotness")[1])["enabled"] is False
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/nope")
        assert e.value.code == 404
        e.value.close()
    finally:
        sidecar.stop()


def test_sidecar_fault_site(no_faults):
    sidecar = ObservabilityServer(service="chaos").start()
    base = f"http://{sidecar.addr}"
    try:
        faults.add("obs.http", "error", path="/metrics", times=1)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/metrics")
        assert e.value.code == 500
        e.value.close()
        faults.add("obs.http", "corrupt", path="/healthz", times=1)
        with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
            assert b"garbage" in r.read()
        faults.add("obs.http", "drop", path="/trace", times=1)
        with pytest.raises((TimeoutError, urllib.error.URLError, OSError)):
            _get(f"{base}/trace", timeout=0.5)
        assert _get(f"{base}/healthz")[0] == 200  # the rules are spent
    finally:
        sidecar.stop()


def test_sidecar_hotness_report_equals_jax():
    """``/hotness`` over the port's tracker: the summary (zipf fit,
    coverage curve, top rows) and ``?full=1`` snapshot equal the JAX
    package's report of the same snapshot."""
    from persia_tpu import hotness as jhotness
    from persia_tpu_torch import hotness

    tracker = hotness.HotnessTracker(4)
    rng = np.random.default_rng(0)
    for table in (8, 16):  # tables are the slot dims
        signs = (rng.zipf(1.1, size=20_000) % 50_000 + 1).astype(np.uint64)
        tracker.observe(table, signs)
    snap = tracker.snapshot()
    sidecar = ObservabilityServer(service="hot",
                                  hotness_fn=tracker.snapshot).start()
    try:
        summary = json.loads(_get(f"http://{sidecar.addr}/hotness")[1])
        full = json.loads(_get(f"http://{sidecar.addr}/hotness?full=1")[1])
    finally:
        sidecar.stop()
    want = json.loads(json.dumps(jhotness.summary_view(snap)))
    assert summary == want
    assert summary["tables"]["8"]["zipf_alpha"] is not None
    assert full == json.loads(json.dumps(snap))


def test_http_args_convention(tmp_path, monkeypatch):
    import argparse

    from persia_tpu_torch import obs_http

    monkeypatch.setenv("PERSIA_HTTP_PORT", "-1")
    parser = argparse.ArgumentParser()
    obs_http.add_http_args(parser)
    args = parser.parse_args([])
    assert obs_http.port_from_args(args) is None
    assert obs_http.maybe_start("127.0.0.1", None, lambda: {}) is None
    path = tmp_path / "http.addr"
    args = parser.parse_args(["--http-port", "0",
                              "--http-addr-file", str(path)])
    sidecar = obs_http.maybe_start("127.0.0.1", obs_http.port_from_args(args),
                                   lambda: {"x": 1})
    try:
        obs_http.write_addr_file_from_args(sidecar, args)
        assert path.read_text() == sidecar.addr
        assert json.loads(_get(f"http://{sidecar.addr}/healthz")[1])["x"] == 1
    finally:
        sidecar.stop()


# --- fault injection ----------------------------------------------------------


def test_fault_grammar_and_rules_equal_the_jax_injector():
    spec = ("rpc.server.recv:reset@after=2,times=1,method=lookup;"
            "rpc.client.send:delay:0.05@p=0.5;obs.http:error;"
            "rpc.server.recv:corrupt:@method=predict")
    t, j = faults.FaultInjector(seed=7), jfaults.FaultInjector(seed=7)
    t.load_spec(spec)
    j.load_spec(spec)
    assert t.rules() == j.rules()
    for kw in ({"method": "lookup"}, {"method": "predict"}, {}):
        for _ in range(4):
            try:
                a = t.fire("rpc.server.recv", **kw)
            except ConnectionResetError:
                a = "raised"
            try:
                b = j.fire("rpc.server.recv", **kw)
            except ConnectionResetError:
                b = "raised"
            assert a == b
    assert t.rules() == j.rules()
    for bad in ("nosuchsite", "a:explode"):
        with pytest.raises(ValueError):
            t.load_spec(bad)
    assert faults.corrupt_bytes(b"\x0fab") == jfaults.corrupt_bytes(b"\x0fab")


def test_transport_fault_sites(no_faults):
    srv = RpcServer()
    srv.register("echo", lambda p: p)
    srv.serve_background()
    cl = RpcClient(srv.addr, timeout=2.0)
    try:
        faults.add("rpc.server.recv", "error", method="echo", times=1)
        with pytest.raises(RpcError, match="InjectedFault"):
            cl.call("echo", b"a")
        faults.add("rpc.server.recv", "corrupt", method="echo", times=1)
        assert cl.call("echo", b"\x00b") == b"\xffb"
        # a reset kills the connection; the client redials and retries
        faults.add("rpc.server.recv", "reset", method="echo", times=1)
        assert cl.call("echo", b"c") == b"c"
        faults.add("rpc.client.send", "reset", method="echo", times=1)
        assert cl.call("echo", b"d") == b"d"
        fired = [r["fired"] for r in faults.default_injector().rules()]
        assert fired == [1, 1, 1, 1]
    finally:
        cl.close()
        srv.stop()


def test_faults_remote_control(no_faults, monkeypatch):
    """``PERSIA_FAULTS_RPC=1`` exposes ``__faults__``; :func:`control`
    arms a live server's injector through it, from either package."""
    srv = RpcServer()
    srv.register("echo", lambda p: p)
    srv.serve_background()
    try:
        with pytest.raises(RpcError, match="no such method"):
            faults.control(srv.addr, spec="obs.http:error")
    finally:
        srv.stop()
    monkeypatch.setenv("PERSIA_FAULTS_RPC", "1")
    srv = RpcServer()
    srv.register("echo", lambda p: p)
    srv.serve_background()
    try:
        faults.control(srv.addr, spec="rpc.server.recv:error@method=echo",
                       seed=3)
        assert faults.active()
        cl = RpcClient(srv.addr)
        with pytest.raises(RpcError, match="InjectedFault"):
            cl.call("echo", b"x")
        jfaults.control(srv.addr, clear=True)  # the JAX control, same wire
        assert not faults.active()
        assert cl.call("echo", b"x") == b"x"
        cl.close()
    finally:
        srv.stop()
