"""The fleet control plane on the port (``tests/test_fleet.py`` on
``persia_tpu_torch.fleet`` and ``persia_tpu_torch.slos``), then parity
with the JAX package: the same seeded scrape windows through both SLO
engines and history rings, both packages' monitors over the same port
sidecars, the hotness plan, rule files in YAML and JSON, the version-skew
decision, and ``python -m persia_tpu_torch.fleet`` as a process.

The first part mirrors the JAX file test for test: scrape-loop
resilience against hung, garbled and dead sidecars (through the port's
fault injection), the SLO grammar and firing semantics, the federated
views, the flight recorder's bundles and the pull-only pin (a scraping
monitor adds no request on the RPC plane).
"""

import json
import os
import time
import urllib.request

import pytest

from persia_tpu_torch import faults, tracing
from persia_tpu_torch.fleet import FleetHistory, FleetMonitor, FlightRecorder
from persia_tpu_torch.metrics import MetricsRegistry, parse_exposition
from persia_tpu_torch.obs_http import ObservabilityServer
from persia_tpu_torch.slos import SloEngine, SloRule, default_rules, load_rules


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _mk_sidecar(service, extra_health=None, registry=None, collector=None):
    reg = registry if registry is not None else MetricsRegistry()
    return reg, ObservabilityServer(
        registry=reg, collector=collector,
        health_fn=lambda: {"ready": True, **(extra_health or {})},
        service=service).start()


@pytest.fixture
def clean_faults():
    yield
    faults.reset_faults()


# --- SLO engine ------------------------------------------------------------


def test_slo_rule_validation():
    with pytest.raises(ValueError):
        SloRule("bad", "p98(foo)", ">", 1)  # unknown function
    with pytest.raises(ValueError):
        SloRule("bad", "rate(foo", ">", 1)  # unbalanced
    with pytest.raises(ValueError):
        SloRule("bad", "foo", "~", 1)       # bad comparison
    with pytest.raises(ValueError):
        SloRule("bad", "ratio(a, b)", ">", 1, scope="galaxy")
    r = SloRule.from_dict({"name": "x", "expr": "rate(m_total)",
                           "threshold": 2, "window_sec": 30,
                           "service": "^ps"})
    assert r.fn == "rate" and r.arg1 == "m_total"
    assert r.matches("ps0") and not r.matches("worker0")


def test_slo_rules_load_yaml(tmp_path):
    p = tmp_path / "rules.yml"
    p.write_text(
        "rules:\n"
        "  - name: lost\n"
        "    expr: rate(pipeline_lost_updates_total)\n"
        "    op: '>'\n"
        "    threshold: 0\n"
        "    window_sec: 45\n"
        "  - name: degraded\n"
        "    expr: ratio(bad_total, all_total)\n"
        "    threshold: 0.1\n")
    rules = load_rules(str(p))
    assert [r.name for r in rules] == ["lost", "degraded"]
    assert rules[1].fn == "ratio" and rules[1].arg2 == "all_total"


def test_slo_engine_instant_rate_ratio():
    eng = SloEngine([
        SloRule("depth", "queue_depth", ">", 5.0),
        SloRule("lost", "rate(lost_total)", ">", 0.0, window_sec=60),
        SloRule("deg", "ratio(bad_total, req_total)", ">", 0.25,
                window_sec=60),
    ])
    t0 = 1000.0
    eng.ingest("svc0", [("queue_depth", {}, 2.0),
                        ("lost_total", {}, 0.0),
                        ("bad_total", {}, 0.0),
                        ("req_total", {}, 100.0)], t=t0)
    assert not [a for a in eng.evaluate(now=t0) if a["firing"]]
    # 10s later: queue deep, counters moved
    eng.ingest("svc0", [("queue_depth", {}, 9.0),
                        ("lost_total", {}, 5.0),
                        ("bad_total", {}, 40.0),
                        ("req_total", {}, 200.0)], t=t0 + 10)
    firing = {(a["rule"], a["service"])
              for a in eng.evaluate(now=t0 + 10) if a["firing"]}
    assert firing == {("depth", "svc0"), ("lost", "svc0"),
                      ("deg", "svc0")}
    lost = [a for a in eng.evaluate(now=t0 + 10)
            if a["rule"] == "lost"][0]
    assert lost["value"] == pytest.approx(0.5)  # 5 over 10s
    deg = [a for a in eng.evaluate(now=t0 + 10)
           if a["rule"] == "deg"][0]
    assert deg["value"] == pytest.approx(0.4)


def test_slo_engine_counter_reset_is_not_negative_rate():
    eng = SloEngine([SloRule("lost", "rate(lost_total)", ">", 0.0,
                             window_sec=60)])
    eng.ingest("s", [("lost_total", {}, 100.0)], t=0.0)
    # restart: counter back near zero, then climbs to 3
    eng.ingest("s", [("lost_total", {}, 3.0)], t=10.0)
    a = [x for x in eng.evaluate(now=10.0) if x["rule"] == "lost"][0]
    assert a["value"] == pytest.approx(0.3)  # reset -> counts from 0
    assert a["firing"]


def test_slo_engine_p99_over_window_increase():
    eng = SloEngine([SloRule("p99", "p99(lat_sec)", ">", 0.5,
                             window_sec=60)])

    def buckets(fast, slow):
        total = fast + slow
        return [("lat_sec_bucket", {"le": "0.1"}, float(fast)),
                ("lat_sec_bucket", {"le": "1.0"}, float(total)),
                ("lat_sec_bucket", {"le": "+Inf"}, float(total)),
                ("lat_sec_count", {}, float(total))]

    # boot history: all fast
    eng.ingest("s", buckets(1000, 0), t=0.0)
    # window increase: 10 fast, 90 slow -> p99 lands in (0.1, 1.0]
    eng.ingest("s", buckets(1010, 90), t=30.0)
    a = [x for x in eng.evaluate(now=30.0) if x["rule"] == "p99"][0]
    assert a["firing"] and 0.5 < a["value"] <= 1.0
    # cumulative-only judgement would have seen mostly-fast history
    # and stayed quiet — the window is the point


def test_slo_engine_for_sec_and_breach_events():
    hits = []
    eng = SloEngine([SloRule("down", "up", "<", 1.0, for_sec=5.0)],
                    on_breach=hits.append)
    eng.ingest("s", [], t=0.0)
    eng.mark_down("s")
    assert not [a for a in eng.evaluate(now=0.0) if a["firing"]]
    assert not [a for a in eng.evaluate(now=4.0) if a["firing"]]
    fired = [a for a in eng.evaluate(now=6.0) if a["firing"]]
    assert fired and fired[0]["service"] == "s"
    assert len(hits) == 1 and hits[0]["rule"] == "down"
    # still firing on the next pass, but no DUPLICATE breach event
    assert [a for a in eng.evaluate(now=7.0) if a["firing"]]
    assert len(hits) == 1
    # recovery clears the state; a fresh breach restarts for_sec
    eng.ingest("s", [], t=8.0)
    assert not [a for a in eng.evaluate(now=8.0) if a["firing"]]
    assert eng.exit_code() == 0


# --- scrape-loop resilience -----------------------------------------------


def test_scrape_resilience_timeout_garbage_death(clean_faults):
    """One healthy target, one hung (faults delay > scrape timeout),
    one answering garbage, one dead mid-scrape: the round marks the bad
    ones down WITHOUT stalling the healthy one, and a cleared fault is
    re-probed back to up."""
    reg_ok, ok = _mk_sidecar("ok0")
    reg_ok.counter("reqs_total").inc(3)
    _, hung = _mk_sidecar("hung0")
    _, garbage = _mk_sidecar("garbage0")
    _, dead = _mk_sidecar("dead0")
    mon = FleetMonitor(targets=[
        {"service": "ok0", "http_addr": ok.addr},
        {"service": "hung0", "http_addr": hung.addr},
        {"service": "garbage0", "http_addr": garbage.addr},
        {"service": "dead0", "http_addr": dead.addr},
    ], scrape_interval=0.2, scrape_timeout=0.5)
    try:
        dead.stop()  # connection refused: died before the scrape
        # the sidecar fault site is per-process; the hung/garbage
        # sidecars live in THIS process, so filter rules by path and
        # let every sidecar share them — only /metrics is affected
        faults.add("obs.http", "delay", arg=3.0, path="/metrics",
                   times=1)   # first /metrics GET hangs past timeout
        t0 = time.monotonic()
        mon.scrape_once()
        elapsed = time.monotonic() - t0
        # the loop finished on the timeout budget, not the 3s hang
        assert elapsed < 3.0, elapsed
        by_name = {t.service: t for t in mon.targets()}
        # exactly one of the faultable targets ate the delay rule; the
        # dead one is down regardless; ok0 survives if it dodged the
        # one-shot rule (it shares the process-wide fault site)
        assert not by_name["dead0"].up
        down = [s for s, t in by_name.items() if not t.up]
        assert len(down) >= 2  # dead0 + the delay victim
        # garbage: arm corrupt on the next /metrics GETs and re-scrape
        faults.reset_faults()
        faults.add("obs.http", "corrupt", path="/metrics")
        mon.scrape_once()
        by_name = {t.service: t for t in mon.targets()}
        assert not by_name["garbage0"].up  # unparseable exposition
        assert by_name["garbage0"].last_error
        # clear every fault: all live targets recover on the re-probe
        faults.reset_faults()
        mon.scrape_once()
        by_name = {t.service: t for t in mon.targets()}
        assert by_name["ok0"].up
        assert by_name["hung0"].up
        assert by_name["garbage0"].up
        assert not by_name["dead0"].up
        # the up/down history fed the SLO engine
        firing = {a["service"] for a in mon.alerts(firing_only=True)
                  if a["rule"] == "target_down"}
        assert firing == {"dead0"}
    finally:
        mon.stop()
        for s in (ok, hung, garbage):
            s.stop()


def test_scrape_is_pull_only_no_rpc_traffic():
    """Wire-neutrality pin: a scraping fleet monitor adds zero requests
    on a service's RPC plane (served-request counts)."""
    import numpy as np

    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.service.ps_service import PsClient, PsService

    svc = PsService(make_holder(1000, 2), http_port=0)
    svc.server.serve_background()
    mon = FleetMonitor(targets=[
        {"service": "ps0", "http_addr": svc.http.addr}])
    try:
        cl = PsClient(svc.addr)
        cl.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1})
        cl.register_optimizer({
            "type": "adagrad", "lr": 0.02,
            "initial_accumulator_value": 0.1,
            "g_square_momentum": 1.0, "vectorwise_shared": False,
        })
        cl.lookup(np.arange(1, 9, dtype=np.uint64), 8, True)
        served0 = svc.server.health()["served_rpcs"]
        for _ in range(3):
            mon.scrape_once()
        assert svc.server.health()["served_rpcs"] == served0
        assert mon.targets()[0].up
        cl.client.close()
    finally:
        mon.stop()
        svc.stop()


# --- federation + topology -------------------------------------------------


def test_fleet_metrics_federation_labels_and_types():
    reg_a, a = _mk_sidecar("ps0")
    reg_b, b = _mk_sidecar("ps1")
    reg_a.counter("reqs_total", help_text="served requests").inc(5)
    reg_b.counter("reqs_total").inc(7)
    reg_b.histogram("lat_sec").observe(0.02)
    mon = FleetMonitor(targets=[
        {"service": "ps0", "http_addr": a.addr, "replica": 0},
        {"service": "ps1", "http_addr": b.addr, "replica": 1},
    ])
    try:
        mon.scrape_once()
        text = mon.fleet_metrics()
        samples, families = parse_exposition(text)
        d = {(n, tuple(sorted(l.items()))): v for n, l, v in samples}
        assert d[("reqs_total",
                  (("replica", "0"), ("service", "ps0")))] == 5.0
        assert d[("reqs_total",
                  (("replica", "1"), ("service", "ps1")))] == 7.0
        # histogram series keep le labels + gain service labels
        assert d[("lat_sec_bucket", (("le", "+Inf"), ("replica", "1"),
                                     ("service", "ps1")))] == 1.0
        # TYPE declared once per family even with two services
        assert text.count("# TYPE reqs_total counter") == 1
        assert families["fleet_target_up"]["type"] == "gauge"
        assert d[("fleet_target_up",
                  (("replica", "0"), ("role", "static"),
                   ("service", "ps0")))] == 1.0
    finally:
        mon.stop()
        a.stop()
        b.stop()


def test_fleet_status_topology_and_version_skew():
    _, a = _mk_sidecar("ps0")
    _, b = _mk_sidecar("worker0")
    mon = FleetMonitor(targets=[
        {"service": "ps0", "http_addr": a.addr, "role": "ps"},
        {"service": "worker0", "http_addr": b.addr, "role": "worker"},
    ])
    try:
        mon.scrape_once()
        st = mon.fleet_status()
        assert st["n_targets"] == 2 and st["n_up"] == 2
        assert not st["version_skew"]  # same process, same version
        by_name = {t["service"]: t for t in st["targets"]}
        assert by_name["ps0"]["ready"] is True
        assert by_name["ps0"]["version"]
        assert by_name["worker0"]["role"] == "worker"
        assert by_name["ps0"]["last_scrape_age_sec"] is not None
    finally:
        mon.stop()
        a.stop()
        b.stop()


def test_fleet_status_trainer_group_rows_and_skew():
    """Multi-process trainer rows: /fleet/status carries each group
    member's process_index/count + rendezvoused mesh shape, flags
    version or mesh disagreement across the group (either means the
    collectives will deadlock), and the process-labeled step gauges
    land in /fleet/history as per-member series."""
    h0 = {"process_index": 0, "process_count": 2, "mesh_shape": "2x1"}
    h1 = {"process_index": 1, "process_count": 2, "mesh_shape": "2x1"}
    reg0, t0 = _mk_sidecar("trainer0", extra_health=h0)
    reg1, t1 = _mk_sidecar("trainer1", extra_health=h1)
    _, ps = _mk_sidecar("ps0")
    reg0.gauge("trainer_step", labels={"process": "p0"}).set(4.0)
    reg1.gauge("trainer_step", labels={"process": "p1"}).set(3.0)
    mon = FleetMonitor(targets=[
        {"service": "trainer0", "http_addr": t0.addr, "role": "trainer"},
        {"service": "trainer1", "http_addr": t1.addr, "role": "trainer"},
        {"service": "ps0", "http_addr": ps.addr, "role": "ps"},
    ])
    try:
        mon.scrape_once()
        st = mon.fleet_status()
        assert st["n_trainer_processes"] == 2
        assert not st["trainer_version_skew"]  # same package everywhere
        assert not st["trainer_mesh_skew"]
        assert st["trainer_mesh_shapes"] == ["2x1"]
        by_name = {t["service"]: t for t in st["targets"]}
        assert by_name["trainer0"]["process_index"] == 0
        assert by_name["trainer1"]["process_index"] == 1
        assert by_name["trainer1"]["process_count"] == 2
        assert by_name["trainer1"]["mesh_shape"] == "2x1"
        # non-trainer rows are untouched (and excluded from the group)
        assert by_name["ps0"]["process_index"] is None

        # process-labeled gauges become distinct /fleet/history series
        ex = mon.history.excerpt("trainer_step", window_sec=100.0, points=4)
        assert {e["service"] for e in ex} == {"trainer0", "trainer1"}

        # one member rendezvoused a different mesh on a different
        # package build: both skew flags must fire
        h1["mesh_shape"] = "4x1"
        h1["version"] = "0.0.0-canary"
        mon.scrape_once()
        st = mon.fleet_status()
        assert st["trainer_mesh_skew"]
        assert st["trainer_version_skew"]
        assert st["trainer_mesh_shapes"] == ["2x1", "4x1"]
    finally:
        mon.stop()
        t0.stop()
        t1.stop()
        ps.stop()


def test_fleet_http_endpoints():
    reg, a = _mk_sidecar("ps0")
    reg.counter("reqs_total").inc()
    mon = FleetMonitor(
        targets=[{"service": "ps0", "http_addr": a.addr}],
        slo_engine=SloEngine(default_rules()))
    http = mon.serve_http()
    try:
        mon.scrape_once()
        metrics = _get(f"http://{http.addr}/fleet/metrics")
        assert 'reqs_total{replica="0",service="ps0"} 1.0' in metrics
        status = json.loads(_get(f"http://{http.addr}/fleet/status"))
        assert status["n_up"] == 1
        alerts = json.loads(_get(f"http://{http.addr}/fleet/alerts"))
        assert isinstance(alerts, list) and alerts
        assert not json.loads(
            _get(f"http://{http.addr}/fleet/alerts?firing=1"))
        trace = json.loads(_get(f"http://{http.addr}/fleet/trace"))
        assert "traceEvents" in trace
        hz = json.loads(_get(f"http://{http.addr}/healthz"))
        assert hz["service"] == "fleet_monitor" and hz["ready"]
    finally:
        http.stop()
        mon.stop()
        a.stop()


def test_fleet_trace_merges_across_collectors():
    """Two sidecars with separate collectors (stand-ins for two
    processes): /fleet/trace stitches their spans into one trace_id
    with cross-capture parents resolved."""
    tracing.enable_tracing(True)
    try:
        ca = tracing.TraceCollector()
        cb = tracing.TraceCollector()
        with tracing.span("client/root", root=True,
                          service="svc_a") as root:
            ctx = root.ctx
        # the root landed in the DEFAULT collector; copy it into a's
        for s in tracing.default_collector().recent():
            if s.span_id == root.span_id:
                ca.add(s)
        with tracing.span("remote/child", ctx=ctx,
                          service="svc_b") as child:
            pass
        for s in tracing.default_collector().recent():
            if s.span_id == child.span_id:
                cb.add(s)
        _, a = _mk_sidecar("svc_a", collector=ca)
        _, b = _mk_sidecar("svc_b", collector=cb)
        mon = FleetMonitor(targets=[
            {"service": "svc_a", "http_addr": a.addr},
            {"service": "svc_b", "http_addr": b.addr},
        ])
        try:
            mon.scrape_once()
            doc = mon.fleet_trace(trace_id=f"{root.trace_id:016x}",
                                  fmt="raw")
            names = {s["name"] for s in doc["spans"]}
            assert {"client/root", "remote/child"} <= names
            by_id = {s["span_id"]: s for s in doc["spans"]}
            child_d = next(s for s in doc["spans"]
                           if s["name"] == "remote/child")
            assert child_d["parent_id"] in by_id  # chain resolved
        finally:
            mon.stop()
            a.stop()
            b.stop()
    finally:
        tracing.enable_tracing(False)


# --- flight recorder -------------------------------------------------------


def test_flight_recorder_bundle_contents(tmp_path):
    tracing.enable_tracing(True)
    try:
        with tracing.span("svc/op", root=True) as root:
            with tracing.span("svc/sub"):
                pass
        spans = [s.to_dict() for s in
                 tracing.default_collector().recent()
                 if s.trace_id == root.trace_id]
        # one span references a parent outside the capture (a remote
        # caller): capture must promote it, not leave an orphan
        orphan = dict(spans[0])
        orphan["span_id"] = "00000000000000aa"
        orphan["parent_id"] = "00000000000000bb"
        spans.append(orphan)
    finally:
        tracing.enable_tracing(False)
    rec = FlightRecorder(str(tmp_path / "pm"), per_service=2)
    assert rec.capture("ghost", "crash") is None  # never observed
    rec.observe("ps0", {
        "t_wall": time.time(), "service": "ps0", "pid": 1234,
        "version": "0.1.0",
        "health": {"status": "ok", "model_manager_status": "Idle"},
        "metrics": "reqs_total 5.0\n",
        "spans": spans, "spans_dropped_total": 3,
        "faults": [{"site": "ps.lookup", "action": "delay"}],
        "env": {"PERSIA_TRACING": "1"},
    })
    path = rec.capture("ps0", "crash:test", extra={"restart_no": 1})
    assert path and os.path.isdir(path)
    names = set(os.listdir(path))
    assert {"flight.json", "health.json", "trace.json", "metrics.prom",
            "faults.json", "env.json", "reason.json"} <= names
    with open(os.path.join(path, "trace.json")) as f:
        trace = json.load(f)
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    ids = {e["args"]["span_id"] for e in xs}
    assert all(not e["args"].get("parent_id")
               or e["args"]["parent_id"] in ids for e in xs)
    promoted = next(e for e in xs
                    if e["args"]["span_id"] == "00000000000000aa")
    assert promoted["args"]["remote_parent"] == "00000000000000bb"
    assert trace["otherData"]["spans_dropped_total"] == 3
    with open(os.path.join(path, "reason.json")) as f:
        reason = json.load(f)
    assert reason["reason"] == "crash:test"
    assert reason["extra"]["restart_no"] == 1
    samples, _ = parse_exposition(
        open(os.path.join(path, "metrics.prom")).read())
    assert samples == [("reqs_total", {}, 5.0)]


def test_flight_failure_is_not_a_liveness_failure(clean_faults, tmp_path):
    """/flight is the heavy GET; a target whose snapshot times out while
    /metrics + /healthz answer fine must stay UP (same rule as the PS
    supervisor), and the flight fetch is retried next round."""
    _, a = _mk_sidecar("ps0")
    mon = FleetMonitor(
        targets=[{"service": "ps0", "http_addr": a.addr}],
        scrape_timeout=0.5, postmortem_dir=str(tmp_path / "pm"),
        flight_interval=0.0)
    try:
        faults.add("obs.http", "delay", arg=2.0, path="/flight")
        assert mon.scrape_once() == 1
        t = mon.targets()[0]
        assert t.up and t.consecutive_failures == 0
        assert mon.recorder.last("ps0") is None  # snapshot missed
        faults.reset_faults()
        mon.scrape_once()
        assert mon.recorder.last("ps0") is not None  # retried
    finally:
        mon.stop()
        a.stop()


def test_breach_capture_and_ring_bound(tmp_path):
    """An SLO breach captures a postmortem from the LAST snapshot; the
    per-service ring stays bounded."""
    reg, a = _mk_sidecar("ps0")
    lost = reg.counter("pipeline_lost_updates_total")
    mon = FleetMonitor(
        targets=[{"service": "ps0", "http_addr": a.addr}],
        slo_engine=SloEngine([SloRule(
            "lost", "rate(pipeline_lost_updates_total)", ">", 0.0,
            window_sec=60)]),
        postmortem_dir=str(tmp_path / "pm"), flight_interval=0.0)
    try:
        mon.scrape_once()
        time.sleep(0.05)
        lost.inc(7)
        mon.scrape_once()
        assert mon.recorder.captures, "breach did not capture a bundle"
        bundle = mon.recorder.captures[-1]
        with open(os.path.join(bundle, "reason.json")) as f:
            assert json.load(f)["reason"] == "slo:lost"
        ring = mon.recorder._rings["ps0"]
        assert len(ring) <= ring.maxlen
    finally:
        mon.stop()
        a.stop()


# --- discovery -------------------------------------------------------------


def test_coordinator_topology_and_fleet_discovery():
    from persia_tpu_torch.service.coordinator import (
        ROLE_PS,
        Coordinator,
        CoordinatorClient,
    )
    from persia_tpu_torch.service_discovery import get_fleet_targets

    coord = Coordinator()
    coord.server.serve_background()
    try:
        cl = CoordinatorClient(coord.addr)
        cl.register(ROLE_PS, 0, "127.0.0.1:1111",
                    http_addr="127.0.0.1:2222")
        cl.register(ROLE_PS, 1, "127.0.0.1:1112")  # no sidecar
        members = cl.topology()
        assert len(members) == 2
        assert members[0]["http_addr"] == "127.0.0.1:2222"
        assert members[1]["http_addr"] is None
        targets = get_fleet_targets(coord.addr)
        assert [t["service"] for t in targets] == ["ps0"]
        assert targets[0]["rpc_addr"] == "127.0.0.1:1111"
        # static spec merges in and dedupes by address
        targets = get_fleet_targets(
            coord.addr, static="serving=127.0.0.1:3333")
        assert {t["service"] for t in targets} == {"ps0", "serving"}
        # restart on a new port: same replica, updated addresses
        cl.register(ROLE_PS, 0, "127.0.0.1:1121",
                    http_addr="127.0.0.1:2232")
        mon = FleetMonitor(coordinator_addr=coord.addr)
        t = mon.targets()[0]
        assert t.http_addr == "127.0.0.1:2232"
        mon.stop()
        # re-registration WITHOUT a sidecar must clear the stale one
        # (topology must never advertise a dead sidecar address)
        cl.register(ROLE_PS, 0, "127.0.0.1:1122")
        m0 = [m for m in cl.topology() if m["replica"] == 0][0]
        assert m0["http_addr"] is None
        cl.deregister(ROLE_PS, 0)
        assert not [m for m in cl.topology() if m["replica"] == 0]
    finally:
        coord.server.stop()


# --- donor-side frozen-slot observability (PR 12 satellite) ------------------


def test_frozen_slot_gauge_and_stuck_rule():
    """A controller that dies post-freeze is invisible to the
    controller-side reshard_stuck gauge — the DONOR must report its own
    wedged state: ps_frozen_slot_age_sec climbs while frozen, resets on
    finish, and the default reshard_frozen_slot_stuck rule fires on
    it."""
    import numpy as np

    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service.ps_service import PsClient, PsService

    holder = EmbeddingHolder(capacity=10_000)
    svc = PsService(holder, port=0)
    svc.server.serve_background()
    try:
        client = PsClient(svc.addr, circuit_breaker=False)
        client.configure("bounded_uniform", {"lower": 0.0, "upper": 0.0},
                         admit_probability=1.0, weight_bound=1e9,
                         enable_weight_bound=False)
        client.register_optimizer({"type": "sgd", "lr": 1.0, "wd": 0.0})
        t = RoutingTable.uniform(1, slots_per_replica=4)
        client.lookup(np.arange(32, dtype=np.uint64), 8, True)
        h = client.health()
        assert "reshard" not in h
        svc._refresh_mem_gauges()
        assert svc._g_frozen_age.value == 0
        client.reshard_begin([0], t.num_slots, epoch=2, fence=(2, 0),
                             mig_id="m", lease_sec=60.0)
        svc._refresh_mem_gauges()
        assert svc._g_frozen_age.value == 0  # armed but not frozen
        client.reshard_freeze(epoch=2, fence=(2, 0))
        time.sleep(0.05)
        h = client.health()
        assert h["reshard"]["frozen"] is True
        assert h["reshard"]["frozen_age_sec"] > 0
        assert h["reshard"]["mig_id"] == "m"
        svc._refresh_mem_gauges()
        age = svc._g_frozen_age.value
        assert age > 0
        # the default rule fires once the age passes its threshold
        rule = [r for r in default_rules()
                if r.name == "reshard_frozen_slot_stuck"][0]
        eng = SloEngine([rule])
        t0 = 1000.0
        eng.ingest("ps0", [("ps_frozen_slot_age_sec", {}, 300.0)], t=t0)
        assert not [a for a in eng.evaluate(now=t0) if a["firing"]]
        eng.ingest("ps0", [("ps_frozen_slot_age_sec", {}, 340.0)],
                   t=t0 + rule.for_sec / 2)
        eng.evaluate(now=t0 + rule.for_sec / 2)
        eng.ingest("ps0", [("ps_frozen_slot_age_sec", {}, 370.0)],
                   t=t0 + rule.for_sec + 1)
        assert [a for a in eng.evaluate(now=t0 + rule.for_sec + 1)
                if a["firing"] and a["rule"] == rule.name]
        # silent on healthy (zero) data
        eng2 = SloEngine([rule])
        eng2.ingest("ps0", [("ps_frozen_slot_age_sec", {}, 0.0)], t=t0)
        assert not [a for a in eng2.evaluate(now=t0) if a["firing"]]
        client.reshard_finish(fence=(2, 0))
        svc._refresh_mem_gauges()
        assert svc._g_frozen_age.value == 0
    finally:
        svc.stop()


def test_fleet_routing_reports_frozen_donors():
    """/fleet/routing surfaces the wedged-donor shortlist (service,
    frozen age, pending epoch, mig id) the DEPLOY.md runbook keys
    on."""
    reg0, ps0 = _mk_sidecar("ps0", extra_health={
        "routing_epoch": 2,
        "reshard": {"frozen": True, "frozen_age_sec": 12.5,
                    "pending_epoch": 3, "mig_id": "m3-abc",
                    "captured": 0, "captured_total": 9,
                    "lease_sec": 30.0, "snapshot_rows_left": 0}})
    reg1, ps1 = _mk_sidecar("ps1", extra_health={"routing_epoch": 2})
    mon = FleetMonitor(targets=[
        {"service": "ps0", "http_addr": ps0.addr, "role": "ps"},
        {"service": "ps1", "http_addr": ps1.addr, "role": "ps"},
    ], scrape_interval=0.1)
    try:
        mon.scrape_once()
        doc = mon.fleet_routing()
        assert doc["migrating"] == ["ps0"]
        assert doc["frozen_donors"] == [
            {"service": "ps0", "frozen_age_sec": 12.5,
             "pending_epoch": 3, "mig_id": "m3-abc"}]
        assert doc["epoch_skew"] is False
    finally:
        ps0.stop()
        ps1.stop()


# --- fleet history ring (PR 18 tentpole substrate) ---------------------------


def test_fleet_history_retention_and_aggregates():
    """Time-window + point-cap retention, duplicate-series summing
    within one scrape, and avg/min/max over the window."""
    h = FleetHistory(keep_sec=10.0, max_points=4)
    for t in (0.0, 2.0, 4.0, 6.0, 8.0):
        h.record("ps0", [("m", {}, t)], t=t)
    # max_points=4: the t=0 point fell off the cap
    assert h.avg_over("m", 100.0, now=8.0) == pytest.approx(5.0)
    assert h.min_over("m", 100.0, now=8.0) == 2.0
    assert h.max_over("m", 100.0, now=8.0) == 8.0
    # time retention: recording at t=20 prunes everything before t=10
    h.record("ps0", [("m", {}, 9.0)], t=20.0)
    assert h.avg_over("m", 100.0, now=20.0) == 9.0
    assert h.stats()["n_points"] == 1
    # duplicate series within ONE scrape sum (same contract as the
    # SLO engine's ingestion)
    h2 = FleetHistory(keep_sec=100.0, max_points=100)
    h2.record("w0", [("q", {}, 1.0), ("q", {}, 2.0)], t=0.0)
    assert h2.max_over("q", 10.0, now=1.0) == 3.0
    # unknown metric / empty window answer None, not 0
    assert h2.avg_over("nope", 10.0, now=1.0) is None
    assert h2.avg_over("q", 0.5, now=50.0) is None


def test_fleet_history_rate_and_breakdown():
    h = FleetHistory(keep_sec=100.0, max_points=100)
    for i, t in enumerate((0.0, 5.0, 10.0)):
        h.record("ps0", [("c_total", {}, 10.0 * i)], t=t)
    assert h.rate_over("c_total", 100.0, now=10.0) == pytest.approx(2.0)
    # counter reset (restart): counts from zero, never negative
    h.record("ps0", [("c_total", {}, 5.0)], t=15.0)
    assert h.rate_over("c_total", 100.0, now=15.0) == pytest.approx(
        (10.0 + 10.0 + 5.0) / 15.0)
    # breakdown: per-service decomposition, label series summed
    h3 = FleetHistory(keep_sec=100.0, max_points=100)
    h3.record("ps0", [("rows", {"shard": "a"}, 3.0),
                      ("rows", {"shard": "b"}, 5.0)], t=0.0)
    h3.record("ps1", [("rows", {}, 2.0)], t=0.0)
    assert h3.breakdown("rows", 10.0, "avg", now=1.0) == {
        "ps0": 8.0, "ps1": 2.0}
    # the aggregate view agrees with the breakdown's sum
    assert h3.avg_over("rows", 10.0, now=1.0) == 10.0
    with pytest.raises(ValueError):
        h3.breakdown("rows", 10.0, "median", now=1.0)


def test_fleet_history_excerpt_is_bounded():
    h = FleetHistory(keep_sec=1000.0, max_points=500)
    for t in range(100):
        h.record("ps0", [("m", {}, float(t))], t=float(t))
    # inventory form: metric names only
    assert h.excerpt() == [{"metric": "m"}]
    ex = h.excerpt("m", window_sec=1000.0, points=8, now=99.0)
    assert len(ex) == 1
    e = ex[0]
    assert e["service"] == "ps0" and e["metric"] == "m"
    assert len(e["points"]) == 8          # downsampled, not truncated
    assert e["points"][-1] == [0.0, 99.0]  # newest kept exactly
    ages = [p[0] for p in e["points"]]
    assert ages == sorted(ages, reverse=True)  # oldest-first ages


# --- sustained()/trend() rule grammar ---------------------------------------


def test_sustained_rule_needs_window_coverage_and_no_dip():
    eng = SloEngine([SloRule("hot", "sustained(load)", ">", 50.0,
                             window_sec=10.0)])
    eng.ingest("s", [("load", {}, 100.0)], t=0.0)
    eng.ingest("s", [("load", {}, 100.0)], t=4.0)
    # only 4s of a 10s window covered (<80%): answers None, not firing
    a = [x for x in eng.evaluate(now=4.0) if x["rule"] == "hot"][0]
    assert a["value"] is None and not a["firing"]
    eng.ingest("s", [("load", {}, 80.0)], t=8.0)
    # 8s covered (>=80%): the window extremum under '>' is the MIN
    a = [x for x in eng.evaluate(now=8.0) if x["rule"] == "hot"][0]
    assert a["value"] == 80.0 and a["firing"]
    # one dip kills "sustained" — min drops under the threshold
    eng.ingest("s", [("load", {}, 30.0)], t=10.0)
    a = [x for x in eng.evaluate(now=10.0) if x["rule"] == "hot"][0]
    assert a["value"] == 30.0 and not a["firing"]


def test_sustained_under_less_than_uses_the_max():
    # scale-in shape: fire only when load NEVER ROSE above the floor
    eng = SloEngine([SloRule("calm", "sustained(load)", "<", 20.0,
                             window_sec=10.0)])
    for t, v in ((0.0, 5.0), (4.0, 40.0), (8.0, 5.0)):
        eng.ingest("s", [("load", {}, v)], t=t)
    a = [x for x in eng.evaluate(now=8.0) if x["rule"] == "calm"][0]
    assert a["value"] == 40.0 and not a["firing"]  # one spike blocks
    for t in (12.0, 16.0, 20.0):
        eng.ingest("s", [("load", {}, 5.0)], t=t)
    a = [x for x in eng.evaluate(now=20.0) if x["rule"] == "calm"][0]
    assert a["value"] == 5.0 and a["firing"]


def test_sustained_fleet_scope_sums_services():
    eng = SloEngine([SloRule("fleet_hot", "sustained(load)", ">", 100.0,
                             window_sec=10.0, service="^ps",
                             scope="fleet")])
    for t in (0.0, 4.0, 8.0):
        eng.ingest("ps0", [("load", {}, 60.0)], t=t)
        eng.ingest("ps1", [("load", {}, 60.0)], t=t)
    a = [x for x in eng.evaluate(now=8.0)
         if x["rule"] == "fleet_hot"][0]
    assert a["service"] == "fleet"
    assert a["value"] == 120.0 and a["firing"]  # summed across replicas


def test_trend_rule_slope():
    eng = SloEngine([SloRule("grow", "trend(depth)", ">", 1.0,
                             window_sec=100.0)])
    eng.ingest("s", [("depth", {}, 0.0)], t=0.0)
    # a single point has no slope: None, not firing
    a = [x for x in eng.evaluate(now=0.0) if x["rule"] == "grow"][0]
    assert a["value"] is None and not a["firing"]
    for t, v in ((2.0, 5.0), (4.0, 10.0), (6.0, 15.0)):
        eng.ingest("s", [("depth", {}, v)], t=t)
    a = [x for x in eng.evaluate(now=6.0) if x["rule"] == "grow"][0]
    assert a["value"] == pytest.approx(2.5) and a["firing"]
    # plateau: slope decays back under the threshold
    for t in (8.0, 10.0, 12.0, 14.0, 16.0, 18.0, 20.0):
        eng.ingest("s", [("depth", {}, 15.0)], t=t)
    a = [x for x in eng.evaluate(now=20.0) if x["rule"] == "grow"][0]
    assert a["value"] < 1.0 and not a["firing"]


# --- by_label churn (variant drain / re-register / restart) ------------------


def test_by_label_churn_drain_reregister_and_restart():
    """A drained variant must not park stale firing state; the SAME
    variant re-registered after a serving restart (counters reset) must
    fire a FRESH breach event — and exactly one, not one per round."""
    hits = []
    eng = SloEngine([SloRule("vdeg", "ratio(bad_total, req_total)",
                             ">", 0.25, window_sec=25.0,
                             by_label="variant")],
                    on_breach=hits.append)

    def feed(t, variants):
        samples = []
        for name, (bad, req) in variants.items():
            samples.append(("bad_total", {"variant": name}, bad))
            samples.append(("req_total", {"variant": name}, req))
        eng.ingest("serving0", samples, t=t)

    t0 = 1000.0
    feed(t0, {"default": (0.0, 100.0), "canary": (0.0, 100.0)})
    feed(t0 + 10, {"default": (1.0, 200.0), "canary": (60.0, 200.0)})
    alerts = eng.evaluate(now=t0 + 10)
    firing = {a["service"] for a in alerts if a["firing"]}
    assert firing == {"serving0[variant=canary]"}
    assert len(hits) == 1
    # drain: the canary leaves the exposition entirely. No judgement,
    # no stale alert row, and the firing state is purged.
    feed(t0 + 20, {"default": (1.0, 300.0)})
    alerts = eng.evaluate(now=t0 + 20)
    assert not [a for a in alerts if "canary" in a["service"]]
    assert not [k for k in eng._state if "canary" in k[1]]
    # re-register after a restart: counters RESET to zero, then the
    # still-broken canary climbs again
    feed(t0 + 30, {"default": (1.0, 400.0), "canary": (0.0, 0.0)})
    assert not [a for a in eng.evaluate(now=t0 + 30) if a["firing"]]
    feed(t0 + 40, {"default": (1.0, 500.0), "canary": (30.0, 100.0)})
    alerts = eng.evaluate(now=t0 + 40)
    a = [x for x in alerts
         if x["service"] == "serving0[variant=canary]"][0]
    assert a["firing"] and a["value"] == pytest.approx(0.3)
    # a FRESH breach event — firing_since restarts at the new breach,
    # it does not inherit the pre-drain episode's clock
    assert len(hits) == 2
    assert a["firing_since"] == t0 + 40
    # still firing next round: no duplicate breach event (no
    # double-fire from the churn)
    feed(t0 + 45, {"default": (1.0, 550.0), "canary": (45.0, 150.0)})
    alerts = eng.evaluate(now=t0 + 45)
    assert [x for x in alerts
            if x["service"] == "serving0[variant=canary]"
            and x["firing"]]
    assert len(hits) == 2


# --- /fleet/history + meta-observability -------------------------------------


def test_fleet_history_endpoint_and_meta_metrics():
    """GET /fleet/history serves the ring (inventory + windowed
    aggregates + bounded excerpts), the sidecar's own request timings
    land in obs_http_request_sec, and the monitor times its rounds in
    fleet_scrape_round_sec."""
    reg0, a = _mk_sidecar("ps0")
    reg1, b = _mk_sidecar("ps1")
    g0 = reg0.gauge("ps_lookup_row_rate")
    g1 = reg1.gauge("ps_lookup_row_rate")
    mon = FleetMonitor(targets=[
        {"service": "ps0", "http_addr": a.addr},
        {"service": "ps1", "http_addr": b.addr},
    ])
    http = mon.serve_http()
    try:
        for v in (10.0, 20.0, 30.0):
            g0.set(v)
            g1.set(v / 10.0)
            mon.scrape_once()
            time.sleep(0.02)
        # inventory form: the scraped metric names + ring stats
        inv = json.loads(_get(f"http://{http.addr}/fleet/history"))
        assert "ps_lookup_row_rate" in inv["metrics"]
        assert "up" in inv["metrics"]  # synthetic liveness series
        assert inv["stats"]["n_series"] >= 2
        # per-metric form: aggregates + breakdown + bounded series
        doc = json.loads(_get(
            f"http://{http.addr}/fleet/history"
            f"?metric=ps_lookup_row_rate&window=60&points=2"))
        assert doc["max"] == pytest.approx(30.0 + 3.0)  # summed series
        assert doc["min"] == pytest.approx(10.0 + 1.0)
        assert doc["breakdown"]["ps0"] == pytest.approx(20.0)
        assert doc["breakdown"]["ps1"] == pytest.approx(2.0)
        assert {s["service"] for s in doc["series"]} == {"ps0", "ps1"}
        assert all(len(s["points"]) <= 2 for s in doc["series"])
        # ?service= regex narrows every view consistently
        doc = json.loads(_get(
            f"http://{http.addr}/fleet/history"
            f"?metric=ps_lookup_row_rate&service=ps1"))
        assert doc["max"] == pytest.approx(3.0)
        assert list(doc["breakdown"]) == ["ps1"]
        # meta-observability: the sidecar timed its own /metrics GETs…
        samples, _ = parse_exposition(reg0.render())
        hist = {(n, tuple(sorted(l.items()))): v for n, l, v in samples}
        assert hist[("obs_http_request_sec_count",
                     (("path", "/metrics"),))] >= 3.0
        # …and the monitor timed its scrape rounds
        msam, _ = parse_exposition(mon.registry.render())
        d = {n: v for n, l, v in msam if not l}
        assert d["fleet_scrape_round_sec_count"] >= 3.0
        assert d["fleet_scrape_rounds_total"] >= 3.0
    finally:
        http.stop()
        mon.stop()
        a.stop()
        b.stop()


# --- parity with the JAX package ---------------------------------------------

import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

import persia_tpu_torch  # noqa: E402
from persia_tpu import fleet as jfleet  # noqa: E402
from persia_tpu import obs_http as jobs_http  # noqa: E402
from persia_tpu import slos as jslos  # noqa: E402
from persia_tpu_torch import fleet as tfleet  # noqa: E402
from persia_tpu_torch import slos as tslos  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grammar_rules(pkg):
    """Every expression form, scope and option of the grammar, beside the
    default rules."""
    R = pkg.SloRule
    return pkg.default_rules() + [
        R("depth", "queue_depth", ">", 5.0),
        R("rate", "rate(reqs_total)", ">", 3.0, window_sec=20.0),
        R("inc", "increase(errs_total)", ">=", 4.0, window_sec=30.0),
        R("ratio", "ratio(errs_total, reqs_total)", ">", 0.1,
          window_sec=25.0, for_sec=4.0),
        R("p50", "p50(lat_sec)", ">", 0.05, window_sec=30.0),
        R("p90", "p90(lat_sec)", ">", 0.2, window_sec=30.0),
        R("p95", "p95(lat_sec)", "<", 0.9, window_sec=30.0),
        R("p99", "p99(lat_sec)", ">", 0.5, window_sec=30.0),
        R("hot", "sustained(queue_depth)", ">", 3.0, window_sec=12.0),
        R("calm", "sustained(queue_depth)", "<=", 8.0, window_sec=12.0),
        R("grow", "trend(queue_depth)", ">", 0.2, window_sec=20.0),
        R("fleet_rate", "rate(reqs_total)", ">", 8.0, window_sec=20.0,
          scope="fleet", service="^ps"),
        R("vdeg", "ratio(bad_total, req_total)", ">", 0.2,
          window_sec=20.0, by_label="variant"),
        R("down_ps", "up", "<", 1.0, for_sec=3.0, service="^ps"),
    ]


def _seeded_windows(seed: int, ticks: int = 24):
    """Per tick: service -> samples (or None: the target is down), from
    a seeded walk of counters (with one restart), gauges, a histogram and
    variant-labeled counters."""
    rng = np.random.default_rng(seed)
    services = ["ps0", "ps1", "worker0", "serving0"]
    state = {s: {"reqs": 0.0, "errs": 0.0, "lost": 0.0,
                 "buckets": np.zeros(4), "bad": {"a": 0.0, "b": 0.0},
                 "req": {"a": 0.0, "b": 0.0}} for s in services}
    out = []
    for tick in range(ticks):
        snap = {}
        for s in services:
            st = state[s]
            if s == "ps1" and 9 <= tick < 13:
                snap[s] = None  # stalled: scrapes fail
                continue
            if s == "worker0" and tick == 15:  # a restart
                st["reqs"] = st["errs"] = 0.0
            st["reqs"] += float(rng.integers(0, 80))
            st["errs"] += float(rng.integers(0, 12))
            st["lost"] += float(rng.integers(0, 2))
            st["buckets"] += rng.integers(0, 20, size=4)
            samples = [("reqs_total", {}, st["reqs"]),
                       ("errs_total", {}, st["errs"]),
                       ("pipeline_lost_updates_total", {}, st["lost"]),
                       ("queue_depth", {}, float(rng.integers(0, 12))),
                       ("queue_depth", {"shard": "b"},
                        float(rng.integers(0, 3)))]
            cum = np.cumsum(st["buckets"])
            for le, v in zip(("0.1", "0.5", "1.0", "+Inf"), cum):
                samples.append(("lat_sec_bucket", {"le": le}, float(v)))
            samples.append(("lat_sec_count", {}, float(cum[-1])))
            if s == "serving0":
                for v in ("a", "b"):
                    if v == "b" and tick in (17, 18):
                        continue  # variant b drained, then back
                    st["req"][v] += float(rng.integers(1, 40))
                    st["bad"][v] += float(rng.integers(0, 10 if v == "b"
                                                       else 2))
                    samples += [("bad_total", {"variant": v},
                                 st["bad"][v]),
                                ("req_total", {"variant": v},
                                 st["req"][v])]
            snap[s] = samples
        out.append(snap)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_engine_matches_jax_on_seeded_windows(seed, monkeypatch):
    """The same seeded scrape windows through both packages' engines:
    equal ``evaluate()`` at every tick, equal ``alerts()`` (all and
    firing), breach logs and exit codes."""
    jhits, thits = [], []
    jeng = jslos.SloEngine(_grammar_rules(jslos), on_breach=jhits.append)
    teng = tslos.SloEngine(_grammar_rules(tslos), on_breach=thits.append)
    t0 = 5000.0
    n_firing = 0
    for tick, snap in enumerate(_seeded_windows(seed)):
        t = t0 + 2.0 * tick
        for eng in (jeng, teng):
            for svc, samples in snap.items():
                if samples is None:
                    eng.mark_down(svc, t=t)
                else:
                    eng.ingest(svc, samples, t=t)
        ja, ta = jeng.evaluate(now=t), teng.evaluate(now=t)
        assert ta == ja, tick
        n_firing += sum(a["firing"] for a in ta)
    assert n_firing > 0  # the walk breaches something
    assert thits == jhits and len(thits) > 0
    assert teng.breach_events() == jeng.breach_events()
    now = t0 + 2.0 * 23
    monkeypatch.setattr(time, "monotonic", lambda: now)
    assert teng.alerts() == jeng.alerts()
    assert teng.alerts(firing_only=True) == jeng.alerts(firing_only=True)
    assert teng.exit_code() == jeng.exit_code() == 1
    for eng in (jeng, teng):
        eng.forget("ps1")
        eng.add_rules([eng.rules[0]])  # idempotent by name
    assert [r.describe() for r in teng.rules] == \
        [r.describe() for r in jeng.rules]
    assert teng.evaluate(now=now) == jeng.evaluate(now=now)


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_history_matches_jax(seed):
    """Seeded scrapes into both packages' history rings (a point cap and
    a time window that both prune): equal aggregates, breakdowns,
    excerpts and stats."""
    jh = jfleet.FleetHistory(keep_sec=30.0, max_points=9)
    th = tfleet.FleetHistory(keep_sec=30.0, max_points=9)
    t0 = 100.0
    for tick, snap in enumerate(_seeded_windows(seed)):
        t = t0 + 2.0 * tick
        for h in (jh, th):
            for svc, samples in snap.items():
                if samples is not None:
                    h.record(svc, samples, t=t)
                h.record_up(svc, samples is not None, t=t)
    now = t0 + 2.0 * 23
    for metric in ("reqs_total", "queue_depth", "lat_sec_bucket", "up",
                   "req_total", "absent"):
        for window in (5.0, 17.0, 60.0):
            for service in (None, "^ps", "serving0"):
                for fn in ("avg_over", "min_over", "max_over", "rate_over"):
                    assert getattr(th, fn)(metric, window, service, now) \
                        == getattr(jh, fn)(metric, window, service, now)
                for agg in ("avg", "min", "max", "rate"):
                    assert th.breakdown(metric, window, agg, service, now) \
                        == jh.breakdown(metric, window, agg, service, now)
                assert th.excerpt(metric, window, service, 4, now) == \
                    jh.excerpt(metric, window, service, 4, now)
    assert th.excerpt() == jh.excerpt()
    assert th.stats() == jh.stats()


def _parity_sidecars():
    """Port sidecars carrying every kind of series and the health keys
    the status document reads: two PS replicas (one with a SIMD path of
    its own, both with hotness sketches) and a trainer of a group."""
    from persia_tpu_torch.hotness import HotnessTracker

    rng = np.random.default_rng(11)
    sidecars, regs = [], []
    for i, extra in enumerate((
            {"simd": "avx2", "routing_epoch": 2, "update_version": 7},
            {"simd": "avx2", "routing_epoch": 2, "update_version": 9},
            {"process_index": 0, "process_count": 1,
             "mesh_shape": "1x1"})):
        reg = MetricsRegistry()
        reg.counter("reqs_total", help_text="served requests").inc(5 + i)
        reg.gauge("queue_depth", labels={"shard": "a"}).set(3.0 * i)
        h = reg.histogram("lat_sec")
        for v in (0.01, 0.2, 0.9):
            h.observe(v * (i + 1))
        tracker = None
        if i < 2:
            tracker = HotnessTracker(4)
            for table in (8, 16):
                tracker.observe(table, (rng.zipf(1.2, 3000) % 5000 + 1)
                                .astype(np.uint64))
        sidecars.append(ObservabilityServer(
            registry=reg, collector=tracing.TraceCollector(),
            health_fn=lambda e=extra: {"ready": True, **e},
            hotness_fn=tracker.snapshot if tracker else None,
            service=f"svc{i}").start())
        regs.append(reg)
    targets = [{"service": "ps0", "http_addr": sidecars[0].addr,
                "role": "ps", "replica": 0},
               {"service": "ps1", "http_addr": sidecars[1].addr,
                "role": "ps", "replica": 1},
               {"service": "trainer", "http_addr": sidecars[2].addr,
                "role": "trainer", "replica": 0}]
    return sidecars, targets


# what moves between two scrapes of the same sidecar, or is the monitor's
# own: the sidecar's timing of its own GETs, scrape ages, round timings
_MOVING = ("obs_http_request_sec", "last_scrape_age_sec",
           "fleet_scrape_round_sec")


def _steady_status(doc):
    doc = json.loads(json.dumps(doc))
    mon = doc.pop("fleet_monitor")
    for t in doc["targets"]:
        for k in ("last_scrape_age_sec", "last_attempt_age_sec",
                  "uptime_sec"):
            t.pop(k)
    return mon, doc


def test_monitors_of_both_packages_agree_over_port_sidecars():
    """Both packages' monitors over the same port sidecars: the same
    ``/fleet/metrics`` lines (apart from what moves between two scrapes)
    and the same ``/fleet/status`` document apart from the monitor's own
    version and clocks; the same routing, variants and history views,
    and the same hotness report and placement plan."""
    sidecars, targets = _parity_sidecars()
    mons = [jfleet.FleetMonitor(targets=targets),
            tfleet.FleetMonitor(targets=targets)]
    try:
        for m in mons:
            assert m.scrape_once() == 3
        jm, tm = ([ln for ln in m.fleet_metrics().splitlines()
                   if not any(k in ln for k in _MOVING)] for m in mons)
        assert tm == jm and any("reqs_total" in ln for ln in tm)
        (jmon, jst), (tmon, tst) = (_steady_status(m.fleet_status())
                                    for m in mons)
        assert tst == jst
        assert not tst["version_skew"] and not tst["simd_skew"]
        assert {t["version"] for t in tst["targets"]} == {
            persia_tpu_torch.__version__}
        assert tmon["version"] == persia_tpu_torch.__version__
        assert jmon["version"] != tmon["version"]
        assert tmon.keys() == jmon.keys()
        jv, tv = (m.fleet_variants() for m in mons)
        assert tv == jv
        jr, tr = (m.fleet_routing() for m in mons)
        for r in (jr, tr):
            for t in r["targets"]:
                t.pop("last_scrape_age_sec")
        assert tr == jr and tr["epoch_min"] == 2
        jhist, thist = (m.fleet_history("reqs_total", window_sec=60.0)
                        for m in mons)
        for h in (jhist, thist):
            for s in h["series"]:
                s["points"] = [[0.0, v] for _, v in s["points"]]
        assert thist == jhist
        jplan, tplan = (m.hotness_plan(3) for m in mons)
        assert tplan == jplan and tplan["num_replicas"] == 3
        jhot, thot = (m.fleet_hotness(hbm_bytes=1 << 20, num_replicas=2)
                      for m in mons)
        assert thot == jhot and len(thot["sources"]) == 2
    finally:
        for m in mons:
            m.stop()
        for s in sidecars:
            s.stop()


@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_load_rules_matches_jax(fmt, tmp_path):
    """A rule file with every field, as YAML (the port's subset reads
    it) and as JSON (read first as JSON): the port's rules equal the JAX
    ``load_rules``'s, both as a list and under ``rules:``."""
    rules = [
        {"name": "lost", "expr": "rate(pipeline_lost_updates_total)",
         "op": ">", "threshold": 0, "window_sec": 45},
        {"name": "deg", "expr": "ratio(bad_total, all_total)",
         "threshold": 0.1, "for_sec": 30, "service": "^serving",
         "severity": "ticket", "description": "degraded: over 10%",
         "by_label": "variant"},
        {"name": "fleet_hot", "expr": "sustained(load)", "op": "<=",
         "threshold": 2.5, "scope": "fleet", "window_sec": 120},
        {"name": "p99", "expr": "p99(lat_sec)", "op": ">=",
         "threshold": 1e-3},
    ]
    for doc in (rules, {"rules": rules}):
        path = tmp_path / f"rules.{fmt}"
        if fmt == "json":
            path.write_text(json.dumps(doc, indent=1))
        else:
            from persia_tpu_torch import _yaml

            path.write_text(_yaml.dump(doc))
        mine = tslos.load_rules(str(path))
        ref = jslos.load_rules(str(path))
        assert [r.describe() for r in mine] == [r.describe() for r in ref]
        assert [(r.fn, r.arg1, r.arg2) for r in mine] == \
            [(r.fn, r.arg1, r.arg2) for r in ref]


@pytest.mark.parametrize("mixed", [False, True])
def test_version_skew_decision(mixed):
    """A fleet of port sidecars reports no ``version_skew``; one that
    mixes a JAX package's sidecar reports it (the packages run different
    step functions). Both packages' monitors agree either way."""
    _, a = _mk_sidecar("ps0")
    b = (jobs_http.ObservabilityServer(health_fn=lambda: {"ready": True},
                                       service="ps1").start() if mixed
         else _mk_sidecar("ps1")[1])
    targets = [{"service": "ps0", "http_addr": a.addr},
               {"service": "ps1", "http_addr": b.addr}]
    mons = [jfleet.FleetMonitor(targets=targets),
            tfleet.FleetMonitor(targets=targets)]
    try:
        docs = []
        for m in mons:
            m.scrape_once()
            docs.append(m.fleet_status())
        for st in docs:
            assert st["version_skew"] is mixed
            versions = {t["service"]: t["version"] for t in st["targets"]}
            assert versions["ps0"] == persia_tpu_torch.__version__
            assert (versions["ps1"] != versions["ps0"]) is mixed
    finally:
        for m in mons:
            m.stop()
        a.stop()
        b.stop()


def test_fleet_cli_serves_status_and_checks(tmp_path):
    """``python -m persia_tpu_torch.fleet`` as a process: it serves
    ``/fleet/status`` over its static targets; ``--check`` exits 0 on a
    healthy fleet and 1 once ``target_down`` fires, printing the rule."""
    reg, a = _mk_sidecar("ps0")
    reg.counter("reqs_total").inc(2)
    _, dead = _mk_sidecar("ps9")
    dead.stop()
    env = {**os.environ, "PYTHONPATH": REPO, "LOG_LEVEL": "WARNING"}
    addr_file = tmp_path / "fleet.addr"
    proc = subprocess.Popen(
        [sys.executable, "-m", "persia_tpu_torch.fleet", "--targets",
         f"ps0={a.addr}", "--scrape-interval", "0.2", "--addr-file",
         str(addr_file)], env=env, cwd=tmp_path)
    try:
        deadline = time.monotonic() + 60
        status = None
        while time.monotonic() < deadline:
            if addr_file.exists() and addr_file.read_text():
                status = json.loads(_get(
                    f"http://{addr_file.read_text()}/fleet/status"))
                if status["n_up"] == 1:
                    break
            assert proc.poll() is None
            time.sleep(0.1)
        assert status["n_up"] == 1 and not status["version_skew"]
        assert status["fleet_monitor"]["version"] == \
            persia_tpu_torch.__version__
        metrics = _get(f"http://{addr_file.read_text()}/fleet/metrics")
        assert 'reqs_total{replica="0",service="ps0"} 2.0' in metrics
        for target, rc in ((f"ps0={a.addr}", 0), (f"ps9={dead.addr}", 1)):
            out = subprocess.run(
                [sys.executable, "-m", "persia_tpu_torch.fleet",
                 "--targets", target, "--check", "1", "--scrape-interval",
                 "0.05"], env=env, cwd=tmp_path, capture_output=True,
                text=True, timeout=120)
            assert out.returncode == rc, out.stdout + out.stderr
            assert ("target_down on ps9" in out.stdout) is bool(rc)
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        a.stop()
