"""The port's autopilot (``persia_tpu_torch/autopilot.py``) on the CPU,
against the JAX package's.

``tests/test_autopilot.py``'s 14 tests run on the port over injected time:
policy hysteresis and hold, cooldown and rate-limit gating in both modes,
the journal's record format and on-disk reload, deferred verification,
and the recommend-mode wire-neutrality pin against a live in-process PS
behind a port sidecar. Parity (tolerance: equality): one scripted
timeline of history and firing alerts (scale-out, a skew that
rebalances, a burning variant, calm that scales back in, a regression)
through both packages' ``Autopilot`` in recommend and in enforce mode,
each over its own SLO engine and history ring with recording operators,
gives the same decision stream (policy, kind, action, reason), the same
operator calls and postmortem captures, and journal records equal but
for their wall-clock ``ts``.
"""

import json
import os

import pytest

from persia_tpu_torch.autopilot import (ActionJournal, Autopilot,
                                        PsScalePolicy, RebalancePolicy,
                                        VariantShedPolicy, default_policies)
from persia_tpu_torch.fleet import FleetHistory
from persia_tpu_torch.slos import SloEngine


class SpyRecorder:
    def __init__(self):
        self.captures = []

    def capture(self, service, reason, extra=None):
        self.captures.append((service, reason, extra))


class FakeMonitor:
    """A real SLO engine + real history ring fed by hand with explicit
    timestamps — the pilot only ever reads these, so nothing else of
    the fleet plane is needed."""

    def __init__(self):
        self.engine = SloEngine()
        self.history = FleetHistory()
        self.recorder = None
        self.plan = None

    def feed(self, service, rows_rate, t):
        samples = [("ps_lookup_row_rate", {}, float(rows_rate))]
        self.engine.ingest(service, samples, t=t)
        self.history.record(service, samples, t=t)

    def hotness_plan(self, num_replicas, num_slots=None,
                     current_table=None):
        if self.plan is None:
            raise RuntimeError("no hotness telemetry")
        return dict(self.plan)


class FakeOperator:
    def __init__(self, replicas=2):
        self._replicas = {"job": replicas}
        self.calls = []

    def ps_replicas(self, job):
        return self._replicas[job]

    def scale_ps(self, job, replicas):
        self.calls.append(("scale_ps", job, replicas))
        self._replicas[job] = replicas
        return {"job": job, "to": replicas, "status": "done"}

    def rebalance_ps(self, job):
        self.calls.append(("rebalance_ps", job))
        return {"job": job, "phase": "rebalance", "status": "done"}

    def variant_op(self, job, op, payload):
        self.calls.append(("variant_op", job, op, dict(payload)))
        return {"job": job, "op": op, "status": "done"}


def _mk_scale_pilot(mode="enforce", journal_dir=None, cooldown=0.0,
                    per_hour=100, replicas=2, verify_sec=30.0):
    mon, op = FakeMonitor(), FakeOperator(replicas=replicas)
    policy = PsScalePolicy("job", scale_out_at=100.0,
                           scale_in_below=20.0, window_sec=10.0,
                           min_replicas=2, max_replicas=4,
                           verify_sec=verify_sec)
    pilot = Autopilot(mon, op, "job", policies=[policy], mode=mode,
                      journal_dir=journal_dir, cooldown_sec=cooldown,
                      max_actions_per_hour=per_hour)
    return mon, op, policy, pilot


def _feed_window(mon, per_service, t0, t1, step=2.0):
    t = t0
    while t <= t1:
        for svc, v in per_service.items():
            mon.feed(svc, v, t)
        t += step


def _tick(pilot, mon, now):
    return pilot.tick(now, mon.engine.evaluate(now))


def test_scale_policy_hysteresis_band():
    mon, op, _policy, pilot = _mk_scale_pilot()
    # sustained high: both replicas hold 80 rows/s across the whole
    # window -> fleet sum of window-minima 160 > 100
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 0.0, 10.0)
    decisions = _tick(pilot, mon, 10.0)
    assert [d["kind"] for d in decisions] == ["scale_out"]
    assert op.calls == [("scale_ps", "job", 3)]
    assert op.ps_replicas("job") == 3

    # mid-band (sum 60: between 20 and 100) holds the size
    _feed_window(mon, {"ps0": 30.0, "ps1": 30.0}, 12.0, 24.0)
    assert _tick(pilot, mon, 24.0) == []
    assert op.ps_replicas("job") == 3

    # sustained low (sum of window-maxima 10 < 20) -> scale back in
    _feed_window(mon, {"ps0": 5.0, "ps1": 5.0}, 26.0, 38.0)
    decisions = _tick(pilot, mon, 38.0)
    assert [d["kind"] for d in decisions] == ["scale_in"]
    assert op.ps_replicas("job") == 2

    # at the floor, sustained low proposes nothing
    _feed_window(mon, {"ps0": 5.0, "ps1": 5.0}, 40.0, 52.0)
    assert _tick(pilot, mon, 52.0) == []


def test_one_spike_is_not_sustained():
    mon, op, _policy, pilot = _mk_scale_pilot()
    # one scrape spikes far over the threshold; the rest of the
    # window sits below it — sustained() (window min) must hold fire
    _feed_window(mon, {"ps0": 40.0, "ps1": 40.0}, 0.0, 4.0)
    mon.feed("ps0", 5000.0, 6.0)
    mon.feed("ps1", 5000.0, 6.0)
    _feed_window(mon, {"ps0": 40.0, "ps1": 40.0}, 8.0, 10.0)
    assert _tick(pilot, mon, 10.0) == []
    assert op.calls == []


def test_journal_format_evidence_and_disk_reload(tmp_path):
    jdir = str(tmp_path / "journal")
    mon, op, _policy, pilot = _mk_scale_pilot(journal_dir=jdir)
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 0.0, 10.0)
    assert len(_tick(pilot, mon, 10.0)) == 1

    recs = ActionJournal(jdir).records()
    assert [r["kind"] for r in recs] == ["decision", "executed"]
    dec, exe = recs
    # the decision nests its payload: the record's own "kind" is the
    # record type, the ACTION kind lives inside
    assert dec["decision"]["kind"] == "scale_out"
    assert dec["decision"]["action"] == {"job": "job", "replicas": 3}
    ev = dec["decision"]["evidence"]
    assert ev["firing_rules"] and ev["history"]
    assert all(a["rule"] == "autopilot_ps_scale_load_high"
               for a in ev["firing_rules"])
    assert all(e["metric"] == "ps_lookup_row_rate" and e["points"]
               for e in ev["history"])
    assert exe["action_kind"] == "scale_out"
    assert exe["decision_seq"] == dec["decision"]["decision_seq"]
    assert exe["operator_event"]["status"] == "done"
    # every record is its own atomic file, readable in isolation
    names = sorted(os.listdir(jdir))
    assert len(names) == 2 and all(n.startswith("rec_") for n in names)
    for n in names:
        json.loads(open(os.path.join(jdir, n)).read())
    # record keys are reserved — a field cannot shadow them
    j = ActionJournal(jdir)
    with pytest.raises(ValueError):
        j.append("decision", kind="scale_out")
    with pytest.raises(ValueError):
        j.append("decision", seq=1, ts=0.0)


def test_cooldown_defers_with_reason():
    mon, op, _policy, pilot = _mk_scale_pilot(cooldown=100.0)
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 0.0, 10.0)
    assert len(_tick(pilot, mon, 10.0)) == 1
    # load still high at 3 replicas (max 4): proposal repeats but the
    # per-(policy, kind) cooldown blocks it -> deferred, no operator
    # call
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 12.0, 22.0)
    assert _tick(pilot, mon, 22.0) == []
    assert op.calls == [("scale_ps", "job", 3)]
    deferred = [r for r in pilot.journal.tail()
                if r["kind"] == "deferred"]
    assert deferred and "cooldown" in deferred[-1]["blocked_by"]
    assert deferred[-1]["action_kind"] == "scale_out"


def test_global_rate_limit():
    mon, op, _policy, pilot = _mk_scale_pilot(per_hour=1)
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 0.0, 10.0)
    assert len(_tick(pilot, mon, 10.0)) == 1
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 12.0, 22.0)
    assert _tick(pilot, mon, 22.0) == []
    deferred = [r for r in pilot.journal.tail()
                if r["kind"] == "deferred"]
    assert deferred and "rate limit" in deferred[-1]["blocked_by"]
    # the trailing-hour window forgets: an hour later the same
    # proposal clears
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 3700.0, 3710.0)
    assert len(_tick(pilot, mon, 3710.0)) == 1


def test_recommend_mode_never_touches_the_operator():
    mon, op, _policy, pilot = _mk_scale_pilot(mode="recommend")
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 0.0, 10.0)
    decisions = _tick(pilot, mon, 10.0)
    assert [d["kind"] for d in decisions] == ["scale_out"]
    assert decisions[0]["mode"] == "recommend"
    assert op.calls == []
    assert op.ps_replicas("job") == 2
    # journaled all the same — the recommend soak IS the audit trail
    kinds = [r["kind"] for r in pilot.journal.tail()]
    assert kinds == ["decision"]


def test_recommend_matches_enforce_decision_for_decision():
    mon = FakeMonitor()
    op = FakeOperator(replicas=2)

    def mk(mode):
        return Autopilot(
            mon, op, "job",
            policies=[PsScalePolicy("job", scale_out_at=100.0,
                                    scale_in_below=20.0,
                                    window_sec=10.0, min_replicas=2,
                                    max_replicas=4, verify_sec=5.0)],
            mode=mode, cooldown_sec=0.0, max_actions_per_hour=100)

    # shadow shares the operator (reads the same observed replica
    # counts) and ticks FIRST, before enforcement mutates the world
    shadow, enforce = mk("recommend"), mk("enforce")
    rec, enf = [], []
    script = [({"ps0": 80.0, "ps1": 80.0}, 10.0),   # -> scale_out
              ({"ps0": 30.0, "ps1": 30.0}, 24.0),   # hold
              ({"ps0": 5.0, "ps1": 5.0}, 38.0)]     # -> scale_in
    t_prev = 0.0
    for load, t_end in script:
        _feed_window(mon, load, t_prev + 2.0, t_end)
        alerts = mon.engine.evaluate(t_end)
        rec.extend(shadow.tick(t_end, alerts))
        enf.extend(enforce.tick(t_end, alerts))
        t_prev = t_end

    key = [(d["policy"], d["kind"], d["action"]) for d in rec]
    assert key == [(d["policy"], d["kind"], d["action"]) for d in enf]
    assert [k[1] for k in key] == ["scale_out", "scale_in"]
    # only the enforce pilot acted
    assert op.calls == [("scale_ps", "job", 3), ("scale_ps", "job", 2)]


def test_rebalance_hold_min_gain_and_hysteresis():
    mon = FakeMonitor()
    op = FakeOperator(replicas=2)
    policy = RebalancePolicy("job", share_threshold=0.6, hold_sec=5.0,
                             min_gain=0.05, window_sec=10.0,
                             verify_sec=30.0)
    pilot = Autopilot(mon, op, "job", policies=[policy],
                      mode="enforce", cooldown_sec=0.0,
                      max_actions_per_hour=100)
    # ps0 carries 90% — breach, but it must HOLD for hold_sec first
    _feed_window(mon, {"ps0": 90.0, "ps1": 10.0}, 0.0, 10.0)
    mon.plan = {"assignment": [0, 1], "max_replica_share": 0.5,
                "hash_even_max_share": 0.9, "moved_slots": 1,
                "slot_weights": [90.0, 10.0]}
    assert _tick(pilot, mon, 10.0) == []       # pending starts
    assert _tick(pilot, mon, 13.0) == []       # 3s held < 5s
    # held long enough, but a plan that cannot help blocks the move
    mon.plan["max_replica_share"] = 0.88       # 0.9 - 0.05 < 0.88
    assert _tick(pilot, mon, 16.0) == []
    mon.plan["max_replica_share"] = 0.5
    decisions = _tick(pilot, mon, 17.0)
    assert [d["kind"] for d in decisions] == ["rebalance"]
    assert decisions[0]["plan"]["max_replica_share"] == 0.5
    assert decisions[0]["plan"]["measured_shares"]["ps0"] > 0.8
    assert op.calls == [("rebalance_ps", "job")]
    # hysteresis: once the share clears the band, a NEW breach starts
    # a fresh hold — no instant re-fire off stale pending state
    _feed_window(mon, {"ps0": 50.0, "ps1": 50.0}, 19.0, 29.0)
    assert _tick(pilot, mon, 29.0) == []
    _feed_window(mon, {"ps0": 90.0, "ps1": 10.0}, 31.0, 41.0)
    assert _tick(pilot, mon, 41.0) == []       # held 0s: pending only
    assert _tick(pilot, mon, 47.0) != []       # held >5s: fires again


def test_scale_in_watches_the_high_rule_not_the_low_one():
    mon, op, _policy, pilot = _mk_scale_pilot(replicas=3,
                                              verify_sec=5.0)
    # sustained low at 3 replicas -> scale_in executes
    _feed_window(mon, {"ps0": 5.0, "ps1": 5.0}, 0.0, 10.0)
    assert [d["kind"] for d in _tick(pilot, mon, 10.0)] == ["scale_in"]
    # load STAYS low through the verify window — the low rule still
    # fires, and that is exactly what a correct shrink looks like:
    # the verdict must be improved, not regressed
    _feed_window(mon, {"ps0": 5.0, "ps1": 5.0}, 12.0, 16.0)
    _tick(pilot, mon, 16.0)
    kinds = [r["kind"] for r in pilot.journal.tail()]
    assert "outcome" in kinds and "regressed" not in kinds
    outcome = [r for r in pilot.journal.tail()
               if r["kind"] == "outcome"][-1]
    assert outcome["action_kind"] == "scale_in" and outcome["improved"]


def test_scale_out_regression_captures_postmortem():
    mon, op, _policy, pilot = _mk_scale_pilot(verify_sec=5.0)
    spy = SpyRecorder()
    mon.recorder = spy
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 0.0, 10.0)
    assert [d["kind"] for d in _tick(pilot, mon, 10.0)] == ["scale_out"]
    # the high rule is STILL firing after the verify window: the
    # scale-out did not move its target signal
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 12.0, 16.0)
    _tick(pilot, mon, 16.0)
    regressed = [r for r in pilot.journal.tail()
                 if r["kind"] == "regressed"]
    assert len(regressed) == 1
    assert regressed[0]["action_kind"] == "scale_out"
    assert regressed[0]["watch_rule"] == "autopilot_ps_scale_load_high"
    assert len(spy.captures) == 1
    service, reason, _extra = spy.captures[0]
    assert service in ("ps0", "ps1")
    assert reason == "autopilot_regressed:scale_out"


def test_variant_shed_from_by_label_alert():
    mon = FakeMonitor()
    op = FakeOperator()
    pilot = Autopilot(mon, op, "job",
                      policies=[VariantShedPolicy("job", shed_to=0.1)],
                      mode="enforce", cooldown_sec=0.0,
                      max_actions_per_hour=100)
    alerts = [{"rule": "variant_degraded", "firing": True,
               "service": "serving0[variant=canary]", "value": 0.4,
               "expr": "ratio(bad, all)", "op": ">", "threshold": 0.25,
               "firing_since": 1.0}]
    decisions = pilot.tick(10.0, alerts)
    assert [d["kind"] for d in decisions] == ["variant_shed"]
    assert decisions[0]["action"] == {"job": "job", "name": "canary",
                                      "weight": 0.1}
    assert op.calls == [("variant_op", "job", "weight",
                         {"name": "canary", "weight": 0.1})]
    # evidence carries the triggering by_label alert itself
    ev = decisions[0]["evidence"]
    assert ev["firing_rules"][0]["service"] == \
        "serving0[variant=canary]"


def test_failed_action_is_journaled_not_raised():
    mon, op, _policy, pilot = _mk_scale_pilot()

    def boom(job, replicas):
        raise RuntimeError("kube apiserver down")

    op.scale_ps = boom
    _feed_window(mon, {"ps0": 80.0, "ps1": 80.0}, 0.0, 10.0)
    decisions = _tick(pilot, mon, 10.0)   # must not raise
    assert len(decisions) == 1
    recs = pilot.journal.tail()
    failed = [r for r in recs if r["kind"] == "action_failed"]
    assert len(failed) == 1
    assert failed[0]["action_kind"] == "scale_out"
    assert "kube apiserver down" in failed[0]["error"]
    assert not [r for r in recs if r["kind"] == "executed"]


def test_default_policies_shape_and_describe():
    policies = default_policies("job")
    assert [p.name for p in policies] == ["ps_scale", "ps_rebalance",
                                         "variant_shed"]
    mon, op = FakeMonitor(), FakeOperator()
    pilot = Autopilot(mon, op, "job", mode="recommend")
    doc = pilot.describe()
    assert doc["mode"] == "recommend"
    assert doc["policies"] == ["ps_scale", "ps_rebalance",
                               "variant_shed"]
    assert doc["actions_trailing_hour"] == 0
    # the policies' rules joined the monitor's live alert surface
    names = {r.name for r in mon.engine.rules}
    assert {"autopilot_ps_scale_load_high",
            "autopilot_ps_scale_load_low"} <= names


def test_recommend_pilot_is_wire_neutral_against_live_ps():
    """The pull-only pin: a recommend-mode pilot driving scrapes and
    ticks over a LIVE PS adds zero requests on the RPC plane."""
    from persia_tpu_torch.fleet import FleetMonitor
    from persia_tpu_torch.metrics import default_registry
    from persia_tpu_torch.obs_http import ObservabilityServer
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.service.ps_service import PsService

    svc = PsService(EmbeddingHolder(capacity=10_000, hotness=True),
                    port=0)
    svc.server.serve_background()
    side = ObservabilityServer(
        registry=default_registry(), health_fn=svc._health,
        service="ps0", refresh_fn=svc._refresh_mem_gauges,
        hotness_fn=svc._hotness_snapshot).start()
    mon = FleetMonitor(
        targets=[{"service": "ps0", "http_addr": side.addr,
                  "role": "ps"}])
    pilot = Autopilot(mon, FakeOperator(), "job", mode="recommend",
                      cooldown_sec=0.0, max_actions_per_hour=100)
    try:
        before = svc.server.health()["served_rpcs"]
        for _ in range(3):
            mon.scrape_once()
            pilot.tick()
        assert svc.server.health()["served_rpcs"] == before == 0
    finally:
        mon.stop()
        side.stop()
        svc.stop()


# --- parity with the JAX package --------------------------------------------

class PkgMonitor(FakeMonitor):
    """FakeMonitor over one package's SLO engine and history ring."""

    def __init__(self, engine, history):
        self.engine, self.history = engine, history
        self.recorder = SpyRecorder()
        self.plan = None


def _package(name):
    if name == "port":
        from persia_tpu_torch import autopilot, fleet, slos
    else:
        from persia_tpu import autopilot, fleet, slos
    return autopilot, fleet, slos


def _policies(ap):
    return [
        ap.PsScalePolicy("job", scale_out_at=100.0, scale_in_below=20.0,
                         window_sec=10.0, min_replicas=2, max_replicas=4,
                         verify_sec=6.0),
        ap.RebalancePolicy("job", share_threshold=0.6, hold_sec=5.0,
                           min_gain=0.05, window_sec=10.0, verify_sec=6.0),
        ap.VariantShedPolicy("job", shed_to=0.1, verify_sec=6.0),
    ]


VARIANT_ALERT = {"rule": "variant_degraded", "firing": True,
                 "service": "serving0[variant=canary]", "value": 0.4,
                 "expr": "ratio(bad, all)", "op": ">", "threshold": 0.25,
                 "firing_since": 1.0}

# (per-service row rates fed every 2 s up to the tick, the tick's time,
# a placement plan for the rebalance policy, extra alerts)
TIMELINE = [
    ({"ps0": 80.0, "ps1": 80.0}, 10.0, None, []),    # scale_out
    ({"ps0": 90.0, "ps1": 10.0}, 16.0, None, []),    # skew: hold starts
    ({"ps0": 90.0, "ps1": 10.0}, 22.0,
     {"assignment": [0, 1], "max_replica_share": 0.5,
      "hash_even_max_share": 0.9, "moved_slots": 1,
      "slot_weights": [90.0, 10.0]}, []),            # rebalance
    ({"ps0": 50.0, "ps1": 50.0}, 30.0, None,
     [VARIANT_ALERT]),                               # variant_shed
    ({"ps0": 5.0, "ps1": 5.0}, 42.0, None, []),      # scale_in (enforce)
    ({"ps0": 80.0, "ps1": 80.0}, 56.0, None, []),    # out again
    ({"ps0": 80.0, "ps1": 80.0}, 64.0, None, []),    # still burning
]


def _run_timeline(pkg: str, mode: str, tmp_path):
    ap, fleet, slos = _package(pkg)
    mon = PkgMonitor(slos.SloEngine(), fleet.FleetHistory())
    op = FakeOperator(replicas=2)
    jdir = str(tmp_path / f"{pkg}_{mode}")
    pilot = ap.Autopilot(mon, op, "job", policies=_policies(ap), mode=mode,
                         journal_dir=jdir, cooldown_sec=4.0,
                         max_actions_per_hour=5)
    t_prev, decisions = 0.0, []
    for load, t, plan, extra in TIMELINE:
        _feed_window(mon, load, t_prev + 2.0 if t_prev else 0.0, t)
        mon.plan = plan
        decisions.extend(pilot.tick(t, mon.engine.evaluate(t) + extra))
        t_prev = t
    records = ap.ActionJournal(jdir).records()
    for r in records:
        assert isinstance(r.pop("ts"), float)
    return ([(d["policy"], d["kind"], d["action"], d["reason"])
             for d in decisions], records, op.calls,
            mon.recorder.captures, pilot.describe())


@pytest.mark.parametrize("mode", ["recommend", "enforce"])
def test_decision_stream_and_journal_match_jax(mode, tmp_path):
    port = _run_timeline("port", mode, tmp_path)
    jax = _run_timeline("jax", mode, tmp_path)
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    assert port[2] == jax[2]
    assert port[3] == jax[3]
    for doc in (port[4], jax[4]):
        doc["journal"].pop("root")
        for r in doc["journal"]["tail"]:
            r.pop("ts")
    assert port[4] == jax[4]
    kinds = [d[1] for d in port[0]]
    if mode == "enforce":
        assert kinds == ["scale_out", "rebalance", "variant_shed",
                         "scale_in", "scale_out"]
        assert [r["kind"] for r in port[1]].count("regressed") >= 1
        assert port[3]  # the regression's postmortem capture
    else:
        assert kinds[:3] == ["scale_out", "rebalance", "variant_shed"]
        assert port[2] == []


@pytest.mark.parametrize("env", [
    {},
    {"PERSIA_AUTOPILOT_MODE": "enforce",
     "PERSIA_AUTOPILOT_COOLDOWN_SEC": "12.5",
     "PERSIA_AUTOPILOT_MAX_ACTIONS_PER_HOUR": "3"},
    {"PERSIA_AUTOPILOT_MODE": "bogus"},
    {"PERSIA_AUTOPILOT_COOLDOWN_SEC": "",
     "PERSIA_AUTOPILOT_MAX_ACTIONS_PER_HOUR": ""},
])
def test_autopilot_knobs_read_as_jax(env, monkeypatch, tmp_path):
    """The pilot's mode, cooldown, hourly limit and journal directory
    from the ``PERSIA_AUTOPILOT_*`` knobs, as the JAX pilot reads them
    (a bad mode raises in both)."""
    for k in ("PERSIA_AUTOPILOT_MODE", "PERSIA_AUTOPILOT_COOLDOWN_SEC",
              "PERSIA_AUTOPILOT_MAX_ACTIONS_PER_HOUR",
              "PERSIA_AUTOPILOT_JOURNAL_DIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    for pkg in ("port", "jax"):
        ap, fleet, slos = _package(pkg)
        monkeypatch.setenv("PERSIA_AUTOPILOT_JOURNAL_DIR",
                           str(tmp_path / pkg))
        mon = PkgMonitor(slos.SloEngine(), fleet.FleetHistory())
        try:
            p = ap.Autopilot(mon, FakeOperator(), "job")
            got.append((p.mode, p.cooldown_sec, p.max_actions_per_hour,
                        os.path.basename(p.journal.root)))
        except ValueError as e:
            got.append(("ValueError", str(e)))
    assert got[0][:3] == got[1][:3]
    if got[0][0] != "ValueError":
        assert (got[0][3], got[1][3]) == ("port", "jax")
