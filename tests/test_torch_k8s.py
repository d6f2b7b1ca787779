"""The port's k8s surface (``persia_tpu_torch/k8s_utils.py``,
``k8s_operator.py``) on the CPU, against the JAX package's.

``tests/test_k8s_operator.py``'s 16 reconcile-loop tests and
``tests/test_k8s_kubectl.py``'s 10 kubectl-surface tests (a recording stub
``kubectl`` on ``PATH``) run on the port, and ``tests/test_reshard.py``'s
two operator cases (the reshard sequenced around PS pods; a journaled
migration resumed by a restarted operator). Parity (tolerance: equality):
``gen_manifests`` of both packages on each spec of those files and on
``examples/criteo/job.yml`` without its ``tpu`` block are equal once
``persia_tpu.launcher`` is mapped to ``persia_tpu_torch.launcher``; the
CRDs are equal but for the role's accelerator property (``gpu`` here,
``tpu`` there); ``validate_manifests`` gives the same verdicts and
messages on the drift cases; the manifests a kubectl dry run reads parse
to the same documents. Stated difference: a spec with a ``tpu`` block is
refused by name.
"""

import copy
import json
import os
import pathlib
import stat

import numpy as np
import pytest
import yaml

from persia_tpu_torch.k8s_operator import FakeKubeApi, KubectlApi, Operator
from persia_tpu_torch.k8s_utils import (
    gen_crd,
    gen_manifests,
    validate_manifests,
)

REPO = pathlib.Path(__file__).resolve().parent.parent

# --- tests/test_k8s_operator.py on the port ---------------------------------

SPEC = {
    "jobName": "testjob",
    "image": "persia-tpu-runtime:test",
    "embeddingConfigPath": "/config/embedding_config.yml",
    "roles": {
        "embeddingParameterServer": {"replicas": 2},
        "embeddingWorker": {"replicas": 1},
        "nnWorker": {"replicas": 1, "entry": "train.py"},
    },
}


def _operator():
    api = FakeKubeApi()
    return api, Operator(api, [SPEC], interval=0.01)


def test_initial_reconcile_creates_all_objects():
    api, op = _operator()
    stats = op.reconcile_job(SPEC)
    desired = gen_manifests(SPEC)
    assert stats["created"] == len(desired)
    assert len(api.list_objects("persia-job=testjob")) == len(desired)
    # second pass is a no-op
    stats = op.reconcile_job(SPEC)
    assert stats == {"created": 0, "restarted": 0, "removed": 0}


def test_killed_ps_pod_is_recreated():
    api, op = _operator()
    op.reconcile_job(SPEC)
    victim = "testjob-embeddingparameterserver-1"
    api.kill_pod(victim, phase="Failed")
    # pass 1 deletes the dead pod (recreating the same name in the same
    # pass would race the apiserver's termination grace period)
    stats = op.reconcile_job(SPEC)
    assert stats["restarted"] == 1
    assert ("Pod", victim) not in api.objects
    assert f"Pod/{victim}" in api.delete_log
    # pass 2 recreates it through the missing-object branch
    stats = op.reconcile_job(SPEC)
    assert stats["created"] == 1
    assert api.objects[("Pod", victim)]["status"]["phase"] == "Running"


def test_exited_service_pod_is_restarted_but_finished_entry_is_not():
    api, op = _operator()
    op.reconcile_job(SPEC)
    # service role: Succeeded means the server process exited -> restart
    api.kill_pod("testjob-embeddingworker-0", phase="Succeeded")
    assert op.reconcile_job(SPEC)["restarted"] == 1
    assert op.reconcile_job(SPEC)["created"] == 1
    # entry-script role: Succeeded is legitimate completion -> leave it
    api.kill_pod("testjob-nnworker-0", phase="Succeeded")
    assert op.reconcile_job(SPEC) == {"created": 0, "restarted": 0,
                                      "removed": 0}
    # ...but a Failed entry pod does restart
    api.kill_pod("testjob-nnworker-0", phase="Failed")
    assert op.reconcile_job(SPEC)["restarted"] == 1


def test_scale_down_removes_extra_pods():
    api, op = _operator()
    op.reconcile_job(SPEC)
    smaller = dict(SPEC, roles={**SPEC["roles"],
                                "embeddingParameterServer": {"replicas": 1}})
    stats = op.reconcile_job(smaller)
    assert stats["removed"] == 1
    assert ("Pod", "testjob-embeddingparameterserver-1") not in api.objects


def test_untrack_tears_down_job():
    api, op = _operator()
    op.reconcile_all()
    assert api.list_objects("persia-job=testjob")
    op.untrack("testjob")
    assert api.list_objects("persia-job=testjob") == []
    op.reconcile_all()  # untracked: nothing comes back
    assert api.list_objects("persia-job=testjob") == []


def test_reconcile_survives_api_errors():
    api, op = _operator()

    calls = {"n": 0}
    orig = api.apply

    def flaky(manifest):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("apiserver hiccup")
        orig(manifest)

    api.apply = flaky
    op.reconcile_all()  # must not raise (operator requeues on error)
    op.reconcile_all()  # next pass completes the creation
    names = {k for k in api.objects}
    assert ("Pod", "testjob-embeddingparameterserver-0") in names


def test_metrics_gateway_manifests_and_env():
    spec = dict(SPEC, metrics={"enabled": True, "port": 9091})
    manifests = gen_manifests(spec)
    kinds = {(m["kind"], m["metadata"]["name"]) for m in manifests}
    assert ("Pod", "testjob-metrics-gateway") in kinds
    assert ("Service", "testjob-metrics-gateway") in kinds
    ps0 = next(m for m in manifests
               if m["metadata"]["name"] == "testjob-embeddingparameterserver-0")
    env = {e["name"]: e["value"] for e in ps0["spec"]["containers"][0]["env"]}
    assert env["PERSIA_METRICS_GATEWAY_ADDR"] == "testjob-metrics-gateway:9091"


def test_grafana_dashboard_references_live_metric_names():
    """The dashboard the manifests' pushgateway feeds reads series the
    port's worker and pipeline register under these names."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "resources",
                        "grafana", "persia_tpu_training.json")
    with open(path) as f:
        dash = json.load(f)
    exprs = " ".join(t["expr"] for p in dash["panels"]
                     for t in p["targets"])
    src = "".join(p.read_text() for p in (REPO / "persia_tpu_torch")
                  .rglob("*.py"))
    for name in ("lookup_preprocess_time_cost_sec",
                 "lookup_rpc_time_cost_sec",
                 "lookup_postprocess_time_cost_sec",
                 "forward_client_time_cost_sec",
                 "backward_client_time_cost_sec",
                 "estimated_distinct_id"):
        assert name in exprs
        assert f'"{name}"' in src, name


def test_rest_scheduling_server_lifecycle():
    """The REST surface (reference k8s/src/bin/server.rs): apply a job,
    list it, inspect pods, delete it — over real HTTP."""
    import json
    import urllib.request

    from persia_tpu_torch.k8s_operator import SchedulingServer

    api = FakeKubeApi()
    op = Operator(api, interval=0.01)
    server = SchedulingServer(op)
    server.serve_background()
    base = f"http://{server.addr}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return json.loads(r.read())

    def post(path, payload=None):
        data = json.dumps(payload).encode() if payload is not None else b""
        req = urllib.request.Request(base + path, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    try:
        resp = post("/apply", SPEC)
        assert resp["job"] == "testjob"
        assert resp["reconcile"]["created"] > 0
        assert get("/listjobs")["jobs"] == ["testjob"]
        pods = get("/listpods?job=testjob")["pods"]
        assert {"name": "testjob-embeddingparameterserver-0",
                "phase": "Running"} in pods
        st = get("/podstatus?job=testjob&pod=testjob-nnworker-0")
        assert st["phase"] == "Running"
        assert post("/delete?job=testjob")["deleted"] == "testjob"
        assert get("/listjobs")["jobs"] == []
        assert get("/listpods?job=testjob")["pods"] == []
    finally:
        server.stop()


def test_delete_during_reconcile_loop_does_not_resurrect():
    """A job deleted between reconcile_all's snapshot and its per-job
    pass must stay deleted (no orphaned pods recreated): inject the
    stale snapshot taken BEFORE the delete."""
    api, op = _operator()
    op.reconcile_all()  # create everything
    stale_snapshot = [SPEC]  # what the loop saw before the delete
    op.untrack("testjob")  # REST /delete lands: teardown + untrack
    op.reconcile_all(stale_snapshot)  # the in-flight pass resumes
    assert api.list_objects("persia-job=testjob") == []


def test_gencrd_schema_covers_job_spec():
    """The emitted CRD (reference gencrd.rs) must accept the job-spec
    shape gen_manifests consumes."""
    from persia_tpu_torch.k8s_utils import gen_crd

    crd = gen_crd()
    assert crd["metadata"]["name"] == "persiajobs.persia.com"
    assert crd["spec"]["group"] == "persia.com"
    schema = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]
    spec_props = schema["properties"]["spec"]["properties"]
    for key in SPEC:
        assert key in spec_props, f"CRD schema missing job-spec key {key}"
    roles_schema = spec_props["roles"]
    # closed schema: only the launcher's roles are admissible (an open
    # schema would accept CRs that can never converge)
    assert roles_schema["additionalProperties"] is False
    for role in ("embeddingParameterServer", "embeddingWorker",
                 "nnWorker", "dataloader"):
        assert role in roles_schema["properties"]
    role_props = roles_schema["properties"]["nnWorker"]["properties"]
    for key in ("replicas", "entry", "env", "gpu", "resources"):
        assert key in role_props
    assert "tpu" not in role_props


def test_operator_watches_custom_resources():
    """CR add -> job reconciled; CR delete -> job torn down; YAML/REST
    jobs are not governed by CR deletion (reference Controller watch,
    operator.rs:25-123)."""
    api = FakeKubeApi()
    op = Operator(api, interval=0.01)
    api.custom_resources.append({
        "metadata": {"name": "crjob"},
        "spec": dict(SPEC, jobName="crjob"),
    })
    op.sync_custom_resources()
    op.reconcile_all()
    assert api.list_objects("persia-job=crjob")
    # a REST/YAML-tracked job alongside
    op.track(dict(SPEC, jobName="yamljob"))
    op.reconcile_all()
    assert api.list_objects("persia-job=yamljob")
    # CR removed -> crjob torn down, yamljob untouched
    api.custom_resources.clear()
    op.sync_custom_resources()
    op.reconcile_all()
    assert api.list_objects("persia-job=crjob") == []
    assert api.list_objects("persia-job=yamljob")


def test_system_e2e_rest_plus_loop_recovery():
    """System-e2e harness analogue (reference k8s/src/bin/e2e.rs submits
    a job and polls pod phases to completion): submit over REST with the
    reconcile loop running, poll until all pods Running, kill a PS pod,
    poll until the loop restores it, delete, poll until gone."""
    import json
    import time as _time
    import urllib.request

    from persia_tpu_torch.k8s_operator import SchedulingServer

    api = FakeKubeApi()
    op = Operator(api, interval=0.02)
    server = SchedulingServer(op)
    server.serve_background()
    op.start()
    base = f"http://{server.addr}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return json.loads(r.read())

    def post(path, payload=None):
        data = json.dumps(payload).encode() if payload is not None else b""
        req = urllib.request.Request(base + path, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    def poll(pred, timeout=10.0):
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if pred():
                return True
            _time.sleep(0.02)
        return False

    n_pods = sum(1 for m in gen_manifests(SPEC) if m["kind"] == "Pod")
    try:
        post("/apply", SPEC)
        assert poll(lambda: len(get("/listpods?job=testjob")["pods"])
                    == n_pods
                    and all(p["phase"] == "Running"
                            for p in get("/listpods?job=testjob")["pods"]))
        victim = "testjob-embeddingparameterserver-0"
        api.kill_pod(victim, phase="Failed")
        assert poll(lambda: any(
            p["name"] == victim and p["phase"] == "Running"
            for p in get("/listpods?job=testjob")["pods"]))
        post("/delete?job=testjob")
        assert poll(lambda: get("/listpods?job=testjob")["pods"] == [])
    finally:
        op.stop()
        server.stop()


def test_cr_sweep_does_not_reclaim_user_applied_job():
    """A job re-applied via REST/YAML is owned by the user: the CR poll
    must neither overwrite their spec nor reclaim it into CR governance
    (a later CR delete cannot tear it down)."""
    api = FakeKubeApi()
    op = Operator(api, interval=0.01)
    api.custom_resources.append({
        "metadata": {"name": "j"}, "spec": dict(SPEC, jobName="j")})
    op.sync_custom_resources()
    # user re-applies with a scaled-up spec
    user_spec = dict(SPEC, jobName="j",
                     roles={**SPEC["roles"],
                            "embeddingParameterServer": {"replicas": 3}})
    op.track(user_spec)
    op.sync_custom_resources()  # next poll must not revert the spec
    with op._lock:
        assert op._jobs["j"]["roles"]["embeddingParameterServer"][
            "replicas"] == 3
    api.custom_resources.clear()
    op.sync_custom_resources()  # CR deleted: user-owned job survives
    assert "j" in op.job_names()


def test_gen_manifests_rejects_unknown_role():
    import pytest as _pytest

    bad = dict(SPEC, roles={"trainer": {"replicas": 1}})
    with _pytest.raises(ValueError, match="unknown role"):
        gen_manifests(bad)


def test_manifest_env_wires_fleet_sizes_and_trainer_rank():
    spec = dict(SPEC, roles={**SPEC["roles"],
                             "dataloader": {"replicas": 2,
                                            "entry": "send.py"}})
    manifests = gen_manifests(spec)
    nn = next(m for m in manifests
              if m["metadata"]["name"] == "testjob-nnworker-0")
    env = {e["name"]: e["value"] for e in nn["spec"]["containers"][0]["env"]}
    assert env["RANK"] == "0" and env["WORLD_SIZE"] == "1"
    assert env["PERSIA_NUM_WORKERS"] == "1"
    assert env["PERSIA_NUM_DATALOADERS"] == "2"


# --- tests/test_k8s_kubectl.py on the port ----------------------------------

KSPEC = {
    "jobName": "demo",
    "image": "persia-tpu-runtime:latest",
    "roles": {
        "nnWorker": {"replicas": 2, "script": "train.py"},
        "embeddingWorker": {"replicas": 1},
        "embeddingParameterServer": {"replicas": 2},
        "dataloader": {"replicas": 1, "script": "loader.py"},
    },
    "metrics": {"enabled": True},
    "embeddingConfigPath": "config/embedding_config.yml",
    "globalConfigPath": "config/global_config.yml",
}


def _stub_kubectl(tmp_path, rc: int = 0, stderr: str = ""):
    """A kubectl that records argv + stdin and answers canned JSON."""
    log = tmp_path / "kubectl.log"
    stdin_log = tmp_path / "kubectl.stdin"
    script = tmp_path / "kubectl"
    script.write_text(f"""#!/bin/bash
printf '%s\\n' "$*" >> {log}
case "$*" in
  *apply*) cat >> {stdin_log} ;;
esac
if [ {rc} -ne 0 ]; then echo "{stderr}" >&2; exit {rc}; fi
case "$*" in
  *"-o json"*) echo '{{"items": []}}' ;;
  *apply*) echo "applied (dry run)" ;;
esac
""")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return log, stdin_log


@pytest.fixture
def on_path(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    return tmp_path


def test_structural_validation_accepts_rendered_manifests(monkeypatch,
                                                          tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # no kubectl anywhere
    validate_manifests(gen_manifests(KSPEC) + [gen_crd()])


def test_structural_validation_rejects_drift(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    bad = [
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "Bad_Name"},
         "spec": {}},
        {"apiVersion": "v1", "kind": "Service",
         "metadata": {"name": "svc"}, "spec": {}},
    ]
    with pytest.raises(ValueError) as e:
        validate_manifests(bad)
    msg = str(e.value)
    assert "DNS-1123" in msg
    assert "spec.containers" in msg
    assert "spec.ports" in msg


def test_structural_validation_rejects_non_string_env(monkeypatch, tmp_path):
    """The classic drift bug: an int env value renders fine as YAML but
    the API server rejects it."""
    monkeypatch.setenv("PATH", str(tmp_path))
    manifests = gen_manifests(KSPEC)
    pod = next(m for m in manifests if m["kind"] == "Pod"
               and m["spec"]["containers"][0].get("env"))
    pod["spec"]["containers"][0]["env"].append(
        {"name": "REPLICA_SIZE", "value": 2})  # int, not str
    with pytest.raises(ValueError, match="must be a string"):
        validate_manifests(manifests)


def test_validate_via_kubectl_dry_run(on_path):
    log, stdin_log = _stub_kubectl(on_path)
    validate_manifests(gen_manifests(KSPEC))
    assert "apply --dry-run=client --validate=true -o name -f -" in \
        log.read_text()
    docs = list(yaml.safe_load_all(stdin_log.read_text()))
    assert {d["kind"] for d in docs} >= {"Pod", "Service"}


def test_validate_via_kubectl_dry_run_failure(on_path):
    _stub_kubectl(on_path, rc=1, stderr="error validating data")
    with pytest.raises(ValueError, match="error validating data"):
        validate_manifests(gen_manifests(KSPEC))


def test_kubectl_api_command_construction(on_path):
    log, stdin_log = _stub_kubectl(on_path)
    api = KubectlApi(namespace="prod")
    api.apply({"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "p0"}})
    api.delete("Pod", "p0")
    api.list_objects("persia-job=demo")
    api.list_custom()
    lines = log.read_text().splitlines()
    assert lines[0] == "-n prod apply -f -"
    assert lines[1] == "-n prod delete pod p0 --ignore-not-found --wait=false"
    assert lines[2] == "-n prod get pods -l persia-job=demo -o json"
    assert lines[3] == "-n prod get services -l persia-job=demo -o json"
    assert lines[4] == "-n prod get persiajobs -o json"
    assert json.loads(stdin_log.read_text())["metadata"]["name"] == "p0"


def test_rest_apply_rejects_invalid_spec_without_tracking():
    """An invalid spec gets a 400 and is NOT tracked, so the reconcile
    loop does not re-raise on every interval until a manual /delete."""
    import json as _json
    import urllib.request

    from persia_tpu_torch.k8s_operator import FakeKubeApi, SchedulingServer

    op = Operator(FakeKubeApi())
    server = SchedulingServer(op)
    server.serve_background()
    try:
        bad = {"jobName": "badjob", "roles": {"nonsenseRole": {}}}
        req = urllib.request.Request(
            f"http://{server.addr}/apply",
            data=_json.dumps(bad).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 400
        assert op.job_names() == []
    finally:
        server.stop()


def test_rest_apply_rejects_renderable_but_invalid_spec():
    """A spec that renders but produces invalid manifests (bad DNS-1123
    job name) must also 400 without being tracked."""
    import json as _json
    import urllib.request

    from persia_tpu_torch.k8s_operator import FakeKubeApi, SchedulingServer

    op = Operator(FakeKubeApi())
    server = SchedulingServer(op)
    server.serve_background()
    try:
        bad = dict(KSPEC, jobName="My_Job")
        req = urllib.request.Request(
            f"http://{server.addr}/apply",
            data=_json.dumps(bad).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 400
        assert op.job_names() == []
    finally:
        server.stop()


def test_validate_falls_back_when_kubectl_has_no_cluster(on_path):
    """kubectl present but no reachable cluster: connectivity failures
    must fall back to structural checks, not reject valid manifests."""
    _stub_kubectl(on_path, rc=1,
                  stderr="The connection to the server localhost:8080 was "
                         "refused - connection refused")
    validate_manifests(gen_manifests(KSPEC))  # must not raise


def test_operator_reconcile_through_kubectl_stub(on_path):
    """A full reconcile pass driven through the real KubectlApi shell-out
    path (previously only FakeKubeApi ever executed)."""
    log, stdin_log = _stub_kubectl(on_path)
    op = Operator(KubectlApi(namespace="default"), [KSPEC])
    op.reconcile_job(KSPEC)
    applied = [ln for ln in log.read_text().splitlines()
               if "apply" in ln]
    # every rendered manifest applied (stub lists no existing objects)
    assert len(applied) == len(gen_manifests(KSPEC))


# --- tests/test_reshard.py's operator cases on the port ---------------------

RSPEC = {"jobName": "j", "image": "persia:latest",
         "embeddingConfigPath": "/config/embedding_config.yml",
         "roles": {"embeddingParameterServer": {"replicas": 2},
                   "embeddingWorker": {"replicas": 1}}}


def _rspec():
    return dict(RSPEC, roles={k: dict(v) for k, v in RSPEC["roles"].items()})


def test_operator_scale_sequences_reshard_around_pods():
    """Scale-out creates PS pods BEFORE the migration runs onto them;
    scale-in drains slots off dying replicas BEFORE their pods go;
    driverless scale-in refuses to delete pods (pending_drain)."""

    def ps_pods(api):
        return sorted(o["metadata"]["name"]
                      for o in api.list_objects("persia-job=j")
                      if o["kind"] == "Pod"
                      and "parameterserver" in o["metadata"]["name"])

    calls = []
    api = FakeKubeApi()

    def driver(job, old, new, phase, drv_spec):
        calls.append((job, old, new, phase, len(ps_pods(api))))

    op = Operator(api, [_rspec()], reshard_driver=driver)
    op.reconcile_all()
    assert len(ps_pods(api)) == 2
    ev = op.scale_ps("j", 4)
    assert ev["status"] == "done"
    assert calls[-1] == ("j", 2, 4, "scale_out", 4)
    assert len(ps_pods(api)) == 4
    ev = op.scale_ps("j", 3)
    assert calls[-1] == ("j", 4, 3, "scale_in", 4)
    assert len(ps_pods(api)) == 3
    assert [e["status"] for e in op.reshard_events()] == ["done", "done"]
    op2 = Operator(FakeKubeApi(), [_rspec()])
    op2.reconcile_all()
    ev = op2.scale_ps("j", 1)
    assert ev["status"] == "pending_drain"
    assert len(ps_pods(op2.api)) == 2


def test_operator_resumes_journaled_migration_on_restart(tmp_path):
    """A restarted operator's first reconcile hands the port's journaled
    in-flight migration to the driver under phase 'resume' (or records
    resume_pending without a driver); a finalized journal is quiet."""
    from persia_tpu_torch.reshard import MigrationJournal
    from persia_tpu_torch.routing import RoutingTable

    jdir = str(tmp_path / "journals")
    t = RoutingTable.uniform(2, slots_per_replica=4)
    t2 = t.derive(np.zeros(t.num_slots, np.int32), 1)
    j = MigrationJournal(os.path.join(jdir, "j"))
    j.append("plan", mig_id="m1", attempt=0, epoch=t2.epoch,
             old_table=t.to_doc(), new_table=t2.to_doc(),
             moves=[{"donor": 1, "target": 0, "slots": [1]}])
    j.append("frozen", mig_id="m1", attempt=0, donor=1, slots=[1])

    calls = []
    op = Operator(FakeKubeApi(), [_rspec()],
                  reshard_driver=lambda *a: calls.append(a),
                  reshard_journal_dir=jdir)
    op.reconcile_all()
    assert calls and calls[0][3] == "resume" and calls[0][2] == 1
    assert op.reshard_events()[0]["status"] == "resumed"
    op.reconcile_all()
    assert len(calls) == 1
    op2 = Operator(FakeKubeApi(), [_rspec()], reshard_journal_dir=jdir)
    op2.reconcile_all()
    assert op2.reshard_events()[0]["status"] == "resume_pending"
    j.append("finalized", mig_id="m1", attempt=0)
    op3 = Operator(FakeKubeApi(), [_rspec()], reshard_journal_dir=jdir)
    op3.reconcile_all()
    assert op3.reshard_events() == []


# --- parity with the JAX package --------------------------------------------

def _job_yml(accelerator: bool):
    """``examples/criteo/job.yml`` as PyYAML reads it, its nnWorker's
    ``tpu`` block dropped (``accelerator=False``) or swapped for
    ``gpu: {count: 1}`` (``True``, the port only)."""
    with open(REPO / "examples" / "criteo" / "job.yml") as f:
        spec = yaml.safe_load(f)
    del spec["roles"]["nnWorker"]["tpu"]
    if accelerator:
        spec["roles"]["nnWorker"]["gpu"] = {"count": 1}
    return spec


def _to_port(manifests):
    """The JAX package's manifests with the launcher module mapped."""
    out = copy.deepcopy(manifests)
    for m in out:
        for c in m["spec"].get("containers", []):
            if "command" in c:
                c["command"] = ["persia_tpu_torch.launcher"
                                if a == "persia_tpu.launcher" else a
                                for a in c["command"]]
    return out


PARITY_SPECS = {
    "operator": SPEC,
    "operator_metrics": dict(SPEC, metrics={"enabled": True, "port": 9091}),
    "operator_loaders": dict(SPEC, roles={
        **SPEC["roles"], "dataloader": {"replicas": 2, "entry": "send.py"}}),
    "kubectl": KSPEC,
    "reshard": RSPEC,
    "criteo_job": _job_yml(False),
    "resources_env": dict(SPEC, globalConfigPath="/config/g.yml", roles={
        "embeddingParameterServer": {"replicas": 3, "port": 9000,
                                     "env": {"X": "1", "N": 2}},
        "nnWorker": {"replicas": 2, "entry": "t.py",
                     "resources": {"limits": {"memory": "8Gi"}}},
        "embeddingWorker": {}}),
}


@pytest.mark.parametrize("name", sorted(PARITY_SPECS))
def test_gen_manifests_match_jax(name):
    from persia_tpu import k8s_utils as jk8s

    spec = PARITY_SPECS[name]
    assert gen_manifests(copy.deepcopy(spec)) == _to_port(
        jk8s.gen_manifests(copy.deepcopy(spec)))


def test_job_yml_reads_alike_and_renders_gpu_limits(tmp_path):
    """The port's YAML reader gives PyYAML's job spec; with ``gpu:
    {count: 1}`` only the nnWorker container gains an
    ``nvidia.com/gpu`` limit, the rest equal to the JAX rendering."""
    from persia_tpu import k8s_utils as jk8s

    from persia_tpu_torch.utils import load_yaml

    with open(REPO / "examples" / "criteo" / "job.yml") as f:
        assert load_yaml(str(REPO / "examples" / "criteo" / "job.yml")) \
            == yaml.safe_load(f)
    mine = gen_manifests(_job_yml(True))
    ref = _to_port(jk8s.gen_manifests(_job_yml(False)))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if a["metadata"]["labels"].get("persia-role") == "nnWorker":
            limits = a["spec"]["containers"][0].pop("resources")["limits"]
            assert limits == {"nvidia.com/gpu": 1}
        assert a == b


def test_tpu_block_is_refused_by_name():
    """Stated difference: the JAX package renders a ``tpu`` block into GKE
    TPU node selectors; the port refuses it, naming the block."""
    with open(REPO / "examples" / "criteo" / "job.yml") as f:
        spec = yaml.safe_load(f)
    with pytest.raises(ValueError, match="'tpu'.*gpu: {count: N}"):
        gen_manifests(spec)
    from persia_tpu_torch.k8s_utils import validate_spec

    with pytest.raises(ValueError, match="tpu"):
        validate_spec(spec)


def test_crd_matches_jax_but_the_accelerator():
    from persia_tpu import k8s_utils as jk8s

    # unshared copies: each role's schema is one dict in both CRDs
    mine, ref = (json.loads(json.dumps(c))
                 for c in (gen_crd(), jk8s.gen_crd()))
    roles = lambda crd: crd["spec"]["versions"][0]["schema"][  # noqa: E731
        "openAPIV3Schema"]["properties"]["spec"]["properties"]["roles"][
        "properties"]
    for name, role in roles(mine).items():
        assert role["properties"].pop("gpu") == {
            "type": "object",
            "properties": {"count": {"type": "integer", "minimum": 0}}}
        del roles(ref)[name]["properties"]["tpu"]
    assert mine == ref


def _drift_cases():
    good = gen_manifests(copy.deepcopy(KSPEC))
    env_int = copy.deepcopy(good)
    pod = next(m for m in env_int if m["kind"] == "Pod"
               and m["spec"]["containers"][0].get("env"))
    pod["spec"]["containers"][0]["env"].append(
        {"name": "REPLICA_SIZE", "value": 2})
    crd_bad_name = gen_crd()
    crd_bad_name["metadata"]["name"] = "wrong.persia.com"
    crd_no_names = gen_crd()
    del crd_no_names["spec"]["names"]
    return {
        "valid": good + [gen_crd()],
        "names_and_specs": [
            {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": "Bad_Name"}, "spec": {}},
            {"apiVersion": "v1", "kind": "Service",
             "metadata": {"name": "svc"}, "spec": {}}],
        "env_not_string": env_int,
        "crd_name": [crd_bad_name],
        "crd_names_missing": [crd_no_names],
        "spec_not_mapping": [{"apiVersion": "v1", "kind": "Pod",
                              "metadata": {"name": "p"}, "spec": []}],
        "container_not_mapping": [{"apiVersion": "v1", "kind": "Pod",
                                   "metadata": {"name": "p"},
                                   "spec": {"containers": ["c"]}}],
        "missing_kind": [{"apiVersion": "v1", "metadata": {}}],
    }


@pytest.mark.parametrize("case", sorted(_drift_cases()))
def test_structural_verdicts_match_jax(case, monkeypatch, tmp_path):
    from persia_tpu import k8s_utils as jk8s

    monkeypatch.setenv("PATH", str(tmp_path))  # no kubectl anywhere
    verdicts = []
    for fn in (validate_manifests, jk8s.validate_manifests):
        try:
            fn(copy.deepcopy(_drift_cases()[case]))
            verdicts.append("ok")
        except ValueError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]
    assert (verdicts[0] == "ok") == (case == "valid")


def test_kubectl_dry_run_reads_the_same_documents(tmp_path, monkeypatch):
    """Both packages' ``validate_manifests`` through a stub kubectl: the
    stream each writes to its stdin parses (PyYAML) to the same
    documents, the launcher module mapped."""
    from persia_tpu import k8s_utils as jk8s

    docs = []
    for name, mod in (("port", None), ("jax", jk8s)):
        d = tmp_path / name
        d.mkdir()
        _log, stdin_log = _stub_kubectl(d)
        monkeypatch.setenv("PATH", f"{d}:{os.environ['PATH']}")
        ms = (gen_manifests(copy.deepcopy(KSPEC)) if mod is None
              else jk8s.gen_manifests(copy.deepcopy(KSPEC)))
        (validate_manifests if mod is None else mod.validate_manifests)(ms)
        docs.append(list(yaml.safe_load_all(stdin_log.read_text())))
    assert docs[0] == _to_port(docs[1])


def test_k8s_cli_gen_gencrd_validate(tmp_path, monkeypatch, capsys):
    """``python -m persia_tpu_torch.k8s_utils``: ``gen`` writes the
    manifests as a document stream, ``gencrd`` the CRD, ``validate``
    checks both; the JAX job file's ``tpu`` block is refused."""
    from persia_tpu_torch import k8s_utils

    monkeypatch.setenv("PATH", str(tmp_path))
    job = tmp_path / "job.yml"
    job.write_text(yaml.safe_dump(_job_yml(True), sort_keys=False))
    k8s_utils.main(["gen", str(job)])
    assert list(yaml.safe_load_all(capsys.readouterr().out)) == \
        gen_manifests(_job_yml(True))
    k8s_utils.main(["gencrd"])
    assert yaml.safe_load(capsys.readouterr().out) == gen_crd()
    k8s_utils.main(["validate", str(job)])
    assert capsys.readouterr().out.startswith("ok: ")
    with pytest.raises(ValueError, match="tpu"):
        k8s_utils.main(["gen", str(REPO / "examples" / "criteo" / "job.yml")])


def test_operator_cli_once_through_kubectl_stub(tmp_path, monkeypatch):
    """``python -m persia_tpu_torch.k8s_operator job.yml --once``: one
    reconcile pass applies every rendered object through kubectl."""
    from persia_tpu_torch import k8s_operator

    log, _stdin = _stub_kubectl(tmp_path)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    job = tmp_path / "job.yml"
    job.write_text(yaml.safe_dump(KSPEC))
    k8s_operator.main([str(job), "--once", "--namespace", "ns1"])
    applied = [ln for ln in log.read_text().splitlines()
               if ln.startswith("-n ns1 apply")]
    assert len(applied) == len(gen_manifests(KSPEC))


def test_rest_autopilot_route_and_scale(monkeypatch):
    """``GET /autopilot`` shows an attached pilot's posture (``enabled:
    false`` without one); ``POST /scale`` runs ``scale_ps`` (404 for an
    untracked job)."""
    import urllib.error
    import urllib.request

    from persia_tpu_torch.k8s_operator import SchedulingServer

    op = Operator(FakeKubeApi(), [_rspec()])
    server = SchedulingServer(op)
    server.serve_background()
    base = f"http://{server.addr}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return json.loads(r.read())

    def post(path, payload):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(payload).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    class Pilot:
        def describe(self):
            return {"mode": "recommend", "job": "j"}

    try:
        assert get("/autopilot") == {"enabled": False}
        op.attach_autopilot(Pilot())
        assert get("/autopilot") == {"mode": "recommend", "job": "j",
                                     "enabled": True}
        ev = post("/scale", {"jobName": "j", "psReplicas": 3})
        assert (ev["from"], ev["to"], ev["status"]) == (2, 3, "pending")
        assert get("/reshards")["events"][0]["to"] == 3
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/scale", {"jobName": "nope", "psReplicas": 3})
        assert e.value.code == 404
    finally:
        server.stop()
