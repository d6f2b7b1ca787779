"""Kubernetes reconcile loop for the port's jobs (``persia_tpu/k8s_operator.py``).

The reference runs a Rust kube-runtime Controller that creates the
job's pods, restarts failures, and tears everything down on delete
(k8s/src/bin/operator.rs:25-123, reconcile interval 10 s, with
PersiaJobResources apply/delete in k8s/src/lib.rs). This is the same
control loop over the declarative manifests from
:mod:`persia_tpu_torch.k8s_utils`:

- **desired state** = ``gen_manifests(job_spec)`` for every tracked job
- **observed state** = pods/services labeled ``persia-job=<name>``
- reconcile: create missing objects, delete+recreate pods in a terminal
  phase (Failed, or Succeeded for long-running roles), delete objects
  that are no longer desired, and tear down all objects of untracked
  (deleted) jobs.

The API surface is pluggable: :class:`KubectlApi` shells out to
``kubectl`` (no client library dependency, works against any cluster),
and :class:`FakeKubeApi` is an in-memory twin for tests (the reference's
operator is e2e-tested against a real cluster, k8s/src/bin/e2e.rs; the
fake gives the same coverage in-process).

Besides reconciling, the operator sequences the live reshard of a job's
PS tier around its pods (:meth:`Operator.scale_ps`, :meth:`rebalance_ps`,
a ``reshard_driver`` backed by the port's ``ReshardController``), resumes
a migration a previous incarnation left in flight from its journal,
forwards variant operations to a ``variant_driver``, and shows an
attached :class:`~persia_tpu_torch.autopilot.Autopilot` on its REST
surface (:class:`SchedulingServer`).

Threads: :meth:`Operator.start` runs the loop on a thread of its own and
:meth:`Operator.stop` joins it; :meth:`SchedulingServer.stop` joins the
REST server's thread. (A caller that runs :meth:`Operator.run` on its own
thread joins it after ``stop()``.)

CLI: ``python -m persia_tpu_torch.k8s_operator job1.yml job2.yml
[--interval 10] [--once] [--serve HOST:PORT] [--from-crd]``
"""

import argparse
import json
import logging
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from persia_tpu_torch.k8s_utils import gen_manifests
from persia_tpu_torch.utils import load_yaml

_logger = logging.getLogger(__name__)

# Service roles run forever — any terminal phase (even Succeeded) means
# the process exited and must be replaced. Entry-script roles (trainer,
# data-loader) legitimately finish: only Failed/Unknown restarts them.
_SERVICE_ROLES = frozenset({
    "coordinator", "embeddingParameterServer", "embeddingWorker",
    "metricsGateway",
})
_FAILED_PHASES = ("Failed", "Unknown")
_SERVICE_TERMINAL_PHASES = ("Failed", "Succeeded", "Unknown")


def _pod_needs_restart(manifest: dict, observed: dict) -> bool:
    phase = observed.get("status", {}).get("phase")
    role = manifest["metadata"].get("labels", {}).get("persia-role", "")
    terminal = (_SERVICE_TERMINAL_PHASES if role in _SERVICE_ROLES
                else _FAILED_PHASES)
    return phase in terminal


class KubectlApi:
    """Real-cluster access through the kubectl CLI."""

    def __init__(self, namespace: str = "default", kubectl: str = "kubectl"):
        self.namespace = namespace
        self.kubectl = kubectl

    def _run(self, args: List[str], stdin: Optional[str] = None) -> str:
        proc = subprocess.run(
            [self.kubectl, "-n", self.namespace, *args],
            input=stdin, capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"kubectl {' '.join(args)} failed: {proc.stderr.strip()}")
        return proc.stdout

    def apply(self, manifest: dict):
        self._run(["apply", "-f", "-"], stdin=json.dumps(manifest))

    def delete(self, kind: str, name: str):
        self._run(["delete", kind.lower(), name, "--ignore-not-found",
                   "--wait=false"])

    def list_objects(self, label_selector: str) -> List[dict]:
        out = []
        for kind in ("pods", "services"):
            data = json.loads(
                self._run(["get", kind, "-l", label_selector, "-o", "json"]))
            out.extend(data.get("items", []))
        return out

    def list_custom(self, plural: str = "persiajobs") -> List[dict]:
        """PersiaJob custom resources (requires the CRD from
        ``persia_tpu_torch.k8s_utils gencrd`` to be installed)."""
        data = json.loads(self._run(["get", plural, "-o", "json"]))
        return data.get("items", [])


class FakeKubeApi:
    """In-memory twin of KubectlApi for unit tests.

    Tests mutate observed state directly (``kill_pod``) to simulate
    crashes; new pods come up ``Running``.
    """

    def __init__(self):
        # (kind, name) -> manifest (with .status.phase for pods)
        self.objects: Dict[Tuple[str, str], dict] = {}
        self.apply_log: List[str] = []
        self.delete_log: List[str] = []
        self.custom_resources: List[dict] = []  # PersiaJob CRs

    def apply(self, manifest: dict):
        kind = manifest["kind"]
        name = manifest["metadata"]["name"]
        manifest = dict(manifest)
        if kind == "Pod":
            manifest["status"] = {"phase": "Running"}
        self.objects[(kind, name)] = manifest
        self.apply_log.append(f"{kind}/{name}")

    def delete(self, kind: str, name: str):
        self.objects.pop((kind.capitalize(), name), None)
        # kubectl's kind argument is lowercase; normalize both spellings
        self.objects.pop((kind, name), None)
        self.delete_log.append(f"{kind}/{name}")

    def list_objects(self, label_selector: str) -> List[dict]:
        want = dict(kv.split("=", 1) for kv in label_selector.split(","))
        out = []
        for obj in self.objects.values():
            labels = obj.get("metadata", {}).get("labels", {})
            if all(labels.get(k) == v for k, v in want.items()):
                out.append(obj)
        return out

    def kill_pod(self, name: str, phase: str = "Failed"):
        self.objects[("Pod", name)]["status"] = {"phase": phase}

    def list_custom(self, plural: str = "persiajobs") -> List[dict]:
        return list(self.custom_resources)


class Operator:
    """The reconcile loop (reference operator.rs:25-123)."""

    def __init__(self, api, job_specs: Optional[List[dict]] = None,
                 interval: float = 10.0, reshard_driver=None,
                 reshard_journal_dir: Optional[str] = None,
                 variant_driver=None):
        self.api = api
        self.interval = interval
        # elastic-tier hook: ``reshard_driver(job_name, old, new,
        # phase, spec)`` runs the live slot migration around PS pod
        # reconciliation (phase "scale_out": pods already created,
        # migrate onto them; phase "scale_in": migrate OFF the dying
        # replicas BEFORE their pods are removed; phase "resume": a
        # restarted operator found the job's migration journal showing
        # an in-flight migration — the driver must
        # ReshardController.resume() it before any new scale runs).
        # Without a driver, scale intents are recorded for an external
        # controller.
        self._reshard_driver = reshard_driver
        # per-job durable migration journals live under
        # <reshard_journal_dir>/<job_name> (the driver passes the same
        # path to its ReshardController); on operator start the first
        # reconcile pass scans them and resumes/flags any migration a
        # previous operator incarnation left in flight
        self._reshard_journal_dir = reshard_journal_dir
        # (job, mig_id, attempt) triples already resumed/surfaced — the
        # scan runs every reconcile pass (a job tracked AFTER startup
        # still gets its wedged migration found), but each in-flight
        # attempt is handled once
        self._resumed_migs: set = set()
        self._reshard_events: List[dict] = []
        # multi-variant serving hook: ``variant_driver(job_name, op,
        # payload, spec)`` forwards a variant operation (add / remove /
        # promote / weight / drain / resume) to the job's serving
        # replicas — typically a variant_admin RPC broadcast. Without a
        # driver the intent is recorded for an external controller,
        # mirroring the reshard_driver convention.
        self._variant_driver = variant_driver
        self._variant_events: List[dict] = []
        self._jobs: Dict[str, dict] = {}
        # serializes reconcile passes against track/untrack (the REST
        # API mutates job state while the loop runs; without this a
        # delete could race an in-flight reconcile, which would recreate
        # the torn-down pods of a no-longer-tracked job — orphans)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._autopilot = None
        self._from_cr: set = set()  # jobs sourced from PersiaJob CRs
        for spec in job_specs or []:
            self.track(spec)

    # --- job tracking (the CRD add/delete events) -----------------------

    def track(self, spec: dict, source: str = "api"):
        """Track a job. ``source="cr"`` marks it as governed by its
        PersiaJob custom resource; any other source (YAML argv, REST)
        claims the job away from CR governance so a later CR sweep
        cannot tear down a job the user explicitly re-applied."""
        with self._lock:
            self._jobs[spec["jobName"]] = spec
            if source == "cr":
                self._from_cr.add(spec["jobName"])
            else:
                self._from_cr.discard(spec["jobName"])

    def untrack(self, job_name: str):
        """Stop managing a job; its objects are torn down immediately
        (the reference's delete finalizer)."""
        with self._lock:
            self._jobs.pop(job_name, None)
            self.teardown(job_name)

    def teardown(self, job_name: str):
        for obj in self.api.list_objects(f"persia-job={job_name}"):
            self.api.delete(obj["kind"], obj["metadata"]["name"])

    # locked snapshots for concurrent readers (the REST handlers run on
    # their own threads; iterating shared dicts unlocked would race the
    # reconcile loop)
    def job_names(self) -> List[str]:
        with self._lock:
            return sorted(self._jobs)

    def objects_of(self, job_name: str) -> List[dict]:
        with self._lock:
            return list(self.api.list_objects(f"persia-job={job_name}"))

    # --- reconcile ------------------------------------------------------

    def reconcile_job(self, spec: dict, manifests=None) -> Dict[str, int]:
        """Drive one job toward its desired manifest set. Returns action
        counts (created/restarted/removed) for observability. Callers
        that already rendered the spec (e.g. /apply's validation pass)
        hand the manifests in to avoid a second gen_manifests()."""
        with self._lock:
            return self._reconcile_job_locked(spec, manifests)

    def _reconcile_job_locked(self, spec: dict, manifests=None) -> Dict[str, int]:
        job = spec["jobName"]
        stats = {"created": 0, "restarted": 0, "removed": 0}
        desired = {
            (m["kind"], m["metadata"]["name"]): m
            for m in (manifests if manifests is not None
                      else gen_manifests(spec))
        }
        observed = {
            (o["kind"], o["metadata"]["name"]): o
            for o in self.api.list_objects(f"persia-job={job}")
        }
        for key, manifest in desired.items():
            obj = observed.get(key)
            if obj is None:
                self.api.apply(manifest)
                stats["created"] += 1
            elif key[0] == "Pod" and _pod_needs_restart(manifest, obj):
                # dead pod: delete now; the NEXT pass's missing-object
                # branch recreates it. Re-applying the same name in the
                # same pass races the apiserver's termination grace
                # period (the object still exists with a
                # deletionTimestamp) and would abort the reconcile.
                self.api.delete(key[0], key[1])
                stats["restarted"] += 1
        for key in observed.keys() - desired.keys():
            self.api.delete(key[0], key[1])
            stats["removed"] += 1
        if any(stats.values()):
            _logger.info("reconciled %s: %s", job, stats)
        return stats

    # --- elastic PS tier (scale-out / scale-in / drain) -----------------

    @staticmethod
    def _ps_replicas_of(spec: dict) -> int:
        conf = spec.get("roles", {}).get("embeddingParameterServer")
        return int(conf.get("replicas", 1)) if conf is not None else 0

    def ps_replicas(self, job_name: str) -> int:
        """The job's CURRENT desired PS replica count — the autopilot
        reads the world it acts on from here (observed state, not its
        own action history, so an operator-side manual scale between
        ticks is seen, not fought)."""
        with self._lock:
            spec = self._jobs.get(job_name)
            if spec is None:
                raise KeyError(f"job {job_name!r} is not tracked")
            return self._ps_replicas_of(spec)

    def reshard_events(self) -> List[dict]:
        with self._lock:
            return list(self._reshard_events)

    def rebalance_ps(self, job_name: str) -> dict:
        """Re-place slots across the CURRENT replica set by workload
        hotness (replica count unchanged): the driver runs a
        ``reshard_to`` at the same count with a hotness
        ``placement_plan``'s slot weights. Without a driver the intent
        is recorded (status ``pending``) for an external controller,
        same convention as :meth:`scale_ps`."""
        with self._lock:
            spec = self._jobs.get(job_name)
            if spec is None:
                raise KeyError(f"job {job_name!r} is not tracked")
            old = self._ps_replicas_of(spec)
            if old == 0:
                raise ValueError(f"job {job_name!r} has no PS role")
        event = {"job": job_name, "from": old, "to": old,
                 "phase": "rebalance",
                 "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
                 "status": "pending"}
        if self._reshard_driver is not None:
            self._reshard_driver(job_name, old, old, "rebalance", spec)
            event["status"] = "done"
        with self._lock:
            self._reshard_events.append(event)
        _logger.info("rebalance_ps %s: %d replicas (%s)", job_name, old,
                     event["status"])
        return event

    # --- autopilot hookup -------------------------------------------

    def attach_autopilot(self, pilot):
        """Expose a running :class:`persia_tpu_torch.autopilot.Autopilot` on
        the REST surface (``GET /autopilot``). The operator never
        drives the pilot — the pilot calls INTO the operator; this
        hook only makes its decisions inspectable next to the
        reshard/variant audit trails."""
        self._autopilot = pilot

    def autopilot_doc(self) -> dict:
        pilot = self._autopilot
        if pilot is None:
            return {"enabled": False}
        doc = pilot.describe()
        doc["enabled"] = True
        return doc

    def scale_ps(self, job_name: str, replicas: int) -> dict:
        """Reconcile a job's PS tier to ``replicas`` with the live
        reshard sequenced safely around pod churn:

        - **scale-out**: new PS pods are created FIRST (reconcile),
          then the driver migrates hotness-balanced slot plans onto
          them and publishes the successor routing epoch;
        - **scale-in / drain**: the driver migrates every slot OFF the
          dying replicas and cuts over BEFORE their pods are removed —
          a drained replica serves stale-epoch double-reads until the
          window closes, then reconcile deletes it.

        Without a driver the intent is recorded (status "pending") so
        an external reshard controller — or an operator following
        docs/DEPLOY.md's runbook — can pick it up; the pod set is only
        changed for scale-out in that case (never delete a PS that
        still owns slots)."""
        with self._lock:
            spec = self._jobs.get(job_name)
            if spec is None:
                raise KeyError(f"job {job_name!r} is not tracked")
            old = self._ps_replicas_of(spec)
            if old == 0:
                raise ValueError(f"job {job_name!r} has no PS role")
        replicas = int(replicas)
        event = {"job": job_name, "from": old, "to": replicas,
                 "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
                 "status": "noop" if replicas == old else "pending"}
        if replicas == old:
            with self._lock:
                self._reshard_events.append(event)
            return event

        def _apply_spec_and_reconcile():
            with self._lock:
                spec["roles"]["embeddingParameterServer"]["replicas"] = \
                    replicas
                self._jobs[job_name] = spec
                self._reconcile_job_locked(spec)

        if replicas > old:
            # grow the pod set, then migrate onto it
            _apply_spec_and_reconcile()
            if self._reshard_driver is not None:
                self._reshard_driver(job_name, old, replicas,
                                     "scale_out", spec)
                event["status"] = "done"
        else:
            # drain slots off the dying replicas BEFORE removing pods
            if self._reshard_driver is not None:
                self._reshard_driver(job_name, old, replicas,
                                     "scale_in", spec)
                event["status"] = "done"
                _apply_spec_and_reconcile()
            else:
                # no driver: record the intent but leave the pods —
                # deleting a PS that still owns slots loses rows
                event["status"] = "pending_drain"
        with self._lock:
            self._reshard_events.append(event)
        _logger.info("scale_ps %s: %d -> %d (%s)", job_name, old,
                     replicas, event["status"])
        return event

    # --- multi-variant serving (promote / rollback a variant) -----------

    def variant_events(self) -> List[dict]:
        with self._lock:
            return list(self._variant_events)

    def variant_op(self, job_name: str, op: str, payload: dict) -> dict:
        """Forward a live variant operation to a job's serving tier
        through the variant driver (``POST /variants`` lands here).
        ``payload`` carries at least ``name`` (except for ``list``);
        ``add`` additionally the model/dense-checkpoint fields the
        serving ``variant_admin`` RPC expects. The event log is the
        operator's audit trail — the promote/rollback runbook
        (docs/DEPLOY.md) reads it back via ``GET /variants``."""
        with self._lock:
            spec = self._jobs.get(job_name)
            if spec is None:
                raise KeyError(f"job {job_name!r} is not tracked")
        if op not in ("add", "remove", "promote", "weight", "drain",
                      "resume", "list"):
            raise ValueError(f"unknown variant op {op!r}")
        event = {"job": job_name, "op": op,
                 "variant": payload.get("name"),
                 "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
                 "status": "pending"}
        if self._variant_driver is not None:
            result = self._variant_driver(job_name, op, dict(payload),
                                          spec)
            event["status"] = "done"
            if result is not None:
                event["result"] = result
        with self._lock:
            self._variant_events.append(event)
        _logger.info("variant_op %s: %s %s (%s)", job_name, op,
                     payload.get("name"), event["status"])
        return event

    def resume_pending_reshards(self) -> List[dict]:
        """Operator-crash recovery: scan each tracked job's migration
        journal (``<reshard_journal_dir>/<job>``) for a migration a
        previous operator incarnation left in flight. With a driver,
        hand it the job under phase ``"resume"`` (it runs
        ``ReshardController.resume()`` against the live fleet — roll
        forward post-publish, fence-and-retry pre-publish); without
        one, record a ``resume_pending`` event so the runbook operator
        sees the wedged migration instead of a silently frozen donor.
        Returns the events recorded (one per in-flight journal)."""
        if self._reshard_journal_dir is None:
            return []
        from persia_tpu_torch.reshard import MigrationJournal

        events = []
        for job in self.job_names():
            root = os.path.join(self._reshard_journal_dir, job)
            if not os.path.isdir(root):
                continue
            try:
                st = MigrationJournal(root).state()
            except Exception as e:
                _logger.error("unreadable reshard journal %s: %s",
                              root, e)
                continue
            if st is None or st["phase"] in MigrationJournal.TERMINAL:
                continue
            key = (job, st["mig_id"], st["attempt"])
            with self._lock:
                if key in self._resumed_migs:
                    continue
                spec = self._jobs.get(job)
            old = self._ps_replicas_of(spec) if spec else None
            new = int(st["new_table"]["num_replicas"])
            event = {"job": job, "from": old, "to": new,
                     "mig_id": st["mig_id"], "phase": st["phase"],
                     "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
                     "status": "resume_pending"}
            if self._reshard_driver is not None and spec is not None:
                try:
                    self._reshard_driver(job, old, new, "resume", spec)
                    event["status"] = "resumed"
                except Exception as e:
                    # a failed resume must RETRY next pass, not be
                    # silently marked handled (the PS fleet is often
                    # briefly unreachable right after an operator
                    # restart — exactly when this scan runs); other
                    # jobs' scans proceed regardless
                    _logger.error("reshard resume driver for %s "
                                  "failed (will retry): %s", job, e)
                    event["status"] = "resume_failed"
                    event["error"] = str(e)
                    with self._lock:
                        self._reshard_events.append(event)
                    events.append(event)
                    continue
            # handled (resumed, or surfaced as pending for a
            # driverless operator) — don't re-fire for this attempt
            with self._lock:
                self._resumed_migs.add(key)
            _logger.warning(
                "reshard journal for %s shows migration %s in flight "
                "(phase %s) -> %s", job, st["mig_id"], st["phase"],
                event["status"])
            with self._lock:
                self._reshard_events.append(event)
            events.append(event)
        return events

    def reconcile_all(self, specs: Optional[List[dict]] = None):
        """One pass over every tracked job. ``specs`` overrides the
        snapshot (tests use it to inject a stale one and prove the
        deleted-while-iterating guard below). Every pass also scans
        the tracked jobs' migration journals (each in-flight attempt
        handled once) — a reshard a previous operator incarnation died
        driving is resumed (or surfaced) before any pod churn can race
        it, including for jobs tracked after startup."""
        try:
            self.resume_pending_reshards()
        except Exception as e:
            _logger.error("reshard resume scan failed: %s", e)
        if specs is None:
            with self._lock:
                specs = list(self._jobs.values())
        for spec in specs:
            with self._lock:
                if spec["jobName"] not in self._jobs:
                    continue  # deleted since the snapshot — do not
                    # resurrect a torn-down job's pods
                try:
                    self._reconcile_job_locked(spec)
                except Exception as e:  # keep the loop alive (operator.rs
                    # requeues on error rather than crashing)
                    _logger.error("reconcile %s failed: %s",
                                  spec.get("jobName"), e)

    def sync_custom_resources(self):
        """Poll PersiaJob custom resources and converge the tracked-job
        set on them (the reference Controller watches the CRD stream,
        operator.rs:25-123; a poll every reconcile interval gives the
        same convergence without a watch API). CR spec = the job spec;
        removed CRs untrack (and tear down) their jobs."""
        crs = self.api.list_custom()
        seen = set()
        for cr in crs:
            spec = cr.get("spec", cr)
            name = spec.get("jobName") or cr.get("metadata", {}).get("name")
            if not name:
                continue
            spec = dict(spec, jobName=name)
            seen.add(name)
            with self._lock:
                # a job the user re-applied via REST/YAML is owned by
                # them — the CR must not reclaim it (or overwrite their
                # spec) on the next poll
                if name in self._jobs and name not in self._from_cr:
                    continue
            self.track(spec, source="cr")
        # only CR-sourced jobs are governed by CR deletion; jobs tracked
        # from YAML argv or the REST API are untouched. Stale detection
        # and the untrack run under ONE lock hold — releasing in between
        # would let a concurrent REST /apply re-track the job only to
        # have it silently torn down here.
        with self._lock:
            for j in list(self._from_cr - seen):
                _logger.info("PersiaJob %s deleted; tearing down", j)
                self._from_cr.discard(j)
                self.untrack(j)

    def run(self, from_crd: bool = False):
        while not self._stop.is_set():
            if from_crd:
                try:
                    self.sync_custom_resources()
                except Exception as e:
                    _logger.error("CR sync failed: %s", e)
            self.reconcile_all()
            self._stop.wait(self.interval)

    def start(self, from_crd: bool = False) -> "Operator":
        """:meth:`run` on a thread of its own; :meth:`stop` joins it."""
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, kwargs={"from_crd": from_crd}, daemon=True,
            name="k8s-operator")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None


class SchedulingServer:
    """REST surface over the operator (reference: the actix-web
    scheduling server, k8s/src/bin/server.rs — /apply /delete /listjobs
    /listpods /podstatus). Submitting a job spec tracks + reconciles it;
    deleting untracks + tears it down."""

    def __init__(self, operator: Operator, host: str = "127.0.0.1",
                 port: int = 0):
        import http.server

        op = operator

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # route through our logger
                _logger.debug("rest: " + a[0], *a[1:])

            def _send(self, code: int, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _query(self) -> dict:
                from urllib.parse import parse_qsl, urlparse

                return dict(parse_qsl(urlparse(self.path).query))

            def do_GET(self):
                from urllib.parse import urlparse

                route = urlparse(self.path).path
                q = self._query()
                try:
                    if route == "/listjobs":
                        self._send(200, {"jobs": op.job_names()})
                    elif route == "/listpods":
                        job = q.get("job", "")
                        pods = [
                            {"name": o["metadata"]["name"],
                             "phase": o.get("status", {}).get("phase")}
                            for o in op.objects_of(job)
                            if o["kind"] == "Pod"
                        ]
                        self._send(200, {"pods": pods})
                    elif route == "/podstatus":
                        job, pod = q.get("job", ""), q.get("pod", "")
                        for o in op.objects_of(job):
                            if (o["kind"] == "Pod"
                                    and o["metadata"]["name"] == pod):
                                self._send(200, {
                                    "phase": o.get("status", {}).get("phase")
                                })
                                return
                        self._send(404, {"error": f"pod {pod!r} not found"})
                    elif route == "/reshards":
                        self._send(200, {"events": op.reshard_events()})
                    elif route == "/variants":
                        self._send(200, {"events": op.variant_events()})
                    elif route == "/autopilot":
                        # the attached autopilot's posture + recent
                        # decisions (enabled: false when none attached)
                        self._send(200, op.autopilot_doc())
                    else:
                        self._send(404, {"error": f"no route {route!r}"})
                except Exception as e:  # surface as HTTP, keep serving
                    self._send(500, {"error": repr(e)})

            def do_POST(self):
                from urllib.parse import urlparse

                route = urlparse(self.path).path
                try:
                    if route == "/apply":
                        n = int(self.headers.get("Content-Length", 0))
                        spec = json.loads(self.rfile.read(n))
                        # validate BEFORE track: an invalid spec must not
                        # stay tracked, or the reconcile loop re-raises on
                        # every interval until a manual /delete
                        from persia_tpu_torch.k8s_utils import \
                            validate_spec

                        try:
                            manifests = validate_spec(spec)
                        except Exception as e:
                            self._send(400, {"error": repr(e)})
                            return
                        op.track(spec)
                        stats = op.reconcile_job(spec, manifests)
                        self._send(200, {"job": spec["jobName"],
                                         "reconcile": stats})
                    elif route == "/delete":
                        job = self._query().get("job", "")
                        op.untrack(job)
                        self._send(200, {"deleted": job})
                    elif route == "/scale":
                        # elastic PS tier: reconcile the replica count
                        # with the live reshard sequenced around pod
                        # churn (see Operator.scale_ps)
                        n = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(n))
                        try:
                            event = op.scale_ps(req["jobName"],
                                                int(req["psReplicas"]))
                        except KeyError as e:
                            self._send(404, {"error": repr(e)})
                            return
                        except ValueError as e:
                            self._send(400, {"error": repr(e)})
                            return
                        self._send(200, event)
                    elif route == "/variants":
                        # multi-variant serving control: forward a live
                        # add/remove/promote/weight/drain to the job's
                        # serving replicas (see Operator.variant_op)
                        n = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(n))
                        try:
                            event = op.variant_op(
                                req["jobName"], req["op"],
                                {k: v for k, v in req.items()
                                 if k not in ("jobName", "op")})
                        except KeyError as e:
                            self._send(404, {"error": repr(e)})
                            return
                        except ValueError as e:
                            self._send(400, {"error": repr(e)})
                            return
                        self._send(200, event)
                    else:
                        self._send(404, {"error": f"no route {route!r}"})
                except Exception as e:
                    self._send(500, {"error": repr(e)})

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        # a request's handler thread is joined by server_close()
        self._httpd.daemon_threads = False
        self.addr = f"{host}:{self._httpd.server_address[1]}"
        self._thread: Optional[threading.Thread] = None

    def serve_background(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"k8s-rest-{self.addr}")
        self._thread.start()

    def stop(self):
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=30)
            self._thread = None
        self._httpd.server_close()


def main(argv=None):
    p = argparse.ArgumentParser(prog="persia-torch-operator")
    p.add_argument("job_yamls", nargs="*", help="job spec YAML files")
    p.add_argument("--namespace", default="default")
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument("--once", action="store_true",
                   help="single reconcile pass, then exit")
    p.add_argument("--serve", default=None, metavar="HOST:PORT",
                   help="also expose the REST scheduling API")
    p.add_argument("--from-crd", action="store_true",
                   help="watch PersiaJob custom resources (install the "
                        "CRD via `python -m persia_tpu_torch.k8s_utils "
                        "gencrd`)")
    args = p.parse_args(argv)
    if not args.job_yamls and not args.serve and not args.from_crd:
        p.error("give job YAML files, --serve HOST:PORT, --from-crd, "
                "or a combination")
    if args.once and args.serve:
        p.error("--once exits immediately and would kill the REST server; "
                "use one or the other")
    specs = [load_yaml(f) for f in args.job_yamls]
    op = Operator(KubectlApi(args.namespace), specs, interval=args.interval)
    if args.serve:
        if ":" not in args.serve:
            p.error(f"--serve expects HOST:PORT, got {args.serve!r}")
        host, port = args.serve.rsplit(":", 1)
        server = SchedulingServer(op, host, int(port))
        server.serve_background()
        _logger.info("scheduling REST API on %s", server.addr)
    if args.once:
        if args.from_crd:
            op.sync_custom_resources()
        op.reconcile_all()
    else:
        op.run(from_crd=args.from_crd)


if __name__ == "__main__":
    main()
