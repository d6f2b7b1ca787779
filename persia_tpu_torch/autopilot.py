"""Autopilot: the decision engine that closes the telemetry ->
planner -> operator loop (``persia_tpu/autopilot.py``).

Every ingredient of a self-scaling fleet exists as a manual step —
hotness fits zipf alpha and emits placement plans, the SLO engine
detects breaches, the reshard controller survives crashes, the operator
has scale/reshard/variant drivers — but a human still watches
``/fleet/*`` and decides. This module is the watcher that ACTS, the
role the reference deployment delegates to the k8s operator's CRD
reconciliation loop (PAPER.md L7, ``k8s/src/crd.rs``):

- **Policies** own one decision each. A policy contributes declarative
  :class:`~persia_tpu_torch.slos.SloRule` objectives (installed into the
  fleet monitor's engine, so the trigger shares the alert surface
  operators already watch) and a ``decide()`` that turns firing rules
  plus :class:`~persia_tpu_torch.fleet.FleetHistory` context into at most
  one proposed action per tick:

  - :class:`PsScalePolicy` — scale the PS tier out on SUSTAINED row
    load (fleet-scope ``sustained(ps_lookup_row_rate)``, so one spike
    never scales), back in when load stays below the low-water band.
    The two thresholds form the hysteresis band: anything between
    them holds the current size.
  - :class:`RebalancePolicy` — when one replica's share of the fleet
    row rate breaches, hold for a confirmation window, then re-place
    slots by workload hotness (the planner's ``placement_plan``) at
    the same replica count — but only when the plan PREDICTS a real
    improvement (no churn for a plan that cannot help).
  - :class:`VariantShedPolicy` — when a per-variant by_label rule
    burns (one A/B arm degraded/slow), shed that variant's split
    weight so the healthy arms absorb its traffic.

- The **Autopilot** ticks: evaluate rules, let each policy propose,
  pass proposals through per-(policy, kind) cooldowns and a GLOBAL
  trailing-hour action-rate limiter (both armed identically in
  recommend and enforce mode, so a recommend soak paces exactly like
  enforcement would), journal every decision with its triggering
  evidence (firing alerts + a bounded history excerpt), and — in
  ``enforce`` mode only — execute through the operator. Default mode
  is **recommend** (``PERSIA_AUTOPILOT_MODE``): the pilot journals
  what it WOULD do and touches nothing.

- The **ActionJournal** uses the reshard journal's atomic-file
  discipline (one ``rec_<seq>_p<pid>_<kind>.json`` per record through
  ``storage.PersiaPath.write_bytes_atomic``), so a SIGKILL mid-decision
  leaves a readable prefix. Kinds: ``decision`` (proposal + evidence, both modes),
  ``executed`` / ``action_failed`` (enforce), ``outcome`` /
  ``regressed`` (the deferred verification verdict), ``deferred``
  (blocked by cooldown/rate limit).

- **Verification**: every executed action schedules a check — after
  ``verify_sec`` the pilot asks whether the triggering rule is still
  firing. Still burning means the action did not help: the journal
  records ``regressed`` and the FlightRecorder captures a postmortem
  bundle of the worst service, same as an SLO breach would.

Pull-only and wire-neutral by construction: the pilot reads only what
the fleet monitor already scraped; in recommend mode it never touches
the RPC plane at all (pinned by test), and in enforce mode every
action flows through the operator's audited drivers.
"""

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from persia_tpu_torch import knobs
from persia_tpu_torch.slos import SloRule
from persia_tpu_torch.storage import PersiaPath

_logger = logging.getLogger(__name__)


class ActionJournal:
    """Append-only decision/outcome journal. With a ``root`` directory
    every record is its own atomically-written
    ``rec_<seq>_p<pid>_<kind>.json`` (the reshard journal's crash
    discipline — a torn record is impossible, a readable prefix always
    survives); without one the bounded in-memory ring still feeds
    ``GET /autopilot`` and the bench gates."""

    def __init__(self, root: Optional[str] = None, keep: int = 256):
        self.root = root
        self._mem: "deque[Dict]" = deque(maxlen=keep)
        self._lock = threading.Lock()
        self._seq = 0
        if root is not None:
            PersiaPath(root).makedirs()
            for seq, _p in self._list_record_files():
                self._seq = max(self._seq, seq)

    def _list_record_files(self):
        out = []
        for p in PersiaPath(self.root).listdir():
            name = os.path.basename(p)
            if (not name.startswith("rec_") or name.endswith(".tmp")
                    or not name.endswith(".json")):
                continue
            try:
                out.append((int(name.split("_")[1]), p))
            except (IndexError, ValueError):
                continue
        out.sort()
        return out

    def append(self, kind: str, /, **fields) -> Dict:
        reserved = {"seq", "kind", "ts"} & set(fields)
        if reserved:
            raise ValueError(
                f"journal fields shadow record keys: {sorted(reserved)}")
        with self._lock:
            self._seq += 1
            seq = self._seq
        rec = {"seq": seq, "kind": kind, "ts": time.time(), **fields}
        with self._lock:
            self._mem.append(rec)
        if self.root is not None:
            path = os.path.join(
                self.root,
                f"rec_{seq:06d}_p{os.getpid()}_{kind}.json")
            PersiaPath(path).write_bytes_atomic(
                json.dumps(rec, sort_keys=True,
                           default=str).encode("utf-8"))
        return rec

    def records(self) -> List[Dict]:
        """Every durable record (or the in-memory ring when the
        journal has no directory), in sequence order."""
        if self.root is None:
            with self._lock:
                return list(self._mem)
        out = []
        for _seq, p in self._list_record_files():
            out.append(json.loads(
                PersiaPath(p).read_bytes().decode("utf-8")))
        out.sort(key=lambda r: int(r.get("seq", 0)))
        return out

    def tail(self, n: int = 32) -> List[Dict]:
        with self._lock:
            return list(self._mem)[-n:]


class Policy:
    """One decision the autopilot can make. Subclasses contribute
    declarative rules via :meth:`rules` (installed into the monitor's
    SLO engine, so triggers share the operator-visible alert surface)
    and propose at most one action per tick via :meth:`decide`.

    A proposal is a dict:

    - ``kind``     — ``scale_out`` | ``scale_in`` | ``rebalance`` |
      ``variant_shed`` (dispatched by :meth:`Autopilot._execute`)
    - ``action``   — the operator-call parameters
    - ``reason``   — one operator-readable sentence
    - ``trigger_rule``      — rule whose firing alerts become the
      journal evidence (omit for history-driven policies)
    - ``watch_rule``        — rule name the deferred verification
      re-checks (still firing after ``verify_sec`` == regressed).
      Not always the trigger: a scale-IN's trigger is the low-load
      rule, but the regression to watch for is the HIGH-load rule
      firing after the shrink
    - ``evidence_spec``     — ``[(metric, service_regex, window_sec)]``
      history excerpts to bundle into the journal record
    - ``postmortem_service`` — whose flight snapshot to capture when
      the action fails or regresses
    """

    name = "policy"
    verify_sec = 60.0
    cooldown_sec: Optional[float] = None  # None -> the global knob

    def rules(self) -> List[SloRule]:
        return []

    def decide(self, pilot: "Autopilot", now: float,
               firing: Dict[str, List[Dict]]) -> Optional[Dict]:
        raise NotImplementedError


class PsScalePolicy(Policy):
    """Scale the PS tier on sustained fleet row load.

    The signal is ``ps_lookup_row_rate`` summed across replicas
    (fleet scope): under the workers' all-to-all fanout the total
    rows/sec IS the offered load, independent of replica count, so
    the same thresholds stay meaningful across every fleet size.
    ``sustained()`` makes one spike powerless; the gap between
    ``scale_out_at`` and ``scale_in_below`` is the hysteresis band
    that prevents flapping at a single threshold."""

    name = "ps_scale"

    def __init__(self, job: str, scale_out_at: float,
                 scale_in_below: float, window_sec: float = 300.0,
                 for_sec: float = 0.0, min_replicas: int = 1,
                 max_replicas: int = 8, step: int = 1,
                 metric: str = "ps_lookup_row_rate",
                 service: str = r"^ps", verify_sec: float = 60.0):
        if scale_in_below >= scale_out_at:
            raise ValueError(
                "hysteresis band inverted: scale_in_below "
                f"({scale_in_below}) must sit strictly below "
                f"scale_out_at ({scale_out_at})")
        self.job = job
        self.scale_out_at = float(scale_out_at)
        self.scale_in_below = float(scale_in_below)
        self.window_sec = float(window_sec)
        self.for_sec = float(for_sec)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.step = int(step)
        self.metric = metric
        self.service = service
        self.verify_sec = float(verify_sec)

    @property
    def rule_high(self) -> str:
        return f"autopilot_{self.name}_load_high"

    @property
    def rule_low(self) -> str:
        return f"autopilot_{self.name}_load_low"

    def rules(self) -> List[SloRule]:
        return [
            SloRule(self.rule_high, f"sustained({self.metric})", ">",
                    self.scale_out_at, window_sec=self.window_sec,
                    for_sec=self.for_sec, service=self.service,
                    scope="fleet", severity="autopilot",
                    description="fleet row load never dipped below the "
                                "scale-out threshold for the whole "
                                "window"),
            SloRule(self.rule_low, f"sustained({self.metric})", "<",
                    self.scale_in_below, window_sec=self.window_sec,
                    for_sec=self.for_sec, service=self.service,
                    scope="fleet", severity="autopilot",
                    description="fleet row load never rose above the "
                                "scale-in threshold for the whole "
                                "window"),
        ]

    def _hottest_service(self, pilot: "Autopilot", now: float):
        shares = pilot.monitor.history.breakdown(
            self.metric, self.window_sec, "avg", self.service, now)
        if not shares:
            return None
        return max(shares, key=shares.get)

    def decide(self, pilot, now, firing):
        replicas = pilot.operator.ps_replicas(self.job)
        if self.rule_high in firing and replicas < self.max_replicas:
            to = min(replicas + self.step, self.max_replicas)
            return {
                "kind": "scale_out",
                "action": {"job": self.job, "replicas": to},
                "reason": (f"fleet {self.metric} sustained above "
                           f"{self.scale_out_at:g} for "
                           f"{self.window_sec:g}s at {replicas} "
                           f"replicas -> scale to {to}"),
                "trigger_rule": self.rule_high,
                "watch_rule": self.rule_high,
                "evidence_spec": [(self.metric, self.service,
                                   self.window_sec)],
                "postmortem_service": self._hottest_service(pilot, now),
            }
        if self.rule_low in firing and replicas > self.min_replicas:
            to = max(replicas - self.step, self.min_replicas)
            return {
                "kind": "scale_in",
                "action": {"job": self.job, "replicas": to},
                "reason": (f"fleet {self.metric} sustained below "
                           f"{self.scale_in_below:g} for "
                           f"{self.window_sec:g}s at {replicas} "
                           f"replicas -> scale to {to}"),
                "trigger_rule": self.rule_low,
                # shrinking while load stays low is the POINT — the
                # regression to catch is the high-load rule firing
                # after the shrink (capacity was actually needed)
                "watch_rule": self.rule_high,
                "evidence_spec": [(self.metric, self.service,
                                   self.window_sec)],
                "postmortem_service": self._hottest_service(pilot, now),
            }
        return None


class RebalancePolicy(Policy):
    """Re-place slots by hotness when one replica carries an outsized
    share of the fleet row rate.

    Shares are cross-service ratios the rule grammar cannot express,
    so this policy reads the history ring directly: per-service
    ``breakdown`` of the row-rate over its window. A breach must HOLD
    for ``hold_sec`` (policy-side pending state, same shape as a
    rule's for_sec), and the hotness planner's plan must predict at
    least ``min_gain`` share improvement — a skew the plan cannot fix
    (one hot row) is not worth a migration."""

    name = "ps_rebalance"

    def __init__(self, job: str, share_threshold: float = 0.45,
                 hold_sec: float = 60.0, min_gain: float = 0.05,
                 window_sec: float = 60.0,
                 metric: str = "ps_lookup_row_rate",
                 service: str = r"^ps", verify_sec: float = 60.0):
        self.job = job
        self.share_threshold = float(share_threshold)
        self.hold_sec = float(hold_sec)
        self.min_gain = float(min_gain)
        self.window_sec = float(window_sec)
        self.metric = metric
        self.service = service
        self.verify_sec = float(verify_sec)
        self._pending_since: Optional[float] = None

    def measured_share(self, pilot: "Autopilot", now: float):
        """(max_share, service, per_service) from the history ring,
        or (None, None, {}) when fewer than two replicas report."""
        shares = pilot.monitor.history.breakdown(
            self.metric, self.window_sec, "avg", self.service, now)
        total = sum(shares.values())
        if len(shares) < 2 or total <= 0:
            return None, None, {}
        top = max(shares, key=shares.get)
        return shares[top] / total, top, {
            s: round(v / total, 4) for s, v in shares.items()}

    def decide(self, pilot, now, firing):
        share, top, per = self.measured_share(pilot, now)
        # hysteresis: pending state only clears once the share drops
        # clearly below the band, not the instant it grazes it
        if share is None or share < self.share_threshold * 0.9:
            self._pending_since = None
            return None
        if share < self.share_threshold:
            return None
        if self._pending_since is None:
            self._pending_since = now
        if now - self._pending_since < self.hold_sec:
            return None
        replicas = pilot.operator.ps_replicas(self.job)
        plan = pilot.plan_placement(replicas)
        if plan is None:
            return None
        predicted = plan.get("max_replica_share")
        if predicted is None or predicted > share - self.min_gain:
            # the planner cannot improve this skew enough to justify
            # moving slots — hold, and let the scale policy react if
            # absolute load is also high
            return None
        return {
            "kind": "rebalance",
            "action": {"job": self.job, "replicas": replicas},
            "reason": (f"{top} carries {share:.0%} of fleet "
                       f"{self.metric} (threshold "
                       f"{self.share_threshold:.0%} held "
                       f"{self.hold_sec:g}s); hotness plan predicts "
                       f"max share {predicted:.0%}"),
            "watch_rule": None,
            "plan": {
                "max_replica_share": predicted,
                "hash_even_max_share": plan.get("hash_even_max_share"),
                "moved_slots": plan.get("moved_slots"),
                "measured_shares": per,
            },
            "evidence_spec": [(self.metric, self.service,
                               self.window_sec)],
            "postmortem_service": top,
        }


class VariantShedPolicy(Policy):
    """Shed a burning model variant's split traffic.

    Reacts to any firing by_label alert of ``rule_name`` (default:
    the built-in per-variant degradation rule) whose alert key names
    a variant — ``serving0[variant=canary]`` — and lowers THAT
    variant's weight to ``shed_to`` through the operator's variant
    driver, so the healthy arms absorb its share. Promote/rollback
    stays a human call; the autopilot only stops the bleeding."""

    name = "variant_shed"

    def __init__(self, job: str, rule_name: str = "variant_degraded",
                 shed_to: float = 0.0, verify_sec: float = 120.0):
        self.job = job
        self.rule_name = rule_name
        self.shed_to = float(shed_to)
        self.verify_sec = float(verify_sec)

    def decide(self, pilot, now, firing):
        for alert in firing.get(self.rule_name, []):
            svc = alert.get("service", "")
            if "[variant=" not in svc:
                continue
            variant = svc.split("[variant=", 1)[1].rstrip("]")
            return {
                "kind": "variant_shed",
                "action": {"job": self.job, "name": variant,
                           "weight": self.shed_to},
                "reason": (f"{self.rule_name} firing for variant "
                           f"{variant!r} on {svc} (value "
                           f"{alert.get('value')}) -> shed split "
                           f"weight to {self.shed_to:g}"),
                "trigger_rule": self.rule_name,
                "watch_rule": self.rule_name,
                "evidence_spec": [],
                "postmortem_service": svc.split("[", 1)[0],
            }
        return None


def default_policies(job: str) -> List[Policy]:
    """The paved-road policy set with production-shaped bands — the
    bench and tests build their own with compressed windows."""
    return [
        PsScalePolicy(job, scale_out_at=500_000.0,
                      scale_in_below=100_000.0, window_sec=300.0),
        RebalancePolicy(job, share_threshold=0.45, hold_sec=120.0,
                        window_sec=120.0),
        VariantShedPolicy(job),
    ]


class Autopilot:
    """The decision loop: rules fire, policies propose, gates pace,
    the journal remembers, and (enforce mode only) the operator acts.

    ``tick()`` is pure control flow over injected time — the bench
    and tests drive it manually with explicit ``now``/``alerts`` so a
    recommend-mode shadow pilot and an enforce pilot can be stepped
    at identical instants and compared decision-for-decision.
    ``start()`` runs it on a daemon thread for real deployments.
    """

    MAX_RECENT = 64

    def __init__(self, monitor, operator, job: str,
                 policies: Optional[List[Policy]] = None,
                 mode: Optional[str] = None,
                 journal_dir: Optional[str] = None,
                 cooldown_sec: Optional[float] = None,
                 max_actions_per_hour: Optional[int] = None,
                 table_fn: Optional[Callable] = None,
                 tick_interval: float = 10.0):
        self.monitor = monitor
        self.operator = operator
        self.job = job
        self.policies = (list(policies) if policies is not None
                         else default_policies(job))
        mode = (mode if mode is not None
                else knobs.get("PERSIA_AUTOPILOT_MODE"))
        if mode not in ("recommend", "enforce"):
            raise ValueError(f"bad autopilot mode {mode!r} "
                             "(recommend|enforce)")
        self.mode = mode
        journal_dir = (journal_dir if journal_dir is not None
                       else knobs.get("PERSIA_AUTOPILOT_JOURNAL_DIR"))
        self.journal = ActionJournal(journal_dir)
        self.cooldown_sec = float(
            cooldown_sec if cooldown_sec is not None
            else knobs.get("PERSIA_AUTOPILOT_COOLDOWN_SEC"))
        self.max_actions_per_hour = int(
            max_actions_per_hour if max_actions_per_hour is not None
            else knobs.get("PERSIA_AUTOPILOT_MAX_ACTIONS_PER_HOUR"))
        # current routing table for plan slot-count pinning (embedders
        # that hold a live ReshardController pass its table); None
        # lets the planner assume a fresh hash-even layout
        self.table_fn = table_fn
        self.tick_interval = float(tick_interval)
        self._lock = threading.Lock()
        self._last_action: Dict[tuple, float] = {}
        self._action_times: "deque[float]" = deque()
        self._pending_checks: List[Dict] = []
        self._recent: "deque[Dict]" = deque(maxlen=self.MAX_RECENT)
        self._seq = itertools.count(1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the policies' rules join the live alert surface (idempotent
        # by name, retention re-widens)
        self.monitor.engine.add_rules(
            [r for p in self.policies for r in p.rules()])

    # --- gates -----------------------------------------------------------

    def _gate(self, policy: Policy, kind: str,
              now: float) -> Optional[str]:
        """Why this proposal may not proceed right now (None = clear).
        Applied BEFORE mode branching, so recommend-mode decisions
        pace exactly as enforcement would."""
        cooldown = (policy.cooldown_sec
                    if policy.cooldown_sec is not None
                    else self.cooldown_sec)
        with self._lock:
            last = self._last_action.get((policy.name, kind))
            if last is not None and now - last < cooldown:
                return (f"cooldown: last {policy.name}/{kind} "
                        f"{now - last:.0f}s ago < {cooldown:g}s")
            while (self._action_times
                   and now - self._action_times[0] > 3600.0):
                self._action_times.popleft()
            if len(self._action_times) >= self.max_actions_per_hour:
                return (f"rate limit: {len(self._action_times)} "
                        f"actions in the trailing hour >= "
                        f"{self.max_actions_per_hour}")
        return None

    def _arm(self, policy: Policy, kind: str, now: float):
        with self._lock:
            self._last_action[(policy.name, kind)] = now
            self._action_times.append(now)

    # --- evidence --------------------------------------------------------

    def _evidence(self, proposal: Dict, triggering: List[Dict],
                  now: float) -> Dict:
        excerpts = []
        for metric, service, window in proposal.get(
                "evidence_spec", []):
            excerpts.extend(self.monitor.history.excerpt(
                metric, window, service, points=16, now=now))
        return {
            "firing_rules": [
                {k: a.get(k) for k in ("rule", "service", "expr",
                                       "op", "threshold", "value",
                                       "firing_since")}
                for a in triggering],
            "history": excerpts,
        }

    def plan_placement(self, num_replicas: int) -> Optional[Dict]:
        """The hotness planner's placement plan for ``num_replicas``,
        pinned to the live table's slot count when an embedder
        provided ``table_fn``. None when telemetry is unarmed or the
        planner fails — a policy treats that as "cannot justify a
        rebalance", never as an error."""
        try:
            table = self.table_fn() if self.table_fn is not None \
                else None
            plan = self.monitor.hotness_plan(num_replicas,
                                             current_table=table)
        except Exception as e:
            _logger.warning("autopilot placement plan failed: %s", e)
            return None
        if not plan or not plan.get("assignment"):
            return None
        return plan

    # --- the loop --------------------------------------------------------

    def tick(self, now: Optional[float] = None,
             alerts: Optional[List[Dict]] = None) -> List[Dict]:
        """One decision pass. Returns the decisions that cleared the
        gates this tick (journaled; executed too in enforce mode).
        ``now``/``alerts`` injection keeps the pass deterministic for
        the recommend==enforce bench gate."""
        now = time.monotonic() if now is None else now
        if alerts is None:
            alerts = self.monitor.engine.evaluate(now)
        firing: Dict[str, List[Dict]] = {}
        for a in alerts:
            if a["firing"]:
                firing.setdefault(a["rule"], []).append(a)
        decisions = []
        for policy in self.policies:
            try:
                proposal = policy.decide(self, now, firing)
            except Exception:
                _logger.exception("policy %s decide() failed",
                                  policy.name)
                continue
            if proposal is None:
                continue
            kind = proposal["kind"]
            blocked = self._gate(policy, kind, now)
            if blocked is not None:
                self.journal.append(
                    "deferred", policy=policy.name, action_kind=kind,
                    action=proposal["action"], mode=self.mode,
                    reason=proposal["reason"], blocked_by=blocked)
                continue
            trigger = (proposal.get("trigger_rule")
                       or proposal.get("watch_rule"))
            triggering = firing.get(trigger, []) if trigger else []
            decision = {
                "decision_seq": next(self._seq),
                "policy": policy.name,
                "kind": kind,
                "action": proposal["action"],
                "reason": proposal["reason"],
                "mode": self.mode,
                "t": now,
                "evidence": self._evidence(proposal, triggering, now),
            }
            if proposal.get("plan") is not None:
                decision["plan"] = proposal["plan"]
            # cooldowns arm in BOTH modes: a recommend soak must pace
            # its decision stream exactly as enforcement would, or
            # graduating to enforce changes behavior
            self._arm(policy, kind, now)
            # nested, not splatted: the decision dict's own "kind"
            # (the ACTION kind) must not shadow the record kind
            self.journal.append("decision", decision=decision)
            if self.mode == "enforce":
                self._execute(policy, proposal, decision, now)
            with self._lock:
                self._recent.append(decision)
            decisions.append(decision)
        self._verify_outcomes(now, firing)
        return decisions

    def _execute(self, policy: Policy, proposal: Dict, decision: Dict,
                 now: float):
        kind = proposal["kind"]
        action = proposal["action"]
        try:
            if kind in ("scale_out", "scale_in"):
                event = self.operator.scale_ps(action["job"],
                                               action["replicas"])
            elif kind == "rebalance":
                event = self.operator.rebalance_ps(action["job"])
            elif kind == "variant_shed":
                event = self.operator.variant_op(
                    action["job"], "weight",
                    {"name": action["name"],
                     "weight": action["weight"]})
            else:
                raise ValueError(f"unknown action kind {kind!r}")
        except Exception as e:
            _logger.exception("autopilot action %s failed", kind)
            self.journal.append(
                "action_failed",
                decision_seq=decision["decision_seq"],
                policy=policy.name, action_kind=kind, action=action,
                error=repr(e))
            self._postmortem(proposal, decision,
                             f"autopilot_action_failed:{kind}")
            return
        self.journal.append(
            "executed", decision_seq=decision["decision_seq"],
            policy=policy.name, action_kind=kind, action=action,
            operator_event={k: v for k, v in (event or {}).items()
                            if k != "spec"})
        with self._lock:
            self._pending_checks.append({
                "decision_seq": decision["decision_seq"],
                "policy": policy.name, "kind": kind,
                "watch_rule": proposal.get("watch_rule"),
                "postmortem_service": proposal.get("postmortem_service"),
                "check_after": now + policy.verify_sec,
                "proposal": proposal,
            })

    def _verify_outcomes(self, now: float,
                         firing: Dict[str, List[Dict]]):
        """The deferred verdicts: after an action's verify window, a
        triggering rule still firing means the action did not move
        its target signal — journal ``regressed`` and capture a
        postmortem. Quiet rules journal ``outcome`` (improved)."""
        with self._lock:
            due = [c for c in self._pending_checks
                   if now >= c["check_after"]]
            if not due:
                return
            self._pending_checks = [c for c in self._pending_checks
                                    if now < c["check_after"]]
        for check in due:
            rule = check.get("watch_rule")
            still = rule is not None and rule in firing
            if still:
                self.journal.append(
                    "regressed", decision_seq=check["decision_seq"],
                    policy=check["policy"], action_kind=check["kind"],
                    watch_rule=rule,
                    detail="triggering rule still firing after the "
                           "verify window — the action did not move "
                           "its target signal")
                self._postmortem(check["proposal"], check,
                                 f"autopilot_regressed:{check['kind']}")
            else:
                self.journal.append(
                    "outcome", decision_seq=check["decision_seq"],
                    policy=check["policy"], action_kind=check["kind"],
                    watch_rule=rule, improved=True)

    def _postmortem(self, proposal: Dict, context: Dict, reason: str):
        recorder = getattr(self.monitor, "recorder", None)
        service = proposal.get("postmortem_service")
        if recorder is None or service is None:
            return
        try:
            recorder.capture(service, reason,
                             extra={"decision_seq":
                                    context.get("decision_seq")})
        except Exception:
            _logger.exception("autopilot postmortem capture failed")

    # --- background loop -------------------------------------------------

    def start(self) -> "Autopilot":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="autopilot")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.tick()
            except Exception:
                _logger.exception("autopilot tick failed")
            elapsed = time.monotonic() - t0
            self._stop.wait(max(self.tick_interval - elapsed, 0.05))

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # --- views -----------------------------------------------------------

    def decisions(self) -> List[Dict]:
        with self._lock:
            return list(self._recent)

    def describe(self) -> Dict:
        with self._lock:
            recent = list(self._recent)[-16:]
            n_hour = len(self._action_times)
            pending = len(self._pending_checks)
        return {
            "mode": self.mode,
            "job": self.job,
            "policies": [p.name for p in self.policies],
            "cooldown_sec": self.cooldown_sec,
            "max_actions_per_hour": self.max_actions_per_hour,
            "actions_trailing_hour": n_hour,
            "pending_verifications": pending,
            "journal": {"root": self.journal.root,
                        "tail": self.journal.tail(16)},
            "recent_decisions": [
                {k: d.get(k) for k in ("decision_seq", "policy",
                                       "kind", "action", "reason",
                                       "mode", "t")}
                for d in recent],
        }
