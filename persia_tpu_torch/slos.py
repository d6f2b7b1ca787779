"""The declarative SLO engine over scraped metric windows
(``persia_tpu/slos.py``).

The fleet monitor (:mod:`persia_tpu_torch.fleet`) scrapes every service's
``/metrics`` exposition; this module turns those per-target sample
snapshots into judgements: a rule is a metric expression, a comparison,
a threshold and a window, evaluated on every round, with alerts that name
the breaching service and a bounded breach log for postmortems and CI
gates.

Expression grammar:

- ``up``: the synthetic liveness of a target (1 scraped, 0 down);
- ``<metric>``: the latest value, summed over the service's series;
- ``rate(<metric>)``: the increase a second over the window (a counter
  reset counts from zero, never negative);
- ``increase(<metric>)``: the increase over the window;
- ``ratio(<a>, <b>)``: increase(a) / increase(b) (0 when b did not move);
- ``p50/p90/p95/p99(<metric>)``: a quantile of a histogram's ``_bucket``
  increases over the window;
- ``sustained(<metric>)``: the window's minimum under ``>`` / ``>=`` and
  its maximum under ``<`` / ``<=``, so the rule fires only when every
  scrape breaches; None until 80% of the window is covered;
- ``trend(<metric>)``: the least-squares slope (units a second) over the
  window, None with fewer than two points.

A rule is judged for each matching service (``scope: service``), for the
sum over them (``scope: fleet``), or for each value of a label
(``by_label``, e.g. each model variant). It fires once its condition has
held ``for_sec``; each firing transition lands in the breach log and goes
to ``on_breach``, where the fleet monitor writes a postmortem bundle.
:meth:`SloEngine.exit_code` is the CI gate.

:func:`load_rules` reads a rule file as JSON first and, if that fails,
with the port's YAML subset (:mod:`persia_tpu_torch._yaml`), where the
JAX package calls ``yaml.safe_load``: the port does not need PyYAML.
"""

import json
import logging
import re
import threading
import time
from collections import deque, namedtuple
from typing import Callable, Dict, List, Optional, Tuple

_logger = logging.getLogger(__name__)

_EXPR_RE = re.compile(
    r"^\s*(?:(?P<fn>rate|increase|ratio|sustained|trend"
    r"|p50|p90|p95|p99)\s*\(\s*"
    r"(?P<arg1>[a-zA-Z_:][a-zA-Z0-9_:]*)\s*"
    r"(?:,\s*(?P<arg2>[a-zA-Z_:][a-zA-Z0-9_:]*)\s*)?\)"
    r"|(?P<metric>[a-zA-Z_:][a-zA-Z0-9_:]*))\s*$")

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


class SloRule:
    """One declarative objective. ``service`` is a regex matched against
    fleet service names (``ps0``, ``worker1``, ``serving:9000``...);
    None matches every service."""

    def __init__(self, name: str, expr: str, op: str, threshold: float,
                 window_sec: float = 60.0, for_sec: float = 0.0,
                 service: Optional[str] = None, scope: str = "service",
                 severity: str = "page", description: str = "",
                 by_label: Optional[str] = None):
        m = _EXPR_RE.match(expr)
        if m is None:
            raise ValueError(f"rule {name!r}: bad expression {expr!r}")
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: bad comparison {op!r} "
                             f"(one of {sorted(_OPS)})")
        if scope not in ("service", "fleet"):
            raise ValueError(f"rule {name!r}: scope must be service|fleet")
        self.name = name
        self.expr = expr
        self.fn = m.group("fn")          # None for bare metric / up
        self.arg1 = m.group("arg1") or m.group("metric")
        self.arg2 = m.group("arg2")
        if self.fn == "ratio" and not self.arg2:
            raise ValueError(f"rule {name!r}: ratio() needs two metrics")
        self.op = op
        self.threshold = float(threshold)
        self.window_sec = float(window_sec)
        self.for_sec = float(for_sec)
        self.service = service
        self._service_re = re.compile(service) if service else None
        self.scope = scope
        self.severity = severity
        self.description = description
        # per-label-value evaluation (the multi-variant serving tier's
        # isolation contract): the rule evaluates once PER VALUE of
        # this label — e.g. by_label="variant" judges every model
        # variant's series separately, so one broken canary fires its
        # own alert instead of hiding inside the service aggregate
        if by_label is not None and scope == "fleet":
            raise ValueError(f"rule {name!r}: by_label needs "
                             "service scope")
        self.by_label = by_label

    @classmethod
    def from_dict(cls, d: Dict) -> "SloRule":
        return cls(
            name=d["name"], expr=d["expr"], op=d.get("op", ">"),
            threshold=d["threshold"],
            window_sec=d.get("window_sec", 60.0),
            for_sec=d.get("for_sec", 0.0),
            service=d.get("service"), scope=d.get("scope", "service"),
            severity=d.get("severity", "page"),
            description=d.get("description", ""),
            by_label=d.get("by_label"),
        )

    def matches(self, service: str) -> bool:
        return self._service_re is None or bool(
            self._service_re.search(service))

    def describe(self) -> Dict:
        return {"name": self.name, "expr": self.expr, "op": self.op,
                "threshold": self.threshold,
                "window_sec": self.window_sec, "for_sec": self.for_sec,
                "service": self.service, "scope": self.scope,
                "severity": self.severity,
                "description": self.description,
                "by_label": self.by_label}


def load_rules(path: str) -> List[SloRule]:
    """Load a rule file, JSON or YAML: a list of rule dicts, or
    ``{"rules": [...]}``."""
    from persia_tpu_torch import _yaml

    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        doc = _yaml.load(text)
    if isinstance(doc, dict):
        doc = doc.get("rules", [])
    return [SloRule.from_dict(d) for d in doc or []]


def default_rules() -> List[SloRule]:
    """The paved-road fleet objectives — every signal a hybrid
    train+serve deployment pages on today. A rule file replaces these
    wholesale; they double as grammar documentation."""
    return [
        SloRule("target_down", "up", "<", 1.0, window_sec=30.0,
                description="a service's sidecar stopped answering "
                            "scrapes (crashed or wedged replica)"),
        SloRule("lost_updates", "rate(pipeline_lost_updates_total)",
                ">", 0.0, window_sec=60.0,
                description="backward ships exhausted retries — "
                            "gradient updates are being dropped"),
        SloRule("serving_degraded",
                "ratio(inference_degraded_lookups_total,"
                " inference_requests_total)",
                ">", 0.05, window_sec=120.0,
                description="more than 5% of predicts served with "
                            "zero-vector embedding fallback"),
        SloRule("lookup_p99_slow", "p99(lookup_rpc_time_cost_sec)",
                ">", 1.0, window_sec=120.0,
                description="worker-observed PS lookup p99 above 1s"),
        SloRule("trace_ring_overrun", "rate(tracing_spans_dropped_total)",
                ">", 100.0, window_sec=60.0, severity="ticket",
                description="trace ring evicting >100 spans/s — "
                            "captures are incomplete"),
        # workload-telemetry objectives (both evaluate to no-data until
        # the staleness/freshness series exist, so unarmed fleets never
        # page on them)
        SloRule("gradient_staleness_high",
                "p99(ps_gradient_staleness_steps)",
                ">", 256.0, window_sec=120.0, severity="ticket",
                description="PS-observed gradient staleness p99 above "
                            "256 update steps — async updates are "
                            "applying far behind their lookups"),
        # sec_since_last_apply, not last_delay_sec: the delay gauge is
        # only written when a packet APPLIES, so it freezes at its last
        # healthy value during an actual stall — the since-apply clock
        # keeps rising on every scan, which is what stall detection
        # needs
        SloRule("serving_freshness_stale",
                "inc_update_sec_since_last_apply",
                ">", 600.0, window_sec=60.0,
                description="no incremental packet applied for over "
                            "10 minutes — the train->serve sync loop "
                            "is stalled"),
        # tier-ladder health: the device cache's whole value is hits
        # never paying the PS cycle; a collapsed hit rate means every
        # step silently degrades to flat-PS speed. ratio() is 0 while
        # the probes counter does not move, so uncached trainers never
        # page on this.
        # arena health: the slab arena never returns memory — evicted
        # slots are reused, not freed — so slab bytes parked in free
        # lists instead of live rows are invisible resident waste. A
        # sustained majority-free arena means the workload shrank far
        # below the allocated high-water mark (shrink the table, or
        # restart the replica to compact). No-data until a ps_arena_*
        # gauge exists, so legacy-holder fleets never page on this.
        SloRule("arena_fragmentation_runaway",
                "ps_arena_fragmentation_ratio",
                ">", 0.5, window_sec=120.0, for_sec=60.0,
                severity="ticket",
                description="over half the embedding arena's allocated "
                            "row slots are eviction-churned free space "
                            "for 2+ minutes — slab memory is parked "
                            "idle; shrink capacity or restart to "
                            "compact"),
        # elastic-tier objectives (no-data until a reshard controller
        # exports its gauges, so static fleets never page on them)
        SloRule("reshard_stuck", "reshard_active", ">", 0.0,
                window_sec=120.0, for_sec=600.0,
                description="a slot migration has been in flight for "
                            "over 10 minutes — the copy/replay loop is "
                            "stuck (donor wedged, capture set not "
                            "settling, or the controller died "
                            "mid-freeze); check /fleet/routing for the "
                            "frozen donor"),
        SloRule("reshard_frozen_slot_stuck", "ps_frozen_slot_age_sec",
                ">", 120.0, window_sec=60.0, for_sec=60.0,
                description="a donor PS has held write-frozen slots for "
                            "over 2 minutes — its reshard controller "
                            "died post-freeze (the controller-side "
                            "reshard_stuck gauge cannot see this) or "
                            "the cutover wedged; the freeze lease "
                            "(PERSIA_RESHARD_FREEZE_LEASE_SEC) will "
                            "auto-thaw the donor, then resume() the "
                            "migration from its journal or abort it "
                            "(docs/DEPLOY.md runbook)"),
        SloRule("reshard_replay_runaway",
                "rate(reshard_replayed_rows_total)", ">", 100000.0,
                window_sec=120.0, severity="ticket",
                description="capture replay moving >100k rows/s for "
                            "minutes — write traffic into the moving "
                            "slots outruns the drain; shrink the move "
                            "batch or reshard off-peak"),
        # online-learning loop objectives (both no-data until a serving
        # delta subscriber exports its series, so TTL-only fleets never
        # page on them). The stall clock itself is covered by
        # serving_freshness_stale above: the subscriber exports the
        # SAME inc_update_sec_since_last_apply name, so that rule now
        # fires per serving replica too.
        SloRule("serving_sign_to_servable_slow",
                "p99(serving_sign_to_servable_lag_sec)",
                ">", 60.0, window_sec=300.0, severity="ticket",
                description="online-learning freshness p99 above 60s — "
                            "trained rows are taking over a minute to "
                            "become servable (scan interval too slow, "
                            "governor throttling hard, or the dumper's "
                            "flush cadence collapsed)"),
        # per-VARIANT isolation: by_label fans the judgement out per
        # model variant, so one broken canary fires alone instead of
        # averaging into the healthy default's traffic
        SloRule("variant_degraded",
                "ratio(inference_variant_degraded_total,"
                " inference_variant_requests_total)",
                ">", 0.05, window_sec=120.0, by_label="variant",
                description="more than 5% of ONE model variant's "
                            "predicts served zero-vector embedding "
                            "fallback — judged per variant, so an A/B "
                            "arm degrading alone still pages"),
        SloRule("device_cache_hit_collapse",
                "ratio(device_cache_misses_total,"
                " device_cache_probes_total)",
                ">", 0.5, window_sec=120.0, for_sec=60.0,
                severity="ticket",
                description="device-cache hit rate below 50% over 2 "
                            "minutes — the HBM tier is thrashing (hot "
                            "set outgrew capacity, or cold traffic is "
                            "flooding admission); training pays the "
                            "PS cycle on most rows"),
    ]


class _Window:
    """Per-service scrape history: a deque of ``(t, series)`` snapshots
    where ``series`` maps ``(name, labels_tuple) -> value``."""

    def __init__(self):
        self.snaps: "deque[Tuple[float, Dict]]" = deque()
        self.up = True

    def add(self, t: float, series: Dict, keep_sec: float):
        self.snaps.append((t, series))
        while self.snaps and self.snaps[0][0] < t - keep_sec:
            self.snaps.popleft()


# immutable view handed to expression evaluation (the scrape thread
# keeps appending to the live deques; evaluation reads a frozen copy)
_Frozen = namedtuple("_Frozen", ["snaps", "up"])


class SloEngine:
    """Continuous evaluation of :class:`SloRule` objectives over
    per-service scrape snapshots.

    Thread-safe: the fleet scrape loop calls :meth:`ingest` /
    :meth:`mark_down` per target, anyone may call :meth:`evaluate` /
    :meth:`alerts`. Breach events (0->1 firing transitions) land in
    ``breaches`` (bounded ring) and fire ``on_breach(alert_dict)``.
    """

    MAX_BREACHES = 256

    def __init__(self, rules: Optional[List[SloRule]] = None,
                 on_breach: Optional[Callable[[Dict], None]] = None):
        self.rules = list(rules) if rules is not None else default_rules()
        self.on_breach = on_breach
        self._lock = threading.Lock()
        self._windows: Dict[str, _Window] = {}
        # (rule name, service) -> {"pending_since", "firing_since"}
        self._state: Dict[Tuple[str, str], Dict] = {}
        self.breaches: "deque[Dict]" = deque(maxlen=self.MAX_BREACHES)
        self._keep_sec = max([r.window_sec for r in self.rules] + [60.0])

    def add_rules(self, rules: List[SloRule]):
        """Install additional rules at runtime, idempotent by name —
        the autopilot contributes its policy rules to an already-
        running engine. The retention window re-widens to cover the
        largest new window."""
        with self._lock:
            have = {r.name for r in self.rules}
            for r in rules:
                if r.name not in have:
                    self.rules.append(r)
                    have.add(r.name)
            self._keep_sec = max([r.window_sec for r in self.rules]
                                 + [60.0])

    # --- ingestion -------------------------------------------------------

    def ingest(self, service: str, samples, t: Optional[float] = None):
        """Feed one scrape's parsed samples (``metrics.parse_exposition``
        output, or any iterable of (name, labels, value))."""
        t = time.monotonic() if t is None else t
        series: Dict = {}
        for name, labels, value in samples:
            key = (name, tuple(sorted(labels.items())))
            # duplicate series within one scrape (multiple servers in
            # one process): sum — one exposition, one sample per key
            series[key] = series.get(key, 0.0) + value
        with self._lock:
            w = self._windows.setdefault(service, _Window())
            w.up = True
            w.add(t, series, self._keep_sec)

    def mark_down(self, service: str, t: Optional[float] = None):
        """A scrape failed: the service contributes ``up == 0`` and its
        stale series stop advancing (rates decay to 0 naturally)."""
        with self._lock:
            w = self._windows.setdefault(service, _Window())
            w.up = False

    def forget(self, service: str):
        # by_label judgement state is keyed "service[label=value]" —
        # forgetting a service must drop those too, or a re-registered
        # service inherits a drained variant's firing_since and never
        # fires a fresh breach
        with self._lock:
            self._windows.pop(service, None)
            for key in [k for k in self._state
                        if k[1] == service
                        or k[1].startswith(service + "[")]:
                self._state.pop(key, None)

    # --- expression evaluation -------------------------------------------

    @staticmethod
    def _latest(w: _Window, name: str) -> Optional[float]:
        if not w.snaps:
            return None
        _, series = w.snaps[-1]
        vals = [v for (n, _l), v in series.items() if n == name]
        return sum(vals) if vals else None

    @staticmethod
    def _series_increase(w: _Window, name: str, window_sec: float,
                         now: float):
        """Per-series (increase, dt) over the window, counter-reset
        aware. Returns dict keyed by labels_tuple.

        Each series' first in-window value is looked up for ``name``'s
        series alone, and the scan stops once every one was found; the
        JAX engine records every series of every retained snapshot, a
        cost that grows with the retention (the widest rule's window) and
        that a monitor living in a trainer's process pays a round."""
        if not w.snaps:
            return {}
        t_last, last = w.snaps[-1]
        keys = [k for k in last if k[0] == name]
        first: Dict = {}
        pending = set(keys)
        for t, series in w.snaps:
            if not pending:
                break
            if t < now - window_sec:
                continue
            for key in [k for k in pending if k in series]:
                first[key] = (series[key], t)
                pending.discard(key)
        out = {}
        for key in keys:
            v_last = last[key]
            v_first, t_first = first.get(key, (v_last, t_last))
            inc = v_last - v_first
            if inc < 0:  # counter reset mid-window (service restart)
                inc = v_last
            out[key[1]] = (inc, max(t_last - t_first, 0.0))
        return out

    def _increase(self, w: _Window, name: str, window_sec: float,
                  now: float) -> Optional[float]:
        per = self._series_increase(w, name, window_sec, now)
        if not per:
            return None
        return sum(inc for inc, _ in per.values())

    def _rate(self, w: _Window, name: str, window_sec: float,
              now: float) -> Optional[float]:
        per = self._series_increase(w, name, window_sec, now)
        vals = [inc / dt for inc, dt in per.values() if dt > 0]
        if not vals:
            return None
        return sum(vals)

    def _quantile(self, w: _Window, name: str, q: float,
                  window_sec: float, now: float) -> Optional[float]:
        """Histogram quantile over the window's bucket increases; falls
        back to the cumulative buckets when the window saw no traffic
        start (fresh window)."""
        per = self._series_increase(w, name + "_bucket", window_sec, now)
        buckets: Dict[float, float] = {}
        for lbl, (inc, _dt) in per.items():
            le = dict(lbl).get("le")
            if le is None:
                continue
            bound = float("inf") if le == "+Inf" else float(le)
            buckets[bound] = buckets.get(bound, 0.0) + inc
        if not buckets or all(v <= 0 for v in buckets.values()):
            return None
        bounds = sorted(buckets)
        total = buckets[bounds[-1]]  # +Inf cumulative == count
        if total <= 0:
            return None
        rank = q * total
        lo = 0.0
        prev_cum = 0.0
        for b in bounds:
            cum = buckets[b]
            if cum >= rank:
                if b == float("inf"):
                    return lo  # pessimistic finite answer
                width = cum - prev_cum
                frac = ((rank - prev_cum) / width) if width > 0 else 1.0
                return lo + (b - lo) * min(max(frac, 0.0), 1.0)
            prev_cum = cum
            lo = b if b != float("inf") else lo
        return bounds[-2] if len(bounds) > 1 else 0.0

    @staticmethod
    def _points(w: _Window, name: str, window_sec: float,
                now: float) -> List[Tuple[float, float]]:
        """Per-snapshot summed values of ``name`` inside the window —
        the time series sustained()/trend() aggregate over."""
        pts: List[Tuple[float, float]] = []
        for t, series in w.snaps:
            if t < now - window_sec:
                continue
            vals = [v for (n, _l), v in series.items() if n == name]
            if vals:
                pts.append((t, sum(vals)))
        return pts

    def _sustained(self, w: _Window, name: str, window_sec: float,
                   now: float, op: str = ">") -> Optional[float]:
        """The comparison's conservative extremum of the per-scrape
        summed values over the window: min under >/>= ("never dipped
        below"), max under </<= ("never rose above") — either way the
        rule only fires when every in-window scrape breaches. Answers
        None until the window holds >=80% of its span — a freshly
        started monitor (or a freshly appeared series) must not
        declare load "sustained" off its first two scrapes. 80% rather
        than 100% because retention prunes to exactly the largest rule
        window, so strict coverage could never be met."""
        pts = self._points(w, name, window_sec, now)
        if not pts or now - pts[0][0] < window_sec * 0.8:
            return None
        ys = [v for _, v in pts]
        return max(ys) if op in ("<", "<=") else min(ys)

    def _trend(self, w: _Window, name: str, window_sec: float,
               now: float) -> Optional[float]:
        """Least-squares slope (units/sec) of the per-scrape summed
        values over the window; None until two points exist."""
        pts = self._points(w, name, window_sec, now)
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return None
        n = len(pts)
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [v for _, v in pts]
        mx = sum(xs) / n
        my = sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        if den <= 0:
            return None
        num = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        return num / den

    def _eval_expr(self, rule: SloRule, w: _Window,
                   now: float) -> Optional[float]:
        if rule.arg1 == "up" and rule.fn is None:
            return 1.0 if w.up else 0.0
        if rule.fn is None:
            return self._latest(w, rule.arg1)
        if rule.fn == "rate":
            return self._rate(w, rule.arg1, rule.window_sec, now)
        if rule.fn == "increase":
            return self._increase(w, rule.arg1, rule.window_sec, now)
        if rule.fn == "sustained":
            return self._sustained(w, rule.arg1, rule.window_sec, now,
                                   op=rule.op)
        if rule.fn == "trend":
            return self._trend(w, rule.arg1, rule.window_sec, now)
        if rule.fn == "ratio":
            num = self._increase(w, rule.arg1, rule.window_sec, now)
            den = self._increase(w, rule.arg2, rule.window_sec, now)
            if num is None and den is None:
                return None
            if not den:
                return 0.0
            return (num or 0.0) / den
        q = {"p50": 0.50, "p90": 0.90, "p95": 0.95, "p99": 0.99}[rule.fn]
        return self._quantile(w, rule.arg1, q, rule.window_sec, now)

    # --- per-label evaluation (by_label rules) ---------------------------

    @staticmethod
    def _label_values(w, rule: SloRule) -> set:
        """Values of ``rule.by_label`` present on the rule's own series
        in the latest snapshot (restricting to the rule's metric names
        keeps an unrelated metric that happens to carry the label from
        minting phantom groups)."""
        if not w.snaps:
            return set()
        names = {rule.arg1, rule.arg1 + "_bucket"}
        if rule.arg2:
            names.add(rule.arg2)
        _, series = w.snaps[-1]
        out = set()
        for (name, lbl) in series:
            if name in names:
                val = dict(lbl).get(rule.by_label)
                if val is not None:
                    out.add(val)
        return out

    @staticmethod
    def _filter_label(w, label: str, value: str):
        """A window view holding only series whose ``label`` equals
        ``value`` — what a by_label rule evaluates per group."""
        snaps = [(t, {k: v for k, v in series.items()
                      if dict(k[1]).get(label) == value})
                 for t, series in w.snaps]
        return _Frozen(snaps, w.up)

    # --- evaluation ------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """Evaluate every rule against the current windows; returns the
        full alert list (firing and healthy) and records/announces new
        breaches."""
        now = time.monotonic() if now is None else now
        fired: List[Dict] = []
        with self._lock:
            windows = {s: _Frozen(list(w.snaps), w.up)
                       for s, w in self._windows.items()}
        alerts: List[Dict] = []
        # tuple(): add_rules may append concurrently mid-evaluation
        for rule in tuple(self.rules):
            matched = {s: w for s, w in windows.items()
                       if rule.matches(s)}
            if rule.scope == "fleet":
                vals = [self._eval_expr(rule, w, now)
                        for w in matched.values()]
                vals = [v for v in vals if v is not None]
                value = sum(vals) if vals else None
                alerts.append(self._judge(rule, "fleet", value, now,
                                          fired))
            elif rule.by_label is not None:
                # per-label-value isolation: one judgement per value of
                # the label (e.g. per model variant), keyed
                # service[label=value] so alert/breach state never
                # blends across values — a healthy default cannot mask
                # (or be masked by) a broken canary
                judged = set()
                for service in sorted(matched):
                    w = matched[service]
                    for val in sorted(self._label_values(w, rule)):
                        skey = f"{service}[{rule.by_label}={val}]"
                        judged.add((rule.name, skey))
                        value = self._eval_expr(
                            rule, self._filter_label(w, rule.by_label,
                                                     val), now)
                        alerts.append(self._judge(
                            rule, skey, value, now, fired))
                # label-value churn: a value absent from its service's
                # latest snapshot (variant drained/removed) must not
                # park pending/firing state — a re-registered variant
                # that is STILL breaching gets a fresh breach event
                # instead of silently inheriting firing_since (which
                # would suppress the postmortem capture)
                with self._lock:
                    for k in [k for k in self._state
                              if k[0] == rule.name and "[" in k[1]
                              and k not in judged]:
                        self._state.pop(k, None)
            else:
                for service in sorted(matched):
                    value = self._eval_expr(rule, matched[service], now)
                    alerts.append(self._judge(rule, service, value, now,
                                              fired))
        for alert in fired:
            self.breaches.append(alert)
            _logger.warning("SLO breach: %s on %s — %s %s %s (value %s)",
                            alert["rule"], alert["service"], alert["expr"],
                            alert["op"], alert["threshold"],
                            alert["value"])
            if self.on_breach is not None:
                try:
                    self.on_breach(alert)
                except Exception:
                    _logger.exception("on_breach callback failed")
        return alerts

    def _judge(self, rule: SloRule, service: str, value: Optional[float],
               now: float, fired: List[Dict]) -> Dict:
        key = (rule.name, service)
        breaching = value is not None and _OPS[rule.op](value,
                                                        rule.threshold)
        with self._lock:
            st = self._state.setdefault(
                key, {"pending_since": None, "firing_since": None})
            if breaching:
                if st["pending_since"] is None:
                    st["pending_since"] = now
                held = now - st["pending_since"]
                if held >= rule.for_sec and st["firing_since"] is None:
                    st["firing_since"] = now
                    new_breach = True
                else:
                    new_breach = False
            else:
                st["pending_since"] = None
                st["firing_since"] = None
                new_breach = False
            firing = st["firing_since"] is not None
            firing_since = st["firing_since"]
        alert = {
            "rule": rule.name, "service": service,
            "expr": rule.expr, "op": rule.op,
            "threshold": rule.threshold,
            "value": value, "firing": firing,
            "firing_since": firing_since, "t": now,
            "severity": rule.severity,
            "description": rule.description,
        }
        if new_breach:
            fired.append(dict(alert))
        return alert

    def alerts(self, firing_only: bool = False) -> List[Dict]:
        out = self.evaluate()
        if firing_only:
            out = [a for a in out if a["firing"]]
        return out

    def breach_events(self) -> List[Dict]:
        with self._lock:
            return list(self.breaches)

    def exit_code(self) -> int:
        """CI gate: nonzero iff any rule is currently firing."""
        return 1 if any(a["firing"] for a in self.evaluate()) else 0
