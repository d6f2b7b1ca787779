"""The fleet control plane (``persia_tpu/fleet.py``): the central scrape
loop, the federated views, the SLO wiring and the crash-postmortem flight
recorder.

:class:`FleetMonitor` knows the live topology (from the coordinator, where
every service publishes its sidecar when it registers, from
``PERSIA_FLEET_TARGETS``'s ``name=host:port`` pairs, or from a list),
scrapes every sidecar's ``/metrics`` and ``/healthz`` concurrently, feeds
the :class:`~persia_tpu_torch.slos.SloEngine` and the
:class:`FleetHistory` ring, and serves (:class:`FleetHttpServer`):

- ``/fleet/metrics``: every up target's exposition in one document, each
  series labeled ``service`` / ``replica``, ``# TYPE`` / ``# HELP`` once a
  family, then ``fleet_target_up``, the scrape ages and the monitor's own
  series;
- ``/fleet/status``: each target's role, addresses, up / ready, version,
  uptime and scrape age, with ``version_skew``, ``simd_skew`` and the
  trainer group's version and mesh skews;
- ``/fleet/trace[?trace_id=]``: every up target's spans merged into one
  Chrome trace, cross-process parents resolved;
- ``/fleet/alerts``, ``/fleet/breaches``: the engine's judgement and its
  breach log;
- ``/fleet/history``: the ring's inventory, or one series' window
  aggregates and bounded excerpts;
- ``/fleet/routing``, ``/fleet/variants``, ``/fleet/hotness``: the routing
  epochs and frozen donors, the serving variants merged, and the merged
  hotness sketches with their capacity plan.

The monitor is pull-only: it reads the HTTP sidecars and puts no byte on
the RPC plane, so its presence changes nothing a service serves. Every
GET carries a socket timeout and a round has a deadline, so a dead, hung
or garbled sidecar marks only its own target down.

:class:`FlightRecorder` keeps the last ``/flight`` snapshots of each
service (fed by the monitor on its own cadence and by ``ServiceCtx``'s
supervisor); on a breach or a death it writes a postmortem bundle, the
JAX package's files:

- ``flight.json``: the snapshot as it was served;
- ``health.json``, ``faults.json``, ``env.json``: its parts;
- ``trace.json``: its spans as a Chrome trace, parents recorded in a
  process outside the capture promoted to roots (``remote_parent`` tag);
- ``reason.json``: the service, the reason, when and whose snapshot;
- ``metrics.prom``: the last exposition.

The monitor reports the port's ``__version__`` (``0.4.0``; the JAX
package's is ``0.1.0``), so a fleet of port processes shows no
``version_skew`` and a fleet that mixes sidecars of both packages does:
they run different step functions.

Run: ``python -m persia_tpu_torch.fleet --coordinator 127.0.0.1:23333
--port 9090 [--slo-rules rules.yml] [--postmortem-dir DIR] [--check N]``
"""

import argparse
import itertools
import json
import logging
import os
import re
import threading
import time
import urllib.request
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from persia_tpu_torch import __version__, knobs, tracing
from persia_tpu_torch.metrics import MetricsRegistry, parse_exposition
from persia_tpu_torch.service_discovery import get_fleet_targets
from persia_tpu_torch.slos import SloEngine, load_rules

_logger = logging.getLogger(__name__)


def _http_get(url: str, timeout: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


class ScrapeTarget:
    """One sidecar under watch, with its last-known observable state."""

    def __init__(self, service: str, http_addr: str, role: str = "static",
                 replica: int = 0, rpc_addr: Optional[str] = None):
        self.service = service
        self.http_addr = http_addr
        self.role = role
        self.replica = replica
        self.rpc_addr = rpc_addr
        self.up = False
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None
        self.last_scrape_t: Optional[float] = None  # monotonic, success
        self.last_attempt_t: Optional[float] = None
        self.last_health: Dict = {}
        self.last_samples: List = []
        self.last_families: Dict = {}
        self.last_flight_t: Optional[float] = None

    def status_doc(self, now: float) -> Dict:
        h = self.last_health
        return {
            "service": self.service,
            "role": self.role,
            "replica": self.replica,
            "rpc_addr": self.rpc_addr or h.get("rpc_addr"),
            "http_addr": self.http_addr,
            "up": self.up,
            "ready": h.get("ready"),
            "version": h.get("version"),
            "uptime_sec": h.get("uptime_sec"),
            "pid": h.get("pid"),
            "health_status": h.get("status"),
            # tier-ladder observables (PS replicas only; None elsewhere):
            # which rung rows occupy and how the write-back/update
            # version stream is advancing
            "update_version": h.get("update_version"),
            "spill": h.get("spill"),
            # elastic-tier observables: the replica's published routing
            # epoch and, mid-migration, its donor capture/freeze state
            "routing_epoch": h.get("routing_epoch"),
            "reshard": h.get("reshard"),
            # kernel-path + dispatch observables (PS replicas): which
            # SIMD path the native store selected and how requests are
            # parallelized — fleet_status cross-checks these so one
            # replica silently running scalar kernels is flagged
            "simd": h.get("simd"),
            "dispatch": h.get("dispatch"),
            # multi-process trainer observables (trainer rows only;
            # None elsewhere): which group member this row is, the
            # group size, and the jax mesh shape it rendezvoused —
            # fleet_status cross-checks mesh/version agreement across
            # the group (trainer_*_skew)
            "process_index": h.get("process_index"),
            "process_count": h.get("process_count"),
            "mesh_shape": h.get("mesh_shape"),
            "last_scrape_age_sec": (
                round(now - self.last_scrape_t, 3)
                if self.last_scrape_t is not None else None),
            "last_attempt_age_sec": (
                round(now - self.last_attempt_t, 3)
                if self.last_attempt_t is not None else None),
            "consecutive_failures": self.consecutive_failures,
            "last_error": self.last_error,
        }


class FlightRecorder:
    """A bounded ring of ``/flight`` snapshots a service and the bundle
    writer. ``observe`` is fed by whoever polls the sidecars (the
    ``ServiceCtx`` supervisor); ``capture`` turns the last snapshot into
    a postmortem directory under ``out_dir``."""

    def __init__(self, out_dir: str, per_service: int = 4):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._rings: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self.captures: List[str] = []
        self._per_service = per_service

    def observe(self, service: str, flight_doc: Dict):
        with self._lock:
            ring = self._rings.setdefault(
                service, deque(maxlen=self._per_service))
            ring.append(flight_doc)

    def last(self, service: str) -> Optional[Dict]:
        with self._lock:
            ring = self._rings.get(service)
            return ring[-1] if ring else None

    def capture(self, service: str, reason: str,
                extra: Optional[Dict] = None) -> Optional[str]:
        """Write a postmortem bundle from the last observed snapshot of
        ``service``; returns its directory, or None when the service was
        never observed (no bundle rather than an empty one)."""
        doc = self.last(service)
        if doc is None:
            _logger.warning("no flight snapshot for %s: no postmortem "
                            "bundle (%s)", service, reason)
            return None
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", service)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        path = os.path.join(
            self.out_dir, f"postmortem_{safe}_{stamp}_{next(self._seq)}")
        os.makedirs(path, exist_ok=True)
        spans = tracing.promote_remote_parents(
            tracing.as_span_dicts(doc.get("spans", [])))
        trace_doc = tracing.chrome_trace(spans)
        trace_doc["otherData"] = {
            "spans_dropped_total": doc.get("spans_dropped_total", 0),
            "service": service,
            "reason": reason,
        }
        manifest = {
            "service": service,
            "reason": reason,
            "captured_at": time.time(),
            "observed_at": doc.get("t_wall"),
            "version": doc.get("version"),
            "pid": doc.get("pid"),
            "extra": extra or {},
        }
        for name, payload in (
                ("flight.json", doc),
                ("health.json", doc.get("health", {})),
                ("trace.json", trace_doc),
                ("faults.json", doc.get("faults", [])),
                ("env.json", doc.get("env", {})),
                ("reason.json", manifest)):
            with open(os.path.join(path, name), "w") as f:
                json.dump(payload, f, indent=1)
        with open(os.path.join(path, "metrics.prom"), "w") as f:
            f.write(doc.get("metrics", ""))
        with self._lock:
            self.captures.append(path)
        _logger.warning("postmortem bundle for %s (%s) -> %s", service,
                        reason, path)
        return path


class FleetHistory:
    """Bounded in-memory ring over every scraped metric: per-series
    ``(t, value)`` points with time-window retention
    (``PERSIA_FLEET_HISTORY_SEC``) and a per-series point cap
    (``PERSIA_FLEET_HISTORY_POINTS``). Series are keyed
    ``(service, metric, labels)``; duplicate series within one scrape
    sum, same as the SLO engine's ingestion.

    This is the substrate instantaneous scrapes cannot provide:
    ``avg/min/max/rate_over(window)`` for capacity questions,
    per-service ``breakdown`` for imbalance questions, and bounded
    ``excerpt`` slices for autopilot decision evidence and
    ``GET /fleet/history``. Pull-only by construction — it only ever
    observes what the scrape loop already fetched."""

    def __init__(self, keep_sec: Optional[float] = None,
                 max_points: Optional[int] = None):
        self.keep_sec = float(keep_sec if keep_sec is not None
                              else knobs.get("PERSIA_FLEET_HISTORY_SEC"))
        self.max_points = int(max_points if max_points is not None
                              else knobs.get(
                                  "PERSIA_FLEET_HISTORY_POINTS"))
        self._lock = threading.Lock()
        # (service, metric, labels_tuple) -> deque[(t, value)]
        self._series: Dict[tuple, deque] = {}

    def record(self, service: str, samples, t: Optional[float] = None):
        """Feed one scrape's parsed samples (``parse_exposition``
        output, or any iterable of ``(name, labels, value)``)."""
        t = time.monotonic() if t is None else t
        acc: Dict[tuple, float] = {}
        for name, labels, value in samples:
            key = (service, name, tuple(sorted(labels.items())))
            acc[key] = acc.get(key, 0.0) + value
        horizon = t - self.keep_sec
        with self._lock:
            for key, v in acc.items():
                dq = self._series.setdefault(
                    key, deque(maxlen=self.max_points))
                dq.append((t, v))
                while dq and dq[0][0] < horizon:
                    dq.popleft()

    def record_up(self, service: str, up: bool,
                  t: Optional[float] = None):
        """The synthetic liveness series, recorded every round whether
        the scrape succeeded or not (a down target still moves its
        history)."""
        self.record(service, [("up", {}, 1.0 if up else 0.0)], t=t)

    # --- queries ---------------------------------------------------------

    def _windowed(self, metric: str, window_sec: float,
                  service: Optional[str] = None,
                  now: Optional[float] = None) -> Dict[tuple, list]:
        """``{(service, labels): [(t, v), ...]}`` restricted to the
        window; ``service`` is a regex (same contract as SloRule)."""
        now = time.monotonic() if now is None else now
        svc_re = re.compile(service) if service else None
        out: Dict[tuple, list] = {}
        with self._lock:
            for (svc, name, lbl), dq in self._series.items():
                if name != metric:
                    continue
                if svc_re is not None and not svc_re.search(svc):
                    continue
                pts = [(t, v) for t, v in dq if t >= now - window_sec]
                if pts:
                    out[(svc, lbl)] = pts
        return out

    @staticmethod
    def _series_rate(pts) -> float:
        """Counter-reset-aware per-second rate over one series' window
        points (a restart counts from zero, not negative)."""
        if len(pts) < 2:
            return 0.0
        inc = 0.0
        for (_, prev), (_, cur) in zip(pts, pts[1:]):
            inc += cur - prev if cur >= prev else cur
        dt = pts[-1][0] - pts[0][0]
        return inc / dt if dt > 0 else 0.0

    def _agg(self, metric: str, window_sec: float, fn: str,
             service: Optional[str] = None,
             now: Optional[float] = None) -> Optional[float]:
        per = self._windowed(metric, window_sec, service, now)
        if not per:
            return None
        vals = []
        for pts in per.values():
            ys = [v for _, v in pts]
            if fn == "avg":
                vals.append(sum(ys) / len(ys))
            elif fn == "min":
                vals.append(min(ys))
            elif fn == "max":
                vals.append(max(ys))
            elif fn == "rate":
                vals.append(self._series_rate(pts))
        # summed across series: the same aggregation the SLO engine
        # applies, so history answers and rule answers agree
        return sum(vals)

    def avg_over(self, metric, window_sec, service=None, now=None):
        return self._agg(metric, window_sec, "avg", service, now)

    def min_over(self, metric, window_sec, service=None, now=None):
        return self._agg(metric, window_sec, "min", service, now)

    def max_over(self, metric, window_sec, service=None, now=None):
        return self._agg(metric, window_sec, "max", service, now)

    def rate_over(self, metric, window_sec, service=None, now=None):
        return self._agg(metric, window_sec, "rate", service, now)

    def breakdown(self, metric: str, window_sec: float,
                  agg: str = "avg", service: Optional[str] = None,
                  now: Optional[float] = None) -> Dict[str, float]:
        """Per-service decomposition of an aggregate — the imbalance
        view ('which replica carries the load'). Returns
        ``{service: value}`` with each service's series summed."""
        per = self._windowed(metric, window_sec, service, now)
        out: Dict[str, float] = {}
        for (svc, _lbl), pts in per.items():
            ys = [v for _, v in pts]
            if agg == "avg":
                v = sum(ys) / len(ys)
            elif agg == "min":
                v = min(ys)
            elif agg == "max":
                v = max(ys)
            elif agg == "rate":
                v = self._series_rate(pts)
            else:
                raise ValueError(f"bad agg {agg!r}")
            out[svc] = out.get(svc, 0.0) + v
        return out

    def excerpt(self, metric: Optional[str] = None,
                window_sec: float = 60.0,
                service: Optional[str] = None,
                points: int = 32,
                now: Optional[float] = None) -> List[Dict]:
        """Bounded raw slices for evidence bundles and the HTTP view:
        one entry per matching series, each with at most ``points``
        stride-downsampled points (newest kept exactly)."""
        now = time.monotonic() if now is None else now
        if metric is None:
            with self._lock:
                names = sorted({k[1] for k in self._series})
            return [{"metric": n} for n in names]
        per = self._windowed(metric, window_sec, service, now)
        out = []
        for (svc, lbl) in sorted(per):
            pts = per[(svc, lbl)]
            if len(pts) > points:
                stride = len(pts) / points
                pts = [pts[min(int(i * stride), len(pts) - 1)]
                       for i in range(points - 1)] + [pts[-1]]
            out.append({
                "service": svc, "metric": metric, "labels": dict(lbl),
                "points": [[round(now - t, 3), v] for t, v in pts],
            })
        return out

    def stats(self) -> Dict:
        with self._lock:
            return {"n_series": len(self._series),
                    "n_points": sum(len(d)
                                    for d in self._series.values()),
                    "keep_sec": self.keep_sec,
                    "max_points_per_series": self.max_points}


class FleetMonitor:
    """The scrape loop + federation + SLO wiring.

    Targets come from an explicit list, a static spec, and/or a
    coordinator (rediscovered periodically, so restarted replicas with
    new ports are picked up). ``start()`` runs the loop on a daemon
    thread; embedders (tests, the bench) may instead call
    :meth:`scrape_once` synchronously.
    """

    def __init__(self,
                 targets: Optional[List[Dict]] = None,
                 coordinator_addr: Optional[str] = None,
                 static_targets: Optional[str] = None,
                 scrape_interval: float = 5.0,
                 scrape_timeout: float = 2.0,
                 flight_interval: float = 10.0,
                 rediscover_interval: float = 10.0,
                 slo_engine: Optional[SloEngine] = None,
                 postmortem_dir: Optional[str] = None,
                 capture_on_breach: bool = True,
                 first_scrape_delay: float = 0.0):
        self.coordinator_addr = coordinator_addr
        self.static_targets = static_targets
        self.scrape_interval = float(scrape_interval)
        self.scrape_timeout = float(scrape_timeout)
        self.flight_interval = float(flight_interval)
        self.rediscover_interval = float(rediscover_interval)
        # 0 = scrape immediately on start (fast first picture); the
        # bench's paired A/B sets one interval so every measured block
        # carries exactly the configured scrape duty cycle
        self.first_scrape_delay = float(first_scrape_delay)
        self._targets: Dict[str, ScrapeTarget] = {}
        self._targets_lock = threading.Lock()
        self.recorder = (FlightRecorder(postmortem_dir)
                         if postmortem_dir else None)
        self.capture_on_breach = capture_on_breach and (
            self.recorder is not None)
        self.engine = slo_engine if slo_engine is not None else SloEngine()
        # chain, don't clobber: an embedder may have its own callback
        self._user_on_breach = self.engine.on_breach
        self.engine.on_breach = self._on_breach
        # fleet-own metrics live in a PRIVATE registry: embedding a
        # monitor in a bench/test process must not leak fleet series
        # into that process's service exposition
        self.registry = MetricsRegistry()
        self._m_rounds = self.registry.counter(
            "fleet_scrape_rounds_total",
            help_text="completed scrape rounds")
        self._m_failures = self.registry.counter(
            "fleet_scrape_failures_total",
            help_text="individual target scrape failures")
        self._m_breaches = self.registry.counter(
            "fleet_slo_breaches_total",
            help_text="SLO firing transitions observed")
        self._t_round = self.registry.histogram(
            "fleet_scrape_round_sec",
            help_text="wall time of one full scrape round — a wedged "
                      "or slow sidecar shows up here before it pages")
        # bounded per-series history over everything scraped: the
        # substrate for /fleet/history, autopilot evidence excerpts,
        # and hysteresis questions instantaneous scrapes cannot answer
        self.history = FleetHistory()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_discover = 0.0
        self._t0 = time.monotonic()
        self.rounds = 0
        if targets:
            self._merge_targets(targets)
        # discovery only runs for sources the CALLER named: a monitor
        # built with an explicit target list must not silently absorb
        # ambient PERSIA_FLEET_TARGETS / PERSIA_COORDINATOR_ADDR env
        # (the binary's main() resolves those env defaults explicitly)
        if self.coordinator_addr or self.static_targets:
            self.discover()

    # --- target management ----------------------------------------------

    def _merge_targets(self, dicts: List[Dict]):
        with self._targets_lock:
            for d in dicts:
                t = self._targets.get(d["service"])
                if t is None:
                    self._targets[d["service"]] = ScrapeTarget(
                        d["service"], d["http_addr"],
                        role=d.get("role", "static"),
                        replica=d.get("replica", 0),
                        rpc_addr=d.get("rpc_addr"))
                elif t.http_addr != d["http_addr"]:
                    # same service, new sidecar address: a restarted
                    # replica — repoint, reset the failure streak
                    t.http_addr = d["http_addr"]
                    t.rpc_addr = d.get("rpc_addr", t.rpc_addr)
                    t.consecutive_failures = 0

    def discover(self):
        """Refresh the target set from the coordinator/static spec.
        Discovery failures are non-fatal: the monitor keeps scraping
        what it already knows."""
        self._last_discover = time.monotonic()
        try:
            # empty strings (not None) pin get_fleet_targets to the
            # caller-named sources — no env-var fallback in the library
            found = get_fleet_targets(self.coordinator_addr or "",
                                      static=self.static_targets or "")
        except Exception as e:
            _logger.warning("fleet discovery failed: %s", e)
            return
        if found:
            self._merge_targets(found)

    def targets(self) -> List[ScrapeTarget]:
        with self._targets_lock:
            return sorted(self._targets.values(),
                          key=lambda t: t.service)

    def add_target(self, service: str, http_addr: str, **kw):
        self._merge_targets([{"service": service, "http_addr": http_addr,
                              **kw}])

    # --- scraping --------------------------------------------------------

    def _scrape_one(self, t: ScrapeTarget, fetch_flight: bool) -> Dict:
        base = f"http://{t.http_addr}"
        metrics_text = _http_get(
            f"{base}/metrics", self.scrape_timeout).decode()
        samples, families = parse_exposition(metrics_text)
        health = json.loads(_http_get(
            f"{base}/healthz", self.scrape_timeout).decode())
        out = {"samples": samples, "families": families, "health": health}
        if fetch_flight and self.recorder is not None:
            # a flight hiccup is not a liveness failure (same rule as
            # the PS supervisor): /flight is the heavy GET — spans ride
            # along — and a busy target whose snapshot runs past the
            # timeout must not read as DOWN while /metrics + /healthz
            # answered fine
            try:
                out["flight"] = json.loads(_http_get(
                    f"{base}/flight", self.scrape_timeout).decode())
            except Exception as e:
                _logger.debug("flight fetch of %s failed: %s",
                              t.service, e)
        return out

    def scrape_once(self) -> int:
        """One full round over every known target; returns the number of
        up targets. Per-target failures (timeout, connection refused,
        garbage output, death mid-scrape) mark that target down and
        never abort the round."""
        now = time.monotonic()
        if (self.coordinator_addr or self.static_targets) and (
                now - self._last_discover >= self.rediscover_interval):
            self.discover()
        targets = self.targets()
        # lazy pool init under the lock: scrape_once is public API, and
        # two overlapping first rounds (background loop + a caller-
        # driven round) racing the None check would each build a pool —
        # one of them orphaned with live worker threads, never shut down
        with self._targets_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=min(16, max(4, len(targets) or 1)),
                    thread_name_prefix="fleet-scrape")
        t_round0 = time.perf_counter()
        futs = {}
        for t in targets:
            fetch_flight = (
                self.recorder is not None
                and (t.last_flight_t is None
                     or now - t.last_flight_t >= self.flight_interval))
            t.last_attempt_t = now
            futs[self._pool.submit(self._scrape_one, t, fetch_flight)] = (
                t, fetch_flight)
        # the socket timeout bounds each GET; this deadline is the
        # belt-and-braces backstop so a pathological target cannot hold
        # the ROUND open either
        done, not_done = wait(futs, timeout=self.scrape_timeout * 3 + 1)
        n_up = 0
        for fut, (t, _fetched) in futs.items():
            if fut in not_done or fut.exception() is not None:
                err = ("scrape deadline exceeded" if fut in not_done
                       else repr(fut.exception()))
                self._target_down(t, err)
                continue
            res = fut.result()
            t.up = True
            n_up += 1
            t.consecutive_failures = 0
            t.last_error = None
            t.last_scrape_t = time.monotonic()
            t.last_samples = res["samples"]
            t.last_families = res["families"]
            t.last_health = res["health"]
            if res.get("flight") is not None:
                t.last_flight_t = now
                self.recorder.observe(t.service, res["flight"])
            self.engine.ingest(t.service, res["samples"])
            self.history.record(t.service, res["samples"])
        # liveness moves every round for every target — a down target
        # still advances its history (the autopilot's "is it back" view)
        for t in targets:
            self.history.record_up(t.service, t.up)
        self.engine.evaluate()
        self._m_rounds.inc()
        # under the targets lock: scrape_once is public API — the
        # background loop and a caller-driven round (tests, the CLI
        # --check gate) may overlap, and an unguarded += here is the
        # lost-increment shape persialint's lock pass flags
        with self._targets_lock:
            self.rounds += 1
        self._t_round.observe(time.perf_counter() - t_round0)
        return n_up

    def _target_down(self, t: ScrapeTarget, err: str):
        t.up = False
        t.consecutive_failures += 1
        t.last_error = err
        self._m_failures.inc()
        self.engine.mark_down(t.service)
        _logger.warning("fleet: target %s (%s) down: %s",
                        t.service, t.http_addr, err)

    def _on_breach(self, alert: Dict):
        self._m_breaches.inc()
        if self.capture_on_breach and alert["service"] != "fleet":
            try:
                self.recorder.capture(alert["service"],
                                      f"slo:{alert['rule']}",
                                      extra=alert)
            except Exception:
                _logger.exception("breach postmortem capture failed")
        if self._user_on_breach is not None:
            self._user_on_breach(alert)

    # --- loop ------------------------------------------------------------

    def start(self) -> "FleetMonitor":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-monitor")
        self._thread.start()
        return self

    def _run(self):
        if self.first_scrape_delay and self._stop.wait(
                self.first_scrape_delay):
            return
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.scrape_once()
            except Exception:
                _logger.exception("fleet scrape round failed")
            elapsed = time.monotonic() - t0
            self._stop.wait(max(self.scrape_interval - elapsed, 0.05))

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        with self._targets_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)  # start() after stop(): fresh pool

    # --- federated views -------------------------------------------------

    def fleet_metrics(self) -> str:
        """One exposition document for the whole fleet: every up
        target's families (``# TYPE``/``# HELP`` deduped across
        services) with ``service``/``replica`` labels injected, then
        the monitor's own synthetic series."""
        from persia_tpu_torch.metrics import _fmt

        now = time.monotonic()
        lines: List[str] = []
        seen_families = set()
        for t in self.targets():
            if not t.up:
                continue
            extra = {"service": t.service, "replica": str(t.replica)}
            pending_family: Optional[str] = None
            for name, labels, value in t.last_samples:
                family = re.sub(r"_(bucket|sum|count)$", "", name)
                if family != pending_family:
                    pending_family = family
                    if family not in seen_families:
                        seen_families.add(family)
                        fam = (t.last_families.get(family)
                               or t.last_families.get(name) or {})
                        if fam.get("help"):
                            lines.append(
                                f"# HELP {family} {fam['help']}")
                        if fam.get("type"):
                            lines.append(
                                f"# TYPE {family} {fam['type']}")
                merged = {**labels, **extra}
                lines.append(f"{name}{_fmt(merged)} {value}")
        # synthetic per-target series
        lines.append("# TYPE fleet_target_up gauge")
        for t in self.targets():
            lbl = _fmt({"service": t.service, "replica": str(t.replica),
                        "role": t.role})
            lines.append(f"fleet_target_up{lbl} {1.0 if t.up else 0.0}")
        lines.append("# TYPE fleet_target_last_scrape_age_sec gauge")
        for t in self.targets():
            if t.last_scrape_t is None:
                continue
            lbl = _fmt({"service": t.service, "replica": str(t.replica)})
            lines.append(f"fleet_target_last_scrape_age_sec{lbl} "
                         f"{round(now - t.last_scrape_t, 3)}")
        own = self.registry.render()
        return "\n".join(lines) + "\n" + own

    def fleet_status(self) -> Dict:
        now = time.monotonic()
        targets = [t.status_doc(now) for t in self.targets()]
        versions = {t["version"] for t in targets if t["version"]}
        # kernel-path skew, same shape as version_skew: PS replicas
        # reporting different SIMD paths (one fell back to scalar —
        # env forced down, wrong .so, heterogeneous hosts) serve
        # bit-identical results but at silently different cost, which
        # capacity planning must see
        simd_paths = {t["simd"] for t in targets if t.get("simd")}
        # trainer-group skew, same shape as simd_skew: the rows of a
        # multi-process trainer group must agree on package version
        # (mixed rollout mid-job = divergent step functions) and mesh
        # shape (a member that rendezvoused a different mesh cannot be
        # in the same collective) — either is a co-scheduling bug the
        # fleet view must flag before the collectives deadlock
        trainers = [t for t in targets
                    if t.get("process_index") is not None]
        trainer_versions = {t["version"] for t in trainers
                            if t.get("version")}
        trainer_meshes = {t["mesh_shape"] for t in trainers
                          if t.get("mesh_shape")}
        return {
            "fleet_monitor": {
                "version": __version__,
                "pid": os.getpid(),
                "uptime_sec": round(now - self._t0, 3),
                "scrape_interval_sec": self.scrape_interval,
                "rounds": self.rounds,
            },
            "n_targets": len(targets),
            "n_up": sum(1 for t in targets if t["up"]),
            "version_skew": len(versions) > 1,
            "simd_skew": len(simd_paths) > 1,
            "simd_paths": sorted(simd_paths),
            "n_trainer_processes": len(trainers),
            "trainer_version_skew": len(trainer_versions) > 1,
            "trainer_mesh_skew": len(trainer_meshes) > 1,
            "trainer_mesh_shapes": sorted(trainer_meshes),
            "targets": targets,
        }

    def fleet_trace(self, trace_id: Optional[str] = None,
                    n: int = 8192, fmt: str = "chrome") -> Dict:
        """Live multi-process trace merge: pull ``/trace?format=raw``
        from every up target, merge, resolve cross-capture parentage.
        ``trace_id`` (hex) filters to one logical operation."""
        groups = []
        dropped = 0
        for t in self.targets():
            if not t.up:
                continue
            try:
                doc = json.loads(_http_get(
                    f"http://{t.http_addr}/trace?n={n}&format=raw",
                    self.scrape_timeout).decode())
            except Exception as e:
                _logger.warning("fleet trace scrape of %s failed: %s",
                                t.service, e)
                continue
            dropped += doc.get("dropped_total", 0) \
                if isinstance(doc, dict) else 0
            groups.append(doc)
        merged = tracing.merge_span_dicts(groups, trace_id=trace_id)
        merged = tracing.promote_remote_parents(merged)
        if fmt == "raw":
            return {"spans": merged, "dropped_total": dropped}
        doc = tracing.chrome_trace(merged)
        doc["otherData"] = {"spans_dropped_total": dropped,
                            "n_spans": len(merged)}
        return doc

    def fleet_hotness(self, hbm_bytes: Optional[int] = None,
                      num_replicas: Optional[int] = None,
                      measured_hit_rate: Optional[float] = None) -> Dict:
        """Cross-shard workload-hotness merge: pull every up target's
        ``/hotness?full=1`` snapshot (disabled/absent targets
        contribute nothing), merge them exactly — totals equal the sum
        of per-shard snapshots, Space-Saving counts add, count-min
        cells add, HLL registers max — then render per-table zipfian
        fits, coverage curves ("top p% of rows serve q% of lookups"),
        and, when an HBM budget is named, the frequency-admission
        capacity plan for the device-cache tier ladder. Pull-only like
        every other fleet view: zero requests on the RPC plane."""
        from persia_tpu_torch import hotness as _hotness

        snaps, scraped = self._hotness_snaps()
        merged = _hotness.merge_snapshots(snaps)
        report = _hotness.fleet_report(merged, hbm_bytes=hbm_bytes,
                                       num_replicas=num_replicas,
                                       measured_hit_rate=measured_hit_rate)
        report["sources"] = scraped
        return report

    def _hotness_snaps(self):
        """Pull every up target's full hotness snapshot (disabled or
        absent targets contribute nothing)."""
        snaps = []
        scraped = []
        for t in self.targets():
            if not t.up:
                continue
            try:
                doc = json.loads(_http_get(
                    f"http://{t.http_addr}/hotness?full=1",
                    self.scrape_timeout).decode())
            except Exception as e:
                _logger.debug("fleet hotness scrape of %s failed: %s",
                              t.service, e)
                continue
            if doc.get("enabled"):
                snaps.append(doc)
                scraped.append({"service": t.service,
                                "total": int(doc.get("total", 0))})
        return snaps, scraped

    def hotness_plan(self, num_replicas: int,
                     num_slots: Optional[int] = None,
                     current_table=None) -> Dict:
        """Hotness-balanced placement plan against the LIVE merged
        sketches — what the autopilot's rebalance policy and the
        operator's reshard driver size moves from. ``current_table``
        pins slot count and enables moved-slot minimization; without
        it the plan assumes a fresh hash-even layout. Pull-only like
        every other fleet view."""
        from persia_tpu_torch import hotness as _hotness

        snaps, _ = self._hotness_snaps()
        merged = _hotness.merge_snapshots(snaps)
        return _hotness.placement_plan(merged, num_replicas,
                                       num_slots=num_slots,
                                       current_table=current_table)

    def fleet_history(self, metric: Optional[str] = None,
                      service: Optional[str] = None,
                      window_sec: float = 60.0,
                      points: int = 32) -> Dict:
        """The history ring's HTTP view: without ``metric``, the series
        inventory + ring stats; with one, bounded per-series excerpts
        plus the window aggregates (avg/min/max/rate + per-service
        breakdown) so operators and CI read the same numbers the
        autopilot decides on."""
        doc = {"stats": self.history.stats(), "window_sec": window_sec}
        if metric is None:
            doc["metrics"] = [e["metric"]
                              for e in self.history.excerpt()]
            return doc
        now = time.monotonic()
        doc.update({
            "metric": metric,
            "service": service,
            "avg": self.history.avg_over(metric, window_sec, service,
                                         now),
            "min": self.history.min_over(metric, window_sec, service,
                                         now),
            "max": self.history.max_over(metric, window_sec, service,
                                         now),
            "rate": self.history.rate_over(metric, window_sec, service,
                                           now),
            "breakdown": self.history.breakdown(metric, window_sec,
                                                "avg", service, now),
            "series": self.history.excerpt(metric, window_sec, service,
                                           points, now),
        })
        return doc

    def fleet_routing(self) -> Dict:
        """The elastic tier's control-plane view: every target's
        published routing epoch, the fleet-wide min/max (a skew means a
        cutover is mid-publish or a replica missed it), and any
        in-flight donor migration state — the operator's one-stop
        'is the reshard done / stuck' document."""
        now = time.monotonic()
        targets = []
        epochs = []
        migrating = []
        for t in self.targets():
            h = t.last_health or {}
            ep = h.get("routing_epoch")
            doc = {
                "service": t.service,
                "role": t.role,
                "up": t.up,
                "routing_epoch": ep,
                "reshard": h.get("reshard"),
                "last_scrape_age_sec": (
                    round(now - t.last_scrape_t, 3)
                    if t.last_scrape_t is not None else None),
            }
            targets.append(doc)
            if t.up and ep is not None:
                epochs.append(int(ep))
            if t.up and h.get("reshard"):
                # up-gated like the epoch aggregation: a donor that
                # died mid-migration keeps its stale health doc, and a
                # forever-"migrating" ghost would block the runbook's
                # no-concurrent-reshard precondition
                migrating.append(t.service)
        # donors whose moving slots are write-frozen, with the age the
        # reshard_frozen_slot_stuck rule alarms on — the operator's
        # shortlist when deciding between resume() and abort
        frozen_donors = [
            {"service": d["service"],
             "frozen_age_sec": d["reshard"].get("frozen_age_sec"),
             "pending_epoch": d["reshard"].get("pending_epoch"),
             "mig_id": d["reshard"].get("mig_id")}
            for d in targets
            if d["up"] and d["reshard"] and d["reshard"].get("frozen")
        ]
        return {
            "epoch_min": min(epochs) if epochs else None,
            "epoch_max": max(epochs) if epochs else None,
            "epoch_skew": bool(epochs) and min(epochs) != max(epochs),
            "migrating": migrating,
            "frozen_donors": frozen_donors,
            "targets": targets,
        }

    def fleet_variants(self) -> Dict:
        """The multi-variant serving tier's control-plane view: every
        serving replica's variant topology (ridden on its health doc),
        merged per variant name with fleet-wide request totals —
        plus skew detection: replicas disagreeing on a variant's
        weight, status, or the default marker means a variant_admin
        broadcast only half-landed (the operator's re-push signal,
        like /fleet/routing's epoch_skew)."""
        per_variant: Dict[str, Dict] = {}
        replicas = []
        for t in self.targets():
            h = t.last_health or {}
            variants = h.get("variants")
            if variants is None:
                continue
            replicas.append({"service": t.service, "up": t.up,
                             "variants": [v["name"] for v in variants],
                             "default": next(
                                 (v["name"] for v in variants
                                  if v.get("default")), None)})
            if not t.up:
                continue
            for v in variants:
                agg = per_variant.setdefault(v["name"], {
                    "name": v["name"], "replicas": 0, "requests": 0,
                    "degraded": 0, "weights": set(), "statuses": set(),
                    "default_on": 0})
                agg["replicas"] += 1
                agg["requests"] += int(v.get("requests", 0))
                agg["degraded"] += int(v.get("degraded", 0))
                agg["weights"].add(float(v.get("weight", 0.0)))
                agg["statuses"].add(v.get("status", "live"))
                agg["default_on"] += 1 if v.get("default") else 0
        out = []
        skew = False
        n_serving = sum(1 for r in replicas if r["up"])
        for name in sorted(per_variant):
            agg = per_variant[name]
            v_skew = (len(agg["weights"]) > 1
                      or len(agg["statuses"]) > 1
                      or agg["replicas"] != n_serving
                      or agg["default_on"] not in (0, agg["replicas"]))
            skew = skew or v_skew
            out.append({
                "name": name,
                "replicas": agg["replicas"],
                "requests": agg["requests"],
                "degraded": agg["degraded"],
                "weight": (sorted(agg["weights"])
                           if len(agg["weights"]) > 1
                           else next(iter(agg["weights"]))),
                "status": sorted(agg["statuses"]),
                "default": agg["default_on"] > 0,
                "skew": v_skew,
            })
        return {"variants": out, "skew": skew,
                "serving_replicas": replicas}

    def alerts(self, firing_only: bool = False) -> List[Dict]:
        return self.engine.alerts(firing_only=firing_only)

    # --- HTTP surface ----------------------------------------------------

    def serve_http(self, host: str = "127.0.0.1",
                   port: int = 0) -> "FleetHttpServer":
        return FleetHttpServer(self, host, port).start()


class FleetHttpServer:
    """HTTP front for one :class:`FleetMonitor` (same dependency-free
    http.server arrangement as the per-service sidecar)."""

    def __init__(self, monitor: FleetMonitor, host: str = "127.0.0.1",
                 port: int = 0):
        self.monitor = monitor
        mon = monitor

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: D102
                pass

            def do_GET(self):  # noqa: N802
                try:
                    url = urlparse(self.path)
                    q = parse_qs(url.query)
                    ctype = "application/json"
                    if url.path == "/fleet/metrics":
                        body = mon.fleet_metrics().encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    elif url.path == "/fleet/status":
                        body = json.dumps(mon.fleet_status()).encode()
                    elif url.path == "/fleet/trace":
                        body = json.dumps(mon.fleet_trace(
                            trace_id=q.get("trace_id", [None])[0],
                            n=int(q.get("n", ["8192"])[0]),
                            fmt=q.get("format", ["chrome"])[0],
                        )).encode()
                    elif url.path == "/fleet/alerts":
                        firing = q.get("firing", ["0"])[0] not in ("", "0")
                        body = json.dumps(
                            mon.alerts(firing_only=firing)).encode()
                    elif url.path == "/fleet/breaches":
                        body = json.dumps(
                            mon.engine.breach_events()).encode()
                    elif url.path == "/fleet/history":
                        # ?metric= names the series (omit for the
                        # inventory); ?service= regex-filters;
                        # ?window= seconds; ?points= per-series cap
                        body = json.dumps(mon.fleet_history(
                            metric=q.get("metric", [None])[0],
                            service=q.get("service", [None])[0],
                            window_sec=float(
                                q.get("window", ["60"])[0]),
                            points=int(q.get("points", ["32"])[0]),
                        )).encode()
                    elif url.path == "/fleet/routing":
                        body = json.dumps(mon.fleet_routing()).encode()
                    elif url.path == "/fleet/variants":
                        body = json.dumps(mon.fleet_variants()).encode()
                    elif url.path == "/fleet/hotness":
                        # ?hbm_gb= names the device-tier budget the
                        # capacity planner sizes against
                        # ?replicas= additionally renders the elastic
                        # tier's hotness-balanced placement plan
                        # ?measured_hit_rate= pairs an externally-
                        # measured device hit rate with the prediction
                        # (the planner emits the signed delta)
                        hbm_gb = q.get("hbm_gb", [None])[0]
                        replicas = q.get("replicas", [None])[0]
                        measured = q.get("measured_hit_rate", [None])[0]
                        body = json.dumps(mon.fleet_hotness(
                            hbm_bytes=(int(float(hbm_gb) * (1 << 30))
                                       if hbm_gb else None),
                            num_replicas=(int(replicas)
                                          if replicas else None),
                            measured_hit_rate=(float(measured)
                                               if measured else None),
                        )).encode()
                    elif url.path == "/healthz":
                        doc = mon.fleet_status()["fleet_monitor"]
                        doc.update({"status": "ok", "ready": True,
                                    "service": "fleet_monitor"})
                        body = json.dumps(doc).encode()
                    else:
                        self.send_error(404, "unknown path")
                        return
                except Exception as e:  # noqa: BLE001
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = f"{host}:{self._httpd.server_address[1]}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FleetHttpServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"fleet-http-{self.addr}")
        self._thread.start()
        return self

    def stop(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass


def main(argv=None):
    p = argparse.ArgumentParser(
        description="persia_tpu_torch fleet monitor: central scrape/SLO "
                    "engine + merged traces + postmortem recorder")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="/fleet/* HTTP port (0 = ephemeral)")
    p.add_argument("--addr-file", default=None,
                   help="write the bound address here after listen")
    p.add_argument("--coordinator",
                   default=knobs.get_raw("PERSIA_COORDINATOR_ADDR"),
                   help="coordinator for sidecar discovery")
    p.add_argument("--targets",
                   default=knobs.get_raw("PERSIA_FLEET_TARGETS"),
                   help="static name=host:port targets, comma separated")
    p.add_argument("--scrape-interval", type=float, default=5.0)
    p.add_argument("--scrape-timeout", type=float, default=2.0)
    p.add_argument("--flight-interval", type=float, default=10.0)
    p.add_argument("--slo-rules", default=None,
                   help="YAML rule file (default: built-in rules)")
    p.add_argument("--postmortem-dir",
                   default=knobs.get_raw("PERSIA_POSTMORTEM_DIR"),
                   help="where breach/crash bundles land (enables the "
                        "flight recorder)")
    p.add_argument("--check", type=int, default=0, metavar="ROUNDS",
                   help="CI gate mode: run ROUNDS scrape rounds "
                        "synchronously, print the alert table plus an "
                        "actionable FIRING summary (rule, label set, "
                        "value vs threshold), exit nonzero iff any SLO "
                        "is firing")
    p.add_argument("--json", action="store_true",
                   help="with --check: emit the full alert/breach "
                        "document as JSON instead of the table "
                        "(machine-readable CI logs)")
    args = p.parse_args(argv)
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO").upper())

    engine = SloEngine(load_rules(args.slo_rules)
                       if args.slo_rules else None)
    monitor = FleetMonitor(
        coordinator_addr=args.coordinator,
        static_targets=args.targets,
        scrape_interval=args.scrape_interval,
        scrape_timeout=args.scrape_timeout,
        flight_interval=args.flight_interval,
        slo_engine=engine,
        postmortem_dir=args.postmortem_dir,
    )
    if args.check:
        for _ in range(args.check):
            monitor.scrape_once()
            time.sleep(args.scrape_interval)
        alerts = monitor.alerts()
        firing = [a for a in alerts if a["firing"]]
        if args.json:
            print(json.dumps({
                "firing": firing,
                "alerts": alerts,
                "breaches": monitor.engine.breach_events(),
                "targets": [t.status_doc(time.monotonic())
                            for t in monitor.targets()],
            }, indent=1, default=str))
            raise SystemExit(1 if firing else 0)
        for a in alerts:
            state = "FIRING" if a["firing"] else "ok"
            print(f"{state:>6}  {a['rule']:<24} {a['service']:<12} "
                  f"{a['expr']} {a['op']} {a['threshold']} "
                  f"(value={a['value']})")
        # the actionable summary CI logs need: WHAT breached, on which
        # label set, and by how much — not just a nonzero exit
        if firing:
            print(f"\n{len(firing)} SLO rule(s) FIRING:")
            for a in firing:
                val = a["value"]
                val = f"{val:.6g}" if isinstance(val, float) else val
                since = a.get("firing_since")
                held = (f", firing for "
                        f"{time.monotonic() - since:.0f}s"
                        if since is not None else "")
                print(f"  {a['rule']} on {a['service']}: "
                      f"{a['expr']} = {val}, breaching "
                      f"{a['op']} {a['threshold']}{held}"
                      + (f" — {a['description']}"
                         if a.get("description") else ""))
        raise SystemExit(1 if firing else 0)
    http = monitor.serve_http(args.host, args.port)
    monitor.start()
    _logger.info("fleet monitor serving /fleet/* on %s (%d targets)",
                 http.addr, len(monitor.targets()))
    if args.addr_file:
        from persia_tpu_torch.utils import write_addr_file

        write_addr_file(http.addr, args.addr_file)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        monitor.stop()
        http.stop()


if __name__ == "__main__":
    main()
