"""HTTP observability sidecar: /metrics, /healthz, /trace
(``persia_tpu/obs_http.py``).

A service process (in the port: the inference server) can start one of
these next to its RPC socket. It replaces the
push-gateway-only exposition (``MetricsRegistry.push_loop``) with a
standard Prometheus pull endpoint, adds a health probe that reports the
live internals a pager actually needs (queue depths, in-flight RPCs,
last-activity age), and exposes the tracing ring buffer so a stuck or
slow batch can be followed across tiers without restarting anything:

- ``GET /metrics``  — Prometheus text exposition (``registry.render()``)
- ``GET /healthz``  — JSON health document; merges the sidecar's own
  fields (service name, pid, uptime) with whatever the service's
  ``health_fn`` reports. Always HTTP 200 while the process can answer —
  liveness is the TCP accept; the *content* carries the judgement.
- ``GET /healthz?ready=1`` — READINESS variant: same document, but the
  status code follows the health doc's ``ready`` field — 503 when the
  service reports ``ready: false`` (a PS that is Loading/restoring, a
  worker whose PS tier is down). Liveness and readiness are different
  questions: a restarting replica is alive (do not kill it again) but
  not ready (do not route traffic to it) — supervisors probe the
  former, k8s readiness probes and load balancers the latter.
- ``GET /trace?n=K[&format=chrome|raw]`` — the most recent K spans from
  the process-local trace collector. ``chrome`` (default) is a
  Chrome-trace/Perfetto ``traceEvents`` JSON ready to load as-is;
  ``raw`` is ``{"spans": [...], "dropped_total": N}`` — the span-dict
  window the fleet monitor and ``bench.py --mode trace`` merge into one
  multi-process timeline, with the ring's eviction count so a consumer
  knows whether the window is complete.
- ``GET /flight`` — the flight-recorder snapshot: ONE JSON document
  bundling the health doc, the current metrics exposition, the recent
  span window, the armed fault rules, and the PERSIA_* environment.
  Supervisors poll it cheaply and keep the last copy, so when this
  process dies (SIGKILL keeps no last words) the postmortem bundle
  still has the final observable state.

Dependency-free (http.server), daemon-threaded, bound to an ephemeral
port by default so test stacks never collide.

Fault-injection site ``obs.http`` (:mod:`persia_tpu_torch.faults`, kwarg
``path=`` filters per endpoint): ``delay`` stalls a response (a hung
sidecar), ``drop`` swallows the request (reply never comes), ``corrupt``
returns garbage bytes, ``error`` answers 500 — the scrape-resilience
tests and the fleet bench arm these to prove a bad target cannot wedge
the scrape loop.
"""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from persia_tpu_torch import __version__, faults, hotness, knobs
from persia_tpu_torch.metrics import default_registry
from persia_tpu_torch.tracing import chrome_trace, default_collector, \
    service_name
from persia_tpu_torch.utils import write_addr_file


class ObservabilityServer:
    """Sidecar HTTP server for one service process.

    ``health_fn`` returns a JSON-serializable dict of live service
    internals; it is called per /healthz request, so keep it cheap and
    lock-light. ``registry`` defaults to the process-wide metrics
    registry, ``collector`` to the process-wide trace collector.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry=None, collector=None,
                 health_fn: Optional[Callable[[], Dict]] = None,
                 service: str = "persia",
                 refresh_fn: Optional[Callable[[], None]] = None,
                 hotness_fn: Optional[Callable[[], Dict]] = None,
                 variants_fn: Optional[Callable[[], list]] = None):
        if registry is None:
            registry = default_registry()
        if collector is None:
            collector = default_collector()
        self.registry = registry
        self.collector = collector
        self.health_fn = health_fn
        # called before each /metrics render: services sync pull-style
        # gauges (e.g. the PS resident-bytes-per-shard series) so a
        # scrape always sees current values without paying per-mutation
        # gauge updates on the data path
        self.refresh_fn = refresh_fn
        # returns the service's workload-hotness snapshot
        # (persia_tpu_torch.hotness format); None = this service has no
        # hotness source and /hotness answers the disabled marker
        self.hotness_fn = hotness_fn
        # returns the serving tier's variant topology (the
        # InferenceServer's per-variant doc list); None = not a
        # variant-serving process and GET /variants answers the
        # disabled marker
        self.variants_fn = variants_fn
        self.service = service
        self._t0 = time.monotonic()
        # meta-observability: the sidecar measures ITSELF, so a slow
        # /flight render or a wedged refresh_fn is visible in the same
        # exposition it serves (and in /fleet/metrics). Pre-built per
        # known path — unknown paths share "other" so a scanner cannot
        # mint unbounded label cardinality.
        self._t_request = {
            p: registry.histogram(
                "obs_http_request_sec", {"path": p},
                help_text="sidecar HTTP request wall time per endpoint")
            for p in ("/metrics", "/healthz", "/trace", "/flight",
                      "/hotness", "/variants", "other")}
        sidecar = self

        class Handler(BaseHTTPRequestHandler):
            # per-request stderr lines would swamp service logs
            def log_message(self, *a):  # noqa: D102
                pass

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                t_req0 = time.perf_counter()
                try:
                    self._handle_get()
                finally:
                    path = urlparse(self.path).path
                    hist = sidecar._t_request.get(
                        path, sidecar._t_request["other"])
                    hist.observe(time.perf_counter() - t_req0)

            def _handle_get(self):
                status = 200
                try:
                    url = urlparse(self.path)
                    if faults._active:
                        # chaos sites for scrape-resilience testing:
                        # delay = hung sidecar, drop = request swallowed
                        # (peer read times out), corrupt = garbage body,
                        # error -> 500 below, die = process exit
                        action = faults.fire("obs.http", path=url.path)
                        if action == "drop":
                            return  # no response; scraper must time out
                        if action == "corrupt":
                            body = b"\x00garbage not exposition\xff"
                            self.send_response(200)
                            self.send_header("Content-Length",
                                             str(len(body)))
                            self.end_headers()
                            self.wfile.write(body)
                            return
                    if url.path == "/metrics":
                        if sidecar.refresh_fn is not None:
                            try:
                                sidecar.refresh_fn()
                            except Exception:  # never fail a scrape
                                pass
                        body = sidecar.registry.render().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif url.path == "/healthz":
                        doc = sidecar._health()
                        body = json.dumps(doc).encode()
                        ctype = "application/json"
                        q = parse_qs(url.query)
                        if (q.get("ready", ["0"])[0] not in ("", "0")
                                and doc.get("ready") is False):
                            # readiness probe: alive but must not
                            # receive traffic (Loading/restoring/
                            # unarmed) — the 503 makes supervisors and
                            # k8s probes not route to it mid-recovery
                            status = 503
                    elif url.path == "/trace":
                        q = parse_qs(url.query)
                        n = int(q.get("n", ["256"])[0])
                        fmt = q.get("format", ["chrome"])[0]
                        body = sidecar._trace(n, fmt).encode()
                        ctype = "application/json"
                    elif url.path == "/flight":
                        body = json.dumps(sidecar._flight()).encode()
                        ctype = "application/json"
                    elif url.path == "/hotness":
                        q = parse_qs(url.query)
                        full = q.get("full", ["0"])[0] not in ("", "0")
                        body = json.dumps(
                            sidecar._hotness(full)).encode()
                        ctype = "application/json"
                    elif url.path == "/variants":
                        body = json.dumps(sidecar._variants()).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown path")
                        return
                except Exception as e:  # noqa: BLE001 — surfaced as 500
                    self.send_error(500, str(e))
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = f"{host}:{self._httpd.server_address[1]}"
        self._thread: Optional[threading.Thread] = None

    def _health(self) -> Dict:
        doc = {
            "status": "ok",
            "service": self.service,
            "pid": os.getpid(),
            # version lets the fleet topology view spot replica skew
            # (a half-finished rollout mixes versions silently otherwise)
            "version": __version__,
            "uptime_sec": round(time.monotonic() - self._t0, 3),
        }
        if self.health_fn is not None:
            try:
                doc.update(self.health_fn())
            except Exception as e:  # health must never 500 on a bad probe
                doc["status"] = "degraded"
                doc["health_fn_error"] = repr(e)
        return doc

    def _trace(self, n: int, fmt: str) -> str:
        spans = self.collector.recent(n)
        dropped = self.collector.dropped_total
        if fmt == "raw":
            return json.dumps({"spans": [s.to_dict() for s in spans],
                               "dropped_total": dropped})
        doc = chrome_trace(spans)
        doc["otherData"] = {"spans_dropped_total": dropped}
        return json.dumps(doc)

    def _hotness(self, full: bool) -> Dict:
        """``GET /hotness``: the workload-hotness view. Default is the
        human-sized summary (per-table totals, fitted zipf alpha,
        coverage curve, hottest rows); ``?full=1`` returns the raw
        mergeable snapshot (top-K + b64 count-min + HLL) the fleet
        monitor's /fleet/hotness cross-shard merge consumes. Sketches
        unarmed (or no hotness source) answers the disabled marker, so
        a scraper needs no negotiation."""
        snap = (self.hotness_fn() if self.hotness_fn is not None
                else hotness.disabled_snapshot())
        return snap if full else hotness.summary_view(snap)

    def _variants(self) -> Dict:
        """``GET /variants``: the serving replica's live variant
        topology (names, weights, default, status, per-variant request
        counts) — what the operator's promote/rollback runbook and the
        fleet monitor's /fleet/variants merge read. Non-serving
        processes answer the disabled marker, so a scraper needs no
        negotiation."""
        if self.variants_fn is None:
            return {"enabled": False, "variants": []}
        return {"enabled": True, "variants": self.variants_fn()}

    FLIGHT_SPANS = 2048
    _FLIGHT_ENV_PREFIXES = ("PERSIA_", "REPLICA_", "CUDA_", "TORCH_")

    def _flight(self) -> Dict:
        """Flight-recorder snapshot: everything a postmortem needs, in
        one GET (supervisors poll this; a crashed process cannot be
        asked afterwards). Refreshes pull-style gauges like /metrics
        does, so the captured exposition is current."""
        if self.refresh_fn is not None:
            try:
                self.refresh_fn()
            except Exception:
                pass
        return {
            "t_wall": time.time(),
            "service": self.service,
            "pid": os.getpid(),
            "version": __version__,
            "health": self._health(),
            "metrics": self.registry.render(),
            "spans": [s.to_dict()
                      for s in self.collector.recent(self.FLIGHT_SPANS)],
            "spans_dropped_total": self.collector.dropped_total,
            "faults": faults.default_injector().rules(),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith(self._FLIGHT_ENV_PREFIXES)},
        }

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"obs-http-{self.addr}")
        self._thread.start()
        return self

    def stop(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass


def maybe_start(host: str, http_port: Optional[int], health_fn,
                service: Optional[str] = None, refresh_fn=None,
                hotness_fn=None, variants_fn=None):
    """The one sidecar-construction convention every service shares:
    ``None`` keeps the sidecar off (in-process test instances), any port
    number starts one (0 = ephemeral). Returns the started server or
    None."""
    if http_port is None:
        return None
    if service is None:
        service = service_name()
    return ObservabilityServer(host, http_port, health_fn=health_fn,
                               service=service,
                               refresh_fn=refresh_fn,
                               hotness_fn=hotness_fn,
                               variants_fn=variants_fn).start()


def add_http_args(parser):
    """Shared --http-port / --http-addr-file argparse wiring for the
    service binaries (one place owns the 0/-1 convention and the
    PERSIA_HTTP_PORT default)."""
    parser.add_argument(
        "--http-port", type=int,
        default=knobs.get("PERSIA_HTTP_PORT"),
        help="observability sidecar port (/metrics /healthz /trace); "
             "0 = ephemeral, -1 = disabled")
    parser.add_argument(
        "--http-addr-file", default=None,
        help="write the sidecar's bound address here (port handoff for "
             "scrapers/benches, like --addr-file)")


def port_from_args(args) -> Optional[int]:
    """argparse value -> maybe_start port (the -1 = disabled rule)."""
    return None if args.http_port < 0 else args.http_port


def write_addr_file_from_args(sidecar, args):
    if args.http_addr_file and sidecar is not None:
        write_addr_file(sidecar.addr, args.http_addr_file)
