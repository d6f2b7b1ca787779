"""The crash-postmortem flight recorder (the supervision half of
``persia_tpu/fleet.py``).

Every service's observability sidecar serves ``GET /flight``: one JSON
document with its health, metrics exposition, recent spans, armed fault
rules and environment. A supervisor polls it and keeps the last few
snapshots a service (:meth:`FlightRecorder.observe`); when the process
dies, :meth:`FlightRecorder.capture` turns the last one into a bundle
directory, the JAX package's files:

- ``flight.json``: the snapshot as it was served;
- ``health.json``, ``faults.json``, ``env.json``: its parts;
- ``trace.json``: its spans as a Chrome trace, parents recorded in a
  process outside the capture promoted to roots (``remote_parent`` tag);
- ``reason.json``: the service, the reason, when and whose snapshot;
- ``metrics.prom``: the last exposition.

The fleet monitor (``ScrapeTarget``, ``FleetHistory``, ``FleetMonitor``,
``FleetHttpServer``, the CLI) is not ported yet: ``ROADMAP.md`` queue A
item 9c.
"""

import itertools
import json
import logging
import os
import re
import threading
import time
import urllib.request
from collections import deque
from typing import Dict, List, Optional

from persia_tpu_torch import tracing

_logger = logging.getLogger(__name__)


def _http_get(url: str, timeout: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


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
