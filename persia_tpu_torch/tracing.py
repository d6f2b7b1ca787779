"""Cross-tier tracing: spans (the span half of ``persia_tpu/tracing.py``).

One logical request spans several tiers (client <-> inference server <->
embedding worker), and aggregate histograms cannot tell which tier made
*this* request slow. A :class:`Span` carries ``(trace_id, span_id,
parent_id)``; the active span lives in a thread-local so nested ``with
span(...)`` blocks parent naturally; the context crosses process
boundaries through the RPC envelope (rpc.py negotiates the extra envelope
slot per connection, like ``__tags__``, so legacy peers never see it).
Finished spans land in a process-wide ring buffer
(:class:`TraceCollector`) that the HTTP sidecar
(:mod:`persia_tpu_torch.obs_http`) serves at ``/trace`` and
:func:`chrome_trace` exports as Chrome-trace/Perfetto JSON.

Tracing is OFF by default (``PERSIA_TRACING=1`` or :func:`enable_tracing`
turns it on): every ``span(...)`` call site then returns a shared no-op
context manager, and the RPC client never probes ``__trace__`` — the
disabled wire is byte-identical to the untraced one.

The step profiler, heartbeats, deadlock detection and stage timer of the
JAX module are not ported yet.
"""

import json
import os
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from persia_tpu_torch import knobs
from persia_tpu_torch.metrics import default_registry


# --- span context ---------------------------------------------------------

# frozen at import ON PURPOSE (registered import_time_safe): the
# disabled path must cost nothing, so the gate is a module constant
_enabled = knobs.get("PERSIA_TRACING")
_tls = threading.local()
# chrome-trace "pid" label; set_service_name() names this process's track
_service = [f"pid{os.getpid()}"]

# distinct sentinel: span(ctx=None) means "suppress unless propagated",
# while an OMITTED ctx falls back to the thread-local parent
_UNSET = object()


def tracing_enabled() -> bool:
    return _enabled


def enable_tracing(on: bool = True):
    """Flip span recording process-wide. Turn on BEFORE dialing RPC
    clients that should propagate context: the ``__trace__`` capability
    is negotiated per connection at dial time."""
    global _enabled
    _enabled = bool(on)


def set_service_name(name: str):
    """Name this process's track in exported traces (e.g. ``ps0``,
    ``worker1``, ``trainer``)."""
    _service[0] = name


def service_name() -> str:
    return _service[0]


def _rand64() -> int:
    # non-zero 63-bit id: fits signed int64 consumers and msgpack ints
    while True:
        (v,) = struct.unpack("<Q", os.urandom(8))
        v &= (1 << 63) - 1
        if v:
            return v


def current_context() -> Optional[Tuple[int, int]]:
    """(trace_id, span_id) of the active span on THIS thread, or None.
    This is what the RPC client injects into the envelope and what
    fan-out code captures before handing work to a pool thread."""
    if not _enabled:
        return None
    return getattr(_tls, "ctx", None)


class _NullSpan:
    """Shared no-op for disabled tracing — one attribute read + two
    no-op method calls per instrumented block."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def ctx(self):
        return None

    def tag(self, **kw):
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One timed region. ``__enter__`` installs it as the thread's
    active context (its children parent to it); ``__exit__`` restores
    the previous context and hands the finished span to the collector.

    Wall-clock start (``time.time_ns``) makes spans from different
    processes line up on one timeline; the duration is measured with
    the monotonic perf counter so it never jumps with clock slew."""

    __slots__ = ("name", "service", "trace_id", "span_id", "parent_id",
                 "start_ns", "dur_ns", "tags", "pid", "tid", "_prev",
                 "_t0")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: int, tags: Optional[Dict] = None,
                 service: Optional[str] = None):
        self.name = name
        self.service = service if service is not None else _service[0]
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.tags = tags
        self.pid = os.getpid()
        self.tid = threading.current_thread().name
        self.start_ns = 0
        self.dur_ns = 0

    @property
    def ctx(self) -> Tuple[int, int]:
        """Propagation handle: what children (local or remote) parent to."""
        return (self.trace_id, self.span_id)

    def tag(self, **kw):
        if self.tags is None:
            self.tags = {}
        self.tags.update(kw)
        return self

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = (self.trace_id, self.span_id)
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.dur_ns = time.perf_counter_ns() - self._t0
        _tls.ctx = self._prev
        if exc_type is not None:
            self.tag(error=f"{exc_type.__name__}: {exc_val}")
        _collector.add(self)
        return False

    def to_dict(self) -> Dict:
        """JSON-safe form (ids as hex strings: u64s do not survive
        JavaScript JSON consumers)."""
        return {
            "name": self.name,
            "service": self.service,
            "trace_id": f"{self.trace_id:016x}",
            "span_id": f"{self.span_id:016x}",
            "parent_id": f"{self.parent_id:016x}" if self.parent_id else None,
            "start_ns": self.start_ns,
            "dur_ns": self.dur_ns,
            "pid": self.pid,
            "tid": self.tid,
            "tags": self.tags,
        }


def span(name: str, ctx=_UNSET, root: bool = False, service: Optional[str] = None,
         **tags):
    """Open a span as a context manager.

    - default: child of the thread's active span; with no active span,
      starts a NEW trace (a fresh root).
    - ``ctx=(trace_id, parent_span_id)``: child of a PROPAGATED context
      (an RPC envelope, a captured fan-out parent). ``ctx=None``
      (explicitly) suppresses the span entirely — fan-out helpers pass
      whatever :func:`current_context` returned, so untraced requests
      stay untraced instead of spawning orphan roots.
    - ``root=True``: force a fresh trace id even under an active span
      (step boundaries).
    """
    if not _enabled:
        return _NULL_SPAN
    if ctx is None:
        return _NULL_SPAN
    if root or ctx is _UNSET:
        cur = None if root else getattr(_tls, "ctx", None)
        if cur is None:
            trace_id, parent = _rand64(), 0
        else:
            trace_id, parent = cur
    else:
        trace_id, parent = ctx
    return Span(name, trace_id, _rand64(), parent, tags or None,
                service=service)


# --- collector + export ---------------------------------------------------


class TraceCollector:
    """Bounded ring of finished spans, process-wide. Old spans fall off
    the back; ``/trace?n=K`` and the bench read the recent window.

    Eviction is COUNTED, not silent: ``dropped_total`` (mirrored to the
    ``tracing_spans_dropped_total`` registry counter) tells a consumer
    whether the window it scraped is complete — a merge that quietly
    lost spans reads as a pipeline that skipped work."""

    def __init__(self, capacity: int = 8192):
        self._dq: "deque[Span]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._dropped = 0
        self._drop_counter = default_registry().counter(
            "tracing_spans_dropped_total",
            help_text="spans evicted from the bounded trace ring before "
                      "any consumer read them")

    def add(self, s: Span):
        with self._lock:
            if (self._dq.maxlen is not None
                    and len(self._dq) == self._dq.maxlen):
                self._dropped += 1
                self._drop_counter.inc()
            self._dq.append(s)

    @property
    def dropped_total(self) -> int:
        return self._dropped

    def recent(self, n: Optional[int] = None) -> List[Span]:
        with self._lock:
            spans = list(self._dq)
        if n is not None and n < len(spans):
            spans = spans[-n:]
        return spans

    def clear(self):
        with self._lock:
            self._dq.clear()

    def __len__(self) -> int:
        return len(self._dq)


_collector = TraceCollector()


def default_collector() -> TraceCollector:
    return _collector


def chrome_trace(spans=None) -> Dict:
    """Spans (Span objects or ``to_dict()`` dicts — the raw form the
    sidecar serves, so multi-process merges need no re-parsing) ->
    Chrome-trace/Perfetto JSON object. Complete ``ph: X`` duration
    events on one wall-clock timeline; process tracks are named by
    service via metadata events."""
    if spans is None:
        spans = _collector.recent()
    events = []
    named_pids = {}
    for s in spans:
        d = s.to_dict() if isinstance(s, Span) else s
        if d["pid"] not in named_pids:
            named_pids[d["pid"]] = d["service"]
            events.append({
                "ph": "M", "name": "process_name", "pid": d["pid"],
                "tid": 0, "args": {"name": d["service"]},
            })
        args = {"trace_id": d["trace_id"], "span_id": d["span_id"],
                "parent_id": d["parent_id"]}
        if d.get("tags"):
            args.update({str(k): v for k, v in d["tags"].items()})
        events.append({
            "name": d["name"],
            "cat": d["service"],
            "ph": "X",
            "ts": d["start_ns"] / 1e3,   # microseconds
            "dur": d["dur_ns"] / 1e3,
            "pid": d["pid"],
            "tid": d["tid"],
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str, spans=None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans), f)
    return path


# --- multi-process merge (library form of the bench's trace scrape) -------


def as_span_dicts(spans) -> List[Dict]:
    """Normalize a span source to ``to_dict()`` form: Span objects, raw
    dicts, or a ``/trace?format=raw`` response body (either the legacy
    bare list or the ``{"spans": [...], "dropped_total": N}`` object)."""
    if isinstance(spans, dict):
        spans = spans.get("spans", [])
    return [s.to_dict() if isinstance(s, Span) else s for s in spans]


def merge_span_dicts(groups, trace_id: Optional[str] = None) -> List[Dict]:
    """Merge span captures from several processes (each element of
    ``groups`` is one process's spans in any :func:`as_span_dicts`-
    accepted form) into one flat list, optionally filtered to a single
    ``trace_id`` (hex string)."""
    merged: List[Dict] = []
    for g in groups:
        merged.extend(as_span_dicts(g))
    if trace_id is not None:
        merged = [s for s in merged if s["trace_id"] == trace_id]
    return merged


def promote_remote_parents(spans: List[Dict]) -> List[Dict]:
    """Resolve cross-process parentage for a PARTIAL capture: a span
    whose parent was recorded in a process that is not part of the
    capture (a crashed peer, a scrape that raced the ring) is promoted
    to a root, keeping the original parent id as a ``remote_parent``
    tag. The result always validates orphan-free — the contract the
    postmortem bundle's trace relies on."""
    have = {s["span_id"] for s in spans}
    out = []
    for s in spans:
        if s.get("parent_id") and s["parent_id"] not in have:
            s = dict(s)
            tags = dict(s.get("tags") or {})
            tags["remote_parent"] = s["parent_id"]
            s["tags"] = tags
            s["parent_id"] = None
        out.append(s)
    return out


def validate_span_dicts(spans: List[Dict]) -> Dict:
    """Structural validation of a merged capture: trace-id population,
    unresolvable parents, services and span names present. The bench
    acceptance checks (one trace_id, no orphan parents, every tier
    present) read this instead of re-deriving it."""
    by_id = {s["span_id"]: s for s in spans}
    orphans = [s["name"] for s in spans
               if s.get("parent_id") and s["parent_id"] not in by_id]
    return {
        "n_spans": len(spans),
        "trace_ids": sorted({s["trace_id"] for s in spans}),
        "orphans": orphans,
        "services": sorted({s["service"] for s in spans}),
        "names": sorted({s["name"] for s in spans}),
    }
