"""Cross-tier tracing, the step profiler and the stall watchdog
(``persia_tpu/tracing.py``).

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

:class:`StepProfiler` is a ``torch.profiler`` window keyed to trainer
steps (``TrainCtx(profiler=)``, or the ``PERSIA_PROFILE_*`` knobs through
:func:`profiler_from_env`): its Chrome trace holds the card's kernels
beside the host's ``trainer/train_step`` ranges of exactly those steps.
The pipeline beats :func:`heartbeat` and counts its work in flight
(:func:`work_started` / :func:`work_finished`);
:func:`start_deadlock_detection` (``PERSIA_DEADLOCK_DETECTION=1``) arms a
watchdog thread that dumps every thread's stack when work is in flight
and no beat came for an interval. :class:`StageTimer` times a block into
a registry histogram.

This module imports no torch at import time (the service children load
it without torch); the profiler imports it when a window opens.
"""

import contextlib
import json
import logging
import os
import struct
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional, Tuple

from persia_tpu_torch import knobs
from persia_tpu_torch.metrics import default_registry

_logger = logging.getLogger(__name__)

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


# --- the step profiler --------------------------------------------------------


class StepProfiler:
    """Opt-in ``torch.profiler`` window keyed to trainer step indices.

    ``on_step(i)`` is called at each step boundary, before step ``i``
    runs: the capture starts at the first ``i >= start_step`` and stops
    at the boundary ``num_steps`` steps later, so the trace holds exactly
    those steps; ``close()`` stops an open capture (the context's exit)
    and does nothing after its first call. The activities are the CPU,
    and CUDA once :meth:`bind_device` was given a CUDA device
    (``TrainCtx`` binds its own). The Chrome trace is written under
    ``logdir`` (``trace_path``). While the window is open,
    :meth:`step_scope` marks each step as a ``trainer/train_step`` range
    on the host timeline. A start or stop that fails logs a warning and
    never stops training. Environment: :func:`profiler_from_env`."""

    def __init__(self, logdir: str, start_step: int = 10,
                 num_steps: int = 5):
        self.logdir = logdir
        self.start_step = int(start_step)
        self.num_steps = max(1, int(num_steps))
        self.active = False
        self.trace_path: Optional[str] = None
        self._done = False
        self._cuda = False
        self._prof = None
        self._first = self._stop_at = 0

    def bind_device(self, device):
        """Trace the card's activity too when ``device`` is a CUDA
        device (a ``torch.device`` or its name)."""
        kind = getattr(device, "type", None) or str(device).split(":")[0]
        self._cuda = kind == "cuda"

    def on_step(self, step_idx: int):
        if self._done:
            return
        if not self.active and step_idx >= self.start_step:
            try:
                from torch import profiler as tp

                acts = [tp.ProfilerActivity.CPU]
                if self._cuda:
                    acts.append(tp.ProfilerActivity.CUDA)
                prof = tp.profile(activities=acts)
                prof.start()
            except Exception as e:  # profiling must never kill training
                _logger.warning("torch.profiler start failed: %s", e)
                self._done = True
                return
            self._prof, self.active = prof, True
            self._first, self._stop_at = step_idx, step_idx + self.num_steps
            _logger.info("step profiler started at step %d -> %s",
                         step_idx, self.logdir)
        elif self.active and step_idx >= self._stop_at:
            self.close()

    def step_scope(self):
        """A ``trainer/train_step`` range while the window is open, else
        a no-op context."""
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("trainer/train_step")

    def close(self):
        if not self.active:
            return
        self.active = False
        self._done = True
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            path = os.path.join(
                self.logdir, f"trace_{os.getpid()}_step{self._first}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
            _logger.info("step profiler stopped -> %s", path)
        except Exception as e:
            _logger.warning("torch.profiler stop failed: %s", e)


def profiler_from_env() -> Optional[StepProfiler]:
    """A StepProfiler from the ``PERSIA_PROFILE_*`` knobs, or None when
    ``PERSIA_PROFILE_DIR`` is unset or empty."""
    logdir = knobs.get("PERSIA_PROFILE_DIR")
    if not logdir:
        return None
    return StepProfiler(
        logdir,
        start_step=knobs.get("PERSIA_PROFILE_START_STEP"),
        num_steps=knobs.get("PERSIA_PROFILE_NUM_STEPS"),
    )


# --- the stall watchdog -------------------------------------------------------

_beat = 0
_inflight = 0
_lock = threading.Lock()
_watchdog: Optional["_Watchdog"] = None


def heartbeat():
    global _beat
    _beat += 1  # a lost increment is still a change: progress


def work_started():
    global _inflight
    with _lock:
        _inflight += 1


def work_finished():
    global _inflight
    with _lock:
        _inflight -= 1


def dump_all_stacks(out=None):
    """Every thread's stack, each headed by the thread's name, to ``out``
    (default stderr)."""
    out = sys.stderr if out is None else out
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    print("==== persia_tpu_torch thread dump ====", file=out)
    for tid, frame in frames.items():
        print(f"--- thread {names.get(tid, tid)} ---", file=out)
        traceback.print_stack(frame, file=out)
    out.flush()


class _Watchdog(threading.Thread):
    """Every ``interval_sec``: work in flight and no heartbeat since the
    last look logs an error and dumps every stack to stderr."""

    def __init__(self, interval_sec: float):
        super().__init__(daemon=True, name="deadlock-watchdog")
        self.interval_sec = float(interval_sec)
        self.dumps = 0
        self._halt = threading.Event()

    def run(self):
        last = _beat
        while not self._halt.wait(self.interval_sec):
            if _inflight > 0 and _beat == last:
                _logger.error(
                    "no pipeline progress for %.1fs with %d items in flight "
                    "- dumping stacks", self.interval_sec, _inflight)
                dump_all_stacks()
                self.dumps += 1
            last = _beat

    def stop(self):
        self._halt.set()


def start_deadlock_detection(interval_sec: float = 30.0
                             ) -> Optional[_Watchdog]:
    """Start the stall watchdog; a no-op returning None unless
    ``PERSIA_DEADLOCK_DETECTION`` is set. A process runs one watchdog:
    while it lives, a later call returns it unchanged (the JAX package
    starts one a call, so one an engine). ``stop()`` ends it."""
    global _watchdog
    if not knobs.get("PERSIA_DEADLOCK_DETECTION"):
        return None
    with _lock:
        if _watchdog is None or not _watchdog.is_alive():
            _watchdog = _Watchdog(interval_sec)
            _watchdog.start()
        return _watchdog


class StageTimer:
    """A context that times its block into the registry histogram
    ``name`` (``forward_client_time_cost_sec``,
    ``backward_client_time_cost_sec``, ...)."""

    def __init__(self, name: str):
        self.hist = default_registry().histogram(name)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self._t0)
        return False
