"""The program's spans on the device trace: which stage of a step each
device operation belongs to, each stage's device time without a sync, and
the host's dispatch time, from one ``torch.profiler`` window traced while
the program's tracing (``persia_tpu_torch.tracing``) was on.

The clock: a span starts at ``start_ns`` on ``time.time_ns()`` and ends at
``start_ns + dur_ns``; an event of the profiler's Chrome trace at ``ts``
µs lies at ``ts + baseTimeNanoseconds / 1e3`` µs on that clock, up to an
offset that :func:`profile` checks (:func:`calibrate`) by reading
``time.time_ns()`` around each of a few ``cudaDeviceSynchronize`` calls
of the idle device and finding those calls in the trace.

This module imports nothing of the program: the caller turns the
program's tracing on around :func:`profile` and hands its finished spans
to :func:`attribute` as ``Span.to_dict()`` dicts. A span's thread is its
``thread_ident`` (``pthread_self``); the trace names a CUDA API call's
thread by the same number cut to 32 bits (:func:`_tid`).
"""

import bisect
import json
import os
import statistics
import tempfile
import threading
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.trace import DEVICE_CATS, HOST_CATS, TOP, _union

NONE = "(none)"  # device time, or an idle gap, that no span holds
SYNC = "cudaDeviceSynchronize"
BRACKETS = 5  # synchronizes of the idle device read against time.time_ns()


def profile(step: Callable[[], None], warm: int, steps: int) -> dict:
    """``portbench.trace.profile``'s window (``warm`` profiled steps kept
    out, then ``steps`` traced ones ending in a synchronize), but with the
    device drained before the recording starts, so that every operation
    in the trace is a traced step's (there, the last warm step's tail runs
    in the window, launched before it); then :data:`BRACKETS`
    synchronizes of the idle device, each between two reads of
    ``time.time_ns()``. Returns ``events`` (the Chrome trace's),
    ``wall_s`` (the host's seconds over the steps), ``base_us`` (where the
    trace's ``ts`` 0 lies on the ``time.time_ns()`` clock, in µs) and
    ``clock_us`` / ``clock_err_us`` (:func:`calibrate`'s offset, already
    in ``base_us``, and its half-width)."""
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import schedule

    traces, brackets = [], []
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=warm, active=steps,
                                    repeat=1),
                  on_trace_ready=traces.append) as prof:
        for _ in range(warm):
            step()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for _ in range(BRACKETS):
            a = time.time_ns()
            torch.cuda.synchronize()
            brackets.append((a, time.time_ns()))
        for _ in range(steps):
            prof.step()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        traces[0].export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    events = doc["traceEvents"]
    base_us = float(doc.get("baseTimeNanoseconds", 0)) / 1e3
    clock_us, err_us = calibrate(events, base_us, brackets,
                                 threading.get_ident())
    return {"events": events, "wall_s": wall, "base_us": base_us + clock_us,
            "clock_us": clock_us, "clock_err_us": err_us}


def calibrate(events: List[dict], base_us: float,
              brackets: List[Tuple[int, int]], tid: int
              ) -> Tuple[float, float]:
    """The offset (µs) from ``ts + base_us`` to the ``time.time_ns()``
    clock, and its half-width. The bracketed calls ((before, after) in
    ns, in order) are the ``cudaDeviceSynchronize`` calls of the thread
    whose ident is ``tid`` that follow its first one after the window's
    last launch (that one closes the window; the profiler's own stop may
    synchronize after them). If every call lies inside its bracket as it
    stands, the offset is 0 and the half-width the tightest bracket's
    slack; otherwise the tightest bracket moves the call to its
    middle."""
    host = _complete(events, HOST_CATS)
    ops = {(e.get("args") or {}).get("correlation")
           for e in _complete(events, DEVICE_CATS)}
    last = max((float(e["ts"]) for e in host
                if (e.get("args") or {}).get("correlation") in ops),
               default=float("-inf"))
    syncs = sorted((float(e["ts"]), float(e["dur"])) for e in host
                   if e["name"] == SYNC and _tid(e.get("tid")) == _tid(tid)
                   and float(e["ts"]) >= last)
    if len(syncs) < 1 + len(brackets):
        raise RuntimeError("the trace lacks the bracketed synchronizes")
    pairs = list(zip(syncs[1:], brackets))
    slack = [((b - a) / 1e3 - dur) / 2 for (_, dur), (a, b) in pairs]
    k = min(range(len(pairs)), key=slack.__getitem__)
    if all(a / 1e3 <= ts + base_us and ts + dur + base_us <= b / 1e3
           for (ts, dur), (a, b) in pairs):
        return 0.0, max(slack[k], 0.0)
    (ts, dur), (a, b) = pairs[k]
    return (a + b) / 2e3 - (ts + dur / 2 + base_us), max(slack[k], 0.0)


class _Spans:
    """The spans on the trace's clock (µs), sorted by start (an enclosing
    span before what it encloses), with an index by thread."""

    def __init__(self, spans: List[dict], base_us: float):
        iv = []
        for s in spans:
            a = s["start_ns"] / 1e3 - base_us
            iv.append((a, a + s["dur_ns"] / 1e3, s))
        iv.sort(key=lambda x: (x[0], -x[1]))
        self.iv = iv
        self.reach = max((b - a for a, b, _ in iv), default=0.0)
        self.by_tid: Dict[int, List[int]] = defaultdict(list)
        for k, (_, _, s) in enumerate(iv):
            self.by_tid[_tid(s.get("thread_ident"))].append(k)
        self.starts = [a for a, _, _ in iv]
        self.tid_starts = {t: [iv[k][0] for k in ks]
                           for t, ks in self.by_tid.items()}

    def innermost(self, t: float, tid) -> Optional[int]:
        """The latest-starting span open at ``t`` on the thread the trace
        calls ``tid``, else on any thread; None if none is open."""
        tid = _tid(tid)
        ks = self.by_tid.get(tid)
        if ks:
            k = self._scan(ks, self.tid_starts[tid], t)
            if k is not None:
                return k
        return self._scan(range(len(self.iv)), self.starts, t)

    def _scan(self, ks, starts, t):
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            a, b, _ = self.iv[ks[j]]
            if a < t - self.reach:
                return None
            if b >= t:
                return ks[j]
        return None

    def holders(self, k: int) -> List[int]:
        """The spans whose interval holds span ``k``'s, ``k`` among them."""
        a, b, _ = self.iv[k]
        out = []
        for j in range(bisect.bisect_right(self.starts, a) - 1, -1, -1):
            aj, bj, _ = self.iv[j]
            if aj < a - self.reach:
                break
            if bj >= b:
                out.append(j)
        return out


def assign(events: List[dict], spans: List[dict], base_us: float
           ) -> List[Tuple[dict, Optional[dict]]]:
    """Each device operation of ``events`` beside the innermost span open
    when its launch ran: the host CUDA call (a :data:`HOST_CATS` event)
    with the same ``args.correlation``, looked up first among the spans
    of its own thread, then among those of any thread (autograd
    launches the backward from a thread of its own). None for
    an operation no span holds, or whose launch is not in the trace."""
    sp = _Spans(spans, base_us)
    return [(op, None if k is None else sp.iv[k][2])
            for op, k in _assigned(events, sp)]


def _tid(x):
    """A thread as the trace names it: the magnitude of the low 32 bits
    of its ident read as a signed integer (torch 2.11's CUDA activity
    on the H100: ident 140226837123840 is tid 449876736, a low half of
    3168794304 is tid 1126172992)."""
    if x is None:
        return None
    x = int(x) & 0xFFFFFFFF
    return (1 << 32) - x if x >= 1 << 31 else x


def _complete(events, cats):
    return [e for e in events
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in cats]


def _assigned(events, sp: _Spans):
    launch = {}
    for e in _complete(events, HOST_CATS):
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launch[corr] = (float(e["ts"]), e.get("tid"))
    out = []
    for op in _complete(events, DEVICE_CATS):
        at = launch.get((op.get("args") or {}).get("correlation"))
        out.append((op, None if at is None else sp.innermost(*at)))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _overlap(merged: List[Tuple[float, float]], starts: List[float],
             lo: float, hi: float) -> float:
    """The length of sorted, disjoint ``merged`` inside [lo, hi]."""
    total = 0.0
    for j in range(max(0, bisect.bisect_right(starts, lo) - 1), len(merged)):
        a, b = merged[j]
        if a >= hi:
            break
        total += max(0.0, min(b, hi) - max(a, lo))
    return total


def attribute(events: List[dict], spans: List[dict], wall_s: float,
              base_us: float) -> dict:
    """The window's device operations and idle gaps put down to spans.

    The window runs from its first device operation or host CUDA call
    over ``wall_s`` of the host's clock, or to its last operation's end
    if later (``portbench.trace.summarize``'s), and holds the spans that
    overlap it. Each operation goes to the innermost span open at its
    launch (:func:`assign`). A span holds its own operations and those
    of every span whose interval lies inside its own: a stage holds what
    its nested spans and, in the backward, autograd's thread launched
    while it was open. Returns:

    - ``spans``: {name: {``count``, ``span_s`` (the spans' durations
      summed), ``device_s`` (the union of the device intervals of the
      operations the spans of that name hold), ``host_dispatch_s``}};
    - ``none_s``: the union of the operations no span holds;
    - ``busy_s``, ``window_s``: as ``summarize`` computes them;
    - ``idle_by_span``: each idle gap put down to the innermost span of
      the operation that ends it (:data:`NONE` for the gap that closes
      the window), as [name, seconds], the ``TOP`` largest. When that
      operation's launch came after the gap began, the device waited on
      that span's host.

    ``host_dispatch_s`` of a span is its duration less the time inside
    it spent waiting in host CUDA calls, the union over the process's
    threads. A call waits for the part of its duration beyond
    the median duration of the window's calls of its name: a launch
    that found the queue full, a synchronize, an allocator call. What is
    left is the host's own time to dispatch the span's work."""
    dev = _complete(events, DEVICE_CATS)
    host = _complete(events, HOST_CATS)
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    lo = min(float(e["ts"]) for e in dev + host)
    hi = max(lo + wall_s * 1e6,
             max(float(e["ts"]) + float(e["dur"]) for e in dev))
    sp = _Spans([s for s in spans
                 if lo < s["start_ns"] / 1e3 - base_us + s["dur_ns"] / 1e3
                 and s["start_ns"] / 1e3 - base_us < hi], base_us)
    held: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    none: List[Tuple[float, float]] = []
    owner = {}  # an operation's start -> its innermost span's name
    holders = {}
    for op, k in _assigned(events, sp):
        a = float(op["ts"])
        iv = (a, a + float(op["dur"]))
        if k is None:
            none.append(iv)
            owner.setdefault(a, NONE)
            continue
        owner.setdefault(a, sp.iv[k][2]["name"])
        if k not in holders:
            holders[k] = {sp.iv[j][2]["name"] for j in sp.holders(k)}
        for name in holders[k]:
            held[name].append(iv)
    waits = _waits(host)
    wait_starts = [a for a, _ in waits]
    out: Dict[str, Dict[str, float]] = {}
    for a, b, s in sp.iv:
        e = out.setdefault(s["name"], {"count": 0, "span_s": 0.0,
                                       "device_s": 0.0,
                                       "host_dispatch_s": 0.0})
        e["count"] += 1
        e["span_s"] += (b - a) / 1e6
        e["host_dispatch_s"] += (b - a - _overlap(waits, wait_starts, a, b)
                                 ) / 1e6
    for name, ivs in held.items():
        out[name]["device_s"] = _length(_union(ivs, lo, hi)) / 1e6
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev], lo, hi)
    gaps = Counter()
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[owner.get(b, NONE) if b < hi else NONE] += (b - a) / 1e6
    return {
        "spans": out,
        "none_s": _length(_union(none, lo, hi)) / 1e6,
        "busy_s": _length(busy) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "idle_by_span": [[k, v] for k, v in gaps.most_common(TOP)],
    }


def _waits(host: List[dict]) -> List[Tuple[float, float]]:
    """The merged stretches in which a host CUDA call ran past the median
    duration of its name's calls."""
    durs = defaultdict(list)
    for e in host:
        durs[e["name"]].append(float(e["dur"]))
    med = {k: statistics.median(v) for k, v in durs.items()}
    ivs = []
    for e in host:
        a, d = float(e["ts"]), float(e["dur"])
        if d > med[e["name"]]:
            ivs.append((a + med[e["name"]], a + d))
    return _union(ivs, float("-inf"), float("inf"))
