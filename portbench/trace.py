"""The traced window: ``torch.profiler`` (CUPTI) over a run of steps, read
back from its Chrome trace.

Only the device's activity is traced (kernels, copies, fills, and the CUDA
runtime calls that launch them): tracing every host operator as well
costs the host several microseconds an operator, which in a cell the
host nearly keeps up with shows as idle device time that an untraced run
does not have. The window is the host's time from the first launch to
the end of the synchronize after the last, on the host's clock. Busy time
is the union of the device's kernels, copies and fills over the window
(a copy of ``chip_smoke.py``'s ``trace_summary`` union); idle gaps are
the stretches between them, each put down to what the host was doing when
it began: the CUDA runtime call under way then, or the Python between
calls.
"""

import bisect
import json
import os
import re
import tempfile
import time
from collections import Counter
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
WARM = 4  # steps under the profiler before its window


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    name = re.sub(r"\(.*", "", name)  # the argument list
    return name[:120]


def profile(step: Callable[[], None], warm: int, steps: int) -> dict:
    """Run ``warm`` steps under the profiler with tracing on but kept out
    (CUPTI's first launches of each kernel cost extra), then ``steps``
    traced ones ending in a synchronize, and return :func:`summarize` of
    their trace."""
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import schedule

    traces = []
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=warm, active=steps,
                                    repeat=1),
                  on_trace_ready=traces.append) as prof:
        for _ in range(warm):
            step()
            prof.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for _ in range(steps):
            prof.step()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        traces[0].export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, wall)


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float
           ) -> List[Tuple[float, float]]:
    """The merged intervals, clipped to [lo, hi]."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: List[dict], wall_s: float) -> dict:
    """``window_s`` (from the first launch, over ``wall_s`` of the host's
    clock or to the last device operation's end if later), ``busy_s``,
    ``kernels``
    ({short name: (seconds, launches)} of every device operation),
    ``device_ops`` and ``idle_gaps`` (the ``TOP`` largest, as [name,
    seconds])."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in complete if e.get("cat") in DEVICE_CATS]
    host = [e for e in complete if e.get("cat") in HOST_CATS]
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    tids = Counter(e.get("tid") for e in host)
    main = tids.most_common(1)[0][0] if tids else None
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in host if e.get("tid") == main)
    lo = min([float(e["ts"]) for e in dev] + [h[0] for h in host])
    hi = max(lo + wall_s * 1e6,
             max(float(e["ts"]) + float(e["dur"]) for e in dev))
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev], lo, hi)
    kernels: Dict[str, List[float]] = {}
    for e in dev:
        k = kernels.setdefault(short_name(e["name"]), [0.0, 0])
        k[0] += float(e["dur"]) / 1e6
        k[1] += 1
    starts = [h[0] for h in host]
    gaps = Counter()
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in sorted(zip(edges[0::2], edges[1::2]),
                       key=lambda g: g[0] - g[1])[:500]:
        if b > a:
            gaps[_doing(host, starts, a)] += (b - a) / 1e6
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": {k: (v[0], v[1]) for k, v in kernels.items()},
        "device_ops": [[k, v[0]] for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1][0])[:TOP]],
        "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)],
    }


def _doing(host, starts, t: float) -> str:
    """The CUDA runtime call under way on the host at time ``t`` (the one
    that began last among those still running), else the Python between
    calls."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 64), -1):
        a, b, name = host[j]
        if b >= t:
            return f"host: {name}"
    return "host: Python between CUDA calls"


def seconds_of(kernels: Dict[str, Tuple[float, int]], pattern: str
               ) -> Tuple[float, int]:
    """Device seconds and launches of the operations whose name matches
    ``pattern`` (a regular expression)."""
    rx = re.compile(pattern)
    hits = [v for k, v in kernels.items() if rx.search(k)]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)
