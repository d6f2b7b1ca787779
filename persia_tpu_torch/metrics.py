"""Metrics: counters/gauges/histograms with Prometheus text exposition
(``persia_tpu/metrics.py``).

A dependency-free registry with the surface of the reference's metrics
manager. ``push_loop`` PUTs the text exposition to a
Prometheus push gateway (PERSIA_METRICS_GATEWAY_ADDR) at a fixed
interval; scrapers pull ``render()`` through the HTTP sidecar
(:mod:`persia_tpu_torch.obs_http` serves it at ``/metrics``) or call it
in-process.
"""

import bisect
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from persia_tpu_torch import knobs

_logger = logging.getLogger(__name__)


class Counter:
    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, by: float = 1.0):
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Settable AND incrementable: queue-depth gauges are bumped from
    many threads (pipeline feeders, RPC handler pools), and an unlocked
    read-modify-write there loses counts — so ``add``/``dec`` take the
    lock. ``set`` locks too, so a concurrent ``set``/``add`` pair
    cannot interleave mid-update."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._value = v

    def add(self, by: float = 1.0):
        with self._lock:
            self._value += by

    def dec(self, by: float = 1.0):
        self.add(-by)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (Prometheus cumulative convention).

    ``DEFAULT_BUCKETS`` suit sub-second latencies; pass purpose-shaped
    boundaries for anything else — ``STEP_BUCKETS`` for staleness
    measured in steps, ``AGE_BUCKETS`` for freshness lags in seconds,
    ``COUNT_BUCKETS`` for size/count distributions. Mis-shaped buckets
    collapse every observation into the overflow cell and make p99
    read as the top bound forever."""

    DEFAULT_BUCKETS = (
        0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError("histogram buckets must be strictly "
                             "increasing")
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, v: float):
        # bisect_left finds the first boundary >= v (the `v <= b`
        # bucket) in O(log n) — the old linear scan held the lock for
        # the full boundary walk on every overflow-bucket observation
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._sum += v
            self._total += 1
            self._counts[i] += 1

    def timer(self):
        return _Timer(self)

    @property
    def sum(self) -> float:
        """Total of observed values (Prometheus ``_sum`` series)."""
        return self._sum

    @property
    def count(self) -> int:
        """Number of observations (Prometheus ``_count`` series)."""
        return self._total

    def snapshot(self) -> Tuple[int, float]:
        """(count, sum) pair — diff two snapshots to attribute time to a
        bounded region (the worker-cycle breakdown does this, since the
        registry's histograms are process-shared)."""
        with self._lock:
            return self._total, self._sum

    def snapshot_full(self) -> Tuple[List[int], float, int]:
        """(bucket counts, sum, count) read under ONE lock hold —
        exposition must use this: reading ``_counts``/``_sum``/``_total``
        field-by-field races ``observe`` and renders torn series (a
        bucket incremented but the matching ``_count`` not yet, or
        vice versa)."""
        with self._lock:
            return list(self._counts), self._sum, self._total

    def percentile(self, q: float) -> float:
        """Approximate quantile from the bucket counts (linear
        interpolation inside the winning bucket, Prometheus
        histogram_quantile-style). The overflow bucket clamps to the
        top finite bound — serving dashboards prefer a pessimistic
        finite p99 over +Inf."""
        with self._lock:
            counts = list(self._counts)
            total = self._total
        if total == 0:
            return 0.0
        rank = q / 100.0 * total
        cum = 0
        lo = 0.0
        for b, c in zip(self.buckets, counts):
            if c and cum + c >= rank:
                frac = min(max((rank - cum) / c, 0.0), 1.0)
                return lo + (b - lo) * frac
            cum += c
            lo = b
        return self.buckets[-1]


# Purpose-shaped bucket sets for the repo's non-latency histograms.
# STEP_BUCKETS: staleness measured in whole steps/update batches (the
# async pipeline's bounded-staleness observable — sub-second latency
# bounds would put every observation in one bucket).
STEP_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
# AGE_BUCKETS: freshness lags in seconds (train->serve sync runs
# seconds-to-minutes; DEFAULT_BUCKETS top out at 10s).
AGE_BUCKETS = (0.5, 1.0, 2.5, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0,
               600.0, 1800.0, 3600.0)
# COUNT_BUCKETS: size/count distributions (entries per packet, rows
# per batch, sketch candidate counts) — log-spaced integers.
COUNT_BUCKETS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                 10_000, 50_000, 250_000, 1_000_000)


class _Timer:
    def __init__(self, hist: Histogram):
        self.hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Named metrics with optional labels, shared process-wide."""

    def __init__(self, const_labels: Optional[Dict[str, str]] = None):
        self.const_labels = const_labels or {}
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, labels: Optional[Dict[str, str]],
             factory, help_text: Optional[str] = None):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            existing = self._kinds.setdefault(name, kind)
            if existing != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {existing}"
                )
            if help_text:
                self._help.setdefault(name, help_text)
            if key not in self._metrics:
                self._metrics[key] = factory()
            return self._metrics[key]

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help_text: Optional[str] = None) -> Counter:
        return self._get("counter", name, labels, Counter, help_text)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help_text: Optional[str] = None) -> Gauge:
        return self._get("gauge", name, labels, Gauge, help_text)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  help_text: Optional[str] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """``buckets`` lets a call site shape the boundaries to the
        quantity it observes (STEP_BUCKETS/AGE_BUCKETS/COUNT_BUCKETS
        above). Only the first registration of a (name, labels) series
        sizes it — every family should pass the same boundaries, or
        the exposition's `le` sets diverge across label values."""
        factory = (Histogram if buckets is None
                   else (lambda: Histogram(buckets)))
        return self._get("histogram", name, labels, factory, help_text)

    def render(self) -> str:
        """Prometheus text exposition format, with ``# TYPE`` (and
        ``# HELP`` where registered) comment lines per metric family so
        standard parsers (promtool, the JAX package's fleet layer) accept
        the output without heuristics. Histogram series are read through
        ``snapshot_full()`` so a concurrent ``observe`` cannot tear a
        bucket/count pair mid-render."""
        lines: List[str] = []
        with self._lock:
            items = sorted(self._metrics.items())
            kinds = dict(self._kinds)
            helps = dict(self._help)
        last_family = None
        for (name, labels), metric in items:
            all_labels = {**self.const_labels, **dict(labels)}
            kind = kinds[name]
            if name != last_family:
                # family header once, before the family's first series
                if name in helps:
                    lines.append(f"# HELP {name} "
                                 + _escape_help(helps[name]))
                lines.append(f"# TYPE {name} {kind}")
                last_family = name
            if kind == "histogram":
                assert isinstance(metric, Histogram)
                counts, hsum, total = metric.snapshot_full()
                cumulative = 0
                for b, c in zip(metric.buckets, counts):
                    cumulative += c
                    lines.append(
                        f"{name}_bucket{_fmt({**all_labels, 'le': repr(b)})}"
                        f" {cumulative}"
                    )
                cumulative += counts[-1]
                lines.append(
                    f"{name}_bucket{_fmt({**all_labels, 'le': '+Inf'})}"
                    f" {cumulative}"
                )
                lines.append(f"{name}_sum{_fmt(all_labels)} {hsum}")
                lines.append(f"{name}_count{_fmt(all_labels)} {total}")
            else:
                lines.append(f"{name}{_fmt(all_labels)} {metric.value}")
        return "\n".join(lines) + "\n"

    def push_loop(self, job: str, interval_sec: float = 10.0,
                  gateway_addr: Optional[str] = None
                  ) -> Tuple[threading.Thread, threading.Event]:
        """Background pusher to a Prometheus push gateway
        (reference lib.rs:96-144). Returns ``(thread, stop_event)`` —
        set the event to end the loop (it wakes from its interval wait
        immediately), so tests and clean shutdowns don't leak a pusher
        thread for the process lifetime."""
        addr = gateway_addr or knobs.get("PERSIA_METRICS_GATEWAY_ADDR")
        if addr is None:
            raise ValueError("no metrics gateway address configured")
        url = f"http://{addr}/metrics/job/{job}"
        stop = threading.Event()

        def run():
            import urllib.request

            while not stop.wait(interval_sec):
                try:
                    req = urllib.request.Request(
                        url, data=self.render().encode(), method="PUT")
                    urllib.request.urlopen(req, timeout=5)
                except Exception as e:
                    _logger.debug("metrics push failed: %s", e)

        t = threading.Thread(target=run, daemon=True, name="metrics-pusher")
        t.start()
        return t, stop


def _escape_help(v: str) -> str:
    """HELP text escaping (backslash and line feed; quotes are legal)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def parse_exposition(text: str):
    """Parse Prometheus text exposition back into samples — the inverse
    of :meth:`MetricsRegistry.render` (scrapers of the sidecar's
    ``/metrics`` read it back with this).

    Returns ``(samples, families)``: ``samples`` is a list of
    ``(name, labels_dict, value)`` tuples in document order;
    ``families`` maps metric family name -> ``{"type": ..., "help":
    ...}`` (missing keys omitted). Unparseable lines raise ValueError —
    a scraper that wants to tolerate garbage catches it at the call
    site and marks the target down."""
    samples = []
    families: Dict[str, Dict[str, str]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                families.setdefault(parts[2], {})["type"] = parts[3]
            elif len(parts) >= 3 and parts[1] == "HELP":
                families.setdefault(parts[2], {})["help"] = (
                    parts[3] if len(parts) > 3 else "")
            continue
        name, labels, value = _parse_sample_line(line)
        samples.append((name, labels, value))
    return samples, families


def _parse_sample_line(line: str):
    """One sample line: ``name[{k="v",...}] value [timestamp]`` with
    the text-format label-value escapes (\\\\ \\" \\n) honored."""
    brace = line.find("{")
    sp = line.find(" ")
    if brace != -1 and (sp == -1 or brace < sp):
        name = line[:brace]
        labels: Dict[str, str] = {}
        i = brace + 1
        while i < len(line) and line[i] != "}":
            eq = line.index("=", i)
            key = line[i:eq].strip().lstrip(",").strip()
            if line[eq + 1] != '"':
                raise ValueError(f"unquoted label value in {line!r}")
            j = eq + 2
            buf = []
            while True:
                c = line[j]
                if c == "\\":
                    nxt = line[j + 1]
                    buf.append({"n": "\n", '"': '"', "\\": "\\"}
                               .get(nxt, "\\" + nxt))
                    j += 2
                elif c == '"':
                    j += 1
                    break
                else:
                    buf.append(c)
                    j += 1
            labels[key] = "".join(buf)
            i = j
        rest = line[i + 1:].strip()
    else:
        if sp == -1:
            raise ValueError(f"no value on sample line {line!r}")
        name, rest = line[:sp], line[sp + 1:].strip()
        labels = {}
    value_str = rest.split()[0]
    if value_str == "+Inf":
        value = float("inf")
    elif value_str == "-Inf":
        value = float("-inf")
    else:
        value = float(value_str)
    return name, labels, value


def _escape_label_value(v) -> str:
    """Prometheus text-format escaping for label VALUES: backslash,
    double quote, and line feed. Without it an adversarial value (an
    address, a user-supplied job name) terminates the quoted string and
    injects arbitrary series into the exposition."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
