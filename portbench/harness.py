"""One run of a cell: set-up, the measured or the traced window, the check.

Set-up draws the weights and the pool of batches on the device from the
seed, builds the program and loads the weights into it. A training cell
then runs its first three steps through the window's own call and feed on
three different batches, and keeps what the check compares: each step's
loss, the norm of each leaf's gradient as the optimizer got it at the
first step, and the norm of each leaf's change after the first step and
after the third (read before the fourth changes it). Warm steps follow, so that every shape the
window uses is built before it starts.

The window (``--trace 0``) runs steps, or scores batches, cycling through
the pool until ``seconds`` have passed on the host's clock, then waits
for the device: the rate is the window's samples over all of its time. A
CUDA event after each step, recorded on the compute stream with no host
wait, gives the step times on the device's clock. A traced run
(``--trace 1``) instead profiles ``trace_steps`` steps and then, in
training, times ``sync_steps`` steps stage by stage.

The check runs once the window has closed, the peak memory has been read
and the program's state is freed: the reference draws the same weights
again and follows the same batches.
"""

import gc
import math
import subprocess
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from portbench import check, generator, registry, trace, weights
from portbench.arch import Arch, arch, leaves
from portbench.reference import dlrm as reference

FIRST_STEPS = 3


def log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def sync(device: torch.device):
    """Wait for the card; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Marks:
    """A mark after each step: a CUDA event recorded on the current
    stream (no host wait), or the host's clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.points = [self._mark()]

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def mark(self):
        self.points.append(self._mark())

    def step_ms(self) -> List[float]:
        """Each step's milliseconds, once the device is synchronized."""
        p = self.points
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(p, p[1:])]
        return [(b - a) * 1e3 for a, b in zip(p, p[1:])]


@dataclass
class Run:
    cell: registry.Cell
    a: Arch
    seed: int
    device: torch.device
    pool: generator.Pool
    program: object
    train: bool
    next: int = 0  # the pool batch of the next step
    readings: Optional[tuple] = None  # training: the first steps' readings
    out: Optional[torch.Tensor] = None  # scoring: each batch's predictions
    scored: set = field(default_factory=set)

    def advance(self):
        """One step (its loss) or one scored batch (None) on the next
        pool batch."""
        j = self.next
        self.next += 1
        if self.train:
            return self.program.step(*self.pool.batch(j))
        j %= len(self.pool)
        self.out[j].copy_(self.program.score(self.pool.dense[j],
                                             self.pool.ids[j]),
                          non_blocking=True)
        self.scored.add(j)
        return None

    def mode(self):
        return nullcontext() if self.train else torch.inference_mode()


def setup(cell: registry.Cell, seed: int, device) -> Run:
    device = torch.device(device)
    a = arch(cell.config)
    traffic = cell.traffic
    train = {"train": True, "eval": False}[traffic["mode"]]
    lv = leaves(a)
    t = time.perf_counter()

    def stage(name):
        nonlocal t
        sync(device)
        now = time.perf_counter()
        log(f"set-up: {name} {now - t:.3f} s")
        t = now

    pool = generator.make_pool(a, traffic, seed, device)
    stage("pool drawn")
    from portbench.program import Program

    program = Program(a, pool.names, device)
    weights.fill(lv, program.leaf_tensors(), seed)
    stage("program built, weights drawn")
    run = Run(cell, a, seed, device, pool, program, train)
    if train:
        step = program.trainer(pool.batch(0))
        stage("trainer built")
        losses = []
        for j in range(FIRST_STEPS):
            losses.append(step(*pool.batch(j)))
            if j == 0:
                grad_norms = program.grad_norms()
                first = weights.change_norms(lv, program.leaf_tensors(), seed)
        changes = weights.change_norms(lv, program.leaf_tensors(), seed)
        run.readings = ([float(x) for x in losses], grad_norms, first,
                        changes)
        run.next = FIRST_STEPS
        stage(f"first {FIRST_STEPS} steps read")
    else:
        program.model.eval()
        run.out = torch.empty((len(pool), pool.batch_size, 1),
                              pin_memory=device.type == "cuda")
    with run.mode():
        for _ in range(int(traffic["warm_steps"])):
            run.advance()
    stage("warm steps")
    return run


@dataclass
class Window:
    steps: int
    seconds: float
    step_ms: List[float]
    failed: int


def _failed(losses) -> int:
    if not losses:
        return 0
    return int((~torch.isfinite(torch.stack(losses))).sum())


def window(run: Run, seconds: float) -> Window:
    """Steps until ``seconds`` have passed, then a wait for the device."""
    sync(run.device)
    losses = []
    with run.mode():
        marks = Marks(run.device)
        t0 = time.perf_counter()
        while True:
            loss = run.advance()
            marks.mark()
            if loss is not None:
                losses.append(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(run.device)
        t1 = time.perf_counter()
    step_ms = marks.step_ms()
    return Window(len(step_ms), t1 - t0, step_ms, _failed(losses))


@dataclass
class Observations:
    """What a per-layer reader reads (``portbench/metrics/*.py``)."""

    a: Arch
    train: bool
    batch: int
    steps: int  # the traced window's steps
    trace: Optional[dict]  # trace.summarize of the window; None on the CPU
    ids_traced: float  # non-padding ids a traced step, mean
    rows_traced: float  # distinct table rows a traced step touches, mean
    stage_s: Optional[Dict[str, float]]  # stage seconds over sync_steps
    sync_steps: int
    rows_synced: float  # distinct rows a stage-timed step touches, mean


def pool_counts(run: Run):
    """Per pool batch: its non-padding ids and the distinct rows it
    touches, summed over the tables (the reference's hash)."""
    ids_n, rows_n = [], []
    for j in range(len(run.pool)):
        ids = run.pool.ids[j].to(run.device)
        n_ids = n_rows = 0
        for k, vocab in enumerate(run.a.rows):
            rows, mask = reference.hash_rows(ids[k], vocab)
            n_ids += int(mask.sum())
            n_rows += int(torch.unique(rows[mask]).numel())
        ids_n.append(n_ids)
        rows_n.append(n_rows)
    return ids_n, rows_n


def _mean_over(values: List[int], first: int, n: int) -> float:
    if n <= 0:
        return 0.0
    return sum(values[(first + i) % len(values)] for i in range(n)) / n


def traced(run: Run):
    """In training, ``sync_steps`` steps timed stage by stage (before the
    profiler, so that nothing of it stays on for them); then the profiled
    window of ``trace_steps`` steps."""
    traffic = run.cell.traffic
    ids_n, rows_n = pool_counts(run)
    losses = []

    def step():
        loss = run.advance()
        if loss is not None:
            losses.append(loss)

    stage_s, n_sync, sync_first = None, 0, run.next
    if run.train and int(traffic["sync_steps"]) > 0:
        n_sync = int(traffic["sync_steps"])
        run.program.time_stages(True)
        for _ in range(n_sync):
            step()
        sync(run.device)
        stage_s = run.program.stage_seconds()
        run.program.time_stages(False)
    n = int(traffic["trace_steps"])
    with run.mode():
        if run.device.type == "cuda":
            first = run.next + trace.WARM
            summary = trace.profile(step, trace.WARM, n)
            window_s = summary["window_s"]
        else:
            first, summary = run.next, None
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            window_s = time.perf_counter() - t0
    obs = Observations(
        run.a, run.train, run.pool.batch_size, n, summary,
        _mean_over(ids_n, first, n), _mean_over(rows_n, first, n), stage_s,
        n_sync, _mean_over(rows_n, sync_first, n_sync))
    return obs, Window(n, window_s, [], _failed(losses))


def release(run: Run):
    """Free the program's state and return what it produced: the first
    steps' readings (training) or each pool batch's last predictions
    (scoring, {pool index: host tensor})."""
    out = run.readings if run.train else {
        j: run.out[j].reshape(-1).clone() for j in run.scored}
    run.program = None
    run.out = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def reference_readings(run: Run, precision: str, pool=None):
    """The reference's readings from the run's seed's weights on the run's
    batches (or ``pool``'s), with products in ``precision``."""
    lv = leaves(run.a)
    tensors = [torch.empty(leaf.shape, device=run.device) for leaf in lv]
    weights.fill(lv, tensors, run.seed)
    pool = run.pool if pool is None else pool
    if run.train:
        return reference.train(run.a, tensors, pool, precision, FIRST_STEPS)
    return reference.predict(run.a, tensors, pool, precision)


def numbers(run: Run, got, ref) -> Dict[str, float]:
    """The check's numbers of ``got`` (what :func:`release` returns, or a
    reference's readings in the program's place) against ``ref``."""
    if run.train:
        return check.train_numbers(got, ref)
    if not isinstance(got, dict):
        got = dict(enumerate(got))
    order = sorted(got)
    return check.eval_numbers([got[j] for j in order], [ref[j] for j in order])


def check_run(run: Run) -> Dict[str, float]:
    """Free the program, then hold what it produced against the
    reference, from the same seed's weights and the same batches."""
    got = release(run)
    return numbers(run, got, reference_readings(run, run.a.compute_dtype))


def power_limit_w(index: int) -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def run_cell(cell: registry.Cell, seed: int, seconds: float, traced_run: bool,
             device="cuda", started: Optional[float] = None):
    """One run. Returns (the result object, the check's lines)."""
    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    log(f"set-up: imports {time.perf_counter() - started:.3f} s")
    if device.type == "cuda":
        index = device.index or 0
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(index),
                    "count": cell.chips, "memory_peak_bytes": 0}
        torch.cuda.reset_peak_memory_stats(device)
        log(f"set-up: card {dev_info['kind']} "
            f"{time.perf_counter() - started:.3f} s from the start")
    run = setup(cell, seed, device)
    setup_s = time.perf_counter() - started
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s")
    metrics: Dict[str, dict] = {}
    if traced_run:
        obs, win = traced(run)
    else:
        win = window(run, seconds)
    if device.type == "cuda":
        dev_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
        dev_info["power_limit_w"] = power_limit_w(index)
        log(f"card: {dev_info['kind']}, power limit "
            f"{dev_info['power_limit_w']} W")
        if traced_run:
            dev_info["busy_s"] = obs.trace["busy_s"]
            dev_info["window_s"] = obs.trace["window_s"]
            for m in cell.per_layer:
                value = registry.reader(m.name, cell.root)(obs)
                if value is not None:
                    metrics[m.name] = {"value": value, "unit": m.unit}
        else:
            rate = win.steps * run.pool.batch_size / win.seconds
            values = {"train_samples_per_s": rate if run.train else None,
                      "eval_samples_per_s": None if run.train else rate,
                      "step_ms_p95": p95(win.step_ms), "setup_s": setup_s}
            for m in cell.end_to_end:
                if values.get(m.name) is None:
                    raise KeyError(f"the harness does not measure {m.name} "
                                   f"in {cell.name}")
                metrics[m.name] = {"value": values[m.name], "unit": m.unit}
    log(f"window: {win.steps} steps in {win.seconds:.3f} s, "
        f"{win.failed} failed")
    found = check_run(run)
    lines = check.lines(found, cell.limits)
    result = {
        "correct": check.within(found, cell.limits) and win.failed == 0,
        "attempted": win.steps, "failed": win.failed, "metrics": metrics,
        "device": dev_info,
    }
    if traced_run and obs.trace is not None:
        result["breakdown"] = {"device_ops": obs.trace["device_ops"],
                               "idle_gaps": obs.trace["idle_gaps"]}
    result["checks"] = {k: {"value": found[k], "limit": cell.limits[k]}
                        for k in cell.limits}
    return result, lines
