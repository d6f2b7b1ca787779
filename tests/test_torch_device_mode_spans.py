"""Device mode's spans and their reading on the device trace.

On the CPU: a device-mode step with tracing on is one trace, ``step`` over
``forward`` (over ``model``), ``backward`` and ``optimizer``; K1's table
gradients (``k1/table_grad``) carry the step's trace id and the span the
forward ran under, also when the backward runs on another thread; with
tracing off a step records nothing. ``Span.to_dict`` keeps its keys and
adds ``thread_ident``. ``portbench/spans.py`` puts a hand-written Chrome trace
(two threads, a launch that found the queue full, an operation whose
launch is not in the trace, idle gaps) down to spans, and calibrates its
clock.

On the card (``-m gpu``): a few steps at a small width with tracing on
and the profiler tracing CUDA alone. Every launch of a step falls inside
its ``device_mode/step`` span on the shared clock; the optimizer's
``multi_tensor_apply_kernel`` go to ``device_mode/optimizer``, K1's
``bag_kernel`` to ``device_mode/forward`` and ``index_add_``'s
``indexFunc*`` to ``k1/table_grad``; at batch 64 the host paces the step,
so its host dispatch time is within 10% of its duration.

Tolerance: equality on the CPU (the hand-written trace's times are exact
in binary floating point up to the last µs digit: compared to 1e-12 s).
"""

import threading

import pytest
import torch

from persia_tpu_torch import tracing
from persia_tpu_torch.models.dlrm import DLRM
from persia_tpu_torch.ops.embedding_bag import embedding_bag_slots
from persia_tpu_torch.parallel.device_mode import (
    DeviceModeModel,
    make_device_mode_trainer,
    synthetic_device_batch,
)
from persia_tpu_torch.parallel.optim import OptaxAdagrad

from portbench import spans as pspans

SLOTS, VOCAB, DIM, NUM_DENSE = 4, 1000, 16, 13
STAGES = ("device_mode/forward", "device_mode/backward",
          "device_mode/optimizer")


@pytest.fixture
def traced():
    """Tracing on with a clean collector for one test, restored after."""
    was = tracing.tracing_enabled()
    tracing.enable_tracing(True)
    tracing.default_collector().clear()
    try:
        yield tracing.default_collector()
    finally:
        tracing.enable_tracing(was)
        tracing.default_collector().clear()


def _trainer(device, batch):
    specs = [(f"slot_{i}", VOCAB, DIM) for i in range(SLOTS)]
    tower = DLRM(NUM_DENSE, SLOTS, embedding_dim=DIM, bottom_mlp=(32, DIM),
                 top_mlp=(32, 1), device=device)
    non_id, ids, label = synthetic_device_batch(batch, NUM_DENSE, specs,
                                                device=device)
    model, _, step = make_device_mode_trainer(
        DeviceModeModel(specs, tower, device=device),
        lambda p: OptaxAdagrad(p, 0.02), non_id, ids, device=device)
    return model, step, (non_id, ids, label)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_a_step_is_one_trace(traced):
    _, step, batch = _trainer("cpu", 32)
    traced.clear()
    step(*batch)
    got = _by_name(traced.recent())
    assert sorted(got) == sorted(["device_mode/step", "device_mode/model",
                                  "k1/table_grad", *STAGES])
    assert all(len(v) == 1 for v in got.values())
    root = got["device_mode/step"][0]
    assert root.parent_id == 0
    assert {s.trace_id for v in got.values() for s in v} == {root.trace_id}
    for name in STAGES:
        assert got[name][0].parent_id == root.span_id
    model = got["device_mode/model"][0]
    assert model.parent_id == got["device_mode/forward"][0].span_id
    grad = got["k1/table_grad"][0]
    assert grad.parent_id == model.span_id
    # each stage inside the step, in order, on the calling thread
    f, b, o = (got[n][0] for n in STAGES)
    assert root.start_ns <= f.start_ns < b.start_ns < o.start_ns
    assert o.start_ns + o.dur_ns <= root.start_ns + root.dur_ns
    assert {s.thread_ident for s in (root, f, b, o)} == {threading.get_ident()}


def test_scoring_model_span_is_a_root(traced):
    model, _, (non_id, ids, _) = _trainer("cpu", 8)
    traced.clear()
    with torch.inference_mode():
        model(non_id, ids)
    (s,) = traced.recent()
    assert (s.name, s.parent_id) == ("device_mode/model", 0)


def test_table_grad_follows_the_forward_onto_another_thread(traced):
    tables = [torch.randn(VOCAB, DIM, requires_grad=True)
              for _ in range(SLOTS)]
    ids = [torch.randint(1, 1 << 20, (8, 3)) for _ in range(SLOTS)]
    with tracing.span("lookup", root=True) as fwd:
        out = embedding_bag_slots(tables, ids, torch.float32)
    done = []

    def backward():
        out.sum().backward()
        done.append(threading.get_ident())

    th = threading.Thread(target=backward)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and done
    (grad,) = _by_name(traced.recent())["k1/table_grad"]
    assert (grad.trace_id, grad.parent_id) == (fwd.trace_id, fwd.span_id)
    assert grad.thread_ident == done[0] != threading.get_ident()
    assert all(t.grad is not None for t in tables)


def test_step_backward_on_another_thread(traced):
    model, step, (non_id, ids, label) = _trainer("cpu", 16)
    traced.clear()
    with tracing.span("device_mode/step", root=True) as root:
        with tracing.span("device_mode/forward"):
            loss = step.loss_fn(model(non_id, ids), label)
        th = threading.Thread(target=loss.backward)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
    got = _by_name(traced.recent())
    (grad,) = got["k1/table_grad"]
    assert grad.trace_id == root.trace_id
    assert grad.parent_id == got["device_mode/model"][0].span_id


def test_no_span_without_tracing():
    _, step, batch = _trainer("cpu", 16)
    was = tracing.tracing_enabled()
    tracing.enable_tracing(False)
    try:
        before = list(tracing.default_collector().recent())
        step(*batch)
        assert list(tracing.default_collector().recent()) == before
    finally:
        tracing.enable_tracing(was)


def test_to_dict_adds_the_thread_ident(traced):
    with tracing.span("x", root=True) as s:
        pass
    d = s.to_dict()
    assert d["thread_ident"] == threading.get_ident()
    assert set(d) == {"name", "service", "trace_id", "span_id", "parent_id",
                      "start_ns", "dur_ns", "pid", "tid", "thread_ident",
                      "tags"}
    assert d["tid"] == threading.current_thread().name


# --- the reading of a hand-written trace -------------------------------------

BASE_US = 1_000_000.0  # the trace's ts 0 on the time.time_ns() clock, in µs
# the threads' idents (the caller's and autograd's) and the tids a trace
# gives them: the magnitude of their low 32 bits read as signed
MAIN, GRAD = 7 << 32 | 11, 9 << 32 | (1 << 32) - 22
TIDS = {MAIN: 11, GRAD: 22}


def _span(name, a, b, tid, sid, parent=None):
    return {"name": name, "start_ns": int((a + BASE_US) * 1e3),
            "dur_ns": int((b - a) * 1e3), "thread_ident": tid, "span_id": sid,
            "parent_id": parent, "trace_id": "t"}


SPANS = [
    _span("device_mode/step", 0, 100, MAIN, "s"),
    _span("device_mode/forward", 1, 30, MAIN, "f", "s"),
    _span("device_mode/model", 2, 25, MAIN, "m", "f"),
    _span("device_mode/backward", 30, 70, MAIN, "b", "s"),
    _span("k1/table_grad", 40, 60, GRAD, "g", "m"),
    _span("device_mode/optimizer", 70, 99, MAIN, "o", "s"),
]


def _launch(ts, dur, tid, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": dur, "tid": TIDS[tid], "pid": 7,
            "args": {"correlation": corr}}


def _op(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": 7, "pid": 0, "args": {"correlation": corr}}


EVENTS = [
    _launch(3, 2, MAIN, 1), _op("bag_kernel", 10, 10, 1),
    # autograd's thread before its span opens: the caller's backward
    _launch(35, 2, GRAD, 2), _op("indexing_backward_kernel", 36, 4, 2),
    _launch(45, 2, GRAD, 3), _op("indexFuncLargeIndex", 45, 10, 3),
    _op("Memcpy HtoD", 60, 2, 99),  # its launch is not in the trace
    _launch(72, 20, MAIN, 4),  # found the queue full: 18 µs of waiting
    _op("multi_tensor_apply_kernel", 80, 15, 4),
    _launch(96, 2, MAIN, 5), _op("multi_tensor_apply_kernel", 96, 2, 5),
    {"ph": "i", "name": "marker", "ts": 50, "pid": 7, "tid": MAIN},
]


def test_assign_takes_the_launching_thread_then_any():
    got = [(op["name"], None if s is None else s["name"])
           for op, s in pspans.assign(EVENTS, SPANS, BASE_US)]
    assert got == [("bag_kernel", "device_mode/model"),
                   ("indexing_backward_kernel", "device_mode/backward"),
                   ("indexFuncLargeIndex", "k1/table_grad"),
                   ("Memcpy HtoD", None),
                   ("multi_tensor_apply_kernel", "device_mode/optimizer"),
                   ("multi_tensor_apply_kernel", "device_mode/optimizer")]


def test_attribute_hand_written_trace():
    got = pspans.attribute(EVENTS, SPANS, 97e-6, BASE_US)
    us = 1e-6
    # device time: the union of the operations each span holds
    want_device = {"device_mode/step": 41, "device_mode/forward": 10,
                   "device_mode/model": 10, "device_mode/backward": 14,
                   "k1/table_grad": 10, "device_mode/optimizer": 17}
    # host dispatch: the duration less the queue-full launch's 18 µs
    want_dispatch = {"device_mode/step": 82, "device_mode/forward": 29,
                     "device_mode/model": 23, "device_mode/backward": 40,
                     "k1/table_grad": 20, "device_mode/optimizer": 11}
    assert sorted(got["spans"]) == sorted(want_device)
    for name, e in got["spans"].items():
        assert e["count"] == 1
        assert e["device_s"] == pytest.approx(want_device[name] * us,
                                              abs=1e-12)
        assert e["host_dispatch_s"] == pytest.approx(
            want_dispatch[name] * us, abs=1e-12)
    assert got["spans"]["device_mode/step"]["span_s"] == pytest.approx(
        100 * us, abs=1e-12)
    assert got["none_s"] == pytest.approx(2 * us, abs=1e-12)
    assert got["busy_s"] == pytest.approx(43 * us, abs=1e-12)
    assert got["window_s"] == pytest.approx(97 * us, abs=1e-12)
    # the gaps from ts 3 to 100, each by the span of the operation that
    # ends it: [3,10] model, [20,36] backward, [40,45] table_grad, [55,60]
    # and the closing [98,100] none, [62,80] and [95,96] optimizer
    idle = {k: v / us for k, v in got["idle_by_span"]}
    assert idle == pytest.approx({
        "device_mode/optimizer": 19, "device_mode/backward": 16,
        "(none)": 7, "device_mode/model": 7, "k1/table_grad": 5},
        abs=1e-6)
    assert [k for k, _ in got["idle_by_span"]][0] == "device_mode/optimizer"


def test_attribute_leaves_out_spans_before_the_window():
    early = _span("device_mode/step", -500, -400, MAIN, "w")
    got = pspans.attribute(EVENTS, SPANS + [early], 97e-6, BASE_US)
    assert got["spans"]["device_mode/step"]["count"] == 1


def _sync(ts, dur):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
            "ts": ts, "dur": dur, "tid": TIDS[MAIN], "pid": 7}


def test_calibrate():
    ns = lambda us: int((us + BASE_US) * 1e3)  # noqa: E731
    # the window's last launch, the synchronize that closes it, three
    # bracketed ones and the profiler's own
    trace = [_launch(50, 2, MAIN, 1), _op("k", 52, 30, 1), _sync(90, 5),
             _sync(100, 2), _sync(200, 3), _sync(300, 2), _sync(1400, 9)]
    # every call inside its bracket: the clocks agree, to the tightest slack
    brackets = [(ns(99), ns(103)), (ns(198), ns(204)), (ns(299), ns(302.5))]
    off, half = pspans.calibrate(trace, BASE_US, brackets, MAIN)
    assert off == 0.0 and half == pytest.approx(0.75, abs=1e-6)
    # the trace runs 60 µs behind: the tightest bracket moves it
    late = [(a + 60_000, b + 60_000) for a, b in brackets]
    off, half = pspans.calibrate(trace, BASE_US, late, MAIN)
    assert (off, half) == pytest.approx((59.75, 0.75), abs=1e-6)
    # another thread's synchronizes are not the bracketed ones
    with pytest.raises(RuntimeError):
        pspans.calibrate(trace, BASE_US, brackets, GRAD)
    with pytest.raises(RuntimeError):
        pspans.calibrate(trace[:4], BASE_US, brackets, MAIN)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_spans_on_the_device_trace(card, traced):
    _, step, batch = _trainer("cuda", 64)
    for _ in range(3):
        step(*batch)
    traced.clear()
    dropped = traced.dropped_total
    w = pspans.profile(lambda: step(*batch), 4, 8)
    spans = [s.to_dict() for s in traced.recent()]
    assert traced.dropped_total == dropped
    assert abs(w["clock_us"]) <= 50 and w["clock_err_us"] <= 50, w
    events, base = w["events"], w["base_us"]
    got = pspans.attribute(events, spans, w["wall_s"], base)
    steps = sorted((s["start_ns"] / 1e3 - base,
                    (s["start_ns"] + s["dur_ns"]) / 1e3 - base)
                   for s in spans if s["name"] == "device_mode/step")
    assert got["spans"]["device_mode/step"]["count"] == 8
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in pspans.HOST_CATS
              and "correlation" in e.get("args", {})}
    held = {}
    pairs = pspans.assign(events, spans, base)
    for op, s in pairs:
        t = launch[op["args"]["correlation"]]
        assert any(a <= t <= b for a, b in steps), op["name"]
        assert s is not None, op["name"]
        stage = [n for n in STAGES if any(
            x["name"] == n and x["start_ns"] <= s["start_ns"]
            and s["start_ns"] + s["dur_ns"] <= x["start_ns"] + x["dur_ns"]
            for x in spans)]
        held.setdefault(op["name"], set()).update(stage)
        if "indexFunc" in op["name"]:
            assert s["name"] == "k1/table_grad", op["name"]
    names = list(held)
    for pattern, stage in (("multi_tensor_apply_kernel",
                            "device_mode/optimizer"),
                           ("bag_kernel", "device_mode/forward"),
                           ("indexFunc", "device_mode/backward")):
        hits = [n for n in names if pattern in n]
        assert hits, (pattern, names)
        assert all(held[n] == {stage} for n in hits), (pattern, held)
    stage_s = sum(got["spans"][n]["device_s"] for n in STAGES)
    assert stage_s == pytest.approx(got["busy_s"] - got["none_s"], rel=1e-9)
    assert got["none_s"] == 0
    grad = got["spans"]["k1/table_grad"]
    assert grad["device_s"] <= got["spans"]["device_mode/backward"]["device_s"]
    s = got["spans"]["device_mode/step"]
    assert s["host_dispatch_s"] <= s["span_s"]
    assert s["host_dispatch_s"] >= 0.9 * s["span_s"], s
