"""Kernels K1 (embedding bag) and K5 (copy-shape probe) of the PyTorch
port against the JAX package, on the CPU.

K1's plain version (``persia_tpu_torch.ops.embedding_bag``) is held
against ``xla_embedding_bag`` and against the Pallas kernel run in
interpret mode, as the JAX tests run it; its out-of-range rule against
the Pallas kernel; the autograd Function's gradients against ``jax.grad``
of the custom-vjp ``embedding_bag``, and on out-of-range ids against the
stated difference of the two backwards. The multi-slot entry's plain
version (device mode's whole collection in one call) is held against the
flax collection in ``tests/test_torch_device_mode.py``; here its refusals,
and both entries under a shard window (a table row-sharded over a mesh's
model axis) against the unwindowed plain version restricted to the
window's rows, forward and backward (exact: the same rounded products,
with zeros in the place of the rows left out).
K5's plain version is held against the numpy base of
``tools/probe_dma_shapes.py``. The launch path (``ops/_build.Launcher``)
is held to its contract against a stub library. On the CPU the wrappers
run the plain versions and count no launch; the CUDA kernels themselves
are held against the plain versions on the card (``chip_smoke.py`` and
the ``gpu``-marked tests below).

Tolerance for K1 in f32: rtol=atol=1e-6. Each output is a sum of S
rounded products; the versions add them in other orders (XLA's reduce,
the Pallas kernel's masked lane sums), each worth an ulp or two of the
O(1) result. Gradients: 1e-6 likewise (a scatter-add of S·B rounded
products, and a D-long dot per weight). K5 is a copy: exact.
"""

import ast
import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from persia_tpu_torch.ops import _build
from persia_tpu_torch.ops import embedding_bag as eb
from persia_tpu_torch.ops import probe_copy as pc

TOL = 1e-6
REPO = Path(__file__).resolve().parent.parent


def _inputs(seed, vocab, dim, batch, bag):
    """ids with duplicates inside and across bags, and zero weights."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    ids = rng.integers(0, vocab, size=(batch, bag)).astype(np.int32)
    ids[0, :] = ids[0, 0]  # one bag of a single repeated id
    ids[1:, 0] = ids[-1, -1]  # the same id in many bags
    weights = rng.normal(size=(batch, bag)).astype(np.float32)
    weights[rng.random((batch, bag)) < 0.3] = 0.0  # padding
    return table, ids, weights


def _jnp(*xs):
    import jax.numpy as jnp

    return [jnp.asarray(x) for x in xs]


def _torch(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("bag", [1, 3, 8])
@pytest.mark.parametrize("dim", [8, 16, 32])
def test_plain_matches_xla_and_pallas(dim, bag):
    """B = 13 is not a multiple of the Pallas kernel's 8-sample group;
    V = 100 is not a multiple of its packing factor 128 / D."""
    from persia_tpu.ops.embedding_bag import (
        pallas_embedding_bag,
        xla_embedding_bag,
    )

    table, ids, weights = _inputs(dim + bag, 100, dim, 13, bag)
    want_xla = np.asarray(xla_embedding_bag(*_jnp(table, ids, weights)))
    want_pallas = np.asarray(pallas_embedding_bag(
        *_jnp(table, ids, weights), interpret=True))
    tt, ti, tw = _torch(table, ids, weights)
    plain = eb.embedding_bag_reference(tt, ti, tw)
    assert plain.dtype == torch.float32 and plain.shape == (13, dim)
    for want in (want_xla, want_pallas):
        np.testing.assert_allclose(plain.numpy(), want, rtol=TOL, atol=TOL)
    # the wrapper and the Function run the plain version on the CPU, with
    # int64 ids as well
    for got in (eb.embedding_bag_fwd(tt, ti, tw),
                eb.embedding_bag(tt, ti.long(), tw)):
        assert torch.equal(got, plain)


@pytest.mark.parametrize("dim", [8, 16, 32])
def test_clipping_rule_matches_pallas(dim):
    """At a V that P = 128 / D divides, ids -3, V and V + 100 read rows 0,
    V - 1 and V - 1 in the port as in the Pallas kernel (where
    ``jnp.take`` gives NaN for the last two and row V - 3 for -3)."""
    from persia_tpu.ops.embedding_bag import (
        pallas_embedding_bag,
        xla_embedding_bag,
    )

    vocab = 64
    assert vocab % (128 // dim) == 0
    table, ids, weights = _inputs(dim, vocab, dim, 13, 3)
    ids[2:5, 1] = [-3, vocab, vocab + 100]
    weights[2:5, 1] = 1.5
    want = np.asarray(pallas_embedding_bag(*_jnp(table, ids, weights),
                                           interpret=True))
    got = eb.embedding_bag_reference(*_torch(table, ids, weights)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    clipped = np.clip(ids, 0, vocab - 1)
    np.testing.assert_allclose(
        got, np.asarray(xla_embedding_bag(*_jnp(table, clipped, weights))),
        rtol=TOL, atol=TOL)
    xla = np.asarray(xla_embedding_bag(*_jnp(table, ids, weights)))
    assert np.isnan(xla[3:5]).all()  # the rule the port does not follow


@pytest.mark.parametrize("weights_grad", [True, False])
def test_gradients_match_jax_grad(weights_grad):
    import jax

    from persia_tpu.ops.embedding_bag import embedding_bag as jbag

    table, ids, weights = _inputs(5, 50, 16, 13, 4)
    cot = np.random.default_rng(6).normal(size=(13, 16)).astype(np.float32)
    jt, ji, jw, jc = _jnp(table, ids, weights, cot)
    want_t, want_w = jax.grad(
        lambda t, w: (jbag(t, ji, w, "xla") * jc).sum(),
        argnums=(0, 1))(jt, jw)
    tt, ti, tw, tc = _torch(table, ids, weights, cot)
    tt.requires_grad_()
    tw.requires_grad_(weights_grad)
    (eb.embedding_bag(tt, ti, tw) * tc).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_t),
                               rtol=TOL, atol=TOL)
    if weights_grad:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w),
                                   rtol=TOL, atol=TOL)
    else:
        assert tw.grad is None


def test_backward_out_of_range_ids_against_jax_grad():
    """K1's backward on out-of-range ids, a stated difference from the
    JAX package: the port adds a bag's cotangent at the clipped rows
    (-1 -> row 0, ids >= V -> row V - 1), as its forward reads them, while
    JAX's ``_bwd`` scatters at the raw ids, where ``.at[].add`` wraps -1 to
    row V - 1 and drops ids >= V, and its ``d_weights`` gather gives NaN
    for ids >= V. At the clipped ids the two backwards agree."""
    import jax

    from persia_tpu.ops.embedding_bag import embedding_bag as jbag

    vocab = 50
    table, ids, weights = _inputs(7, vocab, 16, 13, 4)
    ids[2, 1], ids[3, 2], ids[4, 0] = -1, vocab, vocab + 9
    weights[2, 1], weights[3, 2], weights[4, 0] = 1.5, -0.5, 2.0
    cot = np.random.default_rng(8).normal(size=(13, 16)).astype(np.float32)

    def jax_grads(jids):
        jt, ji, jw, jc = _jnp(table, jids, weights, cot)
        return [np.asarray(x) for x in jax.grad(
            lambda t, w: (jbag(t, ji, w, "xla") * jc).sum(),
            argnums=(0, 1))(jt, jw)]

    tt, ti, tw, tc = _torch(table, ids, weights, cot)
    tt.requires_grad_()
    tw.requires_grad_()
    (eb.embedding_bag(tt, ti, tw) * tc).sum().backward()
    got_t, got_w = tt.grad.numpy(), tw.grad.numpy()
    clip_t, clip_w = jax_grads(np.clip(ids, 0, vocab - 1))
    np.testing.assert_allclose(got_t, clip_t, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_w, clip_w, rtol=TOL, atol=TOL)
    raw_t, raw_w = jax_grads(ids)
    # JAX's table gradient is the port's with the three bags' terms moved:
    # -1's from row 0 to row V - 1, V's and V + 9's dropped from row V - 1
    want = got_t.copy()
    for b, s, row in ((2, 1, 0), (3, 2, vocab - 1), (4, 0, vocab - 1)):
        want[row] -= cot[b] * weights[b, s]
    want[vocab - 1] += cot[2] * weights[2, 1]
    np.testing.assert_allclose(raw_t, want, rtol=TOL, atol=TOL)
    assert np.isnan(raw_w[[3, 4], [2, 0]]).all()
    assert np.isfinite(got_w).all()


def _tpu_probe_cases():
    """``CASES`` of tools/probe_dma_shapes.py, read from its source: the
    module arms a watchdog and needs a TPU when imported."""
    tree = ast.parse((REPO / "tools" / "probe_dma_shapes.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "CASES":
            return ast.literal_eval(node.value)
    raise AssertionError("CASES not found in tools/probe_dma_shapes.py")


def test_probe_cases_are_the_tpu_probes():
    assert _tpu_probe_cases() == pc.CASES


@pytest.mark.parametrize("name", list(pc.CASES))
def test_probe_plain_matches_numpy_base(name):
    _, src_shape = _tpu_probe_cases()[name]
    # the TPU probe's expected output (probe_dma_shapes.py:79-80)
    base = np.arange(np.prod(src_shape), dtype=np.float32).reshape(
        src_shape)[3].reshape(-1)[:8]
    src, idx = pc.case_inputs(name, "cpu")
    for got in (pc.probe_copy_reference(src, idx), pc.probe_copy(src, idx)):
        assert got.shape == (1, 8) and got.dtype == torch.float32
        np.testing.assert_array_equal(got[0].numpy(), base)


def test_probe_entry_point_on_cpu(capsys):
    assert pc.main(["cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all("ok=True" in ln for ln in lines)
    assert all("us_per_call=not measured" in ln for ln in lines)
    assert [r["row_bytes"] for r in pc.run_probe("cpu")] == [64, 512, 512,
                                                              4096]


def test_cpu_wrappers_do_not_count_launches():
    eb.reset_launch_count()
    pc.reset_launch_count()
    table, ids, weights = _torch(*_inputs(1, 20, 8, 5, 2))
    eb.embedding_bag_fwd(table, ids, weights)
    eb.embedding_bag(table.requires_grad_(), ids, weights).sum().backward()
    pc.run_probe("cpu")
    assert eb.launch_count() == 0 and pc.launch_count() == 0


def test_wrappers_reject_bad_inputs():
    table, ids, weights = _torch(*_inputs(1, 20, 8, 5, 2))
    with pytest.raises(ValueError):
        eb.embedding_bag_fwd(table, ids, weights[:, :1])
    with pytest.raises(ValueError):
        eb.embedding_bag_fwd(table[0], ids, weights)
    with pytest.raises(TypeError):
        eb.embedding_bag_fwd(table, ids.float(), weights)
    with pytest.raises(ValueError):
        pc.probe_copy(torch.zeros(4, 8), torch.zeros(2, dtype=torch.int32))


def test_slots_wrappers_reject_bad_inputs():
    tables = [torch.zeros(10, 4), torch.zeros(20, 4)]
    ids = [torch.ones(3, 1, dtype=torch.int32)] * 2
    with pytest.raises(ValueError):
        eb.embedding_bag_slots_fwd(tables, ids[:1])
    with pytest.raises(ValueError):
        eb.embedding_bag_slots_fwd([tables[0], torch.zeros(10, 8)], ids)
    with pytest.raises(ValueError):
        eb.embedding_bag_slots_fwd(tables, [ids[0], ids[0][:2]])
    with pytest.raises(ValueError):
        eb.embedding_bag_slots_fwd([torch.zeros(1, 4)], ids[:1])
    with pytest.raises(TypeError):
        eb.embedding_bag_slots_fwd(tables, [i.float() for i in ids])
    with pytest.raises(TypeError):
        eb.embedding_bag_slots_fwd(tables, ids, torch.float16)
    # one call's windows all hold the padding row 0 or none does
    shards = [torch.zeros(5, 4)] * 2
    with pytest.raises(ValueError, match="start at row 0"):
        eb.embedding_bag_slots_fwd(shards, ids, windows=[(0, 10), (5, 10)])


# a vocab of 64 in 4 shards of 16 rows: the windows (lo, n)
WINDOWS = [(0, 16), (16, 16), (48, 16)]
W_VOCAB = 64


def _slot_case(seed, lo, batch=24, bag=3, n_slots=2):
    """Raw ids of ``n_slots`` slots over a 64-row vocab with padding (0 and
    negative) and, in the first bags, ids that hash to the window's first
    global row ``lo`` (local row 0) beside padding: the backward must
    scatter into that row and not into the padding row."""
    rng = np.random.default_rng(seed)
    tables, ids = [], []
    for _ in range(n_slots):
        tables.append(torch.from_numpy(
            rng.normal(size=(W_VOCAB, 8)).astype(np.float32)))
        i = rng.integers(1, 1 << 20, size=(batch, bag)).astype(np.int64)
        i[rng.random((batch, bag)) < 0.25] = 0
        i.flat[::7] = -2
        if lo > 0:  # (id % 63) + 1 == lo, next to a padding id
            i[:4, 0] = lo - 1 + 63 * rng.integers(1, 1000, size=4)
            i[:4, 1] = 0
        ids.append(torch.from_numpy(i))
    return tables, ids


def _restricted(ids, lo, n):
    """The raw ids whose hashed row lies outside [lo, lo + n) turned to
    padding: the unwindowed call on them pools only the window's rows."""
    out = []
    for i in ids:
        rows, mask = eb.hash_ids(i, W_VOCAB)
        keep = mask & (rows >= lo) & (rows < lo + n)
        out.append(torch.where(keep, i, 0))
    return out


@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_slots_match_unwindowed_on_the_window(window):
    """The multi-slot plain version (and the wrapper on the CPU) under a
    shard window: the f32 partial equals the unwindowed call on the ids
    restricted to the window, the rows are the local rows (-1 outside;
    padding is global row 0, local 0 on the first shard only), and the
    Function's shard gradients (the padding-mask trap included) equal the
    window's rows of the unwindowed gradients."""
    lo, n = window
    tables, ids = _slot_case(lo + 1, lo)
    shards = [t[lo:lo + n].clone() for t in tables]
    wins = [(lo, W_VOCAB)] * len(tables)
    got, rows = eb.embedding_bag_slots_reference(shards, ids, torch.float32,
                                                 wins)
    want, want_rows = eb.embedding_bag_slots_reference(
        tables, _restricted(ids, lo, n), torch.float32)
    assert torch.equal(got, want)
    full, _ = eb.embedding_bag_slots_reference(tables, ids, torch.float32)
    if lo > 0:
        assert not torch.equal(got, full)  # some ids left out
    glob, mask = zip(*(eb.hash_ids(i, W_VOCAB) for i in ids))
    local = torch.cat([eb.local_rows(g, lo, n).reshape(-1) for g in glob])
    assert torch.equal(rows, local) and rows.dtype == torch.int32
    assert bool((rows == -1).any()) and bool((rows == 0).any())
    fwd = eb.embedding_bag_slots_fwd(shards, ids, torch.float32, wins)
    assert torch.equal(fwd[0], got) and torch.equal(fwd[1], rows)
    cot = torch.from_numpy(np.random.default_rng(lo).normal(
        size=tuple(got.shape)).astype(np.float32))
    grads = []
    for ts, ii, w in ((shards, ids, wins),
                      (tables, _restricted(ids, lo, n), None)):
        ts = [t.clone().requires_grad_() for t in ts]
        (eb.embedding_bag_slots(ts, ii, torch.float32, w) * cot).sum() \
            .backward()
        grads.append([t.grad.to_dense() for t in ts])
    for g, g_full in zip(*grads):
        assert g.shape == (n, 8)
        assert torch.equal(g, g_full[lo:lo + n])
        if lo > 0:  # global row lo is local row 0, and it trains
            assert bool(g[0].abs().sum() > 0)
        else:  # the padding row does not
            assert bool(g[0].abs().sum() == 0)
    # and the Function's backward equals autograd through the plain version
    ts = [t.clone().requires_grad_() for t in shards]
    (eb.embedding_bag_slots_reference(ts, ids, torch.float32, wins)[0]
     * cot).sum().backward()
    for g, want_g in zip(grads[0], (t.grad for t in ts)):
        assert torch.equal(g, want_g)


@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_single_table_matches_unwindowed_on_the_window(window):
    """The single-table entry under a window (clipped ids over the global
    vocab, -1 and ids past it included): the partial and the shard's
    gradient against the unwindowed call with the outside weights zeroed;
    the weights' gradient is the window's part."""
    lo, n = window
    table, ids, weights = _torch(*_inputs(lo, W_VOCAB, 8, 13, 4))
    ids[2:5, 1] = torch.tensor([-1, W_VOCAB, W_VOCAB + 9], dtype=ids.dtype)
    rows = eb.clip_ids(ids, W_VOCAB)
    inside = (rows >= lo) & (rows < lo + n)
    shard = table[lo:lo + n].clone()
    got = eb.embedding_bag_reference(shard, ids, weights, (lo, W_VOCAB))
    want = eb.embedding_bag_reference(table, ids,
                                      torch.where(inside, weights, 0.0))
    assert torch.equal(got, want)
    assert torch.equal(eb.embedding_bag_fwd(shard, ids, weights,
                                            (lo, W_VOCAB)), got)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(lo))
    s, w = shard.clone().requires_grad_(), weights.clone().requires_grad_()
    (eb.embedding_bag(s, ids, w, (lo, W_VOCAB)) * cot).sum().backward()
    t, w2 = table.clone().requires_grad_(), weights.clone().requires_grad_()
    (eb.embedding_bag(t, ids, w2) * cot).sum().backward()
    t3 = table.clone().requires_grad_()
    (eb.embedding_bag(t3, ids, torch.where(inside, weights, 0.0))
     * cot).sum().backward()
    assert torch.equal(s.grad, t3.grad[lo:lo + n])
    assert torch.equal(w.grad, torch.where(inside, w2.grad, 0.0))
    with pytest.raises(ValueError, match="window"):
        eb.embedding_bag_fwd(shard, ids, weights, (W_VOCAB - 8, W_VOCAB))


def test_unwindowed_slots_keep_their_rows_and_mask():
    """No window and the whole table as the window are the same call:
    the same output, rows (padding reads row 0, as before windows came)
    and gradients."""
    tables, ids = _slot_case(5, 0)
    a = eb.embedding_bag_slots_reference(tables, ids)
    b = eb.embedding_bag_slots_reference(tables, ids, windows=[
        (0, W_VOCAB)] * len(tables))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    glob = torch.cat([eb.hash_ids(i, W_VOCAB)[0].reshape(-1) for i in ids])
    assert torch.equal(a[1], glob) and not bool((a[1] < 0).any())


class _StubFn:
    """A C function (a real ctypes callback) whose ``argtypes`` and
    ``restype`` assignments are counted."""

    def __init__(self, restype, argtypes, impl):
        self.c = ctypes.CFUNCTYPE(restype, *argtypes)(impl)
        self.sets = 0

    @property
    def argtypes(self):
        return self.c.argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.sets += 1
        self.c.argtypes = value

    @property
    def restype(self):
        return self.c.restype

    @restype.setter
    def restype(self, value):
        self.sets += 1
        self.c.restype = value

    def __call__(self, *args):
        return self.c(*args)


class _StubLib:
    """A kernel library's C interface without a card: ``persia_stub(ptr,
    n, stream)`` records its arguments and returns ``rc``."""

    def __init__(self):
        self.rc, self.calls = 0, []
        self._msg = ctypes.create_string_buffer(b"stub failure")
        self.persia_stub = _StubFn(
            ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
            lambda ptr, n, stream: self.calls.append((ptr, n, stream))
            or self.rc)
        self.persia_cuda_error_string = _StubFn(
            ctypes.c_void_p, [ctypes.c_int],
            lambda code: ctypes.addressof(self._msg))


def test_launcher_against_stub_library(monkeypatch):
    """The launch path's contract: the C function is resolved once, with
    its argtypes (the stream appended) and restype set then; a launch
    passes 64-bit pointers and the raw stream of the current device,
    enters no device guard on that device and one on another; a non-zero
    code raises with the CUDA message and does not count."""
    lib = _StubLib()
    loads, guards = [], []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name)
                        or lib)
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 0xabc0 + index)

    class Guard:
        def __init__(self, index):
            guards.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "_device_guard", Guard)
    monkeypatch.setattr(_build, "_launchers", {})
    _build.reset_launch_counts(["stub"])
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    launch = _build.launcher("stub", "stub_src", "persia_stub", argtypes)
    assert _build.launcher("stub", "stub_src", "persia_stub",
                           argtypes) is launch
    assert loads == ["stub_src"]
    fn = lib.persia_stub
    assert list(fn.argtypes) == [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    assert fn.restype is ctypes.c_int and fn.sets == 2
    for _ in range(3):
        launch(torch.device("cuda", 0), 2**40 + 16, 7)
    launch(torch.device("cuda"), 1, 2)  # no index: the current device
    launch(torch.device("cuda", 1), 3, 4)
    assert lib.calls == [(2**40 + 16, 7, 0xabc0)] * 3 + [
        (1, 2, 0xabc0), (3, 4, 0xabc1)]
    assert guards == [1]
    assert fn.sets == 2 and _build.launch_count("stub") == 5
    lib.rc = 700
    with pytest.raises(RuntimeError,
                       match=r"stub kernel launch failed: CUDA error 700 "
                             r"\(stub failure\)"):
        launch(torch.device("cuda", 0), 0, 0)
    assert _build.launch_count("stub") == 5


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """K1 against its plain version on the card: bit-equal at S = 1,
    within 1e-6 abs + 1e-5 rel at S = 8 with out-of-range ids, int32 and
    int64 ids (both read as they are); launches counted. K5's four cases
    equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")
    eb.reset_launch_count()
    for seed, (vocab, dim, batch, bag) in enumerate(
            [(1000, 16, 4096, 1), (997, 13, 37, 8), (64, 32, 13, 3)]):
        table, ids, weights = _inputs(seed, vocab, dim, batch, bag)
        ids[2:5, -1] = [-1, vocab, vocab + 7]
        tt, ti, tw = (t.cuda() for t in _torch(table, ids, weights))
        for ti in (ti, ti.long()):
            got = eb.embedding_bag_fwd(tt, ti, tw)
            want = eb.embedding_bag_reference(tt, ti, tw)
            torch.cuda.synchronize()
            if bag == 1:
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert eb.launch_count() == 6
    pc.reset_launch_count()
    for name in pc.CASES:
        src, idx = pc.case_inputs(name, "cuda")
        assert torch.equal(pc.probe_copy(src, idx),
                           pc.probe_copy_reference(src, idx))
    assert pc.launch_count() == len(pc.CASES)


# K1's multi-slot entry against its plain version on the card. At S = 1
# each pooled value is one product by 1 or 0 in both: bit-equal, in bf16
# and in the rows. At S > 1 both round every product and sum in f32,
# possibly adding in another order: 1e-6 abs + 1e-5 rel in f32 (chip_smoke's
# BAG_ATOL / BAG_RTOL), and one bf16 rounding (2**-8 rel) in bf16.
BAG_ATOL, BAG_RTOL = 1e-6, 1e-5


def _slot_inputs(seed, specs, batch, bags, device="cuda", dtype=np.int32):
    """Tables (V_i, D) f32 and raw ids with padding 0, negatives and ids
    far past the vocab, on ``device``."""
    rng = np.random.default_rng(seed)
    tables, ids = [], []
    for (vocab, dim), bag in zip(specs, bags):
        tables.append(torch.from_numpy(rng.normal(size=(vocab, dim)).astype(
            np.float32)).to(device))
        i = rng.integers(1, 1 << 31, size=(batch, bag)).astype(dtype)
        i[rng.random((batch, bag)) < 0.25] = 0
        i.flat[::11] = -3
        ids.append(torch.from_numpy(i).to(device))
    return tables, ids


def _check_slots_on_card(specs, batch, bags, dtype=np.int32, tables=None):
    t, ids = _slot_inputs(len(specs) + batch, specs, batch, bags,
                          dtype=dtype)
    tables = tables or t
    for out_dtype in eb.SLOT_DTYPES:
        got, rows = eb.embedding_bag_slots_fwd(tables, ids, out_dtype)
        want, want_rows = eb.embedding_bag_slots_reference(tables, ids,
                                                           out_dtype)
        torch.cuda.synchronize()
        assert got.shape == (batch, len(specs), specs[0][1])
        assert got.dtype == out_dtype and torch.equal(rows, want_rows)
        if max(bags) == 1:
            assert torch.equal(got, want)
        elif out_dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=BAG_RTOL,
                                       atol=BAG_ATOL)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2**-8, atol=BAG_ATOL)


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")


@pytest.mark.gpu
@pytest.mark.parametrize("bags", [(1,), (4,), (1, 3, 4, 2)])
@pytest.mark.parametrize("dim", [16, 13])
def test_cuda_slots_match_plain(dim, bags):
    """Device mode's shape at a small vocab (26 slots of two vocabs, B =
    4096), and D = 13 for the scalar body; one launch a call; int32 and
    int64 ids."""
    _skip_without_card()
    n = 26
    specs = [(1000 if i % 2 else 257, dim) for i in range(n)]
    slot_bags = [bags[i % len(bags)] for i in range(n)]
    for dtype in (np.int32, np.int64):
        eb.reset_launch_count()
        _check_slots_on_card(specs, 4096, slot_bags, dtype)
        assert eb.launch_count() == len(eb.SLOT_DTYPES)  # one a call


@pytest.mark.gpu
def test_cuda_slots_split_above_max_slots_and_unaligned():
    """More slots than one launch's descriptors: one launch per
    MAX_SLOTS; tables that are not 16-byte aligned take the scalar body;
    the library's limit is the wrapper's."""
    _skip_without_card()
    lib = _build.load(eb.KERNEL)
    assert lib.persia_embedding_bag_max_slots() == eb.MAX_SLOTS
    n = eb.MAX_SLOTS + 6
    eb.reset_launch_count()
    _check_slots_on_card([(300, 16)] * n, 517, [1] * n)
    assert eb.launch_count() == 2 * len(eb.SLOT_DTYPES)
    flat = torch.randn(300 * 16 + 1, device="cuda")
    unaligned = [flat[1:].view(300, 16)] * 3
    _check_slots_on_card([(300, 16)] * 3, 517, [2] * 3, tables=unaligned)


@pytest.mark.gpu
@pytest.mark.parametrize("bags", [(1,), (4,), (1, 4)])
def test_cuda_slots_backward_matches_plain_autograd(bags):
    """The Function's table gradients (scatter-add at the rows the kernel
    wrote) against autograd through the plain version, on the card: f32
    sums in another order, 1e-6 abs + 1e-5 rel."""
    _skip_without_card()
    specs = [(1000, 16), (257, 16), (4096, 16)]
    slot_bags = [bags[i % len(bags)] for i in range(len(specs))]
    tables, ids = _slot_inputs(3, specs, 4096, slot_bags)
    cot = torch.randn((4096, len(specs), 16), device="cuda")
    grads = []
    for fn in (eb.embedding_bag_slots,
               lambda t, i, d: eb.embedding_bag_slots_reference(t, i, d)[0]):
        ts = [t.clone().requires_grad_() for t in tables]
        (fn(ts, ids, torch.bfloat16).float() * cot).sum().backward()
        grads.append([t.grad.to_dense() for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=BAG_RTOL, atol=BAG_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("bags", [(1,), (4,)])
@pytest.mark.parametrize("half", [0, 1])
def test_cuda_windowed_slots_match_plain(bags, half):
    """Windowed K1 (each table the first or the second half of its rows,
    int32 and int64 ids) against its windowed plain version on the card:
    f32 partials bit-equal at S = 1, within 1e-6 + 1e-5 rel above; the
    local rows equal; one launch a call; the Function's shard gradients
    against autograd through the plain version within 1e-6 of the largest
    gradient (on the card ``index_add_`` and the plain gather's backward
    both add a shard row's contributions, tens of them at B = 4096, S = 4,
    in any order, and a row whose terms cancel keeps their rounding)."""
    _skip_without_card()
    specs = [(1000, 16), (256, 16), (4096, 16)]
    slot_bags = [bags[i % len(bags)] for i in range(len(specs))]
    for dtype in (np.int32, np.int64):
        tables, ids = _slot_inputs(7 + half, specs, 4096, slot_bags,
                                   dtype=dtype)
        wins = [(half * (v // 2), v) for v, _ in specs]
        shards = [t[lo:lo + v // 2].contiguous()
                  for t, (lo, v) in zip(tables, wins)]
        eb.reset_launch_count()
        got, rows = eb.embedding_bag_slots_fwd(shards, ids, torch.float32,
                                               wins)
        assert eb.launch_count() == 1
        want, want_rows = eb.embedding_bag_slots_reference(
            shards, ids, torch.float32, wins)
        torch.cuda.synchronize()
        assert torch.equal(rows, want_rows) and bool((rows == -1).any())
        if max(bags) == 1:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=BAG_RTOL,
                                       atol=BAG_ATOL)
    cot = torch.randn(got.shape, device="cuda")
    grads = []
    for fn in (eb.embedding_bag_slots,
               lambda t, i, d, w: eb.embedding_bag_slots_reference(
                   t, i, d, w)[0]):
        ts = [t.clone().requires_grad_() for t in shards]
        (fn(ts, ids, torch.float32, wins) * cot).sum().backward()
        grads.append([t.grad.to_dense() for t in ts])
    for g, want_g in zip(*grads):
        torch.testing.assert_close(
            g, want_g, rtol=0, atol=BAG_ATOL * float(want_g.abs().max()))


@pytest.mark.gpu
def test_cuda_launch_failure_raises_and_does_not_count():
    """A launcher refused by the library (no slots) raises with the CUDA
    message; the failed launch is not counted."""
    _skip_without_card()
    eb.reset_launch_count()
    out = torch.empty((4, 1, 16), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        eb._launch(out.device, eb.array("q", [0] * eb._DESC_WORDS), 0, 4,
                   16, out, None, 1, 0, True)
    assert eb.launch_count() == 0
