"""The port's arena PS holder against the JAX package's, on the CPU.

``persia_tpu_torch.ps.arena.ArenaEmbeddingHolder`` must be bit-identical
to ``persia_tpu.ps.arena.ArenaEmbeddingHolder``: lookups, updates, miss
counts, ``get_entries``, the slab accounting and the PSD dump bytes, for
fp32, fp16 and bf16 rows. The JAX holder runs batches with repeated signs
through its per-sign sequential path; the port runs them in occurrence
rounds, so these tests hold the round path to the sequential one. Also:
``RowPrecision`` against the JAX package's (bf16 through ``ml_dtypes``
there, uint16 bit patterns here), the port's fp32 arena against its
per-entry holder, the per-entry holder's half rows under a byte budget
against ``persia_tpu.ps.store.EmbeddingHolder``'s (lookups, updates, miss
counts, resident bytes, ``get_entries`` and the PSD v2 dump bit for bit),
and ``make_holder``.
"""

import numpy as np
import pytest

from persia_tpu_torch import config as tcfg
from persia_tpu_torch.ps import arena as tarena
from persia_tpu_torch.ps import optim as toptim
from persia_tpu_torch.ps.native import make_holder
from persia_tpu_torch.ps.store import EmbeddingHolder as TLegacy
from persia_tpu_torch.worker import middleware as tmw
from persia_tpu_torch.worker.worker import EmbeddingWorker as TWorker
from persia_tpu_torch.workloads import generator as tgen

ROW_DTYPES = ("fp32", "fp16", "bf16")
OPTIMIZERS = {
    "sgd": {"type": "sgd", "lr": 0.05, "wd": 0.01},
    "adagrad": {"type": "adagrad", "lr": 0.05, "wd": 0.0,
                "g_square_momentum": 0.9, "initialization": 0.01,
                "eps": 1e-10, "vectorwise_shared": False},
    "adagrad_shared": {"type": "adagrad", "lr": 0.05, "wd": 0.0,
                       "g_square_momentum": 1.0, "initialization": 0.05,
                       "eps": 1e-10, "vectorwise_shared": True},
    "adam": {"type": "adam", "lr": 0.01, "beta1": 0.9, "beta2": 0.99,
             "eps": 1e-8},
}
STAT_KEYS = ("slab_bytes", "free_slots", "live_rows", "resident_bytes",
             "fragmentation_ratio")


def _pair(capacity, shards=4, row_dtype="fp32", capacity_bytes=None,
          opt="adagrad", admit=1.0, prefix_bit=0):
    from persia_tpu.ps.arena import ArenaEmbeddingHolder as JArena

    hs = [JArena(capacity, shards, row_dtype=row_dtype,
                 capacity_bytes=capacity_bytes),
          tarena.ArenaEmbeddingHolder(capacity, shards, row_dtype=row_dtype,
                                      capacity_bytes=capacity_bytes)]
    for h in hs:
        h.configure("bounded_uniform", {"lower": -0.2, "upper": 0.2},
                    admit_probability=admit, weight_bound=0.25)
        h.register_optimizer(OPTIMIZERS[opt],
                             feature_index_prefix_bit=prefix_bit)
    return hs


def _eq(a, b):
    """Bit equality of two f32 arrays (NaN payloads included)."""
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _assert_same_state(hs, universe, widths):
    j, t = hs
    assert len(j) == len(t)
    assert j.index_miss_count == t.index_miss_count
    assert j.gradient_id_miss_count == t.gradient_id_miss_count
    js, ts = j.arena_stats(), t.arena_stats()
    assert {k: js[k] for k in STAT_KEYS} == {k: ts[k] for k in STAT_KEYS}
    assert j.resident_bytes == t.resident_bytes
    for width in widths:
        a, b = (h.get_entries(universe, width) for h in hs)
        np.testing.assert_array_equal(a[0], b[0])
        _eq(a[1], b[1])
    assert j.dump_bytes() == t.dump_bytes()


def _traffic(hs, rng, universe, rounds, batch, dims=(8,), mult=1,
             eval_every=2):
    """Training lookups then updates over signs drawn from ``universe``:
    distinct with ``mult`` 1; with ``mult`` > 1 drawn with replacement and
    every drawn sign repeated 1..mult times, the copies scattered through
    the batch. Eval lookups in between."""
    for rnd in range(rounds):
        dim = dims[rnd % len(dims)]
        signs = rng.choice(universe, size=batch, replace=mult > 1)
        if mult > 1:
            signs = np.repeat(signs, rng.integers(1, mult + 1, len(signs)))
            signs = signs[rng.permutation(len(signs))]
        outs = [h.lookup(signs, dim, True) for h in hs]
        _eq(*outs)
        grads = rng.normal(size=(len(signs), dim)).astype(np.float32)
        # a few gradients for signs no lookup created (id misses)
        stray = rng.integers(1, 2**63, size=3, dtype=np.uint64)
        usigns = np.concatenate([signs, stray])
        ugrads = np.concatenate(
            [grads, rng.normal(size=(3, dim)).astype(np.float32)])
        for h in hs:
            h.update_gradients(usigns, ugrads, dim)
        if rnd % eval_every == 0:
            _eq(*(h.lookup(universe, dim, False) for h in hs))


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_random_traffic_is_bit_exact(row_dtype, opt):
    """Admission below 1, dim mismatches (dims 8 and 4 interleaved),
    duplicate signs at multiplicities 1-4 on the round path, four feature
    groups for Adam's beta powers."""
    hs = _pair(1_000_000, row_dtype=row_dtype, opt=opt, admit=0.7,
               prefix_bit=2)
    rng = np.random.default_rng(
        [ROW_DTYPES.index(row_dtype), sorted(OPTIMIZERS).index(opt)])
    universe = (rng.integers(1, 2**40, size=400, dtype=np.uint64)
                | (rng.integers(0, 4, size=400).astype(np.uint64)
                   << np.uint64(62)))
    space = hs[1].optimizer.require_space(8)
    _traffic(hs, rng, universe, rounds=6, batch=150, dims=(8, 8, 4),
             mult=4)
    _traffic(hs, rng, universe, rounds=3, batch=150)  # distinct signs
    stats = hs[1].arena_stats()
    assert stats["lookup_rounds"] > 0 and stats["update_rounds"] > 0
    assert stats["lookup_batched"] > 0 and stats["lookup_sequential"] == 0
    _assert_same_state(hs, universe, (8 + space, 4 + hs[1].optimizer
                                      .require_space(4)))


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_capacity_below_one_batch_takes_the_sequential_path(row_dtype):
    """6 rows per internal shard against batches of ~80 signs with
    repeats: every batch evicts inside itself, which only the exact
    per-sign sequence gets right."""
    hs = _pair(24, row_dtype=row_dtype, admit=0.8)
    rng = np.random.default_rng(5)
    universe = rng.integers(1, 2**63, size=90, dtype=np.uint64)
    _traffic(hs, rng, universe, rounds=8, batch=40, dims=(8, 8, 4), mult=3)
    stats = hs[1].arena_stats()
    assert stats["lookup_sequential"] > 0
    assert stats["live_rows"] <= 24
    _assert_same_state(hs, universe, (16, 8))


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_byte_budget_and_set_get_entries(row_dtype):
    """``capacity_bytes`` evicts by the rows' logical bytes; ``set_entries``
    inserts one row after another (evicting as it goes), ``get_entries``
    reads by width."""
    row = tarena.ArenaEmbeddingHolder(1, 1, row_dtype=row_dtype)._rp \
        .entry_nbytes(8, 8)
    hs = _pair(1_000_000, shards=2, row_dtype=row_dtype,
               capacity_bytes=60 * row)
    rng = np.random.default_rng(8)
    universe = rng.integers(1, 2**63, size=200, dtype=np.uint64)
    vecs = rng.normal(size=(80, 16)).astype(np.float32)
    vecs[:3, :3] = [[np.inf, -0.0, 1e-40], [np.nan, 3e38, -1e-45],
                    [65504.0, 1.0 + 2.0**-8, -np.inf]]
    for h in hs:
        h.set_entries(universe[:80], 8, vecs)
    _assert_same_state(hs, universe, (16,))
    assert hs[1].resident_bytes <= 60 * row
    _traffic(hs, rng, universe, rounds=6, batch=30, mult=2)
    stats = hs[1].arena_stats()
    assert stats["lookup_sequential"] + stats["lookup_rounds"] > 0
    _assert_same_state(hs, universe, (16,))
    for h in hs:
        h.set_entry(int(universe[0]), 4, np.arange(8, dtype=np.float32))
    got = [h.get_entry(int(universe[0])) for h in hs]
    assert got[0][0] == got[1][0] == 4
    _eq(got[0][1], got[1][1])
    _assert_same_state(hs, universe, (16, 8))


@pytest.mark.parametrize("row_dtype", ["fp16", "bf16"])
def test_resident_emb_bytes_and_row_nbytes_match_jax(row_dtype):
    """The embedding share of the resident bytes and one row's bytes, as
    JAX's arena counts them, through inserts, evictions and ``clear``;
    and the health document of a ``PsService`` over the holder."""
    from persia_tpu.service import ps_service as jsvc
    from persia_tpu_torch.service import ps_service as tsvc

    hs = _pair(200, shards=2, row_dtype=row_dtype)
    for dim in (4, 8, 12):
        assert hs[1].row_nbytes(dim) == hs[0].row_nbytes(dim)
    assert hs[1].row_nbytes(8) == 8 * (2 + 4)
    rng = np.random.default_rng(6)
    universe = rng.integers(1, 2**63, size=400, dtype=np.uint64)
    for rnd in range(4):
        signs = rng.choice(universe, size=120, replace=False)
        for h in hs:
            h.lookup(signs, (4, 8)[rnd % 2], True)
        assert hs[1].resident_emb_bytes == hs[0].resident_emb_bytes > 0
    assert hs[1].resident_emb_bytes < hs[1].resident_bytes
    docs = []
    for h, svc in zip(hs, (jsvc, tsvc)):
        s = svc.PsService(h, port=0)
        s.server.serve_background()
        try:
            docs.append(svc.PsClient(s.addr).health())
        finally:
            s.stop()
    for key in ("row_dtype", "resident_bytes", "resident_emb_bytes"):
        assert docs[1][key] == docs[0][key], key
    assert docs[1]["resident_emb_bytes"] == hs[1].resident_emb_bytes
    for h in hs:
        h.clear()
    assert hs[1].resident_emb_bytes == hs[0].resident_emb_bytes == 0


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_dumps_cross_load(row_dtype):
    """Dumps are byte-identical (v1 for fp32, v2 for half rows); a JAX
    dump loads into the port and the port's into JAX, through files too;
    ``clear`` empties."""
    from persia_tpu.ps.arena import ArenaEmbeddingHolder as JArena

    hs = _pair(1_000_000, row_dtype=row_dtype, opt="adam")
    rng = np.random.default_rng(11)
    universe = rng.integers(1, 2**63, size=120, dtype=np.uint64)
    _traffic(hs, rng, universe, rounds=3, batch=60, dims=(8, 4), mult=2)
    blob = hs[0].dump_bytes()
    assert blob == hs[1].dump_bytes()
    assert blob[4:8] == (b"\x01\x00\x00\x00" if row_dtype == "fp32"
                         else b"\x02\x00\x00\x00")
    port = tarena.ArenaEmbeddingHolder(1_000_000, 4, row_dtype=row_dtype)
    port.load_bytes(blob)
    jax_side = JArena(1_000_000, 4, row_dtype=row_dtype)
    jax_side.load_bytes(hs[1].dump_bytes())
    assert port.dump_bytes() == jax_side.dump_bytes() == blob
    # a holder of another precision reads it too, as the JAX one does
    other = "fp32" if row_dtype != "fp32" else "fp16"
    a = tarena.ArenaEmbeddingHolder(1_000_000, 4, row_dtype=other)
    b = JArena(1_000_000, 4, row_dtype=other)
    a.load_bytes(blob)
    b.load_bytes(blob)
    assert a.dump_bytes() == b.dump_bytes()
    assert len(a) == len(hs[1])


def test_dump_file_round_trip(tmp_path):
    hs = _pair(1_000_000, row_dtype="bf16")
    rng = np.random.default_rng(12)
    universe = rng.integers(1, 2**63, size=50, dtype=np.uint64)
    _traffic(hs, rng, universe, rounds=2, batch=40)
    hs[1].dump_file(str(tmp_path / "t.psd"))
    hs[0].dump_file(str(tmp_path / "j.psd"))
    assert (tmp_path / "t.psd").read_bytes() == (tmp_path / "j.psd") \
        .read_bytes()
    fresh = tarena.ArenaEmbeddingHolder(1_000_000, 4, row_dtype="bf16")
    fresh.load_file(str(tmp_path / "j.psd"))
    assert fresh.dump_bytes() == hs[1].dump_bytes()
    fresh.clear()
    assert len(fresh) == 0 and fresh.dump_bytes()[8:16] == bytes(8)


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_fp32_arena_matches_the_per_entry_holder(opt):
    """The port's two holders agree on fp32 rows, whatever their paths:
    rows, misses and the rows' recency (the eviction order)."""
    hs = [TLegacy(40, 4), tarena.ArenaEmbeddingHolder(40, 4)]
    for h in hs:
        h.configure("bounded_uniform", {"lower": -0.2, "upper": 0.2},
                    admit_probability=0.8, weight_bound=0.25)
        h.register_optimizer(OPTIMIZERS[opt])
    rng = np.random.default_rng(13)
    universe = rng.integers(1, 2**63, size=120, dtype=np.uint64)
    width = 8 + hs[1].optimizer.require_space(8)
    for rnd in range(10):
        signs = rng.choice(universe, size=25 if rnd % 2 else 70)
        _eq(*(h.lookup(signs, 8, True) for h in hs))
        grads = rng.normal(size=(len(signs), 8)).astype(np.float32)
        for h in hs:
            h.update_gradients(signs, grads, 8)
        _eq(*(h.lookup(universe, 8, False) for h in hs))
        a, b = (h.get_entries(universe, width) for h in hs)
        np.testing.assert_array_equal(a[0], b[0])
        _eq(a[1], b[1])
    assert hs[0].index_miss_count == hs[1].index_miss_count
    assert hs[0].gradient_id_miss_count == hs[1].gradient_id_miss_count
    stats = hs[1].arena_stats()
    assert stats["lookup_sequential"] > 0 and stats["lookup_rounds"] > 0


# --- RowPrecision -------------------------------------------------------


def _special_f32():
    ties = (np.arange(1, 300, dtype=np.uint32) << 16 | 0x8000)
    bits = np.concatenate([ties, ties | 0x80000000, np.array(
        [0x7FC00001, 0x7F800001, 0xFFBFFFFF, 0x7FFFFFFF, 0xFFFFFFFF,
         0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000,
         0x00000001, 0x00008000, 0x00018000, 0x807FFFFF, 0x00400000,
         0x80000000, 0x00000000, 0x477FE000, 0x477FF000, 0x33800000,
         0x33000001, 0x387FC000], np.uint32)])
    rng = np.random.default_rng(21)
    rand = rng.integers(0, 2**32, size=4000, dtype=np.uint64).astype(
        np.uint32)
    return np.concatenate([bits, rand]).view(np.float32)


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_row_precision_matches_jax(row_dtype):
    """Narrow and widen, bit for bit, on NaN payloads, infinities,
    subnormals, exact ties and overflow; the packed layouts and the
    structured-matrix paths."""
    from persia_tpu.ps.optim import RowPrecision as JRP

    jrp, trp = JRP(row_dtype), toptim.RowPrecision(row_dtype)
    assert (jrp.itemsize, jrp.is_fp32) == (trp.itemsize, trp.is_fp32)
    x = _special_f32()
    dim, space = 6, 3
    n = len(x) // (dim + space)
    mat = np.ascontiguousarray(x[:n * (dim + space)].reshape(n, -1))
    with np.errstate(all="ignore"):
        jn = jrp.narrow_matrix(mat, dim)
        tn = trp.narrow_matrix(mat, dim)
        np.testing.assert_array_equal(jn, tn)
        vecs_j = [jrp.pack(r, dim) for r in mat[:50]]
        vecs_t = [trp.pack(r, dim) for r in mat[:50]]
    for a, b in zip(vecs_j, vecs_t):
        np.testing.assert_array_equal(a, b)
        _eq(jrp.unpack(a, dim), trp.unpack(b, dim))
        _eq(jrp.emb_f32(a, dim), trp.emb_f32(b, dim))
        assert jrp.state_len_of(a, dim) == trp.state_len_of(b, dim) == space
    _eq(jrp.unpack_matrix(vecs_j, dim, dim + space),
        trp.unpack_matrix(vecs_t, dim, dim + space))
    rows = list(tn.copy()) if not trp.is_fp32 else [r.copy() for r in mat]
    with np.errstate(all="ignore"):
        trp.pack_matrix_into(mat[::-1].copy(), rows, dim)
        jrows = [r.copy() for r in (list(jn.copy()) if not jrp.is_fp32
                                    else mat)]
        jrp.pack_matrix_into(mat[::-1].copy(), jrows, dim)
        for a, b in zip(jrows, rows):
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.view(np.uint8))
        buf_j, buf_t = vecs_j[0].copy(), vecs_t[0].copy()
        jrp.pack_into(mat[7], buf_j, dim)
        trp.pack_into(mat[7], buf_t, dim)
    np.testing.assert_array_equal(buf_j.view(np.uint8), buf_t.view(np.uint8))
    assert jrp.stored_len(dim, space) == trp.stored_len(dim, space)
    assert jrp.entry_nbytes(dim, space) == trp.entry_nbytes(dim, space)
    if row_dtype == "bf16":
        import ml_dtypes

        bits = np.arange(65536, dtype=np.uint16)
        _eq(toptim.bf16_bits_to_f32(bits),
            bits.view(ml_dtypes.bfloat16).astype(np.float32))
    with pytest.raises(ValueError, match="row_dtype"):
        toptim.RowPrecision("fp8")


# --- make_holder --------------------------------------------------------


@pytest.mark.parametrize("row_dtype", ["fp16", "bf16"])
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_per_entry_half_rows_under_a_byte_budget_match_jax(row_dtype, opt):
    """The per-entry holder with half rows and ``capacity_bytes`` (via
    ``make_holder(backend="python-legacy")``) against the JAX package's
    ``EmbeddingHolder``: admission below 1, dims 8 and 4, duplicate
    signs, a budget of 50 rows a shard that evicts inside batches, then
    ``set_entries`` / ``set_entry``; every read, the resident bytes, the
    miss counts and the PSD v2 dump bit for bit, and each dump loads into
    the other package's holder."""
    from persia_tpu.ps.store import EmbeddingHolder as JLegacy

    row = toptim.RowPrecision(row_dtype).entry_nbytes(8, 8)
    budget = 2 * 50 * row
    hs = [JLegacy(1_000_000, 2, row_dtype=row_dtype, capacity_bytes=budget),
          make_holder(1_000_000, 2, backend="python-legacy",
                      row_dtype=row_dtype, capacity_bytes=budget)]
    assert type(hs[1]) is TLegacy
    for h in hs:
        h.configure("bounded_uniform", {"lower": -0.2, "upper": 0.2},
                    admit_probability=0.8, weight_bound=0.25)
        h.register_optimizer(OPTIMIZERS[opt])
    rng = np.random.default_rng([ROW_DTYPES.index(row_dtype), len(opt)])
    universe = rng.integers(1, 2**63, size=300, dtype=np.uint64)
    widths = tuple(d + hs[1].optimizer.require_space(d) for d in (8, 4))

    def same():
        j, t = hs
        assert len(j) == len(t) > 0
        assert j.index_miss_count == t.index_miss_count
        assert j.gradient_id_miss_count == t.gradient_id_miss_count
        assert j.resident_bytes == t.resident_bytes <= budget
        assert j.resident_emb_bytes == t.resident_emb_bytes
        for width in widths:
            a, b = (h.get_entries(universe, width) for h in hs)
            np.testing.assert_array_equal(a[0], b[0])
            _eq(a[1], b[1])
        assert j.dump_bytes() == t.dump_bytes()

    _traffic(hs, rng, universe, rounds=6, batch=80, dims=(8, 8, 4), mult=3)
    same()
    assert hs[1].resident_bytes > 0.9 * budget  # the budget binds
    vecs = rng.normal(size=(40, widths[0])).astype(np.float32)
    vecs[:2, :3] = [[np.inf, -0.0, 1e-40], [65504.0, 1.0 + 2.0**-8, -1e-45]]
    for h in hs:
        h.set_entries(universe[:40], 8, vecs)
        h.set_entry(int(universe[50]), 4, np.arange(
            widths[1], dtype=np.float32))
    got = [h.get_entry(int(universe[50])) for h in hs]
    assert got[0][0] == got[1][0] == 4
    _eq(got[0][1], got[1][1])
    same()
    blob = hs[0].dump_bytes()
    assert blob[4:8] == b"\x02\x00\x00\x00"
    port = TLegacy(1_000_000, 2, row_dtype=row_dtype)
    port.load_bytes(blob)
    jax_side = JLegacy(1_000_000, 2, row_dtype=row_dtype)
    jax_side.load_bytes(hs[1].dump_bytes())
    assert port.dump_bytes() == jax_side.dump_bytes()


def test_make_holder_backends_and_refusals(caplog):
    """``auto`` (the default) and ``native`` give the native C++ store,
    without a warning; ``arena`` and ``python-legacy`` stay explicit."""
    from persia_tpu_torch.ps import native as tnative

    with caplog.at_level("WARNING", logger="persia_tpu_torch.ps.native"):
        h = make_holder(1000, 4)
        assert type(make_holder(1000, 4, backend="auto")) is type(h)
    assert isinstance(h, tnative.NativeEmbeddingHolder)
    assert not caplog.records
    native = make_holder(1000, 2, backend="native", row_dtype="fp16",
                         capacity_bytes=4096)
    assert isinstance(native, tnative.NativeEmbeddingHolder)
    assert (native.row_dtype, native.capacity_bytes,
            native.num_internal_shards) == ("fp16", 4096, 2)
    assert isinstance(make_holder(1000, 4, prefer_native=False),
                      tarena.ArenaEmbeddingHolder)
    h = make_holder(1000, 2, backend="arena", row_dtype="bf16",
                    capacity_bytes=4096)
    assert (h.row_dtype, h.capacity_bytes, h.num_internal_shards) == (
        "bf16", 4096, 2)
    legacy = make_holder(1000, 4, backend="python-legacy")
    assert type(legacy) is TLegacy and legacy.capacity == 1000
    legacy = make_holder(1000, 2, backend="python-legacy", row_dtype="fp16",
                         capacity_bytes=4096)
    assert type(legacy) is TLegacy
    assert (legacy.row_dtype, legacy.capacity_bytes,
            legacy.num_internal_shards) == ("fp16", 4096, 2)
    with pytest.raises(ValueError, match="unknown PS backend"):
        make_holder(1000, 4, backend="rocksdb")
    with pytest.raises(ValueError, match="positive"):
        tarena.ArenaEmbeddingHolder(10, 0)
    t = tarena.ArenaEmbeddingHolder(10, 2)
    with pytest.raises(RuntimeError, match="optimizer"):
        t.lookup(np.array([1], np.uint64), 4, True)
    with pytest.raises(RuntimeError, match="optimizer"):
        t.update_gradients(np.array([1], np.uint64),
                           np.zeros((1, 4), np.float32), 4)
    t.register_optimizer(OPTIMIZERS["sgd"])
    with pytest.raises(RuntimeError, match="configured"):
        t.lookup(np.array([1], np.uint64), 4, True)
    assert not t.lookup(np.array([1], np.uint64), 4, False).any()


# --- seq_rec traffic through the workers --------------------------------


@pytest.fixture
def jax_numpy_middleware(monkeypatch):
    """The JAX middleware's numpy path (its C++ kernels when built would
    be held to the same numbers)."""
    from persia_tpu.worker import middleware as jmw

    monkeypatch.setattr(jmw, "_mw_native", lambda: None)
    return jmw


def _seq_schemas(t_hist):
    from persia_tpu import config as jcfg

    out = []
    for cfg in (jcfg, tcfg):
        slots = cfg.uniform_slots(["user_geo", "user_device",
                                   "target_item"], dim=8)
        slots["recent_items"] = cfg.SlotConfig(
            name="recent_items", dim=8, embedding_summation=False,
            sample_fixed_size=t_hist)
        slots["recent_clicks"] = cfg.SlotConfig(
            name="recent_clicks", dim=8, pooling="last4")
        out.append(cfg.EmbeddingSchema(slots_config=slots))
    return out


def test_seqrec_batches_take_the_round_path(jax_numpy_middleware):
    """History, clicks (every other history item) and the target share
    one item sign space, and the worker does not merge signs across
    features: every (shard, dim) group of a seqrec batch repeats signs.
    The port's workers take the round path on every shard call and end
    with the bytes the JAX arena's sequential path gives."""
    from persia_tpu.ps.arena import ArenaEmbeddingHolder as JArena
    from persia_tpu.workloads import generator as jgen
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    jschema, tschema = _seq_schemas(16)
    jw = JWorker(jschema, [JArena(1_000_000, 8) for _ in range(2)])
    tw = TWorker(tschema, [make_holder(1_000_000, 8, backend="arena")
                           for _ in range(2)])
    spec = dict(item_vocab=3000, t_hist=16)
    rng = np.random.default_rng(14)
    try:
        for w in (jw, tw):
            w.configure_parameter_servers(
                "bounded_uniform", {"lower": -0.05, "upper": 0.05}, 1.0, 1.0)
            w.register_optimizer(OPTIMIZERS["adagrad"])
        for jb, tb in zip(
                jgen.seqrec_batches(4 * 32, 32, seed=3,
                                    spec=jgen.SeqRecSpec(**spec)),
                tgen.seqrec_batches(4 * 32, 32, seed=3,
                                    spec=tgen.SeqRecSpec(**spec))):
            feats = tmw.preprocess_batch(tb.id_type_features, tschema)
            groups = tmw.shard_split(feats, tschema, 2)
            assert all(len(np.unique(g.signs)) < len(g.signs)
                       for g in groups if g.dim == 8 and len(g.signs) > 64)
            jref, jl = jw.lookup_direct_training(jb.id_type_features)
            tref, tl = tw.lookup_direct_training(tb.id_type_features)
            for name in tl:
                _eq(jl[name].embeddings, tl[name].embeddings)
            grads = {n: rng.normal(size=r.embeddings.shape).astype(
                np.float32) for n, r in tl.items()}
            jw.update_gradients(jref, grads)
            tw.update_gradients(tref, grads)
        for jh, th in zip(jw.ps_clients, tw.ps_clients):
            assert jh.dump_bytes() == th.dump_bytes()
            stats = th.arena_stats()
            assert stats["lookup_sequential"] == 0
            assert stats["lookup_rounds"] > 0 and stats["update_rounds"] > 0
    finally:
        jw.close()


@pytest.mark.parametrize("repeat", [False, True], ids=["distinct", "repeated"])
def test_hit_evicted_mid_batch_then_not_admitted(repeat):
    """A resident row of an unadmitted sign (written by ``set_entries``)
    that the batch's own inserts evict before its position: the
    sequential path reads a miss there. The per-entry holder reads zeros.
    The JAX arena's distinct-sign path first reads the hits of the whole
    batch and keeps that read when it falls back to the sequential path,
    so it returns the evicted row (ROADMAP.md §C); a batch with repeated
    signs reads zeros. The port's arena gives the JAX arena's bytes in
    both cases. The native C++ store (the JAX package's and the port's)
    reads zeros in both, as the per-entry holder does."""
    from persia_tpu.ps.arena import ArenaEmbeddingHolder as JArena
    from persia_tpu.ps.native import NativeEmbeddingHolder as JNative
    from persia_tpu_torch.ps.native import NativeEmbeddingHolder as TNative
    from persia_tpu_torch.ps.rng import admit_mask

    cand = np.arange(1, 200, dtype=np.uint64)
    admitted = admit_mask(cand, 0.5)
    a, b = cand[admitted][:2]
    s = cand[~admitted][0]
    batch = np.array([a, b, s, s] if repeat else [a, b, s], np.uint64)
    outs = []
    for cls in (JArena, tarena.ArenaEmbeddingHolder, TLegacy, JNative,
                TNative):
        h = cls(2, 1)
        h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1},
                    admit_probability=0.5)
        h.register_optimizer(OPTIMIZERS["sgd"])
        h.set_entries(np.array([s], np.uint64), 4,
                      np.full((1, 4), 7.0, np.float32))
        outs.append((h.lookup(batch, 4, True), h.index_miss_count))
    (jout, jmiss), (tout, tmiss), (lout, lmiss), (jn, jnmiss), (tn, tnmiss) \
        = outs
    _eq(jout, tout)
    _eq(jn, tn)
    _eq(tn, lout)
    assert jmiss == tmiss == lmiss == jnmiss == tnmiss == len(batch)
    assert not lout[2:].any()
    assert (tout[2:] == 7.0).all() != repeat
