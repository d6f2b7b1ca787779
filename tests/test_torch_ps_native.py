"""The port's native C++ PS store, its loader, the middleware's C++ kernels
and the worker's fan-out, against the JAX package, on the CPU.

- ``persia_tpu_torch.ps.native.NativeEmbeddingHolder`` is the same C++
  store as ``persia_tpu.ps.native.NativeEmbeddingHolder``, built by the
  port from ``native/src/``: lookups, updates, miss counts,
  ``get_entries``, the arena statistics and the PSD v1/v2 files are
  bit-identical to it, for fp32/fp16/bf16 rows under SGD, Adagrad (plain
  and shared) and Adam, with repeated signs and both budgets. Against
  both arena holders (the JAX package's and the port's) it is
  bit-identical too under SGD and Adagrad. Under Adam and the shared
  Adagrad the rows differ in their last bits: the C++ optimizer rounds
  ``1 - beta`` in f32 where numpy rounds it from f64, and sums the shared
  accumulator's squares in f64 where numpy's f32 mean sums pairwise
  (ROADMAP.md §C; pinned by
  ``test_native_differs_from_the_arena_in_rounding_only``).
- The ``ptmw_*`` kernels against the port's numpy middleware and the JAX
  package's kernels; the port's middleware with and without them.
- The port's ``EmbeddingWorker`` against the JAX worker over seqrec
  batches: both planes, the fan-out pool, both holders; the stale-batch
  expiry.
"""

import io
import shutil
import threading
import time

import numpy as np
import pytest

from persia_tpu_torch import config as tcfg
from persia_tpu_torch.ops import _build
from persia_tpu_torch.ps import arena as tarena
from persia_tpu_torch.ps import native as tnative
from persia_tpu_torch.ps.store import EmbeddingHolder as TLegacy
from persia_tpu_torch.ps.store import iter_psd_records, read_psd_header
from persia_tpu_torch.worker import middleware as tmw
from persia_tpu_torch.worker import mw_native as tmwn
from persia_tpu_torch.worker.worker import EmbeddingWorker as TWorker
from persia_tpu_torch.workloads import generator as tgen
from test_torch_ps_arena import OPTIMIZERS, ROW_DTYPES, _eq

# Adam and shared-Adagrad rows of the C++ store against the arena's numpy:
# Adam's constants 1 - beta1 and 1 - beta2 differ by 1 f32 ulp (f32
# arithmetic against an f64 value rounded to f32), the shared Adagrad's
# mean of squares by 1 ulp (an f64 sum against numpy's pairwise f32 sum);
# either moves the state by ~1e-7 relative a step. Over a few steps and
# half-precision storage that is at most one unit in the stored row's
# last place: 2**-7 relative for bf16 rows, 2**-10 for fp16, far less for
# fp32 (atol for rows that round near 0).
ROUNDING_RTOL = {"fp32": 1e-5, "fp16": 2.0 ** -10, "bf16": 2.0 ** -7}
ROUNDING_ATOL = 1e-6
EXACT_OPTIMIZERS = ("sgd", "adagrad")


def _holders(capacity, shards=4, row_dtype="fp32", capacity_bytes=None,
             opt="adagrad", admit=1.0, prefix_bit=0):
    """[JAX native, port native, JAX arena, port arena], configured alike."""
    from persia_tpu.ps.arena import ArenaEmbeddingHolder as JArena
    from persia_tpu.ps.native import NativeEmbeddingHolder as JNative

    hs = [cls(capacity, shards, row_dtype=row_dtype,
              capacity_bytes=capacity_bytes)
          for cls in (JNative, tnative.NativeEmbeddingHolder, JArena,
                      tarena.ArenaEmbeddingHolder)]
    for h in hs:
        h.configure("bounded_uniform", {"lower": -0.2, "upper": 0.2},
                    admit_probability=admit, weight_bound=0.25)
        h.register_optimizer(OPTIMIZERS[opt],
                             feature_index_prefix_bit=prefix_bit)
    return hs


def _dump(h, tmp_path) -> bytes:
    if hasattr(h, "dump_bytes"):
        return h.dump_bytes()
    path = tmp_path / f"dump-{id(h)}.psd"
    h.dump_file(str(path))
    return path.read_bytes()


def _records(blob):
    f = io.BytesIO(blob)
    version, count = read_psd_header(f)
    return version, [(s, d, v) for s, d, v in
                     iter_psd_records(f.read, version, count)]


def _close(a, b, row_dtype):
    np.testing.assert_allclose(a, b, rtol=ROUNDING_RTOL[row_dtype],
                               atol=ROUNDING_ATOL)


def _same(ref, other, exact, row_dtype):
    if exact:
        _eq(ref, other)
    else:
        _close(ref, other, row_dtype)


def _traffic(hs, rng, universe, rounds, batch, dims=(8,), mult=1,
             exact=True, row_dtype="fp32"):
    """The arena tests' traffic (training lookups with repeats, updates
    with a few id misses, eval lookups) through all four holders: the
    port's native store bit for bit against the JAX one, against the
    arenas bit for bit when ``exact``."""
    for rnd in range(rounds):
        dim = dims[rnd % len(dims)]
        signs = rng.choice(universe, size=batch, replace=mult > 1)
        if mult > 1:
            signs = np.repeat(signs, rng.integers(1, mult + 1, len(signs)))
            signs = signs[rng.permutation(len(signs))]
        outs = [h.lookup(signs, dim, True) for h in hs]
        _eq(outs[0], outs[1])
        for o in outs[2:]:
            _same(outs[1], o, exact, row_dtype)
        grads = rng.normal(size=(len(signs), dim)).astype(np.float32)
        stray = rng.integers(1, 2**63, size=3, dtype=np.uint64)
        usigns = np.concatenate([signs, stray])
        ugrads = np.concatenate(
            [grads, rng.normal(size=(3, dim)).astype(np.float32)])
        for h in hs:
            h.update_gradients(usigns, ugrads, dim)
        evals = [h.lookup(universe, dim, False) for h in hs]
        _eq(evals[0], evals[1])
        for o in evals[2:]:
            _same(evals[1], o, exact, row_dtype)


def _assert_same_state(hs, universe, widths, tmp_path, exact=True,
                       row_dtype="fp32"):
    jn, tn = hs[:2]
    assert len({len(h) for h in hs}) == 1
    assert len({h.index_miss_count for h in hs}) == 1
    assert len({h.gradient_id_miss_count for h in hs}) == 1
    assert len({h.resident_bytes for h in hs}) == 1
    assert jn.arena_stats() == tn.arena_stats()
    assert jn.resident_emb_bytes == tn.resident_emb_bytes
    assert jn.resident_bytes_per_shard() == tn.resident_bytes_per_shard()
    for width in widths:
        got = [h.get_entries(universe, width) for h in hs]
        for found, vecs in got[1:]:
            np.testing.assert_array_equal(got[0][0], found)
        _eq(got[0][1], got[1][1])
        for _, vecs in got[2:]:
            _same(got[1][1], vecs, exact, row_dtype)
    blobs = [_dump(h, tmp_path) for h in hs]
    assert blobs[0] == blobs[1]
    if exact:
        assert blobs[1] == blobs[2] == blobs[3]
    else:
        (v1, r1), (v2, r2) = _records(blobs[1]), _records(blobs[2])
        assert v1 == v2 and [(s, d, len(v)) for s, d, v in r1] == [
            (s, d, len(v)) for s, d, v in r2]
        for (_, _, a), (_, _, b) in zip(r1, r2):
            _close(a, b, row_dtype)


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_random_traffic_matches_jax(row_dtype, opt, tmp_path):
    """Admission below 1, dims 8 and 4 interleaved, repeated signs at
    multiplicities 1-4, four feature groups for Adam's beta powers."""
    hs = _holders(1_000_000, row_dtype=row_dtype, opt=opt, admit=0.7,
                  prefix_bit=2)
    rng = np.random.default_rng(
        [ROW_DTYPES.index(row_dtype), sorted(OPTIMIZERS).index(opt)])
    universe = (rng.integers(1, 2**40, size=400, dtype=np.uint64)
                | (rng.integers(0, 4, size=400).astype(np.uint64)
                   << np.uint64(62)))
    exact = opt in EXACT_OPTIMIZERS
    _traffic(hs, rng, universe, rounds=6, batch=150, dims=(8, 8, 4),
             mult=4, exact=exact, row_dtype=row_dtype)
    _traffic(hs, rng, universe, rounds=3, batch=150, exact=exact,
             row_dtype=row_dtype)
    space = hs[3].optimizer.require_space
    _assert_same_state(hs, universe, (8 + space(8), 4 + space(4)), tmp_path,
                       exact, row_dtype)
    assert hs[1].row_nbytes(8) == hs[0].row_nbytes(8) == \
        hs[1]._rp.entry_nbytes(8, space(8))


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_row_budget_evicts_as_the_arena(row_dtype, tmp_path):
    """6 rows per internal shard against batches of ~80 signs with
    repeats: every batch evicts inside itself."""
    hs = _holders(24, row_dtype=row_dtype, admit=0.8)
    rng = np.random.default_rng(5)
    universe = rng.integers(1, 2**63, size=90, dtype=np.uint64)
    _traffic(hs, rng, universe, rounds=8, batch=40, dims=(8, 8, 4), mult=3)
    assert len(hs[1]) <= 24
    _assert_same_state(hs, universe, (16, 8), tmp_path)


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_byte_budget_and_entries(row_dtype, tmp_path):
    """``capacity_bytes`` evicts by the rows' logical bytes;
    ``set_entries`` / ``set_entry`` insert (evicting as they go),
    ``get_entries`` / ``get_entry`` read by width; specials survive."""
    row = tnative.NativeEmbeddingHolder(1, 1, row_dtype=row_dtype)._rp \
        .entry_nbytes(8, 8)
    hs = _holders(1_000_000, shards=2, row_dtype=row_dtype,
                  capacity_bytes=60 * row)
    rng = np.random.default_rng(8)
    universe = rng.integers(1, 2**63, size=200, dtype=np.uint64)
    vecs = rng.normal(size=(80, 16)).astype(np.float32)
    vecs[:3, :3] = [[np.inf, -0.0, 1e-40], [np.nan, 3e38, -1e-45],
                    [65504.0, 1.0 + 2.0**-8, -np.inf]]
    for h in hs:
        h.set_entries(universe[:80], 8, vecs)
    _assert_same_state(hs, universe, (16,), tmp_path)
    assert hs[1].resident_bytes <= 60 * row
    _traffic(hs, rng, universe, rounds=6, batch=30, mult=2)
    _assert_same_state(hs, universe, (16,), tmp_path)
    for h in hs:
        h.set_entry(int(universe[0]), 4, np.arange(8, dtype=np.float32))
    got = [h.get_entry(int(universe[0])) for h in hs]
    assert {g[0] for g in got} == {4}
    for g in got[1:]:
        _eq(got[0][1], g[1])
    assert hs[1].get_entry(12345) is None
    _assert_same_state(hs, universe, (16, 8), tmp_path)


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_psd_files_byte_equal_and_cross_load(row_dtype, tmp_path):
    """v1 for fp32 rows, v2 for half rows, byte-equal across the four
    holders; a JAX file loads into the port's store and the port's into
    the JAX store and the arena, each giving the same file again;
    ``load_file(clear=False)`` merges; ``clear`` empties."""
    from persia_tpu.ps.native import NativeEmbeddingHolder as JNative

    hs = _holders(1_000_000, row_dtype=row_dtype, opt="sgd")
    rng = np.random.default_rng(11)
    universe = rng.integers(1, 2**63, size=120, dtype=np.uint64)
    _traffic(hs, rng, universe, rounds=3, batch=60, dims=(8, 4), mult=2)
    paths = []
    for i, h in enumerate(hs[:2]):
        paths.append(str(tmp_path / f"{i}.psd"))
        h.dump_file(paths[-1])
    blob = (tmp_path / "0.psd").read_bytes()
    assert blob == (tmp_path / "1.psd").read_bytes() == hs[3].dump_bytes()
    assert blob[4:8] == (b"\x01\x00\x00\x00" if row_dtype == "fp32"
                         else b"\x02\x00\x00\x00")
    port = tnative.NativeEmbeddingHolder(1_000_000, 4, row_dtype=row_dtype)
    port.load_file(paths[0])
    jax_side = JNative(1_000_000, 4, row_dtype=row_dtype)
    jax_side.load_file(paths[1])
    arena = tarena.ArenaEmbeddingHolder(1_000_000, 4, row_dtype=row_dtype)
    arena.load_file(paths[1])
    assert _dump(port, tmp_path) == _dump(jax_side, tmp_path) == \
        arena.dump_bytes() == blob
    # a store of another precision reads it, as the JAX one does
    other = "fp32" if row_dtype != "fp32" else "fp16"
    a = tnative.NativeEmbeddingHolder(1_000_000, 4, row_dtype=other)
    b = JNative(1_000_000, 4, row_dtype=other)
    a.load_file(paths[0])
    b.load_file(paths[0])
    assert _dump(a, tmp_path) == _dump(b, tmp_path)
    assert len(a) == len(hs[1])
    extra = tnative.NativeEmbeddingHolder(1_000_000, 4, row_dtype=row_dtype)
    extra.set_entry(7, 4, np.ones(4, np.float32))
    extra.load_file(paths[0], clear=False)
    assert len(extra) == len(hs[1]) + 1
    port.clear()
    assert len(port) == 0 and _dump(port, tmp_path)[8:16] == bytes(8)


@pytest.mark.parametrize("opt", ["adam", "adagrad_shared"])
def test_native_differs_from_the_arena_in_rounding_only(opt, tmp_path):
    """The filed difference: under Adam and the shared Adagrad the C++
    store's rows are not the arena's bits, but agree within rounding
    (``ROUNDING_RTOL``). The causes: f32 ``1 - beta1`` against f64
    ``1 - beta1`` rounded to f32; an f64 sum of squares against numpy's
    f32 mean. The port's store is the JAX native store bit for bit."""
    assert np.float32(1.0) - np.float32(0.9) != np.float32(1.0 - 0.9)
    sq = np.random.default_rng(1).normal(size=(1000, 8)).astype(
        np.float32) ** 2
    assert (np.mean(sq, axis=1) != (sq.astype(np.float64).sum(axis=1)
                                    / 8).astype(np.float32)).any()
    hs = _holders(1_000_000, opt=opt)
    rng = np.random.default_rng(17)
    universe = rng.integers(1, 2**63, size=200, dtype=np.uint64)
    _traffic(hs, rng, universe, rounds=4, batch=100, exact=False)
    width = 8 + hs[3].optimizer.require_space(8)
    native, arena = (h.get_entries(universe, width)[1] for h in hs[1::2])
    assert (native.view(np.uint32) != arena.view(np.uint32)).any()
    _close(native, arena, "fp32")
    _assert_same_state(hs, universe, (width,), tmp_path, exact=False)


# --- the loader and make_holder ------------------------------------------


def test_library_is_built_by_the_port_from_native_src(tmp_path, monkeypatch):
    """The loaded library is ``_build/libpersia_native-<hash>.so``; the hash
    follows the sources; a failed build raises with the compiler's
    output; capabilities, policies' needs, the optimizer wire and the
    SIMD path are the JAX package's."""
    from persia_tpu.ps import native as jnative

    lib = tnative.load_native_lib()
    path = tnative.native_lib_path()
    assert lib._name == str(path) and path.parent == _build.BUILD_DIR
    assert path.parent == tnative.REPO_DIR / "persia_tpu_torch" / "_build"
    assert tnative.NATIVE_SRC_DIR == tnative.REPO_DIR / "native" / "src"
    src = tmp_path / "src"
    shutil.copytree(tnative.NATIVE_SRC_DIR, src)
    assert tnative.native_lib_path(src) == path
    (src / "store.h").write_text((src / "store.h").read_text() + "\n")
    assert tnative.native_lib_path(src) != path
    (src / "capi.cc").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "NATIVE_SRC_DIR", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="not C"):
        _build.compile_all(tnative.native_jobs())
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.undo()

    jlib = jnative.load_native_lib()
    assert tnative.native_capabilities() == \
        jnative.native_capabilities(jlib)
    assert "spill" in tnative.native_capabilities()
    for policy in ({}, {"row_dtype": "bf16"}, {"capacity_bytes": 4096},
                   {"row_dtype": "fp16", "capacity_bytes": 1},
                   {"spill_dir": "/spill"}):
        assert tnative.required_capabilities(**policy) == \
            jnative.required_capabilities(**policy)
    for cfg in OPTIMIZERS.values():
        for bit in (0, 3):
            assert tnative.optimizer_config_to_wire(cfg, bit) == \
                jnative.optimizer_config_to_wire(cfg, bit)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tnative.optimizer_config_to_wire({"type": "lamb"})
    assert tnative.native_simd_path() == jnative.native_simd_path(jlib)
    h = tnative.NativeEmbeddingHolder(1000, 4)
    assert h.releases_gil and h.simd_path == tnative.native_simd_path()
    assert h.parallel_info()["threads"] >= 1
    assert h.set_parallel(threads=2, min_batch=16)
    assert h.parallel_info() == {"threads": 2, "min_batch": 16}


@pytest.mark.parametrize("backend", [None, "auto", "native", "arena",
                                     "python-legacy"])
def test_make_holder_backend(backend):
    """``auto`` (and ``None``) and ``native`` give the native store,
    ``arena`` and ``python-legacy`` the Python holders; each serves a
    lookup."""
    want = {"arena": tarena.ArenaEmbeddingHolder,
            "python-legacy": TLegacy}.get(backend,
                                          tnative.NativeEmbeddingHolder)
    h = tnative.make_holder(1000, 2, backend=backend)
    assert type(h) is want
    assert (h.capacity, h.num_internal_shards) == (1000, 2)
    h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1})
    h.register_optimizer(OPTIMIZERS["sgd"])
    assert h.lookup(np.arange(1, 9, dtype=np.uint64), 4, True).any()
    assert len(h) == 8


def test_make_holder_policies_and_refusals():
    h = tnative.make_holder(1000, 2, row_dtype="bf16", capacity_bytes=4096)
    assert isinstance(h, tnative.NativeEmbeddingHolder)
    assert (h.row_dtype, h.capacity_bytes) == ("bf16", 4096)
    assert isinstance(tnative.make_holder(1000, 2, prefer_native=False),
                      tarena.ArenaEmbeddingHolder)
    with pytest.raises(ValueError, match="positive"):
        tnative.NativeEmbeddingHolder(10, 0)
    with pytest.raises(ValueError, match="row_dtype"):
        tnative.NativeEmbeddingHolder(10, 2, row_dtype="fp8")
    t = tnative.NativeEmbeddingHolder(10, 2)
    with pytest.raises(RuntimeError, match="optimizer"):
        t.lookup(np.array([1], np.uint64), 4, True)
    with pytest.raises(RuntimeError, match="optimizer"):
        t.update_gradients(np.array([1], np.uint64),
                           np.zeros((1, 4), np.float32), 4)
    with pytest.raises(ValueError, match="rejected"):
        t.register_optimizer({"type": "sgd", "lr": "fast"})
    with pytest.raises(ValueError, match="unknown PS backend"):
        tnative.make_holder(1000, 4, backend="rocksdb")


# --- the middleware kernels ----------------------------------------------


def _kernel_cases(rng):
    signs = rng.integers(0, 50, size=300).astype(np.uint64) * np.uint64(
        2**50 + 7)
    emb = rng.normal(size=(40, 8)).astype(np.float32)
    nnz = 200
    counts = rng.multinomial(nnz, np.ones(30) / 30).astype(np.int32)
    elem_sample = np.repeat(np.arange(30, dtype=np.int32), counts)
    elem_distinct = rng.integers(0, 40, size=nnz).astype(np.int32)
    scale = (1.0 / np.sqrt(np.maximum(counts, 1))).astype(np.float32)
    grad = rng.normal(size=(30, 8)).astype(np.float32)
    grad[3, 2], grad[7, 0], grad[9, 5] = np.nan, np.inf, -np.inf
    idx = rng.permutation(40)[:25].astype(np.int32)
    dup = rng.integers(0, 40, size=60).astype(np.int32)
    return dict(signs=signs, emb=emb, counts=counts, elem_sample=elem_sample,
                elem_distinct=elem_distinct, scale=scale, grad=grad, idx=idx,
                dup=dup, src=rng.normal(size=(60, 8)).astype(np.float32))


def _numpy_twin(kernel, c):
    """What the port's numpy middleware computes for each kernel."""
    if kernel == "dedup":
        d, inv = np.unique(c["signs"], return_inverse=True)
        return d, inv.astype(np.int32)
    if kernel == "sum_post":
        out = tmw._segment_sum(c["emb"][c["elem_distinct"]],
                               c["elem_sample"], 30)
        return (out * c["scale"][:, None],)
    if kernel == "sum_grad":
        g = np.nan_to_num(c["grad"], nan=0.0, posinf=0.0, neginf=0.0)
        g = (g * np.float32(0.5)) * c["scale"][:, None]
        return (tmw._segment_sum(g[c["elem_sample"]], c["elem_distinct"],
                                 40),)
    if kernel == "shard_order":
        from persia_tpu_torch.hashing import sign_to_shard

        shards = sign_to_shard(c["signs"], 3)
        order = np.argsort(shards, kind="stable").astype(np.int32)
        starts = np.searchsorted(shards[order], np.arange(4)).astype(
            np.uint32)
        return order, starts
    if kernel == "gather_rows":
        g = np.nan_to_num(c["grad"], nan=0.0, posinf=0.0, neginf=0.0)
        return (g[c["idx"] % 30] * np.float32(0.25),)
    dst = np.arange(40 * 8, dtype=np.float32).reshape(40, 8)
    if kernel == "scatter_rows":
        dst[c["idx"]] = c["src"][:25]
    else:
        np.add.at(dst, c["dup"], c["src"])
    return (dst,)


def _run_kernel(mod, kernel, c):
    if kernel == "dedup":
        return mod.dedup(c["signs"])
    if kernel == "sum_post":
        return (mod.sum_post(c["emb"], c["elem_distinct"], c["counts"], 30,
                             8, c["scale"]),)
    if kernel == "sum_grad":
        return (mod.sum_grad(c["grad"], c["elem_sample"], c["elem_distinct"],
                             40, 8, 0.5, c["scale"]),)
    if kernel == "shard_order":
        return mod.shard_order(c["signs"], 3)
    if kernel == "gather_rows":
        return (mod.gather_rows(c["grad"], c["idx"] % 30, 8,
                                filter_scale=0.25, filter_nonfinite=True),)
    dst = np.arange(40 * 8, dtype=np.float32).reshape(40, 8)
    if kernel == "scatter_rows":
        mod.scatter_rows(dst, c["idx"], c["src"][:25], 8)
    else:
        mod.scatter_add_rows(dst, c["dup"], c["src"], 8)
    return (dst,)


@pytest.mark.parametrize("kernel", ["dedup", "sum_post", "sum_grad",
                                    "shard_order", "gather_rows",
                                    "scatter_rows", "scatter_add_rows"])
def test_mw_kernel_matches_numpy_and_jax(kernel):
    """Bit for bit: the port's kernel, its numpy twin and the JAX
    package's kernel, on repeated signs, non-finite gradients and
    repeated scatter targets."""
    from persia_tpu.worker import mw_native as jmwn

    assert jmwn.available()
    c = _kernel_cases(np.random.default_rng(31))
    got = _run_kernel(tmwn, kernel, c)
    for want in (_numpy_twin(kernel, c), _run_kernel(jmwn, kernel, c)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_kernels_and_store_refuse_bad_shapes():
    """What the C++ side would read or write out of bounds is refused in
    Python first."""
    c = _kernel_cases(np.random.default_rng(32))
    dst = np.zeros((40, 8), np.float32)
    with pytest.raises(IndexError, match="idx"):
        tmwn.scatter_rows(dst, np.array([0, 40], np.int32),
                          np.zeros((2, 8), np.float32), 8)
    with pytest.raises(IndexError, match="idx"):
        tmwn.gather_rows(c["grad"], np.array([-1], np.int32), 8)
    with pytest.raises(ValueError, match="C-contiguous"):
        tmwn.scatter_add_rows(dst[:, :4], c["dup"], c["src"][:, :4], 4)
    with pytest.raises(ValueError, match="src"):
        tmwn.scatter_rows(dst, c["idx"], c["src"], 8)
    with pytest.raises(IndexError, match="elem_distinct"):
        tmwn.sum_post(c["emb"][:10], c["elem_distinct"], c["counts"], 30, 8,
                      None)
    with pytest.raises(ValueError, match="counts"):
        tmwn.sum_post(c["emb"], c["elem_distinct"], c["counts"][:-1], 29, 8,
                      None)
    with pytest.raises(ValueError, match="scale"):
        tmwn.sum_grad(c["grad"], c["elem_sample"], c["elem_distinct"], 40,
                      8, 1.0, c["scale"][:5])
    h = tnative.make_holder(100, 2)
    h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1})
    h.register_optimizer(OPTIMIZERS["sgd"])
    signs = np.arange(1, 5, dtype=np.uint64)
    with pytest.raises(ValueError, match="grads"):
        h.update_gradients(signs, np.zeros((4, 2), np.float32), 4)
    with pytest.raises(ValueError, match="vecs"):
        h.set_entries(signs, 4, np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="vec"):
        h.set_entry(1, 4, np.zeros(3, np.float32))
    assert len(h) == 0


def _mixed_schemas(t_hist=8):
    """seq_rec's slots with the profiles at dim 4 (two dims, so the
    streaming update plane ships early groups), plus a mean-pooled and a
    hash-stacked summed slot with sqrt scaling; every slot under its own
    feature-group prefix."""
    from persia_tpu import config as jcfg

    out = []
    for cfg in (jcfg, tcfg):
        slots = cfg.uniform_slots(["user_geo", "user_device"], dim=4)
        slots["recent_items"] = cfg.SlotConfig(
            name="recent_items", dim=8, embedding_summation=False,
            sample_fixed_size=t_hist)
        slots["recent_clicks"] = cfg.SlotConfig(
            name="recent_clicks", dim=8, pooling="last4")
        slots["target_item"] = cfg.SlotConfig(name="target_item", dim=8)
        slots["clicks_mean"] = cfg.SlotConfig(name="clicks_mean", dim=8,
                                              pooling="mean")
        slots["items_hashed"] = cfg.SlotConfig(
            name="items_hashed", dim=4, sqrt_scaling=True,
            hash_stack_config=cfg.HashStackConfig(hash_stack_rounds=2,
                                                  embedding_size=97))
        out.append(cfg.EmbeddingSchema(slots_config=slots,
                                       feature_index_prefix_bit=3))
    return out


def _mixed_batches(pkg, n, bs=24, seed=3):
    """seqrec batches with two more features, copies of the clicks and
    the history under other names."""
    gen = pkg.seqrec_batches(n * bs, bs, seed=seed,
                             spec=pkg.SeqRecSpec(item_vocab=3000, t_hist=8))
    for b in gen:
        feats = list(b.id_type_features)
        by = {f.name: f for f in feats}
        cls = type(feats[0])
        feats.append(cls.from_csr("clicks_mean", by["recent_clicks"].offsets,
                                  by["recent_clicks"].signs))
        feats.append(cls.from_csr("items_hashed", by["recent_items"].offsets,
                                  by["recent_items"].signs))
        yield feats


def _middleware_run(mw, schema, feats, replicas=3):
    """Every middleware function once over a batch, with seeded lookup
    rows and gradients (NaNs included, loss scale 4)."""
    pre = mw.preprocess_batch(feats, schema)
    groups = mw.shard_split(pre, schema, replicas)
    rng = np.random.default_rng(2)
    mats = mw.alloc_lookup_mats(pre, schema)
    for g in groups:
        mw.scatter_group(mats, g, rng.normal(
            size=(len(g.signs), g.dim)).astype(np.float32))
    post = [mw.postprocess_feature(f, schema.get_slot(f.name), m)
            for f, m in zip(pre, mats)]
    agg = []
    for f, p in zip(pre, post):
        grad = rng.normal(size=p.embeddings.shape).astype(np.float32)
        grad[0, 0] = np.nan
        agg.append(mw.aggregate_gradients(f, schema.get_slot(f.name), grad,
                                          loss_scale=4.0))
    ship = mw.shard_gradients(pre, schema, agg, replicas, groups=groups)
    return pre, groups, post, agg, ship


def test_middleware_kernels_equal_the_numpy_path(monkeypatch):
    """Every middleware function on mixed slots (raw, last-k, mean,
    hash-stacked with sqrt scaling, prefixed): with the kernels, with
    ``_mw_native`` patched to None, and the JAX middleware (its kernels),
    the same bits."""
    from persia_tpu.worker import middleware as jmw

    jschema, tschema = _mixed_schemas()
    for feats in _mixed_batches(tgen, 2):
        runs = [_middleware_run(tmw, tschema, feats),
                _middleware_run(jmw, jschema, feats)]
        with monkeypatch.context() as m:
            m.setattr(tmw, "_mw_native", lambda: None)
            runs.append(_middleware_run(tmw, tschema, feats))
        ref = runs[0]
        for pre, groups, post, agg, ship in runs[1:]:
            for x, y in zip(ref[0], pre):
                np.testing.assert_array_equal(x.distinct_signs,
                                              y.distinct_signs)
                np.testing.assert_array_equal(x.elem_distinct,
                                              y.elem_distinct)
            assert len(ref[1]) == len(groups)
            for x, y in zip(ref[1], groups):
                assert (x.shard, x.dim) == (y.shard, y.dim)
                np.testing.assert_array_equal(x.signs, y.signs)
                np.testing.assert_array_equal(x.distinct_idx, y.distinct_idx)
            for x, y in zip(ref[2], post):
                _eq(x.embeddings, y.embeddings)
            for x, y in zip(ref[3], agg):
                _eq(x, y)
            for x, y in zip(ref[4], ship):
                _eq(x[3], y[3])


# --- the worker ----------------------------------------------------------


class _Recording:
    """A holder that notes which threads called it."""

    def __init__(self, inner):
        self._inner = inner
        self.threads = set()

    def lookup(self, *a):
        self.threads.add(threading.current_thread().name)
        return self._inner.lookup(*a)

    def update_gradients(self, *a):
        self.threads.add(threading.current_thread().name)
        return self._inner.update_gradients(*a)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.parametrize("backend", ["native", "arena"])
@pytest.mark.parametrize("streaming", [True, False],
                         ids=["streaming", "serialized"])
def test_worker_matches_the_jax_worker(backend, streaming, tmp_path):
    """Over mixed seqrec batches on three PS shards: every lookup and the
    PS rows bit for bit against the JAX worker (its kernels, the same
    plane, holders of the same kind), with the PS calls on the fan-out
    pool's threads; ``lookup_signs`` and ``set_rows`` fan out too. (A
    shard's two groups, one a dim, run at once on both workers, so the
    rows' recency, the order of a dump's records, is not compared.)"""
    from persia_tpu.ps.arena import ArenaEmbeddingHolder as JArena
    from persia_tpu.ps.native import NativeEmbeddingHolder as JNative
    from persia_tpu.workloads import generator as jgen
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    jschema, tschema = _mixed_schemas()
    jcls = JNative if backend == "native" else JArena
    jw = JWorker(jschema, [jcls(1_000_000, 4) for _ in range(3)],
                 streaming=streaming)
    holders = [_Recording(tnative.make_holder(1_000_000, 4, backend=backend))
               for _ in range(3)]
    tw = TWorker(tschema, holders, streaming=streaming)
    assert tw._fanout is not None and tw._fanout._max_workers == 6
    rng = np.random.default_rng(14)
    try:
        for w in (jw, tw):
            w.configure_parameter_servers(
                "bounded_uniform", {"lower": -0.05, "upper": 0.05}, 0.9, 1.0)
            w.register_optimizer(OPTIMIZERS["adagrad"])
        for jf, tf in zip(_mixed_batches(jgen, 4), _mixed_batches(tgen, 4)):
            jref, jl = jw.lookup_direct_training(jf)
            tref, tl = tw.lookup_direct_training(tf)
            assert list(jl) == list(tl)
            for name in tl:
                _eq(jl[name].embeddings, tl[name].embeddings)
            grads = {n: rng.normal(size=r.embeddings.shape).astype(
                np.float32) for n, r in tl.items()}
            jw.update_gradients(jref, grads, loss_scale=2.0)
            tw.update_gradients(tref, grads, loss_scale=2.0)
        for jh, th in zip(jw.ps_clients, tw.ps_clients):
            (jv, jrows), (tv, trows) = (_records(_dump(h, tmp_path))
                                        for h in (jh, th._inner))
            assert jv == tv and len(jrows) == len(trows)
            trows = {s: (d, v) for s, d, v in trows}
            for s, d, v in jrows:
                assert trows[s][0] == d
                _eq(trows[s][1], v)
            assert th.threads and all(t.startswith("ps-fanout")
                                      for t in th.threads)
        signs = np.arange(1, 400, dtype=np.uint64)
        vecs = rng.normal(size=(len(signs), 8)).astype(np.float32)
        jw.set_rows(signs, vecs, 4)
        tw.set_rows(signs, vecs, 4)
        _eq(jw.lookup_signs(signs, 4), tw.lookup_signs(signs, 4))
        assert tw.staleness == 0 and not tw._post_forward_buffer
    finally:
        jw.close()
        tw.close()


class _FailsOnce(_Recording):
    """A holder whose first gradient update raises before touching
    anything; it counts the updates that reach the store."""

    def __init__(self, inner):
        super().__init__(inner)
        self.failed = False
        self.updates = 0

    def update_gradients(self, *a):
        if not self.failed:
            self.failed = True
            raise ConnectionError("PS restarting")
        self.updates += 1
        return super().update_gradients(*a)


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["streaming", "serialized"])
def test_a_retried_update_ships_only_the_groups_that_had_not_landed(
        streaming, tmp_path):
    """Shard 1 fails its first update while the other shards' groups land:
    the worker keeps the batch, and the retry by ``ref_id`` ships only the
    failed group, so every row equals a run without the failure."""
    schema = _mixed_schemas()[1]
    flaky = _FailsOnce(tnative.make_holder(100_000, 4))
    workers = [TWorker(schema, [tnative.make_holder(100_000, 4)
                                for _ in range(3)], streaming=streaming),
               TWorker(schema, [tnative.make_holder(100_000, 4), flaky,
                                tnative.make_holder(100_000, 4)],
                       streaming=streaming)]
    rng = np.random.default_rng(21)
    try:
        for w in workers:
            w.configure_parameter_servers(
                "bounded_uniform", {"lower": -0.05, "upper": 0.05}, 1.0, 1.0)
            w.register_optimizer(OPTIMIZERS["adagrad"])
        for step, feats in enumerate(_mixed_batches(tgen, 3)):
            grads = None
            for w in workers:
                ref, looked = w.lookup_direct_training(feats)
                if grads is None:
                    grads = {n: rng.normal(size=r.embeddings.shape).astype(
                        np.float32) for n, r in looked.items()}
                if step == 0 and w is workers[1]:
                    with pytest.raises(ConnectionError):
                        w.update_gradients(ref, grads)
                    assert w.staleness == 1
                w.update_gradients(ref, grads)
                assert w.staleness == 0
        # shard 1 holds a group for each dim: one failed, and was shipped
        # once more by the retry
        n_groups = {(g.shard, g.dim) for g in tmw.shard_split(
            tmw.preprocess_batch(next(_mixed_batches(tgen, 1)), schema),
            schema, 3)}
        assert flaky.updates == 3 * sum(s == 1 for s, _ in n_groups)
        for clean, retried in zip(*(w.ps_clients for w in workers)):
            (cv, crows), (rv, rrows) = (
                _records(_dump(getattr(h, "_inner", h), tmp_path))
                for h in (clean, retried))
            assert cv == rv and len(crows) == len(rrows)
            rrows = {s: (d, v) for s, d, v in rrows}
            for s, d, v in crows:
                assert rrows[s][0] == d
                _eq(rrows[s][1], v)
    finally:
        for w in workers:
            w.close()


def test_worker_without_a_pool_on_one_shard():
    """One PS shard: no pool, every call on the caller's thread."""
    holder = _Recording(tnative.make_holder(1000, 2))
    w = TWorker(_mixed_schemas()[1], [holder])
    assert w._fanout is None
    w.configure_parameter_servers("bounded_uniform",
                                  {"lower": -0.1, "upper": 0.1}, 1.0, 1.0)
    w.register_optimizer(OPTIMIZERS["sgd"])
    feats = next(_mixed_batches(tgen, 1))
    ref, lookup = w.lookup_direct_training(feats)
    w.update_gradients(ref, {n: np.ones_like(r.embeddings)
                             for n, r in lookup.items()})
    assert holder.threads == {threading.current_thread().name}
    w.close()


def test_stale_batches_expire_and_release_their_staleness():
    """Batches older than ``buffered_data_expired_sec`` leave both
    buffers at the next ``put_batch``; each looked-up one gives its
    staleness count back."""
    w = TWorker(_mixed_schemas()[1], [tnative.make_holder(1000, 2)
                                      for _ in range(2)],
                buffered_data_expired_sec=0.2)
    w.configure_parameter_servers("bounded_uniform",
                                  {"lower": -0.1, "upper": 0.1}, 1.0, 1.0)
    w.register_optimizer(OPTIMIZERS["sgd"])
    batches = list(_mixed_batches(tgen, 4))
    try:
        looked = [w.put_batch(b) for b in batches[:2]]
        for ref in looked:
            w.lookup(ref)
        pending = w.put_batch(batches[2])
        assert (w.staleness, len(w._forward_id_buffer),
                len(w._post_forward_buffer)) == (2, 1, 2)
        time.sleep(0.3)
        fresh = w.put_batch(batches[3])
        assert w.staleness == 0 and not w._post_forward_buffer
        assert list(w._forward_id_buffer) == [fresh]
        with pytest.raises(KeyError, match="post-forward"):
            w.update_gradients(looked[0], {})
        with pytest.raises(KeyError, match="forward buffer"):
            w.lookup(pending)
        w.lookup(fresh)
        assert w.staleness == 1
    finally:
        w.close()


def test_expiry_sweep_runs_without_traffic_and_close_stops_it():
    """A dead pipeline's batches expire by the sweep thread alone; a
    closed worker's sweep thread ends, and an unclosed worker can still
    be freed."""
    import gc
    import weakref

    w = TWorker(_mixed_schemas()[1], [tnative.make_holder(1000, 2)
                                      for _ in range(2)],
                buffered_data_expired_sec=0.05)
    w.configure_parameter_servers("bounded_uniform",
                                  {"lower": -0.1, "upper": 0.1}, 1.0, 1.0)
    w.register_optimizer(OPTIMIZERS["sgd"])
    w.lookup(w.put_batch(next(_mixed_batches(tgen, 1))))
    assert w.staleness == 1
    deadline = time.monotonic() + 5
    while w.staleness and time.monotonic() < deadline:
        time.sleep(0.05)
    assert w.staleness == 0 and not w._post_forward_buffer
    w.close()
    w._sweep_thread.join(timeout=5)
    assert not w._sweep_thread.is_alive()
    other = TWorker(_mixed_schemas()[1], [tnative.make_holder(1000, 2)])
    ref = weakref.ref(other)
    del other
    gc.collect()
    assert ref() is None
