"""The port's storage tier ladder against the JAX package, on the CPU:
``storage.PersiaPath``, the ``SpillStore`` (packet bytes, index, budget,
dump capture), the spill and hotness sketches of the arena, native and
per-entry holders, and the hotness snapshots.

Every holder case runs the same traffic through the JAX holder and the
port's of the same backend and requires equal lookups, spill counters and
dump bytes, bit for bit.
"""

import os

import numpy as np
import pytest

from persia_tpu import hotness as jhot
from persia_tpu.ps.arena import ArenaEmbeddingHolder as JArena
from persia_tpu.ps.native import NativeEmbeddingHolder as JNative
from persia_tpu.ps.spill import SpillStore as JSpill
from persia_tpu.ps.store import EmbeddingHolder as JLegacy
from persia_tpu_torch import hotness as thot
from persia_tpu_torch import storage as tstorage
from persia_tpu_torch.ps.arena import ArenaEmbeddingHolder as TArena
from persia_tpu_torch.ps.native import NativeEmbeddingHolder as TNative
from persia_tpu_torch.ps.native import make_holder
from persia_tpu_torch.ps.spill import SpillReadError, SpillStore
from persia_tpu_torch.ps.store import EmbeddingHolder as TLegacy
from persia_tpu_torch.storage import PersiaPath

DIM = 8
# backend -> (JAX holder, port holder, row dtypes it stores)
BACKENDS = {
    "arena": (JArena, TArena, ("fp32", "fp16", "bf16")),
    "native": (JNative, TNative, ("fp32", "fp16", "bf16")),
    "python-legacy": (JLegacy, TLegacy, ("fp32",)),
}
ADAGRAD = {"type": "adagrad", "lr": 0.1, "initialization": 0.01,
           "g_square_momentum": 1.0, "vectorwise_shared": False}


def _armed(cls, spill_dir, capacity=64, shards=4, row_dtype="fp32",
           hotness=None):
    kw = {} if row_dtype == "fp32" else {"row_dtype": row_dtype}
    h = cls(capacity, shards, spill_dir=spill_dir, hotness=hotness, **kw)
    h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1})
    h.register_optimizer(ADAGRAD)
    return h


def _pair(backend, tmp_path, **kw):
    """(JAX holder, port holder) of ``backend``, spill armed, each in its
    own spill directory."""
    jcls, tcls, _ = BACKENDS[backend]
    return (_armed(jcls, str(tmp_path / "jax_spill"), **kw),
            _armed(tcls, str(tmp_path / "port_spill"), **kw))


def _dump(h, path) -> bytes:
    if hasattr(h, "dump_bytes"):
        return h.dump_bytes()
    h.dump_file(str(path))
    return path.read_bytes()


def _cases():
    return [(b, rd) for b, (_, _, rds) in BACKENDS.items() for rd in rds]


# --- storage.PersiaPath -----------------------------------------------------


def test_persia_path_read_range(tmp_path):
    p = PersiaPath(str(tmp_path / "blob"))
    p.write_bytes(bytes(range(100)))
    assert p.read_range(0, 10) == bytes(range(10))
    assert p.read_range(90, 10) == bytes(range(90, 100))
    with pytest.raises(IOError):
        p.read_range(95, 10)  # a short read raises, never truncates


def test_persia_path_write_bytes_atomic(tmp_path):
    p = PersiaPath(str(tmp_path / "pkt"))
    p.write_bytes_atomic(b"first")
    assert p.read_bytes() == b"first"
    p.write_bytes_atomic(b"second-longer")
    assert p.read_bytes() == b"second-longer"
    assert not os.path.exists(str(tmp_path / "pkt.tmp"))
    assert p.exists() and PersiaPath(str(tmp_path)).listdir() == [p.path]
    p.remove()
    assert not p.exists()


def test_write_bytes_atomic_fsyncs_file_and_parent_dir(tmp_path,
                                                        monkeypatch):
    """The tmp file is fsynced before the rename and the parent directory
    after it."""
    synced = []
    real_fsync = os.fsync

    def spy_fsync(fd):
        synced.append(os.path.realpath(f"/proc/self/fd/{fd}"))
        return real_fsync(fd)

    monkeypatch.setattr(tstorage.os, "fsync", spy_fsync)
    target = tmp_path / "manifest.json"
    PersiaPath(str(target)).write_bytes_atomic(b"payload")
    assert target.read_bytes() == b"payload"
    assert len(synced) == 2
    assert synced[0].endswith("manifest.json.tmp")
    assert synced[1] == os.path.realpath(str(tmp_path))


def test_write_bytes_atomic_fsync_knob_off(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tstorage.os, "fsync", lambda fd: calls.append(fd))
    monkeypatch.setenv("PERSIA_FSYNC", "0")
    p = PersiaPath(str(tmp_path / "pkt"))
    p.write_bytes_atomic(b"x")
    assert p.read_bytes() == b"x"
    assert calls == []


# --- SpillStore ---------------------------------------------------------------


def _packets(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))
            if n.endswith(".pkt")}


def test_spill_round_trip_packets_equal_the_jax_store(tmp_path):
    """The same rows give the same packet files, byte for byte, and read
    back bit-identical."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = JSpill(str(tmp_path / "j"), packet_bytes=256)
    t = SpillStore(str(tmp_path / "t"), packet_bytes=256)
    rows = {i: np.arange(16, dtype=np.float32) + i for i in range(40)}
    for sign, vec in rows.items():
        j.put(sign, DIM, vec)
        t.put(sign, DIM, vec)
    signs = np.arange(100, 110, dtype=np.uint64)
    half = np.arange(10 * 20, dtype=np.uint8).reshape(10, 20)
    j.put_batch(signs, 4, half)
    t.put_batch(signs, 4, half)
    j.flush()
    t.flush()
    assert t.stats()["spill_packets"] > 1
    assert _packets(tmp_path / "t") == _packets(tmp_path / "j")
    assert t.stats() == j.stats()
    assert t.contains_batch(np.array([0, 39, 105, 999], np.uint64)).tolist() \
        == [True, True, True, False]
    for sign, vec in rows.items():
        dim, raw = t.take(sign)
        assert dim == DIM
        np.testing.assert_array_equal(raw.view(np.float32), vec)
    dim, raw = t.peek(103)
    assert dim == 4 and raw.tobytes() == half[3].tobytes()
    for s in signs.tolist():
        t.take(s)
    assert len(t) == 0
    assert t.stats()["spill_disk_bytes"] == 0  # drained packets reclaimed


def test_spill_staged_rows_are_readable_before_flush(tmp_path):
    s = SpillStore(str(tmp_path))
    s.put(7, DIM, np.full(16, 3.5, np.float32))
    dim, raw = s.take(7)
    assert dim == DIM
    np.testing.assert_array_equal(raw.view(np.float32),
                                  np.full(16, 3.5, np.float32))


def test_spill_partial_write_cleanup(tmp_path):
    (tmp_path / "spill_00000001.pkt.tmp").write_bytes(b"torn")
    s = SpillStore(str(tmp_path))
    assert not (tmp_path / "spill_00000001.pkt.tmp").exists()
    assert len(s) == 0


def test_spill_missing_file_raises_typed_error(tmp_path):
    s = SpillStore(str(tmp_path), packet_bytes=1)  # a packet a put
    s.put(5, DIM, np.arange(16, dtype=np.float32))
    s.flush()
    pkt = [p for p in os.listdir(tmp_path) if p.endswith(".pkt")]
    assert pkt
    os.remove(tmp_path / pkt[0])
    with pytest.raises(SpillReadError):
        s.take(5)
    assert 5 in s  # the index is left intact


def test_spill_restart_sweeps_stale_packets(tmp_path):
    s = SpillStore(str(tmp_path), packet_bytes=1)
    s.put(5, DIM, np.arange(16, dtype=np.float32))
    s.flush()
    assert [p for p in os.listdir(tmp_path) if p.endswith(".pkt")]
    s2 = SpillStore(str(tmp_path))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".pkt")]
    assert len(s2) == 0 and s2.stats()["spill_disk_bytes"] == 0


def test_spill_dump_capture_preserves_migrating_rows(tmp_path):
    s = SpillStore(str(tmp_path), packet_bytes=1)
    v5 = np.arange(16, dtype=np.float32)
    v6 = np.arange(16, dtype=np.float32) + 100
    s.put(5, DIM, v5)
    s.put(6, DIM, v6)
    s.flush()
    s.start_dump_capture()
    s.take(5)
    s.discard(6)
    cap = s.stop_dump_capture()
    assert set(cap) == {5, 6}
    np.testing.assert_array_equal(cap[5][1].view(np.float32), v5)
    np.testing.assert_array_equal(cap[6][1].view(np.float32), v6)
    s.put(7, DIM, v5)
    s.take(7)
    assert s.stop_dump_capture() == {}


def test_spill_budget_drops_oldest_packets_as_the_jax_store(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    row = np.arange(64, dtype=np.float32)  # 256 B a row
    j = JSpill(str(tmp_path / "j"), max_bytes=2048, packet_bytes=512)
    s = SpillStore(str(tmp_path / "t"), max_bytes=2048, packet_bytes=512)
    for sign in range(40):
        j.put(sign, DIM, row + sign)
        s.put(sign, DIM, row + sign)
    j.flush()
    s.flush()
    st = s.stats()
    assert st == j.stats()
    assert st["spill_disk_bytes"] <= 2048 + 1024
    assert st["spill_dropped_rows"] > 0
    assert s.take(0) is None
    dim, raw = s.take(39)
    np.testing.assert_array_equal(raw.view(np.float32), row + 39)


# --- holders ----------------------------------------------------------------


@pytest.mark.parametrize("backend,row_dtype", _cases())
def test_holder_spill_traffic_equals_jax(backend, row_dtype, tmp_path):
    """Eviction traffic with repeated signs, gradient updates and eval
    lookups: every lookup, the spill counters, the length and the dump
    bytes equal the JAX holder's."""
    j, t = _pair(backend, tmp_path, row_dtype=row_dtype)
    rng = np.random.default_rng(0)
    for step in range(12):
        signs = rng.integers(0, 500, size=120).astype(np.uint64)
        if step % 3 == 0:
            signs = np.unique(signs)
        np.testing.assert_array_equal(t.lookup(signs, DIM, True),
                                      j.lookup(signs, DIM, True))
        grads = rng.standard_normal((len(signs), DIM)).astype(np.float32)
        j.update_gradients(signs, grads, DIM)
        t.update_gradients(signs, grads, DIM)
        probe = rng.integers(0, 600, size=50).astype(np.uint64)
        np.testing.assert_array_equal(t.lookup(probe, DIM, False),
                                      j.lookup(probe, DIM, False))
    stats = t.spill_stats()
    assert stats == j.spill_stats()
    assert stats["spilled_rows"] > 0 and stats["spill_fault_ins_total"] > 0
    assert len(t) == len(j)
    assert _dump(t, tmp_path / "t.psd") == _dump(j, tmp_path / "j.psd")
    found_j, vecs_j = j.get_entries(np.arange(600, dtype=np.uint64),
                                    DIM + DIM)
    found_t, vecs_t = t.get_entries(np.arange(600, dtype=np.uint64),
                                    DIM + DIM)
    np.testing.assert_array_equal(found_t, found_j)
    np.testing.assert_array_equal(vecs_t, vecs_j)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_holder_spill_fault_in_parity(backend, tmp_path):
    j, t = _pair(backend, tmp_path)
    rng = np.random.default_rng(0)
    signs = rng.choice(10_000, size=1500, replace=False).astype(np.uint64)
    first = t.lookup(signs, DIM, training=True)
    np.testing.assert_array_equal(first, j.lookup(signs, DIM, True))
    assert t.spill_stats()["spilled_rows"] > 1000
    assert len(t) == len(signs)  # one logical table
    again = t.lookup(signs, DIM, training=True)
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(again, j.lookup(signs, DIM, True))
    assert t.spill_stats()["spill_fault_ins_total"] > 0
    assert t.spill_stats() == j.spill_stats()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_holder_gradient_update_faults_spilled_rows_in(backend, tmp_path):
    """No update falls through the ladder. The arena holders fault a
    shard's spilled signs in before one batched optimizer call, so there
    the signs of one call must fit the shard's capacity (8 rows here); an
    update of all 400 signs misses the same rows in both packages."""
    j, t = _pair(backend, tmp_path, capacity=32)
    signs = np.arange(1, 401, dtype=np.uint64)
    for h in (j, t):
        h.lookup(signs, DIM, training=True)
    miss0 = t.gradient_id_miss_count
    upd = signs[:12] if backend == "arena" else signs
    grads = np.ones((len(upd), DIM), np.float32)
    j.update_gradients(upd, grads, DIM)
    t.update_gradients(upd, grads, DIM)
    assert t.gradient_id_miss_count == miss0
    if backend == "arena":
        grads = np.ones((len(signs), DIM), np.float32)
        j.update_gradients(signs, grads, DIM)
        t.update_gradients(signs, grads, DIM)
        assert t.gradient_id_miss_count == j.gradient_id_miss_count > 0
    out = t.lookup(signs[:8], DIM, training=False)
    assert np.isfinite(out).all() and (out != 0).any()
    np.testing.assert_array_equal(out, j.lookup(signs[:8], DIM, False))
    assert t.spill_stats() == j.spill_stats()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_holder_eval_lookup_peeks_without_promotion(backend, tmp_path):
    j, t = _pair(backend, tmp_path, capacity=32)
    signs = np.arange(1, 301, dtype=np.uint64)
    for h in (j, t):
        h.lookup(signs, DIM, training=True)
    before = t.spill_stats()
    assert before["spilled_rows"] > 0
    out = t.lookup(signs[:50], DIM, training=False)
    assert (np.abs(out).sum(axis=1) > 0).all()
    np.testing.assert_array_equal(out, j.lookup(signs[:50], DIM, False))
    assert t.spill_stats() == before  # residency unchanged
    dim, vec = t.get_entry(int(signs[0]))  # reads through, peeking
    assert dim == DIM
    np.testing.assert_array_equal(vec, j.get_entry(int(signs[0]))[1])
    assert t.spill_stats() == before


@pytest.mark.parametrize("backend,row_dtype", [
    (b, rd) for b, rd in _cases() if rd != "fp32"])
def test_holder_half_precision_spill_round_trip(backend, row_dtype,
                                                tmp_path):
    j, t = _pair(backend, tmp_path, capacity=32, row_dtype=row_dtype)
    signs = np.arange(1, 501, dtype=np.uint64)
    first = t.lookup(signs, DIM, training=True)
    again = t.lookup(signs, DIM, training=True)
    np.testing.assert_array_equal(first, again)
    j.lookup(signs, DIM, True)
    np.testing.assert_array_equal(again, j.lookup(signs, DIM, True))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_holder_checkpoint_sees_one_logical_table(backend, tmp_path):
    j, t = _pair(backend, tmp_path, capacity=48)
    signs = np.arange(1, 801, dtype=np.uint64)
    for h in (j, t):
        h.lookup(signs, DIM, training=True)
        h.update_gradients(signs[:200],
                           np.full((200, DIM), 0.5, np.float32), DIM)
    buf = _dump(t, tmp_path / "t.psd")
    assert buf == _dump(j, tmp_path / "j.psd")
    fresh = TLegacy(capacity=10_000, num_internal_shards=4)
    fresh.load_bytes(buf)
    assert len(fresh) == len(t) == len(signs)
    for s in (1, 100, 500, 800):
        np.testing.assert_array_equal(fresh.get_entry(s)[1],
                                      t.get_entry(s)[1])
    t.clear()
    assert len(t) == 0 and t.spill_stats()["spilled_rows"] == 0


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_holder_load_past_capacity_spills(backend, tmp_path):
    """A dump holding more rows than the store's capacity loads with the
    overflow demoted to the spill tier, so no row is lost."""
    j, t = _pair(backend, tmp_path, capacity=48)
    signs = np.arange(1, 401, dtype=np.uint64)
    for h in (j, t):
        h.lookup(signs, DIM, training=True)
    path = tmp_path / "dump.psd"
    path.write_bytes(_dump(t, tmp_path / "t.psd"))
    _, tcls, _ = BACKENDS[backend]
    fresh = _armed(tcls, str(tmp_path / "fresh_spill"), capacity=48)
    fresh.load_file(str(path))
    assert len(fresh) == len(signs)
    assert fresh.spill_stats()["spilled_rows"] == len(signs) - 48
    np.testing.assert_array_equal(fresh.lookup(signs, DIM, False),
                                  t.lookup(signs, DIM, False))


@pytest.mark.parametrize("backend", ["arena", "python-legacy"])
def test_holder_dump_keeps_row_faulted_in_mid_dump(backend, tmp_path):
    """A spilled row faulted out of the spill index while the dump walks
    the spill tier lands in the dump through the capture."""
    _, t = _pair(backend, tmp_path)
    signs = np.arange(1, 301, dtype=np.uint64)
    t.lookup(signs, DIM, training=True)
    t.spill.flush()
    spilled = [s for s in signs.tolist() if s in t.spill]
    assert len(spilled) > 1
    probe = spilled[-1]
    want_dim, want = t.spill.peek(probe)
    orig_items = t.spill.items

    def racing_items():
        gen = orig_items()
        first = next(gen)
        t.spill.take(probe)  # a fault-in during the spill pass
        yield first
        yield from gen

    t.spill.items = racing_items
    buf = t.dump_bytes()
    fresh = TLegacy(capacity=100_000, num_internal_shards=2)
    fresh.load_bytes(buf)
    assert len(fresh) == len(signs)
    got = fresh.get_entry(probe)
    assert got is not None and got[0] == want_dim
    np.testing.assert_array_equal(got[1], want.view(np.float32))


def test_make_holder_arms_spill_and_hotness_on_every_backend(tmp_path):
    for backend, cls in (("native", TNative), ("arena", TArena),
                         ("python-legacy", TLegacy)):
        h = make_holder(100, 2, backend=backend, hotness=True,
                        spill_dir=str(tmp_path / backend), spill_bytes=4096)
        assert type(h) is cls
        assert h.spill is not None and h.spill.max_bytes == 4096
        assert h.hotness is not None
        assert h.spill_stats()["spilled_rows"] == 0
    unarmed = make_holder(100, 2)
    assert unarmed.spill is None and unarmed.spill_stats() == {}
    assert unarmed.hotness_snapshot() == thot.disabled_snapshot()
    # the per-entry holder takes half rows and a byte budget as well
    half = make_holder(100, 2, backend="python-legacy", row_dtype="bf16",
                       capacity_bytes=4096, spill_dir=str(tmp_path / "half"))
    assert type(half) is TLegacy and half.spill is not None
    assert (half.row_dtype, half.capacity_bytes) == ("bf16", 4096)


# --- hotness ------------------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_hotness_snapshot_equals_jax(backend, tmp_path):
    j, t = _pair(backend, tmp_path, capacity=10_000, hotness=True)
    rng = np.random.default_rng(3)
    for _ in range(6):
        # zipfian ids over two tables
        for dim in (DIM, 4):
            signs = (rng.zipf(1.3, size=400) % 3000).astype(np.uint64)
            j.lookup(signs, dim, True)
            t.lookup(signs, dim, True)
    snap = t.hotness_snapshot()
    assert snap == j.hotness_snapshot()
    assert snap["enabled"] and snap["total"] == 6 * 2 * 400
    assert set(snap["tables"]) == {str(DIM), "4"}
    assert thot.top_rows(snap["tables"]["4"], 3) == \
        jhot.top_rows(snap["tables"]["4"], 3)


def test_merge_snapshots_equals_jax():
    rng = np.random.default_rng(5)
    snaps_t, snaps_j = [], []
    for replica in range(3):
        tt = thot.HotnessTracker(4, topk=16, cm_width=256, cm_depth=3)
        jt = jhot.HotnessTracker(4, topk=16, cm_width=256, cm_depth=3)
        for _ in range(5):
            signs = (rng.zipf(1.2, size=300) + replica).astype(np.uint64)
            tt.observe(8, signs)
            jt.observe(8, signs)
        snaps_t.append(tt.snapshot())
        snaps_j.append(jt.snapshot())
    assert snaps_t == snaps_j
    merged = thot.merge_snapshots(snaps_t + [thot.disabled_snapshot()])
    assert merged == jhot.merge_snapshots(snaps_j)
    assert merged["total"] == 3 * 5 * 300
    # commutative
    assert thot.merge_snapshots(snaps_t[::-1]) == merged
    with pytest.raises(ValueError, match="geometry"):
        thot.merge_snapshots([snaps_t[0], thot.HotnessTracker(
            4, topk=8, cm_width=256, cm_depth=3).snapshot() | {
                "enabled": True}])


def test_make_tracker_follows_the_knob(monkeypatch):
    assert thot.make_tracker(4) is None
    monkeypatch.setenv("PERSIA_HOTNESS", "1")
    tr = thot.make_tracker(4)
    assert isinstance(tr, thot.HotnessTracker)
    assert (tr.topk, tr.cm_width, tr.cm_depth) == (512, 8192, 4)
    monkeypatch.setenv("PERSIA_HOTNESS_TOPK", "32")
    assert thot.make_tracker(4).topk == 32
    assert thot.make_tracker(4, enabled=False) is None
