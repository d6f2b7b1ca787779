"""The last public members of ported modules, against the JAX package's,
on the CPU (tolerance: equality throughout).

- ``ps/store.EvictionMap``: the JAX tests' scenarios (the reference's
  eviction order, a re-insert's refresh, the byte accounting) and a
  seeded run with a byte budget, on both maps side by side.
- ``worker/middleware``: ``scatter_lookup_results`` and
  ``DedupedFeature.num_raw_rows`` over the same preprocessed batch.
- ``worker/mw_native.available``.
- ``hashing.farmhash64``: JAX's scalar hash and the port's
  ``farmhash64_np`` on random u64.
- ``knobs``: every shared knob's ``doc`` and ``import_time_safe``, and
  ``render_markdown()``'s table rows, JAX's less its four plumbing knobs.
- ``worker/device_cache``: ``drop`` on ``SignSlotMap`` and
  ``TieredSignSlotMap`` after seeded assigns, and the assigns after it.
- ``ops/flash_attention.flash_attention``, ``ps/native.load_native_lib
  (build_if_missing=)``, ``PsClient(enable_tags=, legacy_frames=)`` and
  ``WorkerService(concurrent_streams=)``.
"""

import numpy as np
import pytest
import torch

from persia_tpu import knobs as jknobs
from persia_tpu_torch import knobs as tknobs

# ROADMAP §A: JAX/TPU process plumbing, not registered in the port
PLUMBING_KNOBS = {"PERSIA_FORCE_JAX_PLATFORM", "PERSIA_TEST_TPU",
                  "PERSIA_NATIVE_LIB", "PERSIA_NATIVE_SIMD"}


def _maps():
    from persia_tpu.ps.store import EvictionMap as J
    from persia_tpu_torch.ps.store import EvictionMap as T

    return J, T


def _entry(i, n=4):
    return np.full(n, float(i), dtype=np.float32)


def _reference_scenario(cls):
    m = cls(capacity=5)
    log = []
    for i in range(5):
        log.append(m.insert(i, 4, _entry(i)))
    log.append(len(m))
    for i in range(5, 10):
        log.append(m.insert(i, 4, _entry(i)))
    log += [len(m), m.get_refresh(4), m.get_refresh(5)]
    log.append(m.insert(10, 4, _entry(10)))
    log += [len(m), m.get_refresh(6), m.get_refresh(5)]
    return m, log


def _reinsert_scenario(cls):
    m = cls(capacity=2)
    log = [m.insert(1, 4, _entry(1)), m.insert(2, 4, _entry(2)),
           m.insert(1, 4, _entry(11)), m.insert(3, 4, _entry(3))]
    log += [m.get(2), m.get(1)]
    return m, log


def _bytes_scenario(cls):
    m = cls(capacity=10, byte_capacity=None, emb_itemsize=4)
    log = [m.insert(1, 4, np.zeros(8, np.float32)),
           (m.resident_bytes, m.emb_bytes)]
    log += [m.insert(1, 4, np.zeros(4, np.float32)),
            (m.resident_bytes, m.emb_bytes)]
    m.clear()
    log.append((m.resident_bytes, m.emb_bytes, len(m)))
    return m, log


def _budget_scenario(cls):
    """Seeded inserts of mixed widths under a row and a byte budget,
    with refreshes and half-width embeddings."""
    rng = np.random.default_rng(7)
    m = cls(capacity=40, byte_capacity=900, emb_itemsize=2)
    log = []
    for _ in range(300):
        sign = int(rng.integers(0, 60))
        if rng.random() < 0.3:
            log.append(m.get_refresh(sign))
            continue
        dim = int(rng.choice([2, 4, 8]))
        log.append(m.insert(sign, dim, _entry(sign, int(rng.integers(2, 24)))))
        log.append((len(m), m.resident_bytes, m.emb_bytes, sign in m))
    return m, log


def _same(a, b):
    """Structural equality of the scenarios' logs (arrays by value)."""
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("scenario", [
    _reference_scenario, _reinsert_scenario, _bytes_scenario,
    _budget_scenario], ids=["reference", "reinsert", "bytes", "budget"])
def test_eviction_map_matches_jax(scenario):
    J, T = _maps()
    (jm, jlog), (tm, tlog) = scenario(J), scenario(T)
    assert _same(tlog, jlog)
    assert _same(list(tm.items_in_lru_order()),
                 list(jm.items_in_lru_order()))
    assert (len(tm), tm.resident_bytes, tm.emb_bytes) == (
        len(jm), jm.resident_bytes, jm.emb_bytes)


def test_eviction_map_reference_order():
    """``tests/test_ps_store.py``'s reference scenario's assertions."""
    _, T = _maps()
    _, log = _reference_scenario(T)
    assert log[5] == 5 and log[11] == 5 and log[15] == 5
    assert log[12] is None and log[13] is not None
    assert [s for s, _ in log[14]] == [6]  # 6 was LRU: 5 was refreshed
    assert log[16] is None and log[17] is not None


def _schemas():
    from persia_tpu import config as jc
    from persia_tpu_torch import config as tc

    out = []
    for c in (jc, tc):
        out.append(c.EmbeddingSchema(slots_config={
            "a": c.SlotConfig(name="a", dim=2),
            "b": c.SlotConfig(name="b", dim=4),
            "raw": c.SlotConfig(
                name="raw", dim=4, embedding_summation=False,
                sample_fixed_size=3,
                hash_stack_config=c.HashStackConfig(hash_stack_rounds=2,
                                                    embedding_size=16)),
            "hs": c.SlotConfig(
                name="hs", dim=2, hash_stack_config=c.HashStackConfig(
                    hash_stack_rounds=3, embedding_size=5)),
        }, feature_index_prefix_bit=8))
    return out


def _features(batch_mod, seed=3):
    rng = np.random.default_rng(seed)
    feats = []
    for name in ("a", "b", "raw", "hs"):
        lil = [rng.integers(1, 40, size=rng.integers(0, 5)).astype(np.uint64)
               for _ in range(6)]
        feats.append(batch_mod.IDTypeFeature(name, lil))
    return feats


def test_scatter_lookup_results_and_num_raw_rows_match_jax():
    from persia_tpu.data import batch as jb
    from persia_tpu.worker import middleware as jmw
    from persia_tpu_torch.data import batch as tb
    from persia_tpu_torch.worker import middleware as tmw

    jschema, tschema = _schemas()
    jf = jmw.preprocess_batch(_features(jb), jschema)
    tf = tmw.preprocess_batch(_features(tb), tschema)
    assert [f.num_raw_rows for f in tf] == [f.num_raw_rows for f in jf]
    assert any(f.raw_row_of_distinct is not None
               and f.num_raw_rows < f.num_distinct for f in tf)
    jg = jmw.shard_split(jf, jschema, replica_size=3)
    tg = tmw.shard_split(tf, tschema, replica_size=3)
    rng = np.random.default_rng(5)
    results = [rng.standard_normal((len(g.signs), g.dim)).astype(np.float32)
               for g in tg]
    jmats = jmw.scatter_lookup_results(jf, jschema, jg, results)
    tmats = tmw.scatter_lookup_results(tf, tschema, tg, results)
    assert len(tmats) == len(jmats) == 4
    for t, j in zip(tmats, jmats):
        assert t.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(t, j)


def test_num_raw_rows_without_hashstack_and_empty():
    from persia_tpu.worker import middleware as jmw
    from persia_tpu_torch.worker import middleware as tmw

    for mw in (jmw, tmw):
        kw = dict(name="x", batch_size=2,
                  distinct_signs=np.array([3, 5, 9], np.uint64),
                  elem_sample=np.zeros(3, np.int32),
                  elem_col=np.arange(3, dtype=np.int32),
                  elem_distinct=np.arange(3, dtype=np.int32),
                  sample_num_signs=np.array([3, 0], np.int32))
        assert mw.DedupedFeature(**kw).num_raw_rows == 3
        assert mw.DedupedFeature(
            **kw, raw_row_of_distinct=np.zeros(0, np.int32)
        ).num_raw_rows == 0


def test_mw_native_available(monkeypatch):
    from persia_tpu_torch.worker import mw_native

    assert mw_native.available() is True

    def broken():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(mw_native, "_lib", broken)
    assert mw_native.available() is False


def test_farmhash64_matches_jax():
    from persia_tpu.hashing import farmhash64 as jfh
    from persia_tpu_torch.hashing import farmhash64, farmhash64_np

    rng = np.random.default_rng(11)
    signs = np.concatenate([
        rng.integers(0, 2**63, size=500, dtype=np.uint64) * np.uint64(2)
        + rng.integers(0, 2, size=500, dtype=np.uint64),
        np.array([0, 1, 2**64 - 1, 2**63, 0x9AE16A3B2F90404F], np.uint64)])
    got = [farmhash64(int(s)) for s in signs]
    assert got == [jfh(int(s)) for s in signs]
    assert got == [int(h) for h in farmhash64_np(signs)]
    assert all(0 <= h < 2**64 for h in got)


def test_knob_docs_and_flags_match_jax():
    assert set(jknobs.REGISTRY) - set(tknobs.REGISTRY) == PLUMBING_KNOBS
    assert set(tknobs.REGISTRY) <= set(jknobs.REGISTRY)
    for name, knob in tknobs.REGISTRY.items():
        want = jknobs.REGISTRY[name]
        assert (knob.type, knob.default, knob.doc, knob.import_time_safe) \
            == (want.type, want.default, want.doc, want.import_time_safe), \
            name
    assert [k.name for k in tknobs.all_knobs()] == sorted(tknobs.REGISTRY)
    assert sum(k.import_time_safe for k in tknobs.all_knobs()) >= 1


def _rows(text):
    return [line for line in text.splitlines()
            if line.startswith("| `PERSIA_")]


def test_render_markdown_rows_match_jax():
    text = tknobs.render_markdown()
    want = [r for r in _rows(jknobs.render_markdown())
            if r.split("`")[1] not in PLUMBING_KNOBS]
    assert _rows(text) == want and len(want) == len(tknobs.REGISTRY)
    assert "`persia_tpu_torch/knobs.py`" in text
    assert "| Knob | Type | Default | Description |" in text


def _slot_maps(kind):
    from persia_tpu.worker import device_cache as jdc
    from persia_tpu_torch.worker import device_cache as tdc

    if kind == "lru":
        return jdc.SignSlotMap(48), tdc.SignSlotMap(48)
    return (jdc.TieredSignSlotMap(48, window_frac=0.25, sketch_k=64),
            tdc.TieredSignSlotMap(48, window_frac=0.25, sketch_k=64))


def _assign_equal(jm, tm, signs):
    ja, ta = jm.assign(signs), tm.assign(signs)
    assert ta.n_unique == ja.n_unique
    for name in ja._fields:
        t, j = getattr(ta, name), getattr(ja, name)
        if name == "unique_slots":  # past n_unique: unwritten
            t, j = t[:ja.n_unique], j[:ja.n_unique]
        np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("kind", ["lru", "tiered"])
def test_drop_matches_jax(kind):
    jm, tm = _slot_maps(kind)
    rng = np.random.default_rng(13)
    for step in range(12):
        signs = rng.zipf(1.3, size=40).astype(np.uint64) % np.uint64(90)
        _assign_equal(jm, tm, signs)
        resident = tm.signs_and_slots()[0]
        drops = [int(s) for s in rng.choice(resident, size=5,
                                            replace=False)] + [10**6, 7]
        for s in drops:
            assert tm.drop(s) == jm.drop(s)
        assert len(tm) == len(jm)
        for a, b in zip(tm.signs_and_slots(), jm.signs_and_slots()):
            np.testing.assert_array_equal(np.sort(a), np.sort(b))
    assert tm.drop(10**6) is None


def test_flash_attention_is_the_unmasked_entry():
    from persia_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 8, 4, generator=g) for _ in range(3))
    for causal in (False, True):
        torch.testing.assert_close(
            fa.flash_attention(q, k, v, causal=causal),
            fa.flash_attention_masked(q, k, v, causal=causal),
            rtol=0, atol=0)


def test_load_native_lib_build_if_missing(monkeypatch, tmp_path):
    from persia_tpu_torch.ps import native

    lib = native.load_native_lib()
    assert native.load_native_lib(build_if_missing=False) is lib
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "native_lib_path",
                        lambda: tmp_path / "absent.so")
    assert native.load_native_lib(build_if_missing=False) is None


@pytest.mark.parametrize("enable_tags,legacy_frames",
                         [(True, False), (False, True), (False, False)])
def test_ps_client_framing_options(enable_tags, legacy_frames):
    """An untagged or legacy-framed client reads and writes rows as the
    default client does, against the same PS service."""
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.rpc import pack_arrays, pack_arrays_sg
    from persia_tpu_torch.service.ps_service import PsClient, PsService

    holder = EmbeddingHolder(capacity=1000, num_internal_shards=2)
    svc = PsService(holder)
    svc.server.serve_background()
    try:
        c = PsClient(svc.addr, enable_tags=enable_tags,
                     legacy_frames=legacy_frames, circuit_breaker=False)
        assert c._pack is (pack_arrays if legacy_frames else pack_arrays_sg)
        c.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1})
        c.register_optimizer({"type": "sgd", "lr": 0.5})
        signs = np.array([3, 9, 27], np.uint64)
        rows = c.lookup(signs, 4, True)
        c.update_gradients(signs, np.ones((3, 4), np.float32), 4)
        after = c.lookup(signs, 4, False)
        np.testing.assert_allclose(after, rows - 0.5, rtol=0, atol=1e-6)
        found, vecs = holder.get_entries(signs, 4)
        assert found.all()
        np.testing.assert_array_equal(vecs[:, :4], after)
        c.client.close()
    finally:
        svc.stop()


def test_worker_service_concurrent_streams():
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.service.worker_service import WorkerService
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    worker = EmbeddingWorker(
        EmbeddingSchema(slots_config=uniform_slots(["a"], dim=4)),
        [EmbeddingHolder(capacity=100, num_internal_shards=1)])
    for n in (WorkerService.CONCURRENT_STREAMS, 3):
        ws = WorkerService(worker, concurrent_streams=n)
        try:
            assert ws.server._concurrent_streams == n
        finally:
            ws.stop()
