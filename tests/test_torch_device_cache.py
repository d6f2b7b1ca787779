"""The port's hot-row device cache against the JAX package, on the CPU.

- Mappers: the port's ``SignSlotMap``, ``NativeSignSlotMap`` (its own
  binding of ``ptcm_*``) and ``TieredSignSlotMap`` against the JAX
  package's on seeded Zipf streams: every ``AssignResult`` field and
  every counter bit-equal; a batch of more distinct signs than the
  capacity raises and leaves the map as it was; the eviction of sign 0
  is reported by the mask; tiered promotion. ``VictimBuffer``'s tokens.
- Steps: ``make_cached_train_step``, ``make_cached_bag_train_step`` and
  ``make_cached_eval_step`` against JAX's, from flax weights carried
  across by ``load_flax_params``, on the same mapped inputs: losses,
  predictions, both cache tensors, the evicted rows and the dense
  parameters within 1e-5 (f32, the same math in another summation order,
  through an Adagrad that divides by each gradient's own size).
- Engine: ``DeviceCacheEngine.prepare`` / ``prepare_bags`` byte-equal to
  JAX's over equally seeded PS holders, through evictions, write-backs
  and victim-buffer reads; ``flush_all`` and ``invalidate``.
- End to end, the JAX test's setup (``tests/test_device_cache.py``): the
  port cached against JAX cached, losses and flushed PS rows within 1e-5;
  the port cached against the port uncached (f32 wire) within 1e-3, the
  JAX test's own bound, with and without eviction churn, single-id and
  bags; ``eval_ctx`` flushes, ``load_checkpoint`` invalidates, a cached
  run resumed from a snapshot equals the unbroken one bit for bit
  (deterministic algorithms on), a ``DataLoader`` over a cached context
  equals the synchronous run; the envelope's refusals; over a mesh whose
  ranks span two hosts the cache is negotiated off, or refused.
- One ``gpu`` test: cached against uncached on the card (``python -m
  pytest tests/test_torch_device_cache.py -m gpu --noconftest``).
"""

import logging

import numpy as np
import pytest
import torch

from persia_tpu_torch import config as tcfg
from persia_tpu_torch.data import batch as tbatch
from persia_tpu_torch.ps.store import EmbeddingHolder as THolder
from persia_tpu_torch.worker import device_cache as tdc
from persia_tpu_torch.worker.worker import EmbeddingWorker as TWorker

DIM = 8
NUM_SLOTS = 4
NUM_DENSE = 13
SLOTS = [f"s{i}" for i in range(NUM_SLOTS)]
LR = 0.05
STEP_TOL = 1e-5  # the port against the JAX package
CACHE_TOL = 1e-3  # cached against uncached (the JAX test's bound)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


# --- mappers ---------------------------------------------------------------


def _zipf_stream(n_batches, size, vocab, seed, a=1.3):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield (rng.zipf(a, size=size) % vocab).astype(np.uint64)


def _mapper_pair(kind, capacity):
    from persia_tpu.worker import device_cache as jdc

    if kind == "python":
        return jdc.SignSlotMap(capacity), tdc.SignSlotMap(capacity)
    if kind == "native":
        return jdc.NativeSignSlotMap(capacity), tdc.NativeSignSlotMap(capacity)
    return (jdc.TieredSignSlotMap(capacity, window_frac=0.25, sketch_k=64),
            tdc.TieredSignSlotMap(capacity, window_frac=0.25, sketch_k=64))


def _assert_same_assign(jr, tr):
    for name in ("slots", "miss_pos", "evicted_signs", "evicted_mask",
                 "inverse"):
        j, t = getattr(jr, name), getattr(tr, name)
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert tr.n_unique == jr.n_unique
    np.testing.assert_array_equal(tr.unique_slots[:tr.n_unique],
                                  jr.unique_slots[:jr.n_unique])


def _counters(m):
    return (m.hits, m.misses, m.evictions, getattr(m, "promotions", 0),
            len(m))


@pytest.mark.parametrize("kind", ["python", "native", "tiered"])
def test_mapper_matches_jax(kind):
    """60 batches of 30 Zipf signs over 120 values through a 50-slot map:
    hits, misses, evictions with duplicates in a batch."""
    jm, tm = _mapper_pair(kind, 50)
    evicted = 0
    for signs in _zipf_stream(60, 30, 120, seed=7):
        jr, tr = jm.assign(signs), tm.assign(signs)
        _assert_same_assign(jr, tr)
        assert _counters(tm) == _counters(jm)
        evicted += int(tr.evicted_mask.sum())
    assert evicted > 50 and tm.hit_rate == jm.hit_rate > 0.3
    (js, jsl), (ts, tsl) = jm.signs_and_slots(), tm.signs_and_slots()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tsl, jsl)


def test_native_mapper_equals_its_python_twin():
    """The C++ mapper is the Python one bit for bit, slot numbers
    included, on a longer stream at a larger capacity."""
    nat, py = tdc.NativeSignSlotMap(400), tdc.SignSlotMap(400)
    for signs in _zipf_stream(40, 500, 3000, seed=3, a=1.2):
        _assert_same_assign(py.assign(signs), nat.assign(signs))
        assert _counters(nat) == _counters(py)
    assert nat.evictions > 1000
    (ps, psl), (ns, nsl) = py.signs_and_slots(), nat.signs_and_slots()
    assert dict(zip(ps.tolist(), psl.tolist())) == \
        dict(zip(ns.tolist(), nsl.tolist()))


@pytest.mark.parametrize("kind", ["python", "native", "tiered"])
def test_oversized_batch_leaves_state_intact(kind):
    """More distinct signs than slots raise ValueError in both packages
    and change nothing: a half-applied assign would map signs to slots
    whose rows were never imported."""
    jm, tm = _mapper_pair(kind, 4)
    for m in (jm, tm):
        m.assign(np.array([10, 11], np.uint64))
    before = [(_counters(m), m.signs_and_slots()) for m in (jm, tm)]
    for m in (jm, tm):
        with pytest.raises(ValueError, match="capacity"):
            m.assign(np.array([1, 2, 3, 4, 5], np.uint64))
    for m, (counters, (signs, slots)) in zip((jm, tm), before):
        assert _counters(m) == counters
        s2, sl2 = m.signs_and_slots()
        np.testing.assert_array_equal(s2, signs)
        np.testing.assert_array_equal(sl2, slots)
    # many duplicates but few distinct signs fit (n > capacity)
    for batch in ([7, 7, 7, 7, 8, 8], [10, 7]):
        jr, tr = (m.assign(np.array(batch, np.uint64)) for m in (jm, tm))
        _assert_same_assign(jr, tr)
    assert _counters(tm) == _counters(jm)
    assert tm.evictions == 0 and tm.misses == 4


@pytest.mark.parametrize("kind", ["python", "native", "tiered"])
def test_eviction_of_sign_zero_is_masked(kind):
    """Sign 0 is a legal sign: its eviction is reported by the mask."""
    jm, tm = _mapper_pair(kind, 2)
    results = []
    for batch in ([0, 5], [5], [9]):
        jr, tr = (m.assign(np.array(batch, np.uint64)) for m in (jm, tm))
        _assert_same_assign(jr, tr)
        results.append(tr)
    last = results[-1]
    assert last.evicted_signs.tolist() == [0]
    assert last.evicted_mask.tolist() == [True]
    assert not results[0].evicted_mask.any()


def test_tiered_promotion_matches_jax(monkeypatch):
    """The hotness mapper's window and protected region under a hot set
    plus one-touch cold traffic, with the window and sketch from the
    knobs: promotions happen, and every field and counter agrees."""
    from persia_tpu.worker import device_cache as jdc

    monkeypatch.setenv("PERSIA_TIER_WINDOW_FRAC", "0.2")
    monkeypatch.setenv("PERSIA_TIER_SKETCH_TOPK", "128")
    jm, tm = jdc.TieredSignSlotMap(60), tdc.TieredSignSlotMap(60)
    assert (tm.window_cap, tm.hot_cap) == (jm.window_cap, jm.hot_cap) \
        == (12, 48)
    rng = np.random.default_rng(5)
    cold = 10_000
    for step in range(80):
        hot = (rng.zipf(1.1, size=20) % 80).astype(np.uint64)
        one_touch = np.arange(cold, cold + 10, dtype=np.uint64)
        cold += 10
        signs = np.concatenate([hot, one_touch])
        if step == 40:  # the hot set moves
            signs = signs + np.uint64(500)
        jr, tr = jm.assign(signs), tm.assign(signs)
        _assert_same_assign(jr, tr)
        assert _counters(tm) == _counters(jm)
    assert tm.promotions > 10 and tm.evictions > 500


def test_make_sign_slot_map_has_no_python_stand_in(monkeypatch):
    assert isinstance(tdc.make_sign_slot_map(8), tdc.NativeSignSlotMap)
    assert isinstance(tdc.make_sign_slot_map(8, "hotness"),
                      tdc.TieredSignSlotMap)
    with pytest.raises(ValueError, match="admission"):
        tdc.make_sign_slot_map(8, "lfu")

    def broken():
        raise RuntimeError("the native library did not build")

    monkeypatch.setattr(tdc, "_bound", None)
    monkeypatch.setattr(tdc, "load_native_lib", broken)
    with pytest.raises(RuntimeError, match="did not build"):
        tdc.make_sign_slot_map(8)
    with pytest.raises(ValueError):
        tdc.SignSlotMap(0)
    with pytest.raises(ValueError):
        tdc.TieredSignSlotMap(1)


def test_victim_buffer_tokens_match_jax():
    """The port's batched forms against the JAX buffer's single-sign put /
    take / peek_if / take_if: a stale job can neither read nor steal a
    newer eviction's entry, sign 0 is a key like any other; then a random
    interleaving of evictions, misses and write-backs with repeated signs
    and stale tokens."""
    from persia_tpu.worker.device_cache import VictimBuffer as JVictims

    j, t = JVictims(), tdc.VictimBuffer()
    for v in (j, t):
        (v.put_many([5], ["old"], token=1) if v is t
         else v.put(5, "old", token=1))
        (v.put_many([5], ["new"], token=2) if v is t
         else v.put(5, "new", token=2))
    assert t.peek_if_many([5], 1) == [j.peek_if(5, 1)] == [None]
    assert t.take_if_many([5], 1) == 0 and j.take_if(5, 1) is None
    assert t.peek_if_many([5], 2) == [j.peek_if(5, 2)] == ["new"]
    assert t.take_if_many([5], 2) == 1 and j.take_if(5, 2) == "new"
    assert len(t) == len(j) == 0
    t.put_many([0, 9], ["zero", "nine"], token=3)
    assert t.take_many([0, 1]) == ["zero", None]
    assert t.pop_any() == (9, "nine") and t.pop_any() is None

    rng = np.random.default_rng(4)
    j, t = JVictims(), tdc.VictimBuffer()
    for token in range(1, 60):
        signs = rng.integers(0, 40, size=rng.integers(1, 12)).tolist()
        op = rng.integers(0, 4)
        if op == 0:
            payloads = [(token, k) for k in range(len(signs))]
            for s_, p_ in zip(signs, payloads):
                j.put(s_, p_, token=token)
            t.put_many(signs, iter(payloads), token=token)
        elif op == 1:
            assert t.take_many(signs) == [j.take(s_) for s_ in signs]
        else:
            old = int(rng.integers(max(1, token - 5), token + 1))
            want = [j.peek_if(s_, old) for s_ in signs]
            assert t.peek_if_many(signs, old) == want
            if op == 3:
                removed = sum(j.take_if(s_, old) is not None
                              for s_ in dict.fromkeys(signs))
                assert t.take_if_many(signs, old) == removed
        assert len(t) == len(j)
    assert sorted(t._pending.items()) == sorted(j._pending.items())


# --- steps -----------------------------------------------------------------


def _models():
    """(JAX DLRM, port DLRM with the JAX weights, flax params), f32."""
    import jax
    import jax.numpy as jnp

    from persia_tpu import models as jm
    from persia_tpu_torch import models as tm
    from persia_tpu_torch.weights import load_flax_params

    jmodel = jm.DLRM(embedding_dim=DIM, compute_dtype=jnp.float32)
    variables = jmodel.init(
        jax.random.key(3), [jnp.zeros((4, NUM_DENSE), jnp.float32)],
        [jnp.zeros((4, DIM), jnp.float32)] * NUM_SLOTS, train=False)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    tmodel = tm.DLRM(NUM_DENSE, NUM_SLOTS, embedding_dim=DIM,
                     compute_dtype=torch.float32, device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, tmodel, params


def _jax_state(params, optimizer):
    import jax
    import jax.numpy as jnp

    from persia_tpu.parallel.train import TrainState

    params = jax.tree_util.tree_map(jnp.asarray, params)
    return TrainState(params=params, batch_stats={},
                      opt_state=optimizer.init(params),
                      step=jnp.zeros((), jnp.int32))


def _step_inputs(rng, mapper, batches, bs, capacity, bags):
    """Mapped inputs of ``batches`` Zipf batches as numpy: the single-id
    or the bag layout of the engine, miss rows drawn at random."""
    from persia_tpu_torch.parallel.cached_train import pad_to_bucket

    for _ in range(batches):
        dense = rng.normal(size=(bs, NUM_DENSE)).astype(np.float32)
        label = (rng.random((bs, 1)) < 0.4).astype(np.float32)
        if bags:
            counts = rng.integers(0, 4, size=(NUM_SLOTS, bs))
            seg = np.concatenate([
                np.repeat(np.arange(bs) * NUM_SLOTS + s, counts[s])
                for s in range(NUM_SLOTS)])
            signs = (rng.zipf(1.4, size=len(seg)) % 90).astype(np.uint64)
        else:
            signs = (rng.zipf(1.4, size=bs * NUM_SLOTS) % 90).astype(
                np.uint64)
        res = mapper.assign(signs)
        n, m = len(signs), len(res.miss_pos)
        mpad = pad_to_bucket(max(m, 1), (64, 256))
        cold_idx = np.full(mpad, capacity, np.int32)
        cold_idx[:m] = res.slots[res.miss_pos]
        cold_vals = np.zeros((mpad, DIM), np.float32)
        cold_vals[:m] = rng.uniform(-0.3, 0.3, (m, DIM))
        cold_acc = np.full((mpad, DIM), 0.01, np.float32)
        cold_acc[:m] = rng.uniform(0.01, 0.5, (m, DIM))
        if bags:
            lpad = pad_to_bucket(max(n, 1), (64, 256, 1024))
            flat = np.full(lpad, capacity, np.int32)
            flat[:n] = res.slots
            seg_pad = np.full(lpad, bs * NUM_SLOTS, np.int32)
            seg_pad[:n] = seg
            inverse = np.zeros(lpad, np.int32)
            inverse[:n] = res.inverse
            uniq = np.full(lpad, capacity, np.int32)
            uniq[:res.n_unique] = res.unique_slots[:res.n_unique]
            scale = np.ones((bs, NUM_SLOTS), np.float32)
            scale[:, 2] = 1.0 / np.sqrt(np.maximum(counts[2], 1)
                                        .astype(np.float32))
            idx = [flat, seg_pad, scale]
        else:
            uniq = res.unique_slots.copy()
            uniq[res.n_unique:] = capacity
            inverse = res.inverse
            idx = [res.slots.reshape(bs, NUM_SLOTS)]
        yield (dense, idx, [cold_idx, cold_vals, cold_acc, inverse, uniq],
               label)


@pytest.mark.parametrize("bags", [False, True], ids=["single_id", "bags"])
def test_cached_steps_match_jax(bags):
    """4 steps of both packages' cached step (with evictions, a weight
    bound that clips, duplicate signs and, for bags, empty bags and a
    sqrt-scaled slot), from the same cache rows and dense weights."""
    import jax.numpy as jnp
    import optax

    from persia_tpu.parallel import cached_train as jct
    from persia_tpu_torch.parallel import cached_train as tct
    from persia_tpu_torch.parallel.optim import OptaxAdagrad
    from persia_tpu_torch.weights import flax_params

    capacity, bs, bound = 120, 16, 0.25
    jmodel, tmodel, params = _models()
    jopt = optax.adagrad(LR)
    state = _jax_state(params, jopt)
    topt = OptaxAdagrad(tmodel.parameters(), LR)
    kw = dict(num_slots=NUM_SLOTS, dim=DIM, lr=LR, eps=1e-10,
              g_square_momentum=0.9, weight_bound=bound, capacity=capacity)
    jmaker, tmaker = ((jct.make_cached_bag_train_step,
                       tct.make_cached_bag_train_step) if bags else
                      (jct.make_cached_train_step,
                       tct.make_cached_train_step))
    jstep, tstep = jmaker(jmodel, jopt, **kw), tmaker(tmodel, topt, **kw)
    rng = np.random.default_rng(11)
    vals0 = rng.uniform(-0.2, 0.2, (capacity + 1, DIM)).astype(np.float32)
    acc0 = rng.uniform(0.01, 0.3, (capacity + 1, DIM)).astype(np.float32)
    jv, ja = jnp.asarray(vals0), jnp.asarray(acc0)
    tv, ta = torch.from_numpy(vals0.copy()), torch.from_numpy(acc0.copy())
    evictions = 0
    for dense, idx, cold, label in _step_inputs(
            rng, tdc.SignSlotMap(capacity), 4, bs, capacity, bags):
        state, jv, ja, jloss, jpred, jev, jea = jstep(
            state, jv, ja, [jnp.asarray(dense)],
            *[jnp.asarray(a) for a in idx + cold], jnp.asarray(label))
        tloss, tpred, tev, tea = tstep(
            tv, ta, [torch.from_numpy(dense)],
            *[torch.from_numpy(a) for a in idx + cold],
            torch.from_numpy(label))
        close = dict(rtol=STEP_TOL, atol=STEP_TOL)
        np.testing.assert_allclose(float(tloss), float(jloss), **close)
        np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), **close)
        np.testing.assert_allclose(tev.numpy(), np.asarray(jev), **close)
        np.testing.assert_allclose(tea.numpy(), np.asarray(jea), **close)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **close)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **close)
        evictions += int((np.abs(tev.numpy()) > 0).any(axis=1).sum())
    assert float(tv.abs().max()) == pytest.approx(bound)  # the clamp bit
    assert evictions > 20
    got = flax_params(tmodel)[0]
    for layer, leaves in got.items():
        for name, leaf in leaves.items():
            for k, v in leaf.items():
                np.testing.assert_allclose(
                    v, np.asarray(state.params[layer][name][k]),
                    rtol=STEP_TOL, atol=STEP_TOL)
    # the steps returned new tensors: the cache changing after does not
    # change the rows a step evicted
    before = tev.clone()
    tv.add_(1.0)
    assert torch.equal(tev, before)


def test_cached_eval_step_and_cache_arrays_match_jax():
    import jax.numpy as jnp
    import optax

    from persia_tpu.parallel import cached_train as jct
    from persia_tpu_torch.parallel import cached_train as tct

    jmodel, tmodel, params = _models()
    jv, ja = jct.init_cache_arrays(40, DIM, 0.07)
    tv, ta = tct.init_cache_arrays(40, DIM, 0.07, device="cpu")
    assert tuple(tv.shape) == jv.shape == (41, DIM)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    rng = np.random.default_rng(2)
    vals = rng.uniform(-0.3, 0.3, (41, DIM)).astype(np.float32)
    slot_idx = rng.integers(0, 40, (8, NUM_SLOTS)).astype(np.int32)
    dense = rng.normal(size=(8, NUM_DENSE)).astype(np.float32)
    want = jct.make_cached_eval_step(jmodel, NUM_SLOTS)(
        _jax_state(params, optax.adagrad(LR)), jnp.asarray(vals),
        [jnp.asarray(dense)], jnp.asarray(slot_idx))
    got = tct.make_cached_eval_step(tmodel, NUM_SLOTS)(
        torch.from_numpy(vals), [torch.from_numpy(dense)],
        torch.from_numpy(slot_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STEP_TOL, atol=STEP_TOL)
    for n in (0, 1, 64, 65, 70000, 200000):
        assert tct.pad_to_bucket(n, (64, 256, 1024, 4096, 16384, 65536)) \
            == jct.pad_to_bucket(n, (64, 256, 1024, 4096, 16384, 65536))


# --- engine ----------------------------------------------------------------


def _schema(cfg, bags=False):
    if not bags:
        return cfg.EmbeddingSchema(slots_config=cfg.uniform_slots(SLOTS,
                                                                  dim=DIM))
    return cfg.EmbeddingSchema(slots_config={
        "b0": cfg.SlotConfig(name="b0", dim=DIM),
        "b1": cfg.SlotConfig(name="b1", dim=DIM),
        "b2": cfg.SlotConfig(name="b2", dim=DIM, sqrt_scaling=True)})


def _zipf_batches(mod, n_batches, bs, vocab=400, seed=0):
    """The JAX test's single-id Zipf stream as ``mod``'s batches."""
    rng = np.random.default_rng(seed)
    for i in range(n_batches):
        ids = rng.zipf(1.5, size=(bs, NUM_SLOTS)) % vocab
        signs = (ids + np.arange(NUM_SLOTS) * vocab + 1).astype(np.uint64)
        yield mod.PersiaBatch(
            [mod.IDTypeFeatureWithSingleID(
                SLOTS[s], np.ascontiguousarray(signs[:, s]))
             for s in range(NUM_SLOTS)],
            non_id_type_features=[mod.NonIDTypeFeature(
                rng.normal(size=(bs, NUM_DENSE)).astype(np.float32))],
            labels=[mod.Label((rng.random((bs, 1)) < 0.3)
                              .astype(np.float32))],
            requires_grad=True, batch_id=i)


def _bag_batches(mod, n_batches, bs, vocab=300, seed=0):
    """The JAX test's bag stream: bags of 0-3 Zipf ids, duplicates legal."""
    rng = np.random.default_rng(seed)
    for i in range(n_batches):
        feats = []
        for s, name in enumerate(["b0", "b1", "b2"]):
            rows = [((rng.zipf(1.5, size=rng.integers(0, 4)) % vocab)
                     + s * vocab + 1).astype(np.uint64) for _ in range(bs)]
            feats.append(mod.IDTypeFeature(name, rows))
        yield mod.PersiaBatch(
            feats, non_id_type_features=[mod.NonIDTypeFeature(
                rng.normal(size=(bs, NUM_DENSE)).astype(np.float32))],
            labels=[mod.Label((rng.random((bs, 1)) < 0.3)
                              .astype(np.float32))],
            requires_grad=True, batch_id=i)


def _holders(pkg, n=2, capacity=100_000):
    """``n`` per-entry numpy PS shards of ``pkg`` ("jax" or "port"),
    configured as a TrainCtx configures them, Adagrad(0.05)."""
    if pkg == "jax":
        from persia_tpu.ps.store import EmbeddingHolder
    else:
        EmbeddingHolder = THolder
    hs = [EmbeddingHolder(capacity, 2) for _ in range(n)]
    for h in hs:
        h.configure("bounded_uniform", {"lower": -0.05, "upper": 0.05},
                    1.0, 10.0, True)
        h.register_optimizer({
            "type": "adagrad", "lr": LR, "wd": 0.0, "g_square_momentum": 1.0,
            "initialization": 0.01, "eps": 1e-10,
            "vectorwise_shared": False})
    return hs


@pytest.mark.parametrize("bags", [False, True], ids=["single_id", "bags"])
def test_engine_prepare_is_byte_equal_to_jax(bags):
    """Both engines over equally seeded holders at a capacity that
    evicts: every array ``prepare`` / ``prepare_bags`` returns, byte for
    byte, batch after batch; the evicted rows go back through each
    engine's ``finish`` (the same rows for both), so later misses read the
    victim buffer or the written-back PS rows. Then ``flush_all`` leaves
    equal PS rows, and ``invalidate`` empties the cache."""
    from persia_tpu import config as jcfg
    from persia_tpu.data import batch as jbatch
    from persia_tpu.parallel.cached_engine import DeviceCacheEngine as JEng
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker
    from persia_tpu_torch.parallel.cached_engine import (
        DeviceCacheEngine as TEng,
    )

    capacity = 150 if bags else 200
    num_slots = 3 if bags else NUM_SLOTS
    scaling = [False, False, True] if bags else None
    jw = JWorker(_schema(jcfg, bags), _holders("jax"))
    tw = TWorker(_schema(tcfg, bags), _holders("port"))
    je = JEng(jw, capacity, num_slots, DIM, 0.01, sqrt_scaling=scaling)
    te = TEng(tw, capacity, num_slots, DIM, 0.01, sqrt_scaling=scaling,
              device="cpu")
    assert isinstance(te.mapper, tdc.NativeSignSlotMap)
    stream = _bag_batches if bags else _zipf_batches
    rng = np.random.default_rng(9)
    for jb, tb in zip(stream(jbatch, 10, 64), stream(tbatch, 10, 64)):
        if bags:
            jout = je.prepare_bags(jb.id_type_features)
            tout = te.prepare_bags(tb.id_type_features)
        else:
            jout = je.prepare(jb.id_type_features)
            tout = te.prepare(tb.id_type_features)
        assert len(tout) == len(jout)
        for t, j in zip(tout, jout):
            assert t.dtype == j.dtype and t.shape == j.shape
            assert t.tobytes() == j.tobytes()
        evicted, mask = tout[-4], tout[-3]
        ev = rng.uniform(-0.1, 0.1, (len(mask), 2, DIM)).astype(np.float32)
        je.finish(evicted, mask, ev[:, 0], ev[:, 1])
        te.finish(evicted, mask, torch.from_numpy(ev[:, 0]),
                  torch.from_numpy(ev[:, 1]))
        if tb.batch_id % 2:  # let some write-backs land, keep others
            je._drain_flush_queue()
            te._drain_flush_queue()
        assert te.wire_bytes_saved == je.wire_bytes_saved
    st = te.stats()
    m = je.mapper
    assert (st["hits"], st["misses"], st["evictions"]) == \
        (m.hits, m.misses, m.evictions)
    assert st["probes"] == st["hits"] + st["misses"]
    assert st["evictions"] > 100 and st["resident_rows"] == len(m)
    assert je.flush_all() == te.flush_all() > 0
    assert te.stats()["writeback_rows"] > st["writeback_rows"] > 0
    for jh, th in zip(jw.ps_clients, tw.ps_clients):
        signs = np.array([s for shard in th._shards for s in sorted(shard)],
                         np.uint64)
        assert len(jh) == len(th) == len(signs) > 0
        (jf, jv), (tf, tv) = (h.get_entries(signs, 2 * DIM)
                              for h in (jh, th))
        assert tf.all() and jf.all()
        assert tv.tobytes() == jv.tobytes()
    te.invalidate()
    assert len(te.mapper) == 0 and len(te.victims) == 0
    assert not te.cache_vals.any()
    assert (te.cache_acc == 0.01).all()
    assert te.stats()["resident_rows"] == 0
    for e in (je, te):
        e.close()
    for w in (jw, tw):
        w.close()


def test_write_backs_racing_the_miss_path_lose_no_row():
    """The flush thread against the training thread: an engine whose
    write-backs run concurrently (the interpreter switching threads every
    microsecond, its PS writes slowed) imports exactly what an engine that
    waits for each write-back imports, batch after batch, and leaves the
    same PS rows. A miss that read the PS before an in-flight row's
    write-back landed, or a write-back that overwrote a newer row, would
    show as a difference."""
    import sys

    from persia_tpu_torch.parallel.cached_engine import DeviceCacheEngine

    import time

    engines = [DeviceCacheEngine(TWorker(_schema(tcfg), _holders("port")),
                                 150, NUM_SLOTS, DIM, 0.01, device="cpu")
               for _ in range(2)]
    # a slow PS write widens the window in which a miss could overtake it
    worker, set_rows = engines[1].worker, engines[1].worker.set_rows
    worker.set_rows = lambda *a: (time.sleep(0.003), set_rows(*a))
    rng = np.random.default_rng(6)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for b in _zipf_batches(tbatch, 30, 64, seed=2):
            outs = [e.prepare(b.id_type_features) for e in engines]
            for t, w in zip(*outs):
                assert t.tobytes() == w.tobytes()
            evicted, mask = outs[0][4], outs[0][5]
            ev = torch.from_numpy(rng.uniform(
                -0.1, 0.1, (2, len(mask), DIM)).astype(np.float32))
            for k, e in enumerate(engines):
                e.finish(evicted, mask, ev[0], ev[1])
                if k == 0:
                    e._drain_flush_queue()
    finally:
        sys.setswitchinterval(interval)
    assert engines[1].stats()["evictions"] > 500
    for e in engines:
        e.flush_all()
        e.close()
        assert not e._flush_thread.is_alive()
    want, got = (_tables(e.worker) for e in engines)
    assert got.keys() == want.keys()
    for sign in want:
        np.testing.assert_array_equal(got[sign], want[sign])


def test_engine_surfaces_a_failed_write_back():
    """A write-back that fails on the flush thread raises at the next
    ``finish`` and at ``flush_all``; a context entered again starts
    clean."""
    from persia_tpu_torch.parallel.cached_engine import DeviceCacheEngine

    tw = TWorker(_schema(tcfg), _holders("port"))
    eng = DeviceCacheEngine(tw, 8, NUM_SLOTS, DIM, 0.01, device="cpu")

    def broken(*a):
        raise OSError("PS unreachable")

    tw.set_rows = broken
    feats = [tbatch.IDTypeFeatureWithSingleID(
        s, np.arange(2, dtype=np.uint64) + 10 * i) for i, s in
        enumerate(SLOTS)]
    out = eng.prepare(feats)
    zeros = torch.zeros((len(out[1]), DIM))
    eng.finish(out[4], out[5], zeros, zeros)
    feats2 = [tbatch.IDTypeFeatureWithSingleID(
        s, np.arange(2, dtype=np.uint64) + 10 * i + 100) for i, s in
        enumerate(SLOTS)]
    out = eng.prepare(feats2)
    assert out[5].sum() == 8  # every slot evicted
    eng.finish(out[4], out[5], zeros, zeros)
    with pytest.raises(OSError, match="unreachable"):
        eng.flush_all()
    with pytest.raises(OSError, match="unreachable"):
        eng.finish(out[4], out[5], zeros, zeros)
    eng.close()
    eng.ensure_open()
    assert eng._flush_err == [] and eng._flush_thread.is_alive()
    eng.close()
    tw.close()


# --- end to end ------------------------------------------------------------


def _port_ctx(cap, tmodel=None, bags=False, holders=None, **kw):
    from persia_tpu_torch import models as tm
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.parallel.optim import OptaxAdagrad

    num_slots = 3 if bags else NUM_SLOTS
    if tmodel is None:
        tmodel = tm.DLRM(NUM_DENSE, num_slots, embedding_dim=DIM,
                         compute_dtype=torch.float32, device="cpu")
        seed = 3
    else:
        seed = None
    worker = TWorker(_schema(tcfg, bags), holders or
                     [THolder(100_000, 2), THolder(100_000, 2)])
    return TrainCtx(
        tmodel, OptaxAdagrad(tmodel.parameters(), LR), Adagrad(lr=LR),
        _schema(tcfg, bags), worker,
        embedding_config=EmbeddingConfig(emb_initialization=(-0.05, 0.05)),
        global_config=tcfg.GlobalConfig(tcfg.CommonConfig("f32")),
        seed=seed, device="cpu", device_cache_capacity=cap, **kw)


def _jax_ctx(cap, params, bags=False):
    import jax.numpy as jnp
    import optax

    from persia_tpu import config as jcfg
    from persia_tpu import models as jm
    from persia_tpu.ctx import TrainCtx
    from persia_tpu.embedding import EmbeddingConfig
    from persia_tpu.embedding.optim import Adagrad
    from persia_tpu.ps.store import EmbeddingHolder
    from persia_tpu.worker.worker import EmbeddingWorker

    opt = optax.adagrad(LR)
    ctx = TrainCtx(
        model=jm.DLRM(embedding_dim=DIM, compute_dtype=jnp.float32),
        dense_optimizer=opt, embedding_optimizer=Adagrad(lr=LR),
        schema=_schema(jcfg, bags),
        worker=EmbeddingWorker(_schema(jcfg, bags),
                               [EmbeddingHolder(100_000, 2),
                                EmbeddingHolder(100_000, 2)]),
        embedding_config=EmbeddingConfig(emb_initialization=(-0.05, 0.05)),
        global_config=jcfg.GlobalConfig(
            common=jcfg.CommonConfig(embedding_wire_dtype="f32")),
        device_cache_capacity=cap)
    ctx.state = _jax_state(params, opt)
    return ctx


def _train(ctx, batches, flush=True):
    losses = []
    with ctx:
        for b in batches:
            losses.append(float(ctx.train_step(b)[0]))
        if flush and ctx.device_cache_capacity:
            assert ctx._cache_engine.hit_rate > 0.3
            assert ctx.flush_device_cache() > 0
    return losses


def _tables(worker):
    """sign -> [value | state] of every row of the port's per-entry
    holders."""
    out = {}
    for h in worker.ps_clients:
        signs = np.array([s for shard in h._shards for s in sorted(shard)],
                         np.uint64)
        found, vecs = h.get_entries(signs, 2 * DIM)
        assert found.all()
        out.update(zip(signs.tolist(), vecs))
    return out


def _assert_tables_close(got, want, tol):
    assert set(got) == set(want) and len(want) > 50
    signs = sorted(want)
    np.testing.assert_allclose(np.stack([got[s] for s in signs]),
                               np.stack([want[s] for s in signs]),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bags", [False, True], ids=["single_id", "bags"])
def test_cached_run_matches_jax(bags):
    """The JAX test's setup in both packages from the same weights:
    losses and the flushed PS rows within 1e-5."""
    from persia_tpu import models as jm
    from persia_tpu.data import batch as jbatch
    from persia_tpu_torch import models as tm
    from persia_tpu_torch.weights import load_flax_params

    import jax
    import jax.numpy as jnp

    num_slots = 3 if bags else NUM_SLOTS
    variables = jm.DLRM(embedding_dim=DIM, compute_dtype=jnp.float32).init(
        jax.random.key(3), [jnp.zeros((4, NUM_DENSE), jnp.float32)],
        [jnp.zeros((4, DIM), jnp.float32)] * num_slots, train=False)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    tmodel = load_flax_params(tm.DLRM(NUM_DENSE, num_slots,
                                      embedding_dim=DIM,
                                      compute_dtype=torch.float32,
                                      device="cpu"), params)
    cap = 2048 if bags else 4096
    stream = _bag_batches if bags else _zipf_batches
    jctx = _jax_ctx(cap, params, bags)
    tctx = _port_ctx(cap, tmodel, bags)
    jl = _train(jctx, stream(jbatch, 8, 64))
    tl = _train(tctx, stream(tbatch, 8, 64))
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL, atol=STEP_TOL)
    want = {}
    for h in jctx.worker.ps_clients:
        for shard in h._shards:
            for sign, (d, vec) in shard._map.items():
                want[sign] = np.asarray(vec[:2 * d])
    _assert_tables_close(_tables(tctx.worker), want, STEP_TOL)


@pytest.mark.parametrize("bags,capacity", [
    (False, 4096), (False, 280), (True, 2048), (True, 160)],
    ids=["single_id", "single_id_evicting", "bags", "bags_evicting"])
def test_cached_run_matches_uncached(bags, capacity):
    """The port cached against the port uncached on the same stream, f32
    wire: losses and every PS row within 1e-3; the small capacities evict,
    write back and import the same rows again."""
    stream = _bag_batches if bags else _zipf_batches
    n = 8 if bags else 10
    ref = _port_ctx(0, bags=bags)
    cached = _port_ctx(capacity, bags=bags)
    rl = _train(ref, stream(tbatch, n, 64))
    cl = _train(cached, stream(tbatch, n, 64))
    np.testing.assert_allclose(cl, rl, rtol=CACHE_TOL, atol=CACHE_TOL)
    _assert_tables_close(_tables(cached.worker), _tables(ref.worker),
                         CACHE_TOL)
    st = cached._cache_engine.stats()
    if capacity < 1000:
        assert st["evictions"] > 100 and st["writeback_rows"] > 100
    assert cached._cache_multi_id == bags


def test_cached_run_on_native_holders_matches_uncached():
    """The same on the port's native C++ store (its batched get_entries /
    set_entries), with eviction churn."""
    from persia_tpu_torch.ps.native import make_holder

    runs = []
    for cap in (0, 200):
        ctx = _port_ctx(cap, holders=[make_holder(100_000, 4)
                                      for _ in range(2)])
        runs.append((_train(ctx, _zipf_batches(tbatch, 8, 64)), ctx))
    (rl, ref), (cl, cached) = runs
    np.testing.assert_allclose(cl, rl, rtol=CACHE_TOL, atol=CACHE_TOL)
    signs = np.unique(np.concatenate([
        f.signs for b in _zipf_batches(tbatch, 8, 64)
        for f in b.id_type_features]))
    for hr, hc in zip(ref.worker.ps_clients, cached.worker.ps_clients):
        (fr, vr), (fc, vc) = (h.get_entries(signs, 2 * DIM)
                              for h in (hr, hc))
        np.testing.assert_array_equal(fc, fr)
        np.testing.assert_allclose(vc, vr, rtol=CACHE_TOL, atol=CACHE_TOL)
    assert cached._cache_engine.stats()["evictions"] > 100


def test_eval_ctx_flushes_the_cache():
    from persia_tpu_torch.ctx import eval_ctx

    ctx = _port_ctx(4096, holders=[THolder(100_000, 2)])
    batches = list(_zipf_batches(tbatch, 6, 64))
    with ctx:
        for b in batches:
            ctx.train_step(b)
        eng = ctx._cache_engine
        flushed = eng.stats()["writeback_rows"]
        with eval_ctx(ctx) as ectx:
            assert eng.stats()["writeback_rows"] > flushed
            for b in batches[:2]:
                b.requires_grad = False
                pred, _ = ectx.forward(b)
                assert torch.isfinite(pred).all()
        signs, slots = eng.mapper.signs_and_slots()
        assert len(signs) > 50
        found, vecs = ctx.worker.ps_clients[0].get_entries(signs, 2 * DIM)
        assert found.all()
        np.testing.assert_array_equal(vecs[:, :DIM],
                                      eng.cache_vals[slots].numpy())
        np.testing.assert_array_equal(vecs[:, DIM:],
                                      eng.cache_acc[slots].numpy())


def test_load_checkpoint_invalidates_the_cache(tmp_path):
    ctx = _port_ctx(4096, holders=[THolder(100_000, 2)])
    batches = list(_zipf_batches(tbatch, 4, 64))
    with ctx:
        for b in batches:
            ctx.train_step(b)
        ctx.dump_checkpoint(str(tmp_path), with_dense=False)
        saved = _tables(ctx.worker)
        for b in batches:  # past the checkpoint
            ctx.train_step(b)
        eng = ctx._cache_engine
        assert len(eng.mapper) > 0
        ctx.load_checkpoint(str(tmp_path), with_dense=False)
        assert len(eng.mapper) == 0 and len(eng.victims) == 0
        assert _tables(ctx.worker).keys() == saved.keys()
        for s, v in _tables(ctx.worker).items():
            np.testing.assert_array_equal(v, saved[s])
        loss, _ = ctx.train_step(batches[0])  # every row imported again
        assert np.isfinite(float(loss))
        assert eng.stats()["misses"] >= len(saved)


def test_resume_from_a_snapshot_equals_the_unbroken_run(tmp_path,
                                                        deterministic):
    """8 cached steps straight against 4, a snapshot (which flushes), and
    4 more in a fresh stack built with ``resume_from``: losses, dense
    state and PS rows bit-equal."""
    from persia_tpu_torch.weights import flax_params

    batches = list(_zipf_batches(tbatch, 8, 64))
    straight = _port_ctx(512)
    sl = _train(straight, batches, flush=False)
    first = _port_ctx(512)
    with first:
        fl = [float(first.train_step(b)[0]) for b in batches[:4]]
        first.snapshot(str(tmp_path), cursor={"step": 4})
    assert first._cache_engine.stats()["writeback_rows"] > 0
    resumed = _port_ctx(512, resume_from=str(tmp_path))
    assert resumed.resume_cursor == {"step": 4}
    rl = _train(resumed, batches[4:], flush=False)
    assert fl + rl == sl
    for a, b in zip(flax_params(straight.model),
                    flax_params(resumed.model)):
        for layer in a:
            for name in a[layer]:
                for k in a[layer][name]:
                    np.testing.assert_array_equal(a[layer][name][k],
                                                  b[layer][name][k])
    got, want = _tables(resumed.worker), _tables(straight.worker)
    assert got.keys() == want.keys()
    for s in want:
        np.testing.assert_array_equal(got[s], want[s])


def test_dataloader_over_a_cached_ctx_equals_the_synchronous_run():
    from persia_tpu_torch.data.dataloader import DataLoader, IterableDataset

    ref = _port_ctx(1024)
    rl = _train(ref, _zipf_batches(tbatch, 6, 64))
    ctx = _port_ctx(1024)
    loader = DataLoader(IterableDataset(_zipf_batches(tbatch, 6, 64)),
                        num_workers=4, embedding_staleness=2)
    with ctx:
        seen = list(loader)
        assert all(type(b) is tbatch.PersiaBatch for b in seen)
        assert [b.batch_id for b in seen] == list(range(6))
        cl = [float(ctx.train_step(b)[0]) for b in seen]
        ctx.flush_device_cache()
    assert loader._engine is None  # no prefetch engine was started
    assert cl == rl
    got, want = _tables(ctx.worker), _tables(ref.worker)
    assert got.keys() == want.keys()
    for s in want:
        np.testing.assert_array_equal(got[s], want[s])


def _refusal_ctx(embedding_optimizer=None, slots=None):
    from persia_tpu_torch import models as tm
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad

    schema = tcfg.EmbeddingSchema(slots_config=slots or tcfg.uniform_slots(
        SLOTS, dim=DIM))
    model = tm.DLRM(NUM_DENSE, NUM_SLOTS, embedding_dim=DIM,
                    compute_dtype=torch.float32, device="cpu")
    return TrainCtx(model, torch.optim.Adam(model.parameters()),
                    embedding_optimizer or Adagrad(lr=LR), schema,
                    TWorker(schema, [THolder(1000, 2)]), device="cpu",
                    device_cache_capacity=64)


@pytest.mark.parametrize("case", [
    "sgd", "adam", "shared_adagrad", "raw_slot", "mean_pooling",
    "mixed_dims"])
def test_cache_refuses_what_it_does_not_mirror(case):
    """The JAX package's envelope refusals
    (``test_cache_rejects_unsupported_shapes``), each with its reason."""
    from persia_tpu_torch.embedding.optim import SGD, Adagrad, Adam

    opt, slots = None, None
    if case == "sgd":
        opt = SGD(lr=LR)
    elif case == "adam":
        opt = Adam()
    elif case == "shared_adagrad":
        opt = Adagrad(lr=LR, vectorwise_shared=True)
    else:
        slots = tcfg.uniform_slots(SLOTS, dim=DIM)
        if case == "raw_slot":
            slots["s1"] = tcfg.SlotConfig(name="s1", dim=DIM,
                                          embedding_summation=False,
                                          sample_fixed_size=2)
        elif case == "mean_pooling":
            slots["s2"] = tcfg.SlotConfig(name="s2", dim=DIM,
                                          pooling="mean")
        else:
            slots["s3"] = tcfg.SlotConfig(name="s3", dim=2 * DIM)
    ctx = _refusal_ctx(opt, slots)
    match = {"sgd": "Adagrad", "adam": "Adagrad",
             "shared_adagrad": "Adagrad", "raw_slot": "raw slot",
             "mean_pooling": "pooling", "mixed_dims": "uniform"}[case]
    with ctx:
        with pytest.raises(NotImplementedError, match=match):
            ctx.train_step(next(_zipf_batches(tbatch, 1, 8)))
        assert ctx._cache_engine is None


def test_cached_ctx_refuses_a_looked_up_batch():
    from persia_tpu_torch.pipeline import LookedUpBatch

    ctx = _refusal_ctx()
    looked = LookedUpBatch.__new__(LookedUpBatch)
    with ctx:
        with pytest.raises(RuntimeError, match="raw PersiaBatch"):
            ctx.train_step(looked)
        with pytest.raises(TypeError, match="PersiaBatch"):
            ctx.train_step(object())


def test_cache_over_a_mesh_of_two_ranks(monkeypatch, caplog):
    """A mesh of two ranks on one host caches (its rows sharded over the
    ranks: ``tests/test_torch_cached_mesh.py``). A mesh whose ranks span
    two hosts is the JAX package's ``jax.process_count() > 1``: by
    default the context warns and trains uncached;
    ``PERSIA_MULTIHOST_CACHE=refuse`` raises; another value is an error.
    Decided once the context has joined the mesh (the ranks count their
    hosts together)."""
    from torch.distributed.device_mesh import DeviceMesh

    from persia_tpu_torch import models as tm
    from persia_tpu_torch.ctx import TrainCtx

    mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                      mesh_dim_names=("data", "model"), _init_backend=False,
                      _rank=0)
    joined, hosts = [], [1]
    monkeypatch.setattr(TrainCtx, "_join_mesh",
                        lambda self: joined.append(self))
    monkeypatch.setattr(TrainCtx, "_mesh_host_count",
                        lambda self: hosts[0])
    model = tm.DLRM(NUM_DENSE, NUM_SLOTS, embedding_dim=DIM,
                    compute_dtype=torch.float32, device="cpu")
    schema = _schema(tcfg)

    def build(on=mesh):
        return TrainCtx(model, torch.optim.Adam(model.parameters()), None,
                        schema, TWorker(schema, [THolder(1000, 2)]),
                        device="cpu", mesh=on, device_cache_capacity=64)

    monkeypatch.setenv("PERSIA_MULTIHOST_CACHE", "refuse")
    ctx = build()  # one host: the knob is not read
    assert ctx.device_cache_capacity == 64 and joined == [ctx]
    hosts[0] = 2
    monkeypatch.delenv("PERSIA_MULTIHOST_CACHE")
    with caplog.at_level(logging.WARNING, logger="persia_tpu_torch.ctx"):
        ctx = build()
    assert ctx.device_cache_capacity == 0 and joined[-1] is ctx
    assert "NEGOTIATING DOWN" in caplog.text and "2 hosts" in caplog.text
    monkeypatch.setenv("PERSIA_MULTIHOST_CACHE", "refuse")
    with pytest.raises(NotImplementedError, match="single-controller"):
        build()
    monkeypatch.setenv("PERSIA_MULTIHOST_CACHE", "maybe")
    with pytest.raises(ValueError, match="PERSIA_MULTIHOST_CACHE"):
        build()
    assert len(joined) == 4
    # a mesh of one rank caches and counts no hosts
    one = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                     mesh_dim_names=("data", "model"), _init_backend=False,
                     _rank=0)
    monkeypatch.setenv("PERSIA_MULTIHOST_CACHE", "refuse")
    assert build(one).device_cache_capacity == 64


@pytest.mark.gpu
def test_cached_matches_uncached_on_the_card():
    """Cached against uncached on the card, f32 tower and wire, with
    eviction churn; ``index_add_`` sums with atomics there, so within the
    CPU test's 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from persia_tpu_torch import models as tm
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.parallel.optim import OptaxAdagrad

    runs = []
    for cap in (0, 280):
        model = tm.DLRM(NUM_DENSE, NUM_SLOTS, embedding_dim=DIM,
                        compute_dtype=torch.float32, device="cuda")
        worker = TWorker(_schema(tcfg), [THolder(100_000, 2),
                                         THolder(100_000, 2)])
        ctx = TrainCtx(
            model, OptaxAdagrad(model.parameters(), LR), Adagrad(lr=LR),
            _schema(tcfg), worker,
            embedding_config=EmbeddingConfig((-0.05, 0.05)),
            global_config=tcfg.GlobalConfig(tcfg.CommonConfig("f32")),
            seed=3, device_cache_capacity=cap)
        losses = _train(ctx, _zipf_batches(tbatch, 10, 64))
        runs.append((losses, _tables(worker)))
        if cap:
            assert ctx._cache_engine.stats()["writeback_rows"] > 100
            assert ctx._cache_engine.cache_vals.is_cuda
    (rl, rt), (cl, ct) = runs
    np.testing.assert_allclose(cl, rl, rtol=CACHE_TOL, atol=CACHE_TOL)
    _assert_tables_close(ct, rt, CACHE_TOL)
