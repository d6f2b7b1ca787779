"""The port's workload zoo against the JAX package, on the CPU.

- Every generator of ``persia_tpu_torch.workloads.generator`` gives
  batches byte-identical (``to_bytes``) to the JAX one for the same seed,
  including ``adult_income_batches`` against
  ``examples/adult_income/data_generator.py`` and
  ``hybrid_bench_batches`` against ``bench.py``'s ``make_batches``.
- The registry resolves the same scenarios (schema, widths, gates,
  streams), its defaults from ``PERSIA_WORKLOAD_SEED`` /
  ``PERSIA_WORKLOAD_ALPHA``.
- Each scenario's tower (``ZooDLRM`` over mixed dims, ``PooledSessionNet``
  over worker-pooled slots, ``MultiTaskDNN`` with ``multitask_bce``)
  takes 3 ``TrainCtx`` steps in both packages at the smoke size, from the
  JAX weights and fresh PS rows, on ``bench.py``'s e2e optimizers, held
  as ``tests/test_torch_zoo.py`` holds the towers (f32, 1e-5; parameters
  2e-5); ``evaluate_auc`` of both then agrees within 1e-3 (a flip in the
  order of two predictions 1e-5 apart moves an AUC over 128 x 128 pairs
  by 6e-5).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from persia_tpu_torch.workloads import generator as tgen
from test_torch_zoo import (
    jax_numpy_middleware,  # noqa: F401  (a fixture)
    jax_train_ctx,
    jax_variables,
    port_train_ctx,
    run_and_compare,
)

ROOT = Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _streams(kind):
    """(JAX stream, port stream) of one generator, 3 batches of 64 rows
    and a ragged last one."""
    from persia_tpu.workloads import generator as jgen

    n, bs = 200, 64
    if kind == "dlrm":
        return [m.dlrm_batches(n, bs, seed=3, spec=m.CriteoSpec.build(
            scale=0.02, alpha=1.2)) for m in (jgen, tgen)]
    if kind == "criteo_uniform":
        return [m.criteo_uniform_batches(n, bs, seed=3, vocab_per_slot=500)
                for m in (jgen, tgen)]
    if kind == "criteo_learnable":
        return [m.criteo_learnable_batches(n, bs, seed=3,
                                           requires_grad=False)
                for m in (jgen, tgen)]
    if kind == "seqrec":
        return [m.seqrec_batches(n, bs, seed=3, spec=m.SeqRecSpec(
            item_vocab=500, t_hist=12)) for m in (jgen, tgen)]
    if kind == "multitask":
        return [m.multitask_batches(n, bs, seed=3, spec=m.MultiTaskSpec(
            user_vocab=300, item_vocab=700)) for m in (jgen, tgen)]
    if kind == "adult_income":
        example = _load("adult_income_data_generator",
                        ROOT / "examples" / "adult_income"
                        / "data_generator.py")
        return [example.batches(n, bs, seed=3),
                tgen.adult_income_batches(n, bs, seed=3)]
    bench = _load("bench_for_parity", ROOT / "bench.py")
    if kind == "infer_requests":
        from persia_tpu_torch.data.batch import PersiaBatch

        return [[PersiaBatch.from_bytes(b) for b in m.make_infer_requests(
            4, bs, 26, 13, seed=3)] for m in (bench, tgen)]
    assert kind == "hybrid_bench"
    return [bench.make_batches(3, bs, seed=3),
            tgen.hybrid_bench_batches(3, bs, seed=3)]


@pytest.mark.parametrize("kind", [
    "dlrm", "criteo_uniform", "criteo_learnable", "seqrec", "multitask",
    "adult_income", "hybrid_bench", "infer_requests"])
def test_generators_are_byte_identical(kind):
    jstream, tstream = (list(s) for s in _streams(kind))
    assert len(jstream) == len(tstream) >= 3
    for jb, tb in zip(jstream, tstream):
        assert tb.to_bytes() == jb.to_bytes()


def test_generator_helpers_match_jax():
    from persia_tpu.workloads import generator as jgen

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 2**40, size=1000).astype(np.uint64)
    streams = rng.integers(0, 30, size=1000).astype(np.uint64)
    np.testing.assert_array_equal(tgen.hidden_weight(streams, ids),
                                  jgen.hidden_weight(streams, ids))
    logits = rng.normal(size=500)
    np.testing.assert_array_equal(
        tgen._labels_from_logits(np.random.default_rng(1), logits, 0.25),
        jgen._labels_from_logits(np.random.default_rng(1), logits, 0.25))
    for scale in (0.02, 0.2, 1.0):
        assert tgen.CriteoSpec.build(scale=scale) == \
            tgen.CriteoSpec(**vars(jgen.CriteoSpec.build(scale=scale)))
    assert tgen.CRITEO_SLOT_NAMES == jgen.CRITEO_SLOT_NAMES
    assert (tgen.MT_TASKS, tgen.MT_SLOTS) == (jgen.MT_TASKS, jgen.MT_SLOTS)


def _slots(schema):
    return [(s.name, s.dim, s.pooling, s.embedding_summation)
            for s in schema.slots_config.values()]


@pytest.mark.parametrize("smoke", [True, False])
def test_registry_matches_jax(smoke, monkeypatch):
    from persia_tpu.workloads import registry as jreg
    from persia_tpu_torch.workloads import registry as treg

    assert treg.scenario_names() == jreg.scenario_names() == (
        "dlrm", "multitask", "seqrec")
    monkeypatch.setenv("PERSIA_WORKLOAD_SEED", "7")
    monkeypatch.setenv("PERSIA_WORKLOAD_ALPHA", "1.2")
    for name in treg.scenario_names():
        j, t = jreg.get_scenario(name, smoke), treg.get_scenario(name, smoke)
        assert t.seed == j.seed == 7
        assert _slots(t.schema) == _slots(j.schema)
        assert t.slot_dims == tuple(s.dim for s in
                                    j.schema.slots_config.values())
        for key in ("name", "num_dense", "tasks", "auc_gate",
                    "ragged_features", "bench_batch_size"):
            assert getattr(t, key) == getattr(j, key), key
        assert (t.loss_fn is None) == (j.loss_fn is None)
        assert [b.to_bytes() for b in t.batches(100, 50)] == \
            [b.to_bytes() for b in j.batches(100, 50)]
        assert [b.to_bytes() for b in t.batches(50, 50, seed=9)] == \
            [b.to_bytes() for b in j.batches(50, 50, seed=9)]
    monkeypatch.delenv("PERSIA_WORKLOAD_SEED")
    monkeypatch.delenv("PERSIA_WORKLOAD_ALPHA")
    assert treg.get_scenario("dlrm").seed == jreg.get_scenario("dlrm").seed
    with pytest.raises(KeyError, match="unknown scenario"):
        treg.get_scenario("nope")


def test_multitask_bce_matches_jax():
    import jax.numpy as jnp

    from persia_tpu.workloads.models import multitask_bce as jbce
    from persia_tpu_torch.workloads.models import multitask_bce

    pred = np.array([[0.0, 0.2], [1e-9, 0.9], [0.3, 1.0], [1.0, 0.5]],
                    np.float32)
    label = np.array([[0.0, 1.0], [1.0, 1.0], [1.0, 0.0], [0.0, 0.0]],
                     np.float32)
    np.testing.assert_allclose(
        float(multitask_bce(torch.from_numpy(pred), torch.from_numpy(label))),
        float(jbce(jnp.asarray(pred), jnp.asarray(label))), rtol=1e-6)


@pytest.mark.parametrize("name", ["dlrm", "seqrec", "multitask"])
def test_scenario_train_steps_match_jax(
        name, jax_numpy_middleware):  # noqa: F811
    import jax.numpy as jnp
    import optax

    from persia_tpu.workloads import registry as jreg
    from persia_tpu_torch.workloads import registry as treg

    bs = 32
    jsc, tsc = jreg.get_scenario(name, smoke=True), treg.get_scenario(
        name, smoke=True)
    jmodel = jsc.model().clone(compute_dtype=jnp.float32)
    tmodel = tsc.model(device="cpu", compute_dtype=torch.float32)
    params, stats = jax_variables(jmodel, jsc.num_dense,
                                  dims=list(tsc.slot_dims))
    if name == "dlrm":  # mixed dims: some fields projected, some not
        assert {"field_proj_0", "MLP_0", "MLP_1"} <= set(params)
        assert len(params) - 2 < len(tsc.slot_dims)
    jctx = jax_train_ctx(jmodel, params, stats, jsc.schema, optax.adam(2e-3),
                         sparse_lr=0.1, loss_fn=jsc.loss_fn)
    tctx = port_train_ctx(
        tmodel, params, stats, tsc.schema,
        lambda p: torch.optim.Adam(p, lr=2e-3), sparse_lr=0.1,
        loss_fn=tsc.loss_fn)
    widths = sorted({2 * d for d in tsc.slot_dims})
    try:
        with jctx, tctx:
            run_and_compare(jctx, tctx, jsc.batches(3 * bs, bs),
                            tsc.batches(3 * bs, bs), 1e-5, 2e-5, widths)
            kw = dict(num_samples=256, batch_size=64)
            jauc = jreg.evaluate_auc(jctx, jsc, **kw)
            tauc = treg.evaluate_auc(tctx, tsc, **kw)
        assert list(tauc) == list(jauc) == list(tsc.tasks)
        for task in jauc:
            assert tauc[task] == pytest.approx(jauc[task], abs=1e-3)
    finally:
        jctx.worker.close()
