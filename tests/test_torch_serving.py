"""The PyTorch port's serving slice against the JAX package, on the CPU.

- Model parity: ``SequenceTower`` after ``load_flax_params`` against the
  flax ``SequenceTower(attn_impl="pallas")`` (Pallas in interpret mode) and
  ``attn_impl="xla"`` under ``apply``, on the same numpy inputs.
- Whole-slice parity: the JAX ``InferenceServer`` over an in-process JAX
  worker against the port's ``InferenceServer(device="cpu")``, with the
  same PS rows, transplanted dense weights and the same ``seqrec``
  requests, through bucket padding, request merging and cache-miss and
  cache-hit rounds.

Tolerances: f32 compute 1e-5 — the same math with other matmul blocking
and summation orders. bf16 compute 2e-2 on the sigmoid output — the two
frameworks round to bf16 at different places (flax's bf16 dot rounds its
product; PyTorch accumulates a bf16 matmul in f32 first; the Pallas
kernel rounds its probabilities to bf16), each worth up to 2**-8
relative, through five bf16 layers.
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch import config as tcfg
from persia_tpu_torch.models import SequenceTower
from persia_tpu_torch.ps.rng import initialize_entries
from persia_tpu_torch.ps.store import EmbeddingHolder as THolder
from persia_tpu_torch.serving import InferenceServer as TServer
from persia_tpu_torch.serving import default_buckets, merge_batches, \
    pad_batch
from persia_tpu_torch.weights import (
    JAX_ATTN_IMPL,
    init_params,
    load_flax_params,
    numpy_tree,
)
from persia_tpu_torch.worker.worker import EmbeddingWorker as TWorker
from persia_tpu_torch.workloads import generator as tgen

DIM, HEADS, T_HIST, NUM_DENSE = 16, 4, 16, 4
SPEC = dict(item_vocab=2000, t_hist=T_HIST)
# the batch's feature order: profiles, history (raw), clicks, target
SLOTS = [(DIM, False), (DIM, False), (DIM, True), (DIM, False),
         (DIM, False)]


def _schema(cfg):
    slots = cfg.uniform_slots(["user_geo", "user_device", "target_item"],
                              dim=DIM)
    slots["recent_items"] = cfg.SlotConfig(
        name="recent_items", dim=DIM, embedding_summation=False,
        sample_fixed_size=T_HIST)
    slots["recent_clicks"] = cfg.SlotConfig(name="recent_clicks", dim=DIM,
                                            pooling="last4")
    return cfg.EmbeddingSchema(slots_config=slots)


def _flax_tower(attn_impl, compute_dtype):
    import jax.numpy as jnp

    from persia_tpu import config as jcfg
    from persia_tpu.models import SequenceTower as FlaxTower
    from persia_tpu.serving import build_state_template

    model = FlaxTower(num_heads=HEADS, attn_impl=attn_impl,
                      compute_dtype=getattr(jnp, compute_dtype))
    state = build_state_template(model, _schema(jcfg), NUM_DENSE, seed=5)
    return model, state


def _port_tower(attn_impl, compute_dtype, state):
    model = SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                          attn_impl=JAX_ATTN_IMPL[attn_impl],
                          compute_dtype=getattr(torch, compute_dtype),
                          device="cpu")
    return load_flax_params(model, numpy_tree(state.params))


def _model_inputs(bs=24, seed=0):
    rng = np.random.default_rng(seed)
    non_id = [rng.normal(size=(bs, NUM_DENSE)).astype(np.float32)]
    cap = bs * T_HIST + 1
    raw = rng.normal(scale=0.3, size=(cap, DIM)).astype(np.float32)
    raw[0] = 0.0
    lengths = rng.integers(0, T_HIST + 1, size=bs)
    lengths[:2] = 0  # empty histories: a fully masked attention row
    index = np.zeros((bs, T_HIST), np.int32)
    for i, n in enumerate(lengths):
        index[i, :n] = rng.integers(1, cap, size=n)
    sums = [rng.normal(scale=0.3, size=(bs, DIM)).astype(np.float32)
            for _ in range(4)]
    return non_id, [sums[0], sums[1], (raw, index), sums[2], sums[3]]


@pytest.mark.parametrize("attn_impl,compute_dtype,tol", [
    ("pallas", "float32", 1e-5),
    ("xla", "float32", 1e-5),
    ("pallas", "bfloat16", 2e-2),
])
def test_sequence_tower_matches_flax(attn_impl, compute_dtype, tol):
    import jax.numpy as jnp

    model, state = _flax_tower(attn_impl, compute_dtype)
    non_id, embs = _model_inputs()
    want = np.asarray(model.apply(
        {"params": state.params}, [jnp.asarray(x) for x in non_id],
        [tuple(jnp.asarray(a) for a in e) if isinstance(e, tuple)
         else jnp.asarray(e) for e in embs], train=False))
    port = _port_tower(attn_impl, compute_dtype, state).eval()
    with torch.inference_mode():
        got = port([torch.from_numpy(x) for x in non_id],
                   [tuple(torch.from_numpy(a) for a in e)
                    if isinstance(e, tuple) else torch.from_numpy(e)
                    for e in embs]).numpy()
    assert got.shape == want.shape == (24, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_weight_loader_rejects_unknown_and_missing_keys():
    _, state = _flax_tower("pallas", "float32")
    params = numpy_tree(state.params)
    port = _port_tower("pallas", "float32", state)
    with pytest.raises(KeyError):
        load_flax_params(port, {**params, "Dense_9": params["Dense_0"]})
    del params["MLP_0"]["Dense_1"]
    with pytest.raises(KeyError):
        load_flax_params(port, params)
    with pytest.raises(ValueError, match="attn_impl"):
        SequenceTower(NUM_DENSE, SLOTS, attn_impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="context_parallel"):
        SequenceTower(NUM_DENSE, SLOTS, context_parallel="ulyses",
                      device="cpu")


def test_seeded_init_is_reproducible():
    a = init_params(SequenceTower(NUM_DENSE, SLOTS, device="cpu"), 3)
    b = init_params(SequenceTower(NUM_DENSE, SLOTS, device="cpu"), 3)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    w = a.MLP_0.Dense_0.weight.detach()
    assert abs(float(w.std()) - (1.0 / w.shape[1]) ** 0.5) < 0.02


def _requests(spec_cls, gen_mod):
    """Requests of 5, 13 and 32 rows: bucket padding to 8/16/32 and, in
    the port's micro-batcher, merges of several requests."""
    spec = spec_cls(**SPEC)
    out = []
    for seed, rows in ((1, 5), (2, 13), (3, 32)):
        out += list(gen_mod.seqrec_batches(2 * rows, rows, seed=seed,
                                           spec=spec, requires_grad=False))
    return [b.to_bytes() for b in out]


def test_inference_server_matches_jax():
    from persia_tpu import config as jcfg
    from persia_tpu.ps.store import EmbeddingHolder as JHolder
    from persia_tpu.rpc import unpack_arrays
    from persia_tpu.serving import InferenceServer as JServer
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker
    from persia_tpu.workloads import generator as jgen

    jschema, tschema = _schema(jcfg), _schema(tcfg)
    signs = tgen.SeqRecSpec(**SPEC).all_signs()
    vecs = initialize_entries(signs, DIM, "bounded_uniform",
                              {"lower": -0.05, "upper": 0.05})
    jworker = JWorker(jschema, [JHolder(1_000_000, 4) for _ in range(2)])
    tworker = TWorker(tschema, [THolder(1_000_000, 4) for _ in range(2)])
    tworker.set_rows(signs, vecs, DIM)
    for holder, port_holder in zip(jworker.ps_clients, tworker.ps_clients):
        found, rows = port_holder.get_entries(signs, DIM)
        holder.set_entries(signs[found], DIM, rows[found])

    model, state = _flax_tower("pallas", "float32")
    port_model = _port_tower("pallas", "float32", state)
    payloads = _requests(jgen.SeqRecSpec, jgen)
    assert payloads == _requests(tgen.SeqRecSpec, tgen)
    jserver = JServer(model, state, jschema, worker=jworker,
                      max_batch_rows=64, cache_rows=10_000)
    tserver = TServer(port_model, tschema, tworker, device="cpu",
                      max_batch_rows=64, cache_rows=10_000)
    try:
        for rnd in range(2):  # cache misses, then cache hits
            want = [unpack_arrays(jserver._predict(p))[1][0]
                    for p in payloads]
            got = tserver.predict_many(payloads)
            for w, g in zip(want, got):
                assert g.shape == w.shape and g.dtype == np.float32
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            stats = tserver.stats()
            if rnd == 0:
                assert stats["cache_misses"] > 0
        assert stats["cache_hits"] >= stats["cache_misses"]
        assert stats["padded_rows"] > 0 and stats["batches"] < len(
            payloads) * 2
        assert set(stats["forward_batch_rows"]) <= set(tserver.buckets)
        # the serialized path, one request at a time, agrees too
        plain = TServer(port_model, tschema, tworker, device="cpu")
        np.testing.assert_allclose(plain.predict_bytes(payloads[0]),
                                   got[0], rtol=1e-5, atol=1e-5)
    finally:
        tserver.stop()
        jserver.stop()
        jworker.close()


def test_merge_and_pad_primitives():
    reqs = [tgen.seqrec_batches(n, n, seed=n, spec=tgen.SeqRecSpec(**SPEC))
            for n in (3, 5)]
    a, b = (next(r) for r in reqs)
    merged, sizes = merge_batches([a, b])
    assert sizes == [3, 5] and merged.batch_size == 8
    f = merged.id_type_features[2]
    np.testing.assert_array_equal(
        f.signs, np.concatenate([a.id_type_features[2].signs,
                                 b.id_type_features[2].signs]))
    padded = pad_batch(merged, 16)
    assert padded.batch_size == 16
    assert len(padded.id_type_features[2].signs) == len(f.signs)
    assert (padded.non_id_type_features[0].data[8:] == 0).all()
    assert default_buckets(64) == (8, 16, 32, 64)


def test_flatten_embeddings_and_infer_ctx_forward():
    import jax.numpy as jnp

    from persia_tpu.models.common import flatten_embeddings as jflatten
    from persia_tpu_torch.ctx import InferCtx
    from persia_tpu_torch.models.common import flatten_embeddings

    _, embs = _model_inputs(bs=6, seed=4)
    want = np.asarray(jflatten(
        [tuple(jnp.asarray(a) for a in e) if isinstance(e, tuple)
         else jnp.asarray(e) for e in embs]))
    got = flatten_embeddings(
        [tuple(torch.from_numpy(a) for a in e) if isinstance(e, tuple)
         else torch.from_numpy(e) for e in embs]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    # the direct-lookup forward of the context equals the served one
    schema = _schema(tcfg)
    worker = TWorker(schema, [THolder(100_000, 2) for _ in range(2)])
    worker.configure_parameter_servers(
        "bounded_uniform", {"lower": -0.05, "upper": 0.05}, 1.0, 10.0)
    assert all(h.configured for h in worker.ps_clients)
    signs = tgen.SeqRecSpec(**SPEC).all_signs()
    worker.set_rows(signs, initialize_entries(
        signs, DIM, "bounded_uniform", {"lower": -0.05, "upper": 0.05}), DIM)
    model = init_params(SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                                      attn_impl="flash", device="cpu"), 1)
    batch = next(tgen.seqrec_batches(8, 8, seed=9,
                                     spec=tgen.SeqRecSpec(**SPEC)))
    pred, labels = InferCtx(model, schema, worker, device="cpu").forward(
        batch)
    served = TServer(model, schema, worker, device="cpu").predict(batch)
    np.testing.assert_array_equal(pred.float().numpy(), served)
    np.testing.assert_array_equal(labels[0].numpy(), batch.labels[0].data)
