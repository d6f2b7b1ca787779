"""Device mode of the PyTorch port against the JAX package, on the CPU.

Modules: ``DeviceEmbeddingBag`` / ``DeviceEmbeddingCollection`` against
the flax modules from transplanted tables, ``DLRM`` against the JAX DLRM,
``OptaxAdagrad`` against ``optax.adagrad``, ``synthetic_device_batch``
against the JAX one, and the flax weight round trip. The whole slice: 3
steps of ``make_device_mode_trainer`` in both packages from the same
weights (the JAX side on a one-device mesh), compared on every loss and
every parameter afterwards. On the CPU the port's pooled lookup is K1's
plain version; K1 itself is held against it on the card.

Tolerances, each with its reason:

- f32, 1e-6 (pooled lookups) and 1e-5 (DLRM predictions): the same math
  with another summation order and matmul blocking.
- bf16 output of the bag, rtol 2**-8: both pool in f32 and round once to
  bf16; an f32 sum an ulp apart can round to the neighbouring bf16 value.
- bf16 DLRM, 2e-2: the test_torch_train bound; flax rounds its bf16
  products where PyTorch accumulates in f32 first, 2**-8 relative per
  layer through six layers and the interaction.
- OptaxAdagrad, rtol 2**-22 (two f32 ulps) and atol 1e-8: XLA's CPU
  rsqrt and PyTorch's differ by an ulp in about a third of the elements,
  and the port fuses the square-add and the scaled add, so an update (at
  most lr = 0.02 in size, whose ulp is 1.9e-9) can land an ulp or two
  from optax's, which is more than 2**-22 of a parameter near 0.
- Whole steps with an f32 tower, 1e-5 on losses and parameters: the
  pooled embeddings are rounded to bf16 in both packages (the JAX model
  keeps the collection's bf16), so an f32 sum an ulp apart can move a
  pooled value by one bf16 ulp; Adagrad carries a gradient's relative
  error into an update of at most lr = 0.02.
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch.models.dlrm import DLRM
from persia_tpu_torch.parallel import device_mode as tdm
from persia_tpu_torch.parallel.device_embedding import (
    DeviceEmbeddingBag,
    DeviceEmbeddingCollection,
)
from persia_tpu_torch.parallel.optim import OptaxAdagrad
from persia_tpu_torch.weights import (
    flax_params,
    init_device_mode,
    load_flax_params,
    numpy_tree,
)

SLOTS, VOCAB, DIM, NUM_DENSE, BS = 4, 257, 8, 13, 32


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _ids(seed, shape, vocab):
    """Ids with padding (0), negatives and values far past the vocab."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1 << 31, size=shape).astype(np.int32)
    ids[rng.random(shape) < 0.25] = 0
    ids.flat[::7] = -5
    ids.flat[3] = vocab - 1
    return ids


@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-6, 1e-6),
                                             ("bfloat16", 2**-8, 1e-6)])
def test_device_embedding_bag_matches_flax(pooling, dtype, rtol, atol):
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from persia_tpu.parallel.device_embedding import DeviceEmbeddingBag as J

    rng = np.random.default_rng(1)
    vocab, dim = 50, 16
    hashed = rng.integers(0, vocab, size=(BS, 5)).astype(np.int32)
    mask = rng.random((BS, 5)) < 0.6
    mask[0] = False  # an empty bag: sum 0, and mean divides by 1
    hashed *= mask
    jbag = J(vocab_size=vocab, dim=dim, pooling=pooling,
             compute_dtype=getattr(jnp, dtype))
    params = meta.unbox(jbag.init(jax.random.key(0), jnp.asarray(hashed),
                                  jnp.asarray(mask)))
    want = np.asarray(jbag.apply(params, jnp.asarray(hashed),
                                 jnp.asarray(mask)).astype(jnp.float32))
    tbag = DeviceEmbeddingBag(vocab, dim, pooling=pooling,
                              compute_dtype=getattr(torch, dtype),
                              device="cpu")
    load_flax_params(tbag, numpy_tree(params["params"]))
    got = tbag(torch.from_numpy(hashed), torch.from_numpy(mask)).detach()
    assert got.dtype == getattr(torch, dtype) and got.shape == (BS, dim)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    assert not got[0].float().any()
    ref = DeviceEmbeddingBag(vocab, dim, pooling=pooling,
                             compute_dtype=getattr(torch, dtype),
                             bag_impl="reference", device="cpu")
    ref.load_state_dict(tbag.state_dict())
    assert torch.equal(ref(torch.from_numpy(hashed), torch.from_numpy(mask)),
                       got)


def test_device_embedding_collection_matches_flax():
    """Slots of several vocabs and dims; ids 0 and negatives are padding,
    the rest are hashed into [1, vocab - 1] in int32."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from persia_tpu.parallel.device_embedding import (
        DeviceEmbeddingCollection as J,
    )

    specs = [("a", 64, 8), ("b", 257, 16), ("c", 2, 4)]
    ids = {name: _ids(i, (BS, 3), vocab)
           for i, (name, vocab, _) in enumerate(specs)}
    jcoll = J(slot_specs=specs)
    jids = {k: jnp.asarray(v) for k, v in ids.items()}
    params = meta.unbox(jcoll.init(jax.random.key(2), jids))
    want = jcoll.apply(params, jids)
    tcoll = DeviceEmbeddingCollection(specs, device="cpu")
    assert [n for n, _ in tcoll.named_children()] == ["bag_a", "bag_b",
                                                       "bag_c"]
    load_flax_params(tcoll, numpy_tree(params["params"]))
    with torch.no_grad():
        got = tcoll({k: torch.from_numpy(v) for k, v in ids.items()})
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("sfs", [1, 4, "mixed"])
def test_collection_slots_and_gradients_match_flax(sfs):
    """The collection's kernel path (K1's multi-slot plain version on the
    CPU, through its autograd Function) against the flax collection: two
    dims, several vocabs (one of 2 rows), padding ids 0 and negative;
    the bf16 outputs bit-equal at sfs 1 (one product by 1 or 0, rounded
    once) and within 2**-8 otherwise, every table's gradient against
    ``jax.grad`` within 1e-6 (f32 scatter-adds in another order), and the
    rows the entry reports equal to the JAX hash."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from persia_tpu.parallel.device_embedding import (
        DeviceEmbeddingCollection as J,
    )
    from persia_tpu_torch.ops import embedding_bag as eb

    specs = [("a", 64, 8), ("b", 257, 16), ("c", 2, 8), ("d", 1000, 16),
             ("e", 300, 16)]
    bags = {"mixed": [1, 4, 2, 3, 4]}.get(sfs, [sfs] * len(specs))
    ids = {name: _ids(10 + i, (BS, bag), vocab)
           for i, ((name, vocab, _), bag) in enumerate(zip(specs, bags))}
    rng = np.random.default_rng(12)
    cots = [rng.normal(size=(BS, dim)).astype(np.float32)
            for _, _, dim in specs]
    jcoll = J(slot_specs=specs)
    jids = {k: jnp.asarray(v) for k, v in ids.items()}
    params = meta.unbox(jcoll.init(jax.random.key(3), jids))

    def jloss(p):
        return sum((o.astype(jnp.float32) * c).sum()
                   for o, c in zip(jcoll.apply(p, jids), cots))

    want = jcoll.apply(params, jids)
    want_grads = jax.grad(jloss)(params)["params"]
    tcoll = DeviceEmbeddingCollection(specs, device="cpu")
    load_flax_params(tcoll, numpy_tree(params["params"]))
    tids = {k: torch.from_numpy(v) for k, v in ids.items()}
    got = tcoll(tids)
    sum((g.float() * torch.from_numpy(c)).sum()
        for g, c in zip(got, cots)).backward()
    for (name, vocab, _), g, w in zip(specs, got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == torch.bfloat16
        if sfs == 1:
            np.testing.assert_array_equal(g.detach().float().numpy(), w)
        else:
            np.testing.assert_allclose(g.detach().float().numpy(), w,
                                       rtol=2**-8, atol=1e-6)
        np.testing.assert_allclose(
            getattr(tcoll, f"bag_{name}").table.grad.to_dense().numpy(),
            np.asarray(want_grads[f"bag_{name}"]["table"]), rtol=1e-6,
            atol=1e-6, err_msg=name)
    # the rows of one group, as the backward scatters at them
    group = [i for i, s in enumerate(specs) if s[2] == 16]
    _, rows = eb.embedding_bag_slots_fwd(
        [getattr(tcoll, f"bag_{specs[i][0]}").table.detach() for i in group],
        [tids[specs[i][0]] for i in group])
    for i, r in zip(group, eb.slot_rows(rows, BS, [bags[i] for i in group])):
        raw, vocab = ids[specs[i][0]], specs[i][1]
        np.testing.assert_array_equal(
            r.numpy(), ((raw % (vocab - 1)) + 1) * (raw > 0))


def test_collection_makes_one_kernel_call_per_dim(monkeypatch):
    """``bag_impl="kernel"``: one multi-slot call per distinct embedding
    dim, each over that dim's slots in order, and the outputs are views
    of its (bs, slots, dim) result; ``"reference"`` makes none."""
    from persia_tpu_torch.parallel import device_embedding as de

    calls = []
    inner = de.embedding_bag_slots

    def spy(tables, ids, out_dtype, windows=None):
        assert windows is None  # an unsharded collection
        calls.append([tuple(t.shape) for t in tables])
        return inner(tables, ids, out_dtype)

    monkeypatch.setattr(de, "embedding_bag_slots", spy)
    specs = [("a", 64, 8), ("b", 257, 16), ("c", 2, 8), ("d", 1000, 16)]
    ids = {name: torch.from_numpy(_ids(i, (BS, 2), vocab))
           for i, (name, vocab, _) in enumerate(specs)}
    out = DeviceEmbeddingCollection(specs, device="cpu")(ids)
    assert calls == [[(64, 8), (2, 8)], [(257, 16), (1000, 16)]]
    assert out[0]._base is out[2]._base and out[1]._base is out[3]._base
    assert [tuple(o.shape) for o in out] == [(BS, 8), (BS, 16), (BS, 8),
                                             (BS, 16)]
    calls.clear()
    ref = DeviceEmbeddingCollection(specs, bag_impl="reference",
                                    device="cpu")
    ref.load_state_dict(DeviceEmbeddingCollection(specs,
                                                  device="cpu").state_dict())
    ref(ids)
    assert calls == []


def test_dlrm_pair_order_and_width():
    import jax.numpy as jnp

    for f in (2, 5, 27):
        iu, ju = torch.triu_indices(f, f, offset=1)
        jiu, jju = jnp.triu_indices(f, k=1)
        np.testing.assert_array_equal(iu.numpy(), np.asarray(jiu))
        np.testing.assert_array_equal(ju.numpy(), np.asarray(jju))
    # bench width: 16 + 27 * 26 / 2 top inputs at 26 slots
    assert DLRM(13, 26, device="cpu").MLP_1.Dense_0.in_features == 367


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_dlrm_matches_jax(dtype, tol):
    """Three summed fields and a raw (mean-pooled) one."""
    import jax
    import jax.numpy as jnp

    from persia_tpu.models import DLRM as J

    rng = np.random.default_rng(3)
    dense = rng.normal(size=(BS, NUM_DENSE)).astype(np.float32)
    embs = [rng.normal(size=(BS, DIM)).astype(np.float32) for _ in range(3)]
    raw_emb = rng.normal(size=(BS * 3 + 1, DIM)).astype(np.float32)
    raw_emb[0] = 0.0  # row 0 is the padding row
    raw_idx = rng.integers(0, BS * 3 + 1, size=(BS, 3)).astype(np.int32)
    jmodel = J(embedding_dim=DIM, compute_dtype=getattr(jnp, dtype))
    jin = ([jnp.asarray(dense)], [jnp.asarray(e) for e in embs]
           + [(jnp.asarray(raw_emb), jnp.asarray(raw_idx))])
    params = jmodel.init(jax.random.key(4), *jin)
    want = np.asarray(jmodel.apply(params, *jin))
    tmodel = DLRM(NUM_DENSE, 4, embedding_dim=DIM,
                  compute_dtype=getattr(torch, dtype), device="cpu")
    load_flax_params(tmodel, numpy_tree(params["params"]))
    got = tmodel([torch.from_numpy(dense)],
                 [torch.from_numpy(e) for e in embs]
                 + [(torch.from_numpy(raw_emb), torch.from_numpy(raw_idx))])
    assert got.dtype == torch.float32 and got.shape == (BS, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("init,zero_grads", [(0.1, False), (0.0, True)])
def test_optax_adagrad_matches_optax(init, zero_grads):
    """Five updates on random gradients; with a zero start and gradients
    that are exactly 0 in places, optax's ``where(s > 0, ...)`` branch."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(5)
    shapes = {"w": (7, 5), "b": (5,), "t": (11, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    opt = optax.adagrad(0.02, initial_accumulator_value=init)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_()
               for k, v in params.items()}
    topt = OptaxAdagrad(tparams.values(), 0.02,
                        initial_accumulator_value=init)
    for _ in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        if zero_grads:
            grads["t"][::2] = 0.0
        upd, state = opt.update({k: jnp.asarray(v) for k, v in
                                 grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        topt.step()
    for k, p in tparams.items():
        assert torch.isfinite(p).all()
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[k]), rtol=2**-22,
                                   atol=1e-8, err_msg=k)
    with pytest.raises(ValueError):
        OptaxAdagrad(tparams.values(), 0.02, initial_accumulator_value=-1)


@pytest.mark.parametrize("sfs", [1, 3])
def test_synthetic_device_batch_is_byte_identical(sfs):
    from persia_tpu.parallel import device_mode as jdm

    specs = tdm.criteo_like_specs(SLOTS, VOCAB, DIM)
    assert specs == jdm.criteo_like_specs(SLOTS, VOCAB, DIM)
    jn, ji, jl = jdm.synthetic_device_batch(BS, NUM_DENSE, specs, sfs, seed=9)
    tn, ti, tl = tdm.synthetic_device_batch(BS, NUM_DENSE, specs, sfs,
                                            seed=9, device="cpu")
    assert tn[0].dtype == torch.float32 and tl.dtype == torch.float32
    np.testing.assert_array_equal(tn[0].numpy(), np.asarray(jn[0]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert list(ti) == list(ji)
    for name in ji:
        assert ti[name].dtype == torch.int32
        np.testing.assert_array_equal(ti[name].numpy(), np.asarray(ji[name]))


def _jax_trainer(sfs, compute_dtype, pad_seed=None):
    import jax
    import jax.numpy as jnp
    import optax

    from persia_tpu.models import DLRM as JDLRM
    from persia_tpu.parallel import device_mode as jdm
    from persia_tpu.parallel.mesh import make_mesh

    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    specs = jdm.criteo_like_specs(SLOTS, VOCAB, DIM)
    model = jdm.DeviceModeModel(slot_specs=specs, tower=JDLRM(
        embedding_dim=DIM, compute_dtype=getattr(jnp, compute_dtype)))
    non_id, ids, label = jdm.synthetic_device_batch(BS, NUM_DENSE, specs,
                                                    sfs)
    ids = {k: np.array(v) for k, v in ids.items()}
    if pad_seed is not None:
        for i, v in enumerate(ids.values()):
            pad = np.random.default_rng(pad_seed + i).random(v.shape) < 0.25
            v[pad] = 0
            v[:2, 0] = -7  # negative ids are padding too
    params, opt_state, step = jdm.make_device_mode_trainer(
        model, optax.adagrad(0.02), mesh, non_id, ids)
    batch = ([np.asarray(non_id[0])], ids, np.asarray(label))
    return mesh, specs, params, opt_state, step, batch


def _port_trainer(specs, compute_dtype, jparams, batch):
    tower = DLRM(NUM_DENSE, SLOTS, embedding_dim=DIM,
                 compute_dtype=getattr(torch, compute_dtype), device="cpu")
    model = tdm.DeviceModeModel(specs, tower, device="cpu")
    load_flax_params(model, numpy_tree(jparams))
    return tdm.make_device_mode_trainer(
        model, lambda p: OptaxAdagrad(p, 0.02), batch[0], batch[1],
        seed=None, device="cpu")


@pytest.mark.parametrize("sfs,compute_dtype,tol", [
    (1, "float32", 1e-5),
    (3, "float32", 1e-5),
])
def test_device_mode_steps_match_jax(sfs, compute_dtype, tol):
    """3 steps in both packages from the same weights, on a batch with
    padding and negative ids; every loss and every parameter after."""
    import jax.numpy as jnp

    mesh, specs, params, opt_state, jstep, batch = _jax_trainer(
        sfs, compute_dtype, pad_seed=11)
    model, _, tstep = _port_trainer(specs, compute_dtype, params, batch)
    non_id, ids, label = batch
    jbatch = ([jnp.asarray(non_id[0])], {k: jnp.asarray(v)
                                         for k, v in ids.items()},
              jnp.asarray(label))
    with mesh:
        for _ in range(3):
            params, opt_state, jloss = jstep(params, opt_state, *jbatch)
            tloss = tstep(*batch)
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol,
                                       atol=tol)
    want, got = _flat(params), _flat(flax_params(model)[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)
    # the tables moved, and only at rows the batch touched
    table = got["DeviceEmbeddingCollection_0/bag_slot_0/table"]
    start = _flat(numpy_tree(_jax_trainer(sfs, compute_dtype, 11)[2]))[
        "DeviceEmbeddingCollection_0/bag_slot_0/table"]
    moved = np.flatnonzero((table != start).any(axis=1))
    ids0 = ids["slot_0"]
    touched = np.unique(((ids0 % (VOCAB - 1)) + 1)[ids0 > 0])
    np.testing.assert_array_equal(moved, touched)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_loss_falls_on_a_repeated_batch(package):
    """Random labels at these widths: 30 steps on one batch memorise it,
    which is what chip_smoke.py's gate at bench width relies on."""
    mesh, specs, params, opt_state, jstep, batch = _jax_trainer(3, "bfloat16")
    losses = []
    if package == "jax":
        with mesh:
            for _ in range(30):
                params, opt_state, loss = jstep(params, opt_state, *batch)
                losses.append(float(loss))
    else:
        _, _, tstep = _port_trainer(specs, "bfloat16", params, batch)
        losses = [float(tstep(*batch)) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.01


def test_weight_round_trip_and_seeded_init():
    _, specs, params, _, _, batch = _jax_trainer(1, "bfloat16")
    model, _, _ = _port_trainer(specs, "bfloat16", params, batch)
    want, got = _flat(params), _flat(flax_params(model)[0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["DeviceEmbeddingCollection_0/bag_slot_1/table"].shape == \
        (VOCAB, DIM)
    # seeded init: U[0, 0.01) tables, the same weights for the same seed
    a, b = (init_device_mode(tdm.DeviceModeModel(specs, DLRM(
        NUM_DENSE, SLOTS, embedding_dim=DIM, device="cpu"), device="cpu"), 3)
        for _ in range(2))
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(x, y), name
    tables = [t for n, t in a.state_dict().items() if n.endswith("table")]
    assert len(tables) == SLOTS
    for t in tables:
        assert 0 <= float(t.min()) and float(t.max()) < 0.01
    assert not torch.equal(tables[0], tables[1])


def test_refusals():
    specs = tdm.criteo_like_specs(SLOTS, VOCAB, DIM)
    model = tdm.DeviceModeModel(specs, DLRM(NUM_DENSE, SLOTS, DIM,
                                            device="cpu"), device="cpu")
    non_id, ids, _ = tdm.synthetic_device_batch(BS, NUM_DENSE, specs,
                                                device="cpu")
    # tables row-sharded over a model axis of 2 (a mesh with no process
    # group behind it: the refusal comes before any collective), at a
    # vocab that does not divide the axis
    from torch.distributed.device_mesh import DeviceMesh

    assert VOCAB % 2
    sharded = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"),
                         _init_backend=False, _rank=0)
    with pytest.raises(ValueError, match=f"slot slot_0: vocab {VOCAB} does "
                                         f"not divide the model axis"):
        tdm.make_device_mode_trainer(model, lambda p: OptaxAdagrad(p, 0.1),
                                     non_id, ids, device="cpu",
                                     mesh=sharded)
    with pytest.raises(KeyError):
        tdm.make_device_mode_trainer(model, lambda p: OptaxAdagrad(p, 0.1),
                                     non_id, {"slot_0": ids["slot_0"]},
                                     device="cpu")
    with pytest.raises(ValueError):
        DeviceEmbeddingBag(10, 4, pooling="max", device="cpu")
    with pytest.raises(ValueError):
        DeviceEmbeddingCollection([("a", 1, 4)], device="cpu")
    if not torch.cuda.is_available():
        # the default device is CUDA: without a card it raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdm.synthetic_device_batch(BS, NUM_DENSE, specs)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceEmbeddingCollection(specs)
