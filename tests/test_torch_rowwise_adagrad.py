"""Row-wise Adagrad: ``OptaxAdagrad`` on row (sparse) gradients, K1's row
gradients, and the kernel ``csrc/rowwise_adagrad.cu``.

On the CPU (the kernel's plain version): a step on uncoalesced row
gradients (duplicate rows, zero entries at row 0 for padding, a shard's
clamped out-of-window rows, several tables beside dense tower parameters
in one group, two steps on one state) against the same step on the
densified gradients (the dense foreach passes) and against
``optax.adagrad``; K1's row gradient densified against the dense
``zeros`` + ``index_add_`` gradient, unwindowed and under a shard window;
device mode with an optimizer that takes no row gradients.

On the card (``-m gpu``, no JAX): the kernel against its plain version at
the shape of ``dlrm-bench-random.train-multihot`` (8 tables of 1M x 64, 1.64M ids, ~800k of them padding on
row 0) and at a Zipf head of 5,000 ids on one row a table, D = 13 for the
scalar body, more tables than one launch takes; two runs bit for bit; one
launch a device-mode step.

Tolerances, each with its reason:

- untouched rows and their accumulators: bit for bit (no entry, no write);
- touched rows against ``optax.adagrad``: rtol 2**-22, atol 1e-8, the
  bound of ``test_optax_adagrad_matches_optax`` (XLA's and PyTorch's
  rsqrt differ by an ulp);
- K1's row gradient densified against ``zeros`` + ``index_add_``: equal
  (both add a row's entries in the ids' order);
- the kernel against its plain version on the card, touched rows: where
  the entries are multiples of 1/64 below 4 (every partial sum exact in
  f32, in any order), the bound of ``optax``'s test, rtol 2**-22 and atol
  1e-8, for the update's arithmetic alone; where they are normal draws,
  rtol 1e-5 and atol 1e-7 (the kernel sums a row in sorted order in
  chunks of 32, the plain version in the entries' order; rows of a few
  entries). A head of thousands of normal draws cancels to a small sum
  whose rounding depends on the order: that is what the exact cases
  cover instead.
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch.models.dlrm import DLRM
from persia_tpu_torch.ops import embedding_bag as eb
from persia_tpu_torch.ops import rowwise_adagrad as rw
from persia_tpu_torch.parallel.device_mode import (
    DeviceModeModel,
    make_device_mode_trainer,
    synthetic_device_batch,
)
from persia_tpu_torch.parallel.optim import OptaxAdagrad

LR, INIT = 0.02, 0.1


def _row_grad(rng, rows, dim, n, pad=0.0, outside=0.0):
    """An uncoalesced (rows, dim) row gradient of ``n`` entries: random
    rows with duplicates, ``pad`` of them padding and ``outside`` of them
    a shard's out-of-window ids (both an entry of zeros at row 0)."""
    idx = rng.integers(0, rows, n)
    idx[: n // 8] = idx[0]  # a row many entries share
    v = rng.normal(size=(n, dim)).astype(np.float32)
    zero = rng.random(n) < pad + outside
    idx[zero] = 0
    v[zero] = 0.0
    return torch.sparse_coo_tensor(torch.from_numpy(idx)[None],
                                   torch.from_numpy(v), (rows, dim),
                                   check_invariants=False)


CASES = {
    # name: (table shapes, entries a table, padding share, outside share,
    # dense tower parameters)
    "duplicates": ([(50, 8)], 400, 0.0, 0.0, False),
    "padding": ([(50, 8)], 400, 0.4, 0.0, False),
    "window": ([(25, 8)], 300, 0.1, 0.3, False),
    "tables_and_tower": ([(50, 8), (7, 8), (300, 4)], 200, 0.2, 0.0, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_row_step_matches_dense_step_and_optax(case):
    """Two steps of ``OptaxAdagrad`` on row gradients against two on the
    same gradients densified (the foreach passes) and ``optax.adagrad``:
    untouched rows and accumulators bit for bit, touched rows within
    optax's bound; the span's entries counted."""
    import jax.numpy as jnp
    import optax

    shapes, n, pad, outside, tower = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    start = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if tower:
        start += [rng.normal(size=(5, 3)).astype(np.float32),
                  rng.normal(size=(3,)).astype(np.float32)]
    rows_p = [torch.from_numpy(x.copy()).requires_grad_() for x in start]
    dense_p = [torch.from_numpy(x.copy()).requires_grad_() for x in start]
    row_opt = OptaxAdagrad(rows_p, LR, initial_accumulator_value=INIT)
    dense_opt = OptaxAdagrad(dense_p, LR, initial_accumulator_value=INIT)
    jopt = optax.adagrad(LR, initial_accumulator_value=INIT)
    jparams = [jnp.asarray(x) for x in start]
    jstate = jopt.init(jparams)
    touched = [np.zeros(s[0], bool) for s in shapes]
    for _ in range(2):
        grads = [_row_grad(rng, r, d, n, pad, outside) for r, d in shapes]
        grads += [torch.from_numpy(rng.normal(size=x.shape).astype(
            np.float32)) for x in start[len(shapes):]]
        for t, g in zip(touched, grads):
            t[g._indices()[0].numpy()] = True
        for p, g in zip(rows_p, grads):
            p.grad = g
        for p, g in zip(dense_p, grads):
            p.grad = g.to_dense() if g.is_sparse else g.clone()
        row_opt.step()
        dense_opt.step()
        upd, jstate = jopt.update(
            [jnp.asarray((g.to_dense() if g.is_sparse else g).numpy())
             for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for i, (rp, dp, jp) in enumerate(zip(rows_p, dense_p, jparams)):
        rs = row_opt.state[rp]["sum_of_squares"]
        ds = dense_opt.state[dp]["sum_of_squares"]
        if i < len(shapes):
            moved = torch.from_numpy(touched[i])
            assert torch.equal(rp[~moved], torch.from_numpy(start[i])[~moved])
            assert torch.equal(rp[~moved], dp[~moved])
            assert bool((rs[~moved] == INIT).all())
            assert torch.equal(rs[~moved], ds[~moved])
        else:
            assert not rp.grad.is_sparse
        np.testing.assert_allclose(rp.detach().numpy(), np.asarray(jp),
                                   rtol=2**-22, atol=1e-8, err_msg=str(i))
        np.testing.assert_allclose(rp.detach().numpy(), dp.detach().numpy(),
                                   rtol=2**-22, atol=1e-8, err_msg=str(i))
        np.testing.assert_allclose(rs.numpy(), ds.numpy(), rtol=2**-22,
                                   atol=1e-8, err_msg=str(i))


def test_rowwise_reference_counts_entries_and_refuses_devices():
    rng = np.random.default_rng(3)
    p, s = torch.zeros(10, 4), torch.full((10, 4), INIT)
    g = _row_grad(rng, 10, 4, 33)
    assert rw.rowwise_adagrad([p], [g], [s], LR, 1e-7) == 33
    assert rw.rowwise_adagrad([], [], [], LR, 1e-7) == 0
    assert rw.launch_count() == 0  # the plain version counts nothing
    meta = torch.zeros(10, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rw.rowwise_adagrad([meta], [g], [meta], LR, 1e-7)


W_VOCAB = 40


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("window", [None, (0, 20), (20, 20)])
def test_slot_bags_row_gradient_is_the_dense_scatter(window, deterministic):
    """K1's backward gives each table an uncoalesced row gradient of the
    table's (the shard's) shape, one entry an id, whose dense form equals
    the old ``zeros`` + ``index_add_`` at the clamped rows exactly; every
    table's entries are views of one buffer (autograd took them without a
    copy)."""
    rng = np.random.default_rng(7)
    bags, batch = (1, 3, 2), 16
    tables = [torch.from_numpy(rng.normal(size=(W_VOCAB, 8)).astype(
        np.float32)) for _ in bags]
    ids = []
    for bag in bags:
        i = rng.integers(1, 1 << 31, (batch, bag))
        i[rng.random((batch, bag)) < 0.3] = 0
        ids.append(torch.from_numpy(i))
    wins = None
    if window is not None:
        lo, n = window
        tables = [t[lo:lo + n].clone() for t in tables]
        wins = [(lo, W_VOCAB)] * len(tables)
    cot = torch.from_numpy(rng.normal(size=(batch, len(bags), 8)).astype(
        np.float32))
    ts = [t.clone().requires_grad_() for t in tables]
    (eb.embedding_bag_slots(ts, ids, torch.float32, wins) * cot).sum() \
        .backward()
    _, rows = eb.embedding_bag_slots_reference(tables, ids, torch.float32,
                                               wins)
    first = 1 if window is None or window[0] == 0 else 0
    storage = {t.grad._values().untyped_storage().data_ptr() for t in ts}
    assert len(storage) == 1
    for k, (t, r, bag) in enumerate(zip(ts, eb.slot_rows(rows, batch, bags),
                                        bags)):
        g = t.grad
        assert g.is_sparse and not g.is_coalesced()
        assert g.shape == t.shape and g._nnz() == batch * bag
        contrib = cot[:, k, None, :].expand(batch, bag, 8) \
            * (r >= first)[..., None]
        want = torch.zeros_like(t).index_add_(
            0, r.reshape(-1).clamp_min(0).long(), contrib.reshape(-1, 8))
        assert torch.equal(g.to_dense(), want)


SLOTS, VOCAB, DIM, NUM_DENSE = 4, 257, 8, 13


def _device_model(bag_impl="kernel", device="cpu"):
    specs = [(f"slot_{i}", VOCAB, DIM) for i in range(SLOTS)]
    tower = DLRM(NUM_DENSE, SLOTS, embedding_dim=DIM, bottom_mlp=(16, DIM),
                 top_mlp=(16, 1), compute_dtype=torch.float32, device=device)
    return specs, DeviceModeModel(specs, tower, bag_impl=bag_impl,
                                  device=device)


def test_device_mode_densifies_for_an_optimizer_without_row_grads():
    """``torch.optim.Adam`` declares no row gradients: the step hands it
    dense table gradients, equal to the plain tower's (autograd through
    the gather), and it steps; ``OptaxAdagrad`` gets row gradients."""
    specs, model = _device_model()
    non_id, ids, label = synthetic_device_batch(32, NUM_DENSE, specs, 3,
                                                seed=4, device="cpu")
    _, plain = _device_model("reference")
    model, _, step = make_device_mode_trainer(
        model, lambda p: torch.optim.Adam(p, 1e-3), non_id, ids, seed=5,
        device="cpu")
    plain.load_state_dict(model.state_dict())
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    step(non_id, ids, label)
    plain.train()
    torch.nn.functional.binary_cross_entropy(
        plain(non_id, ids), label).backward()
    plain_grads = dict(plain.named_parameters())
    for name, p in model.named_parameters():
        if name.endswith(".table"):
            assert p.grad.layout == torch.strided, name
            torch.testing.assert_close(p.grad, plain_grads[name].grad,
                                       rtol=1e-5, atol=1e-7)
            assert not torch.equal(p.detach(), start[name]), name
    _, model2 = _device_model()
    model2, _, step2 = make_device_mode_trainer(
        model2, lambda p: OptaxAdagrad(p, LR), non_id, ids, seed=5,
        device="cpu")
    step2(non_id, ids, label)
    tables = [p for n, p in model2.named_parameters() if n.endswith(".table")]
    assert tables and all(p.grad.is_sparse for p in tables)


# --- on the card -------------------------------------------------------------


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")


def _card_case(seed, tables, ids_per_table, pad, head, exact):
    """Tables (V, D), accumulators, and uncoalesced row gradients on the
    card: ``pad`` of a table's entries padding (zeros at row 0), ``head``
    entries on one row, the rest uniform over the rows; entries normal, or
    (``exact``) multiples of 1/64 in [-4, 4]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params, sums, grads = [], [], []
    for rows, dim in tables:
        params.append(torch.randn(rows, dim, generator=gen, device="cuda"))
        sums.append(torch.rand(rows, dim, generator=gen, device="cuda")
                    + INIT)
        idx = torch.randint(0, rows, (ids_per_table,), generator=gen,
                            device="cuda")
        idx[:head] = rows // 2
        v = torch.randn(ids_per_table, dim, generator=gen, device="cuda")
        if exact:
            v = torch.randint(-256, 257, v.shape, generator=gen,
                              device="cuda").float() / 64
        padding = torch.rand(ids_per_table, generator=gen,
                             device="cuda") < pad
        idx[padding] = 0
        v[padding] = 0.0
        grads.append(torch.sparse_coo_tensor(idx[None], v, (rows, dim),
                                             check_invariants=False))
    return params, sums, grads


CARD_CASES = {
    # name: (tables, entries a table, padding share, head entries, exact)
    "multihot": ([(1_000_000, 64)] * 8, 204_800, 0.49, 0, False),
    "multihot_exact": ([(1_000_000, 64)] * 8, 204_800, 0.49, 0, True),
    "zipf_head": ([(100_000, 16)] * 26, 16_384, 0.0, 5_000, True),
    "scalar": ([(3000, 13), (50, 13)], 9_000, 0.2, 2_000, True),
    "split": ([(500, 8)] * (rw.MAX_TABLES + 6), 700, 0.1, 100, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_cuda_rowwise_matches_plain(case):
    """The kernel against its plain version on the card: untouched rows
    and the padding row bit for bit, touched rows within the sum order's
    bound, two runs bit for bit, one update launch a call of up to
    MAX_TABLES tables of one width."""
    _skip_without_card()
    tables, n, pad, head, exact = CARD_CASES[case]
    params, sums, grads = _card_case(list(CARD_CASES).index(case), tables,
                                     n, pad, head, exact)
    tol = dict(rtol=2**-22, atol=1e-8) if exact else dict(rtol=1e-5,
                                                          atol=1e-7)
    runs = []
    for fn in (rw.rowwise_adagrad, rw.rowwise_adagrad,
               rw.rowwise_adagrad_reference):
        p = [x.clone() for x in params]
        s = [x.clone() for x in sums]
        rw.reset_launch_count()
        assert fn(p, grads, s, LR, 1e-7) == n * len(tables)
        torch.cuda.synchronize()
        runs.append((p, s, rw.launch_count()))
    (kp, ks, launches), (kp2, ks2, _), (rp, rs, plain_launches) = runs
    assert launches == -(-len(tables) // rw.MAX_TABLES)
    assert plain_launches == 0
    for i, g in enumerate(grads):
        assert torch.equal(kp[i], kp2[i]) and torch.equal(ks[i], ks2[i])
        # rows with a nonzero entry (the padding row has zeros only)
        touched = torch.zeros(g.shape[0], dtype=torch.bool, device="cuda")
        touched[g._indices()[0][g._values().ne(0).any(1)]] = True
        for got, plain, start in ((kp[i], rp[i], params[i]),
                                  (ks[i], rs[i], sums[i])):
            assert torch.equal(got[~touched], start[~touched])
            assert torch.equal(plain[~touched], start[~touched])
            torch.testing.assert_close(got[touched], plain[touched], **tol)
        assert not torch.equal(kp[i][touched], params[i][touched])


@pytest.mark.gpu
def test_cuda_rowwise_refusals():
    """What the kernel does not take raises before a launch; the library's
    chunk is the wrapper's."""
    _skip_without_card()
    from persia_tpu_torch.ops import _build

    assert _build.load(rw.KERNEL).persia_rowwise_adagrad_chunk() == rw.CHUNK
    p = torch.zeros(10, 4, device="cuda")
    g = torch.sparse_coo_tensor(torch.zeros(1, 3, dtype=torch.long,
                                            device="cuda"),
                                torch.ones(3, 4, device="cuda"), (10, 4))
    with pytest.raises(TypeError):
        rw.rowwise_adagrad([p.double()], [g.double()], [p.double()], LR, 0.0)
    with pytest.raises(ValueError):
        rw.rowwise_adagrad([p], [g.to_dense()], [p.clone()], LR, 0.0)
    with pytest.raises(ValueError):
        rw.rowwise_adagrad([p], [g], [p.cpu()], LR, 0.0)


@pytest.mark.gpu
def test_cuda_device_mode_step_launches_rowwise_once():
    """A device-mode step on the card: row gradients (every table's entries
    in one buffer), one update launch and one keys launch a step, and the
    same 3 steps as the plain tower
    (dense gradients, the foreach passes) within the f32 tower's bound."""
    _skip_without_card()
    specs, model = _device_model(device="cuda")
    non_id, ids, label = synthetic_device_batch(512, NUM_DENSE, specs, 3,
                                                seed=4, device="cuda")
    model, _, step = make_device_mode_trainer(
        model, lambda p: OptaxAdagrad(p, LR), non_id, ids, seed=5,
        device="cuda")
    _, plain = _device_model("reference", device="cuda")
    plain.load_state_dict(model.state_dict())
    plain, _, pstep = make_device_mode_trainer(
        plain, lambda p: OptaxAdagrad(p, LR), non_id, ids, seed=None,
        device="cuda")
    rw.reset_launch_count()
    eb.reset_launch_count()
    losses = [(float(step(non_id, ids, label)),
               float(pstep(non_id, ids, label))) for _ in range(3)]
    assert rw.launch_count() == 3 and eb.launch_count() == 3
    from persia_tpu_torch.ops import _build

    assert _build.launch_count(rw.KEYS) == 3
    tables = [p for n, p in model.named_parameters() if n.endswith(".table")]
    assert all(p.grad.is_sparse for p in tables)
    # autograd kept the backward's buffer: no copy of the entries
    assert len({p.grad._values().untyped_storage().data_ptr()
                for p in tables}) == 1
    for a, b in losses:
        assert abs(a - b) <= 1e-5
    pparams = dict(plain.named_parameters())
    for n, p in model.named_parameters():
        torch.testing.assert_close(p, pparams[n], rtol=1e-5, atol=1e-5)
