"""Kernels K1 (embedding bag) and K5 (copy-shape probe) of the PyTorch
port against the JAX package, on the CPU.

K1's plain version (``persia_tpu_torch.ops.embedding_bag``) is held
against ``xla_embedding_bag`` and against the Pallas kernel run in
interpret mode, as the JAX tests run it; its out-of-range rule against
the Pallas kernel; the autograd Function's gradients against ``jax.grad``
of the custom-vjp ``embedding_bag``. K5's plain version is held against
the numpy base of ``tools/probe_dma_shapes.py``. On the CPU the wrappers
run the plain versions and count no launch; the CUDA kernels themselves
are held against the plain versions on the card (``chip_smoke.py`` and
the ``gpu``-marked test below).

Tolerance for K1 in f32: rtol=atol=1e-6. Each output is a sum of S
rounded products; the versions add them in other orders (XLA's reduce,
the Pallas kernel's masked lane sums), each worth an ulp or two of the
O(1) result. Gradients: 1e-6 likewise (a scatter-add of S·B rounded
products, and a D-long dot per weight). K5 is a copy: exact.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

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


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """K1 against its plain version on the card: bit-equal at S = 1,
    within 1e-6 abs + 1e-5 rel at S = 8 with out-of-range ids; launches
    counted. K5's four cases equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")
    eb.reset_launch_count()
    for seed, (vocab, dim, batch, bag) in enumerate(
            [(1000, 16, 4096, 1), (997, 13, 37, 8), (64, 32, 13, 3)]):
        table, ids, weights = _inputs(seed, vocab, dim, batch, bag)
        ids[2:5, -1] = [-1, vocab, vocab + 7]
        tt, ti, tw = (t.cuda() for t in _torch(table, ids, weights))
        got = eb.embedding_bag_fwd(tt, ti, tw)
        want = eb.embedding_bag_reference(tt, ti, tw)
        torch.cuda.synchronize()
        if bag == 1:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert eb.launch_count() == 3
    pc.reset_launch_count()
    for name in pc.CASES:
        src, idx = pc.case_inputs(name, "cuda")
        assert torch.equal(pc.probe_copy(src, idx),
                           pc.probe_copy_reference(src, idx))
    assert pc.launch_count() == len(pc.CASES)
