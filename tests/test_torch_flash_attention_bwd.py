"""Kernels K3 and K4 (the flash-attention backward) and K2's logsumexp in
the PyTorch port, against the JAX package's Pallas kernels run in
interpret mode as the JAX tests run them on the CPU.

On the CPU the port's wrappers run the plain PyTorch versions; the CUDA
kernels are held against those plain versions on the card (the
``gpu``-marked tests below and ``chip_smoke.py``).

Tolerances:
- f32 2e-5: the same arithmetic in another summation order (Pallas
  accumulates blockwise over 32-wide tiles, the plain version in one
  einsum), on O(1) inputs and gradients;
- bf16: the bounds of ``tests/test_flash_attention.py``'s bf16 gradient
  test (rtol 1e-1, atol 1e-2). The Pallas kernels round p and ds to bf16
  before their products; the port keeps them in f32 and rounds only the
  outputs.
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch.ops import flash_attention as fa

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=1e-1, atol=1e-2)}


def _inputs(seed, b, h, t_q, t_k, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, t_q, dh)).astype(np.float32)
    k = rng.normal(size=(b, h, t_k, dh)).astype(np.float32)
    v = rng.normal(size=(b, h, t_k, dh)).astype(np.float32)
    do = rng.normal(size=(b, h, t_q, dh)).astype(np.float32)
    mask = rng.random((b, t_k)) < 0.6
    mask[1] = False  # a fully masked batch row: output and gradients 0
    return q, k, v, do, mask


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch,
                                                                  dtype))


def _j(x, dtype="float32"):
    import jax.numpy as jnp

    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k", [(48, 112), (100, 100)])
def test_plain_lse_matches_pallas(causal, t_q, t_k):
    from persia_tpu.ops.flash_attention import flash_attention_fwd_pallas

    q, k, v, _, mask = _inputs(1 + causal, 2, 2, t_q, t_k, 16)
    want_out, want_lse = flash_attention_fwd_pallas(
        _j(q), _j(k), _j(v), causal=causal, block_q=32, block_k=32,
        interpret=True, return_lse=True, kv_mask=_j(mask, "bool_"))
    out, lse = fa.flash_attention_fwd_reference(
        _t(q), _t(k), _t(v), torch.from_numpy(mask), causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, t_q)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=2e-5,
                               atol=2e-5)
    # the fully masked row: both pin lse at -1e30, the backward's marker
    assert (lse[1] <= fa.NEG_INF / 2).all()
    assert (np.asarray(want_lse)[1] <= fa.NEG_INF / 2).all()
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(want_lse)[0],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k,dh", [(48, 112, 4), (112, 48, 16),
                                        (64, 64, 4)])
def test_plain_backward_matches_pallas(dtype, causal, t_q, t_k, dh):
    """Ragged T on both grids (48/112 against 32-blocks), T_q != T_k both
    ways, Dh 4 and 16, a key mask with a fully masked row."""
    from persia_tpu.ops.flash_attention import (
        flash_attention_bwd_pallas,
        flash_attention_fwd_pallas,
    )

    q, k, v, do, mask = _inputs(dh + t_q + causal, 2, 2, t_q, t_k, dh)
    jq, jk, jv, jdo = (_j(x, dtype) for x in (q, k, v, do))
    jmask = _j(mask, "bool_")
    out, lse = flash_attention_fwd_pallas(
        jq, jk, jv, causal=causal, block_q=32, block_k=32, interpret=True,
        return_lse=True, kv_mask=jmask)
    want = flash_attention_bwd_pallas(
        jq, jk, jv, out, lse, jdo, causal=causal, block_q=32, block_k=32,
        interpret=True, kv_mask=jmask)
    tq, tk, tv, tdo = (_t(x, dtype) for x in (q, k, v, do))
    tmask = torch.from_numpy(mask)
    t_out, t_lse = fa.flash_attention_fwd(tq, tk, tv, tmask, causal,
                                          return_lse=True)
    got = fa.flash_attention_bwd(tq, tk, tv, t_out, t_lse, tdo, tmask,
                                 causal)
    for g, w, x in zip(got, want, (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype])
    # the fully masked batch row has exactly zero gradients
    for g in got:
        assert (g[1] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_match_jax_grad(causal):
    """The autograd Function against ``jax.grad`` through the JAX
    package's ``flash_attention_masked`` (Pallas forward and backward in
    interpret mode), with a non-contiguous cotangent as the model gives."""
    import jax

    from persia_tpu.ops.flash_attention import flash_attention_masked as jfa

    q, k, v, do, mask = _inputs(5 + causal, 2, 2, 40, 40, 4)
    # weights of the loss, laid out (B, T, H, Dh) like the model's output
    w = np.random.default_rng(9).normal(size=(2, 40, 2, 4)).astype(
        np.float32)
    jmask = _j(mask, "bool_")

    def jloss(q, k, v):
        out = jfa(q, k, v, kv_mask=jmask, causal=causal, block_q=16,
                  block_k=16, interpret=True)
        return (out.transpose(0, 2, 1, 3) * _j(w)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    out = fa.flash_attention_masked(tq, tk, tv, kv_mask=tmask, causal=causal)
    assert out.grad_fn is not None
    (out.permute(0, 2, 1, 3) * _t(w)).sum().backward()
    for g, wnt in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=2e-5,
                                   atol=2e-5)
        assert (g[1] == 0).all()


def test_mask_gets_no_gradient_and_eval_skips_the_function():
    q, k, v, _, mask = _inputs(3, 2, 2, 16, 16, 4)
    tq = _t(q).requires_grad_()
    tmask = torch.from_numpy(mask).float().requires_grad_()
    out = fa.flash_attention_masked(tq, _t(k), _t(v), kv_mask=tmask)
    out.sum().backward()
    assert tmask.grad is None and tq.grad is not None
    with torch.inference_mode():
        out = fa.flash_attention_masked(_t(q), _t(k), _t(v), kv_mask=tmask)
    assert out.grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention_masked(tq, _t(k), _t(v)).grad_fn is None


def test_cpu_wrappers_do_not_count_launches():
    fa.reset_launch_count()
    q, k, v, do, mask = _inputs(4, 2, 2, 16, 16, 4)
    out, lse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), return_lse=True)
    fa.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(do))
    assert all(fa.launch_count(n) == 0 for n in fa.KERNEL_SOURCES)


def _cuda_case(seed, b, h, t_q, t_k, dh, dtype, causal):
    q, k, v, do, mask = _inputs(seed, b, h, t_q, t_k, dh)
    dev = torch.device("cuda")
    tq, tk, tv, tdo = (_t(x, dtype).to(dev) for x in (q, k, v, do))
    tmask = torch.from_numpy(mask).to(dev)
    fa.reset_launch_count()
    out, lse = fa.flash_attention_fwd(tq, tk, tv, tmask, causal,
                                      return_lse=True)
    got = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, tmask, causal)
    torch.cuda.synchronize()
    assert [fa.launch_count(n) for n in fa.KERNEL_SOURCES] == [1, 1, 1]
    want_out, want_lse = fa.flash_attention_fwd_reference(
        tq, tk, tv, tmask, causal, return_lse=True)
    want = fa.flash_attention_bwd_reference(tq, tk, tv, want_out, want_lse,
                                            tdo, tmask, causal)
    return (out, lse, got), (want_out, want_lse, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k,dh", [(48, 112, 16), (112, 48, 4),
                                        (200, 200, 128)])
def test_cuda_kernels_match_plain(dtype, causal, t_q, t_k, dh):
    """K2 with the lse, K3 and K4 on the card against their plain
    versions. Card tolerances: f32 1e-4 (another summation order over up
    to 200 keys); bf16 2e-2 on outputs rounded once to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")
    tol = 1e-4 if dtype == "float32" else 2e-2
    (out, lse, got), (w_out, w_lse, want) = _cuda_case(
        t_q + dh, 3, 2, t_q, t_k, dh, dtype, causal)
    np.testing.assert_allclose(_np(out.cpu()), _np(w_out.cpu()), rtol=tol,
                               atol=tol)
    assert (lse[1] <= fa.NEG_INF / 2).all()
    np.testing.assert_allclose(lse.cpu().numpy()[[0, 2]],
                               w_lse.cpu().numpy()[[0, 2]], rtol=1e-5,
                               atol=1e-4)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        np.testing.assert_allclose(_np(g.cpu()), _np(w.cpu()), rtol=tol,
                                   atol=tol)
        assert (g[1] == 0).all()
