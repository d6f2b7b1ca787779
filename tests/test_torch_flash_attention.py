"""Kernel K2 of the PyTorch port (persia_tpu_torch.ops.flash_attention)
against the JAX package's Pallas forward kernel, run in interpret mode as
the JAX tests run it on the CPU, and against ``reference_attention``.

On the CPU the port's wrapper runs the plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card
(``chip_smoke.py`` and the ``gpu``-marked test below). The backward
kernels K3 and K4 are tested in ``test_torch_flash_attention_bwd.py``.

Tolerances: f32 rtol=atol=2e-5 — the same math in another summation
order (blockwise online softmax in Pallas, one dense softmax in the plain
version). bf16 rtol=atol=2e-2 — both round the output to bf16 (2**-8
relative), and the Pallas kernel also rounds the probabilities to bf16
before the p·v product, where the port keeps them in f32.
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch.ops.flash_attention import (
    flash_attention_fwd_reference,
    flash_attention_masked,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, h, t_q, t_k, dh, masked):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, t_q, dh)).astype(np.float32)
    k = rng.normal(size=(b, h, t_k, dh)).astype(np.float32)
    v = rng.normal(size=(b, h, t_k, dh)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((b, t_k)) < 0.6
        mask[0] = False  # a fully masked batch row must give 0
    return q, k, v, mask


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(x, dtype=getattr(jnp, dtype))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k", [(100, 100), (40, 100)])
@pytest.mark.parametrize("dh", [4, 16])
def test_plain_matches_pallas_f32(causal, t_q, t_k, dh):
    """Ragged T (100 with 32-blocks), T_q != T_k, Dh in {4, 16}, causal on
    and off, a key mask with fully masked rows."""
    from persia_tpu.ops.flash_attention import flash_attention_fwd_pallas
    from persia_tpu.parallel.ring_attention import reference_attention

    q, k, v, mask = _inputs(dh + t_q + causal, 2, 2, t_q, t_k, dh, True)
    jq, jk, jv = (_jax(x, "float32") for x in (q, k, v))
    want = np.asarray(flash_attention_fwd_pallas(
        jq, jk, jv, causal=causal, block_q=32, block_k=32, interpret=True,
        kv_mask=_jax(mask, "bool_")))
    ref = np.asarray(reference_attention(jq, jk, jv, causal=causal,
                                         kv_mask=_jax(mask, "bool_")))
    tq, tk, tv = (_torch(x, "float32") for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    plain = flash_attention_fwd_reference(tq, tk, tv, kv_mask=tmask,
                                          causal=causal).numpy()
    wrapped = flash_attention_masked(tq, tk, tv, kv_mask=tmask,
                                     causal=causal).numpy()
    for got in (plain, wrapped):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    # the fully masked batch row gives exact zeros, not NaN
    assert (plain[0] == 0).all() and np.isfinite(plain).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_without_mask(dtype, causal):
    from persia_tpu.ops.flash_attention import flash_attention_fwd_pallas

    q, k, v, _ = _inputs(7 + causal, 2, 3, 100, 100, 16, False)
    want = np.asarray(flash_attention_fwd_pallas(
        *(_jax(x, dtype) for x in (q, k, v)), causal=causal, block_q=32,
        block_k=32, interpret=True).astype("float32"))
    got = flash_attention_masked(*(_torch(x, dtype) for x in (q, k, v)),
                                 causal=causal)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_plain_matches_pallas_bf16_masked():
    from persia_tpu.ops.flash_attention import flash_attention_fwd_pallas

    q, k, v, mask = _inputs(11, 2, 2, 64, 64, 4, True)
    want = np.asarray(flash_attention_fwd_pallas(
        *(_jax(x, "bfloat16") for x in (q, k, v)), block_q=32, block_k=32,
        interpret=True, kv_mask=_jax(mask, "bool_")).astype("float32"))
    got = flash_attention_masked(*(_torch(x, "bfloat16") for x in (q, k, v)),
                                 kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_cuda_device_without_card_raises():
    from persia_tpu_torch.device import resolve_device
    from persia_tpu_torch.models import SequenceTower

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        SequenceTower(4, [(16, True)])  # the default device is CUDA
    assert resolve_device("cpu").type == "cpu"


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 2, 8, 4)
    with pytest.raises(ValueError):
        flash_attention_masked(q, q, q[:, :, :, :2])
    with pytest.raises(ValueError):
        flash_attention_masked(q, q, q, kv_mask=torch.ones(2, 9))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_and_refuses_grad():
    """K2 against its plain version on the card; an input that requires
    grad is no longer refused but differentiated through K3 and K4, which
    agree with the plain backward."""
    from persia_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")
    q, k, v, mask = _inputs(3, 4, 2, 100, 100, 16, True)
    tq, tk, tv = (_torch(x, "bfloat16").cuda() for x in (q, k, v))
    tmask = torch.from_numpy(mask).cuda()
    for causal in (False, True):
        got = flash_attention_masked(tq, tk, tv, kv_mask=tmask, causal=causal)
        want = flash_attention_fwd_reference(tq, tk, tv, kv_mask=tmask,
                                             causal=causal)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=2e-2, atol=2e-2)
    gq, gk, gv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    fa.reset_launch_count()
    out = flash_attention_masked(gq, gk, gv, kv_mask=tmask, causal=True)
    do = torch.randn_like(out)
    out.backward(do)
    torch.cuda.synchronize()
    assert fa.launch_count(fa.DQ_KERNEL) == fa.launch_count(fa.DKV_KERNEL) == 1
    w_out, w_lse = fa.flash_attention_fwd_reference(tq, tk, tv, tmask, True,
                                                    return_lse=True)
    want = fa.flash_attention_bwd_reference(tq, tk, tv, w_out, w_lse, do,
                                            tmask, True)
    for g, w in zip((gq.grad, gk.grad, gv.grad), want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=2e-2,
                                   atol=2e-2)
