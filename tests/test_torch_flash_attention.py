"""Kernel K2 of the PyTorch port (persia_tpu_torch.ops.flash_attention)
against the JAX package's Pallas forward kernel, run in interpret mode as
the JAX tests run it on the CPU, and against ``reference_attention``.

On the CPU the port's wrapper runs the plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card
(``chip_smoke.py`` and the ``gpu``-marked tests below, which cover both of
K2's bodies). The backward kernels K3 and K4 are tested in
``test_torch_flash_attention_bwd.py``.

Tolerances: f32 rtol=atol=2e-5 — the same math in another summation
order (blockwise online softmax in Pallas, one dense softmax in the plain
version). bf16 rtol=atol=2e-2 — both round the output to bf16 (2**-8
relative), and the Pallas kernel and K2's bf16 body also round the
probabilities to bf16 before the p·v product, where the plain version
keeps them in f32. The logsumexp is f32 everywhere: 1e-4 absolute, the
same sums in another order.
"""

import numpy as np
import pytest
import torch

from persia_tpu_torch.ops import flash_attention as fa
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


@pytest.mark.parametrize("dtype,dh,t_q,aligned,want", [
    # the attention bench's shape: tensor cores, TMA, two warpgroups
    (torch.bfloat16, 128, 8192, True, (fa.BODY_BF16_TMA, 128)),
    # the sequence tower's Dh=4: rows of 8 bytes are no TMA rows
    (torch.bfloat16, 4, 64, True, (fa.BODY_BF16_CP_ASYNC, 64)),
    (torch.bfloat16, 8, 65, True, (fa.BODY_BF16_TMA, 128)),
    (torch.bfloat16, 12, 100, True, (fa.BODY_BF16_CP_ASYNC, 128)),
    # a view that starts off a 16-byte boundary cannot be a TMA source
    (torch.bfloat16, 64, 40, False, (fa.BODY_BF16_CP_ASYNC, 64)),
    # f32 keeps the CUDA-core body at every width
    (torch.float32, 128, 8192, True, (fa.BODY_F32_CUDA_CORES, 64)),
    (torch.float32, 4, 64, True, (fa.BODY_F32_CUDA_CORES, 64)),
])
def test_fwd_plan_picks_the_body(dtype, dh, t_q, aligned, want):
    assert fa.fwd_plan(dtype, dh, t_q, aligned) == want


def test_fwd_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        fa.fwd_plan(torch.float16, 64, 128)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")


def _check_fwd(q, k, v, mask, causal, want_body):
    """K2 with its lse against the plain version; fully masked rows give
    exactly 0 and an lse at or below -1e30 / 2; the launch used the body
    ``fwd_plan`` names."""
    dh, t_q = q.shape[-1], q.shape[2]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    assert fa.fwd_plan(q.dtype, dh, t_q, aligned)[0] == want_body
    fa.reset_launch_count()
    out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, return_lse=True)
    serve = fa.flash_attention_fwd(q, k, v, mask, causal)
    w_out, w_lse = flash_attention_fwd_reference(q, k, v, mask, causal,
                                                 return_lse=True)
    torch.cuda.synchronize()
    assert fa.launch_count(fa.FWD_KERNEL) == 2
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = TOL["bfloat16" if q.dtype == torch.bfloat16 else "float32"]
    for got in (out, serve):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   w_out.float().cpu().numpy(), rtol=tol,
                                   atol=tol)
    live = w_lse > fa.NEG_INF / 2
    assert torch.equal(lse > fa.NEG_INF / 2, live)
    np.testing.assert_allclose(lse[live].cpu().numpy(),
                               w_lse[live].cpu().numpy(), rtol=0, atol=1e-4)
    if mask is not None:
        assert not bool(mask[0].any())
        assert bool((out[0] == 0).all()) and bool((serve[0] == 0).all())
        assert bool((lse[0] <= fa.NEG_INF / 2).all())


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k", [(100, 173), (64, 40)])
@pytest.mark.parametrize("dh", [4, 8, 16, 64, 128])
def test_cuda_bf16_body_matches_plain(dh, t_q, t_k, causal, masked):
    """The tensor-core body at every padded width, ragged T_q != T_k
    (neither a multiple of a tile), causal and not, a key mask whose first
    batch row is empty."""
    _card()
    q, k, v, mask = _inputs(dh + t_q + causal, 3, 2, t_q, t_k, dh, masked)
    tq, tk, tv = (_torch(x, "bfloat16").cuda() for x in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask).cuda()
    _check_fwd(tq, tk, tv, tmask, causal, fa.BODY_BF16_TMA if dh % 8 == 0
               else fa.BODY_BF16_CP_ASYNC)


@pytest.mark.gpu
@pytest.mark.parametrize("dh,shift", [(5, False), (6, False), (64, True)])
def test_cuda_bf16_body_unaligned_rows(dh, shift):
    """cp.async tiles where TMA cannot go: rows of 10 bytes (copied a value
    at a time) and 12 bytes (4-byte copies), and q, k, v that start 2 bytes
    off a 16-byte boundary."""
    _card()
    q, k, v, mask = _inputs(dh, 2, 2, 150, 150, dh, True)

    def on_card(x):
        if not shift:
            return _torch(x, "bfloat16").cuda()
        flat = torch.empty(x.size + 1, dtype=torch.bfloat16, device="cuda")
        flat[1:] = _torch(x, "bfloat16").reshape(-1).cuda()
        return flat[1:].view(x.shape)

    tq, tk, tv = (on_card(x) for x in (q, k, v))
    _check_fwd(tq, tk, tv, torch.from_numpy(mask).cuda(), True,
               fa.BODY_BF16_CP_ASYNC)


@pytest.mark.gpu
def test_cuda_f32_body_matches_plain():
    """f32 keeps the CUDA-core body."""
    _card()
    q, k, v, mask = _inputs(5, 2, 2, 100, 173, 64, True)
    tq, tk, tv = (_torch(x, "float32").cuda() for x in (q, k, v))
    _check_fwd(tq, tk, tv, torch.from_numpy(mask).cuda(), True,
               fa.BODY_F32_CUDA_CORES)
