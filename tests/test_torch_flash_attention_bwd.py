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
  before their products; the port's plain version keeps them in f32 and
  rounds only the outputs. The card's bf16 bodies round p and ds as
  Pallas does, so against the plain version they differ by that rounding
  (2**-9 relative a term, summed over up to 200 terms with random signs)
  besides the outputs' own bf16 rounding: within 2e-2 on O(1) gradients.
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


@pytest.mark.parametrize("dtype,dh,t,aligned,want", [
    # the attention bench's shape: tensor cores, TMA, two warpgroups
    (torch.bfloat16, 128, 8192, True, (fa.BODY_BF16_TMA, 128)),
    (torch.bfloat16, 64, 65, True, (fa.BODY_BF16_TMA, 128)),
    (torch.bfloat16, 16, 64, True, (fa.BODY_BF16_TMA, 64)),
    # the sequence tower's Dh=4 (rows of 8 bytes are no TMA rows), t = 64
    (torch.bfloat16, 4, 64, True, (fa.BODY_BF16_CP_ASYNC, 64)),
    (torch.bfloat16, 4, 200, True, (fa.BODY_BF16_CP_ASYNC, 128)),
    # a view that starts off a 16-byte boundary cannot be a TMA source
    (torch.bfloat16, 128, 40, False, (fa.BODY_BF16_CP_ASYNC, 64)),
    (torch.bfloat16, 128, 300, False, (fa.BODY_BF16_CP_ASYNC, 128)),
    (torch.bfloat16, 16, 130, False, (fa.BODY_BF16_CP_ASYNC, 128)),
    # f32 keeps the CUDA-core bodies at every width
    (torch.float32, 128, 8192, True, (fa.BODY_F32_CUDA_CORES, 64)),
    (torch.float32, 4, 64, False, (fa.BODY_F32_CUDA_CORES, 64)),
])
def test_bwd_plan_picks_the_body(dtype, dh, t, aligned, want):
    assert fa.bwd_plan(dtype, dh, t, aligned) == want


def test_bwd_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        fa.bwd_plan(torch.float16, 64, 128)


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """A library is rebuilt when a header it may include changes: the
    name hashes every ``csrc/*.cuh`` beside the source."""
    import shutil

    from persia_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = _build._lib_path("flash_attention_bwd")
    assert before == _build._lib_path("flash_attention_bwd")
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build._lib_path("flash_attention_bwd")
    assert after != before and after.parent == before.parent
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert _build._lib_path("flash_attention_bwd") not in (before, after)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")


def _check_bwd(seed, t_q, t_k, dh, causal, masked, place=None):
    """K3 and K4 on the card in the body bwd_plan names, against the
    plain versions fed the kernel's own forward; an empty batch row gives
    exactly zero gradients. Returns the gradients."""
    q, k, v, do, mask = _inputs(seed, 3, 2, t_q, t_k, dh)
    place = place or (lambda x: _t(x, "bfloat16").cuda())
    tq, tk, tv, tdo = (place(x) for x in (q, k, v, do))
    tmask = torch.from_numpy(mask).cuda() if masked else None
    fa.reset_launch_count()
    out, lse = fa.flash_attention_fwd(tq, tk, tv, tmask, causal,
                                      return_lse=True)
    dq, delta = fa.flash_attention_bwd_dq(tq, tk, tv, out, lse, tdo, tmask,
                                          causal)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta, tmask,
                                        causal)
    torch.cuda.synchronize()
    assert [fa.launch_count(n) for n in fa.KERNEL_SOURCES] == [1, 1, 1]
    w_dq, w_delta = fa.flash_attention_bwd_dq_reference(
        tq, tk, tv, out, lse, tdo, tmask, causal)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_reference(
        tq, tk, tv, tdo, lse, w_delta, tmask, causal)
    np.testing.assert_allclose(delta.cpu().numpy(), w_delta.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    for g, w in ((dq, w_dq), (dk, w_dk), (dv, w_dv)):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        np.testing.assert_allclose(_np(g.cpu()), _np(w.cpu()), rtol=2e-2,
                                   atol=2e-2)
        if masked:
            assert bool((g[1] == 0).all())
    return dq, dk, dv


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k", [(48, 112), (200, 200), (130, 70)])
@pytest.mark.parametrize("dh", [4, 8, 16, 32, 64, 128])
def test_cuda_bf16_bodies_match_plain(dh, t_q, t_k, causal, masked):
    """The tensor-core bodies at every padded width, T neither a multiple
    of 64 nor of 128, T_q != T_k both ways, causal and not, with and
    without a key mask whose second batch row is empty."""
    _card()
    assert fa.bwd_plan(torch.bfloat16, dh, t_q)[0] == (
        fa.BODY_BF16_TMA if dh % 8 == 0 else fa.BODY_BF16_CP_ASYNC)
    _check_bwd(dh + t_q + causal, t_q, t_k, dh, causal, masked)


@pytest.mark.gpu
@pytest.mark.parametrize("dh,shift", [(5, False), (6, False), (64, True),
                                      (128, True)])
def test_cuda_bf16_bodies_unaligned_rows(dh, shift):
    """cp.async tiles where TMA cannot go: rows of 10 bytes (a value at a
    time) and 12 bytes (4-byte copies), and operands 2 bytes off a 16-byte
    boundary."""
    _card()

    def place(x):
        if not shift:
            return _t(x, "bfloat16").cuda()
        flat = torch.empty(x.size + 1, dtype=torch.bfloat16, device="cuda")
        flat[1:] = _t(x, "bfloat16").reshape(-1).cuda()
        return flat[1:].view(x.shape)

    _check_bwd(dh, 150, 150, dh, True, True, place)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [4, 128])
def test_cuda_bf16_bodies_are_deterministic(dh):
    """No atomics: two runs on the same inputs give bit-equal gradients."""
    _card()
    first = _check_bwd(3, 200, 200, dh, True, True)
    second = _check_bwd(3, 200, 200, dh, True, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
