"""Flash attention: the CUDA kernels K2, K3 and K4 and their plain versions.

The kernels replace the Pallas TPU kernels of
``persia_tpu/ops/flash_attention.py``:

- K2 (``csrc/flash_attention_fwd.cu``) the forward ``_fwd_kernel``, with
  the optional (B, H, T_q) f32 logsumexp the backward reads. It has two
  bodies (:func:`fwd_plan`): bf16 on the tensor cores (``wgmma``, K/V
  tiles by TMA or cp.async), which rounds the probabilities to bf16
  before the p·v product as the TPU kernel does, and f32 on the CUDA
  cores;
- K3 and K4 (``csrc/flash_attention_bwd.cu``) the backward
  ``_bwd_dq_kernel`` (dq) and ``_bwd_dkv_kernel`` (dk, dv). K3 also
  computes ``delta = rowsum(dO * O)``, which the JAX package leaves to an
  XLA reduce, and hands it to K4. They have the same two bodies
  (:func:`bwd_plan`); the bf16 one rounds p and ds to bf16 before their
  products, as the TPU kernels do.

The Hopper helpers both sources share (``wgmma``, descriptors, mbarriers,
TMA) are in ``csrc/sm90.cuh``.

The layout is the JAX one: q (B, H, T_q, Dh), k/v (B, H, T_k, Dh), an
optional (B, T_k) key mask broadcast over heads, output like q.

Semantics, shared by the kernels and the plain versions: scale
``1/sqrt(Dh)``, f32 statistics and accumulation, mask value ``-1e30``,
optional causal masking (query i sees keys <= i). A fully masked query row
gives 0 and an lse of -1e30, and its gradients are 0.

The wrappers (:func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq`,
:func:`flash_attention_bwd_dkv`) run the plain version for tensors on the
CPU and launch the kernel for CUDA tensors, or raise: there is no fallback
from one to the other. Each kernel counts its launches.
:func:`flash_attention_masked` is the model's entry: an autograd Function
whose forward is K2 with the lse and whose backward is K3 then K4.
"""

import ctypes
from typing import Optional, Tuple

import torch

from persia_tpu_torch.ops import _build

NEG_INF = -1e30
FWD_KERNEL = "flash_attention_fwd"  # K2
DQ_KERNEL = "flash_attention_bwd_dq"  # K3
DKV_KERNEL = "flash_attention_bwd_dkv"  # K4
# the CUDA source each kernel is built from
KERNEL_SOURCES = {FWD_KERNEL: "flash_attention_fwd",
                  DQ_KERNEL: "flash_attention_bwd",
                  DKV_KERNEL: "flash_attention_bwd"}


def launch_count(kernel: str) -> int:
    """The kernel's launches since the last reset; the plain versions on
    the CPU never count."""
    return _build.launch_count(kernel)


def reset_launch_count():
    _build.reset_launch_counts(KERNEL_SOURCES)


# --- plain versions ---------------------------------------------------------


def _keep(q, k, kv_mask, causal) -> torch.Tensor:
    """(B or 1, 1, T_q, T_k) bool: the keys each query may see."""
    t_q, t_k = q.shape[2], k.shape[2]
    keep = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(t_q, device=q.device)[:, None]
        k_pos = torch.arange(t_k, device=q.device)[None, :]
        keep = q_pos >= k_pos
    keep = keep[None, None]
    if kv_mask is not None:
        keep = keep & (kv_mask > 0)[:, None, None, :]
    return keep


def _scores(q, k) -> torch.Tensor:
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  kv_mask: Optional[torch.Tensor] = None,
                                  causal: bool = False,
                                  return_lse: bool = False):
    """Dense-score attention in f32 with the kernel's masking rules; the
    output has q's dtype. With ``return_lse`` also the (B, H, T_q) f32
    logsumexp ``m + log(max(l, 1e-20))``."""
    s = torch.where(_keep(q, k, kv_mask, causal), _scores(q, k), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m > NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = (torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def _masked_p(q, k, lse, kv_mask, causal) -> torch.Tensor:
    """The softmax block recomputed from q, k and the forward's lse, as
    the JAX package's ``_masked_p``: masked keys and every key of a row
    whose lse is at or below -1e30/2 give p = 0."""
    keep = _keep(q, k, kv_mask, causal) & (lse > NEG_INF / 2)[..., None]
    p = torch.exp(_scores(q, k) - lse[..., None])
    return torch.where(keep, p, torch.zeros_like(p))


def flash_attention_bwd_dq_reference(q, k, v, out, lse, do, kv_mask=None,
                                     causal: bool = False):
    """K3's plain version: (dq in q's dtype, delta (B, H, T_q) f32)."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    delta = (do.float() * out.float()).sum(-1)
    p = _masked_p(q, k, lse, kv_mask, causal)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
              - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, kv_mask=None,
                                      causal: bool = False):
    """K4's plain version: (dk, dv) in k's and v's dtypes."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    p = _masked_p(q, k, lse, kv_mask, causal)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
              - delta[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, kv_mask=None,
                                  causal: bool = False):
    """The plain backward: (dq, dk, dv) in the input dtypes, recomputed in
    f32 from the lse (not autograd of the forward)."""
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, out, lse, do,
                                                 kv_mask, causal)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               kv_mask, causal)
    return dq, dk, dv


# --- kernel wrappers --------------------------------------------------------


def _check(q, k, v, kv_mask, *extra):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, T, Dh)")
    b, h, _, dh = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, k.shape[2]):
        raise ValueError(
            f"kv_mask must be (B, T_k) = {(b, k.shape[2])}, got "
            f"{tuple(kv_mask.shape)}")
    devices = {t.device for t in (q, k, v, *extra)}
    if kv_mask is not None:
        devices.add(kv_mask.device)
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _cuda_checks(tensors, rows_like_q, f32_rows):
    """The kernels take one dtype (f32 or bf16) for every (B, H, T, Dh)
    operand, all contiguous; per-row statistics are f32 (B, H, T_q)."""
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernels take f32 or bf16, got "
                        f"{dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"operands must share one dtype, got {t.dtype} "
                            f"and {dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    for t in rows_like_q:
        if t.shape != tensors[0].shape:
            raise ValueError(f"expected {tuple(tensors[0].shape)}, got "
                             f"{tuple(t.shape)}")
    for t in f32_rows:
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.shape != tensors[0].shape[:3]:
            raise ValueError("lse and delta must be contiguous f32 (B, H, "
                             "T_q)")
    if tensors[0].shape[-1] > 128:
        raise ValueError(f"head dim {tensors[0].shape[-1]} > 128 is not "
                         f"supported")


def _mask_bytes(kv_mask):
    if kv_mask is None:
        return None
    # a bool mask is already 0/1 bytes: reinterpret it, no launch
    return (kv_mask.contiguous().view(torch.uint8)
            if kv_mask.dtype == torch.bool
            else (kv_mask > 0).to(torch.uint8).contiguous())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(kernel: str, symbol: str, argtypes, device, *args):
    _build.launcher(kernel, KERNEL_SOURCES[kernel], symbol, argtypes)(
        device, *args)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the launchers' arguments before the stream, which _build.Launcher appends
_FWD_ARGS = [_P] * 6 + [_I] * 8 + [_F]
_BWD_ARGS = [_P] * 9 + [_I] * 8 + [_F]  # K3 and K4

# the kernels' bodies (the enum Body of csrc/flash_attention_{fwd,bwd}.cu)
BODY_F32_CUDA_CORES = 0  # f32 products on the CUDA cores
BODY_BF16_CP_ASYNC = 1  # wgmma on the tensor cores, tiles by cp.async
BODY_BF16_TMA = 2  # wgmma on the tensor cores, tiles by TMA


def fwd_plan(dtype: torch.dtype, dh: int, t_q: int,
             aligned: bool = True) -> Tuple[int, int]:
    """K2's (body, query rows of a CTA) for a launch. f32 keeps the
    CUDA-core body: its agreement gates need f32 products, which the tensor
    cores give only as TF32. bf16 runs on the tensor cores; its K/V tiles
    come by TMA where a row is a multiple of 16 bytes (``dh % 8 == 0``)
    and q, k, v are 16-byte ``aligned``, by cp.async otherwise. A CTA
    takes 128 query rows (two warpgroups), or 64 when ``t_q <= 64``."""
    if dtype == torch.float32:
        return BODY_F32_CUDA_CORES, 64
    if dtype != torch.bfloat16:
        raise TypeError(f"K2 takes f32 or bf16, got {dtype}")
    body = BODY_BF16_TMA if dh % 8 == 0 and aligned else BODY_BF16_CP_ASYNC
    return body, 64 if t_q <= 64 else 128


def bwd_plan(dtype: torch.dtype, dh: int, t: int,
             aligned: bool = True) -> Tuple[int, int]:
    """K3's or K4's (body, rows of a CTA) for a launch: ``t`` is T_q for
    K3, whose CTA owns query rows, and T_k for K4, whose CTA owns keys.
    As :func:`fwd_plan`: f32 keeps the CUDA-core body; bf16 runs on the
    tensor cores, its tiles by TMA where ``dh % 8 == 0`` and q, k, v (and
    out and dO) are 16-byte ``aligned``, by cp.async otherwise. A CTA
    takes 128 rows (two warpgroups), or 64 when ``t <= 64``."""
    if dtype == torch.float32:
        return BODY_F32_CUDA_CORES, 64
    if dtype != torch.bfloat16:
        raise TypeError(f"K3/K4 take f32 or bf16, got {dtype}")
    body = BODY_BF16_TMA if dh % 8 == 0 and aligned else BODY_BF16_CP_ASYNC
    return body, 64 if t <= 64 else 128


def _dims(q, k):
    b, h, t_q, dh = q.shape
    return b * h, h, t_q, k.shape[2], dh


def _scale(dh: int) -> float:
    return 1.0 / float(dh) ** 0.5


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False, return_lse: bool = False):
    """Kernel K2's wrapper: the output, and with ``return_lse`` the
    (B, H, T_q) f32 logsumexp. Plain version for CPU tensors, the CUDA
    kernel for CUDA tensors, in the body :func:`fwd_plan` picks."""
    _check(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, kv_mask, causal,
                                             return_lse)
    _cuda_checks([q, k, v], [], [])
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or k.shape[2] == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(NEG_INF)
    else:
        mask = _mask_bytes(kv_mask)  # referenced until the launch returns
        bh, h, t_q, t_k, dh = _dims(q, k)
        body, block_q = fwd_plan(q.dtype, dh, t_q, _aligned(q, k, v))
        _call(FWD_KERNEL, "persia_flash_attention_fwd", _FWD_ARGS, q.device,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
              out.data_ptr(), _ptr(lse), bh, h, t_q, t_k, dh, body, block_q,
              int(bool(causal)), _scale(dh))
    return (out, lse) if return_lse else out


def flash_attention_bwd_dq(q, k, v, out, lse, do, kv_mask=None,
                           causal: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3's wrapper: (dq, delta). Plain version for CPU tensors,
    the CUDA kernel for CUDA tensors, in the body :func:`bwd_plan` picks."""
    _check(q, k, v, kv_mask, out, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, out, lse, do,
                                                kv_mask, causal)
    _cuda_checks([q, k, v, out, do], [out, do], [lse])
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.shape[2] == 0:
        return dq.zero_(), torch.sum(do.float() * out.float(), -1)
    mask = _mask_bytes(kv_mask)
    dims = _dims(q, k)
    body, rows = bwd_plan(q.dtype, dims[4], dims[2],
                          _aligned(q, k, v, out, do))
    _call(DQ_KERNEL, "persia_flash_attention_bwd_dq", _BWD_ARGS, q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          do.data_ptr(), lse.data_ptr(), _ptr(mask), dq.data_ptr(),
          delta.data_ptr(), *dims, body, rows, int(bool(causal)),
          _scale(dims[4]))
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_mask=None,
                            causal: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K4's wrapper: (dk, dv), with ``delta`` from K3. Plain
    version for CPU tensors, the CUDA kernel for CUDA tensors, in the body
    :func:`bwd_plan` picks."""
    _check(q, k, v, kv_mask, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 kv_mask, causal)
    _cuda_checks([q, k, v, do], [do], [lse, delta])
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if k.numel() == 0 or q.shape[2] == 0:
        return dk.zero_(), dv.zero_()
    mask = _mask_bytes(kv_mask)
    dims = _dims(q, k)
    body, rows = bwd_plan(q.dtype, dims[4], dims[3], _aligned(q, k, v, do))
    _call(DKV_KERNEL, "persia_flash_attention_bwd_dkv", _BWD_ARGS, q.device,
          q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), _ptr(mask), dk.data_ptr(),
          dv.data_ptr(), *dims, body, rows, int(bool(causal)),
          _scale(dims[4]))
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, kv_mask=None,
                        causal: bool = False):
    """The backward, K3 then K4: (dq, dk, dv) in the input dtypes."""
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, kv_mask,
                                       causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, kv_mask,
                                     causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward K2 with the lse; backward K3 and K4. The key mask gets no
    gradient (the JAX package returns zeros for it)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        out, lse = flash_attention_fwd(q, k, v, kv_mask, causal,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        # the cotangent of out.permute(...).reshape(...) is generally not
        # contiguous; the kernels read it row-major
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         kv_mask, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_masked(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           kv_mask: Optional[torch.Tensor] = None,
                           causal: bool = False) -> torch.Tensor:
    """The sequence tower's attention entry, as in the JAX package:
    (B, H, T, Dh) inputs in the compute dtype and an optional (B, T_k)
    key-validity mask. Differentiable in q, k and v; without autograd
    (inference mode, or no input requiring grad) it is K2 alone, with no
    lse."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_mask, causal)
    return flash_attention_fwd(q, k, v, kv_mask=kv_mask, causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """:func:`flash_attention_masked` with every key valid."""
    return flash_attention_masked(q, k, v, causal=causal)
