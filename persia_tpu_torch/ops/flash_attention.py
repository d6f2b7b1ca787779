"""Flash-attention forward: the CUDA kernel K2 and its plain version.

The kernel (``csrc/flash_attention_fwd.cu``) replaces the Pallas TPU
kernel ``persia_tpu/ops/flash_attention.py:_fwd_kernel``. The layout is
the JAX one: q (B, H, T_q, Dh), k/v (B, H, T_k, Dh), an optional (B, T_k)
key mask, output like q.

Semantics, shared by the kernel and :func:`flash_attention_fwd_reference`:
scale ``1/sqrt(Dh)``, f32 accumulation, mask value ``-1e30``, optional
causal masking (query i sees keys <= i), a fully masked query row gives 0.

:func:`flash_attention_fwd` is the wrapper. For tensors on the CPU it runs
the plain version; for CUDA tensors it launches the kernel or raises —
there is no fallback from one to the other. There is no backward yet
(kernels K3/K4), so a CUDA input that requires grad raises.
"""

import ctypes
import threading
from typing import Optional

import torch

from persia_tpu_torch.ops import _build

NEG_INF = -1e30
_KERNEL = "flash_attention_fwd"

# launches of the kernel since the last reset; the plain version on the
# CPU never counts
_launches = 0
_launch_lock = threading.Lock()


def launch_count() -> int:
    return _launches


def reset_launch_count():
    global _launches
    with _launch_lock:
        _launches = 0


def flash_attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  kv_mask: Optional[torch.Tensor] = None,
                                  causal: bool = False) -> torch.Tensor:
    """Dense-score attention in f32 with the kernel's masking rules; the
    result has q's dtype."""
    dh = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (1.0 / float(dh) ** 0.5)
    t_q, t_k = q.shape[2], k.shape[2]
    keep = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(t_q, device=q.device)[:, None]
        k_pos = torch.arange(t_k, device=q.device)[None, :]
        keep = q_pos >= k_pos
    keep = keep[None, None]
    if kv_mask is not None:
        keep = keep & (kv_mask > 0)[:, None, None, :]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m > NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return (torch.einsum("bhqk,bhkd->bhqd", p, vf) / l).to(q.dtype)


def _check(q, k, v, kv_mask):
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
    devices = {t.device for t in (q, k, v)}
    if kv_mask is not None:
        devices.add(kv_mask.device)
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _launch_cuda(q, k, v, kv_mask, causal: bool) -> torch.Tensor:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernel takes f32 or bf16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention backward (kernels K3/K4) is not yet ported: "
            "the CUDA path is forward-only, run it under "
            "torch.inference_mode() or on detached tensors")
    b, h, t_q, dh = q.shape
    t_k = k.shape[2]
    if dh > 128:
        raise ValueError(f"head dim {dh} > 128 is not supported")
    out = torch.empty_like(q)
    if out.numel() == 0 or t_k == 0:
        return out.zero_()
    mask = None
    if kv_mask is not None:
        # a bool mask is already 0/1 bytes: reinterpret it, no launch
        mask = (kv_mask.contiguous().view(torch.uint8)
                if kv_mask.dtype == torch.bool
                else (kv_mask > 0).to(torch.uint8).contiguous())
    lib = _build.load(_KERNEL)
    fn = lib.persia_flash_attention_fwd  # ctypes caches the function object
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                mask.data_ptr() if mask is not None else None,
                out.data_ptr(), b * h, h, t_q, t_k, dh,
                0 if q.dtype == torch.float32 else 1, int(bool(causal)),
                1.0 / float(dh) ** 0.5, stream)
    if rc != 0:
        err = lib.persia_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"flash attention kernel launch failed: CUDA error {rc} "
            f"({err(rc).decode()})")
    global _launches
    with _launch_lock:
        _launches += 1
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """Kernel K2's wrapper: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    _check(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, kv_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_cuda(q, k, v, kv_mask, causal)


def flash_attention_masked(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           kv_mask: Optional[torch.Tensor] = None,
                           causal: bool = False) -> torch.Tensor:
    """The sequence tower's attention entry, as in the JAX package:
    (B, H, T, Dh) inputs in the compute dtype and an optional (B, T_k)
    key-validity mask. Forward only."""
    return flash_attention_fwd(q, k, v, kv_mask=kv_mask, causal=causal)
