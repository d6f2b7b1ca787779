"""Copy-shape probe: the CUDA kernel K5 and its plain version.

K5 (``csrc/probe_copy.cu``) replaces the Pallas TPU probe of
``tools/probe_dma_shapes.py`` (``make_probe``): copy row ``src[idx]`` of a
table in device memory into on-chip memory with an asynchronous copy and
write its first 8 floats, ``out[0, :] = src[idx].reshape(-1)[:8]``. On the
TPU it asked which row shapes the DMA engine accepts; on Hopper the copy
is the 1-D bulk asynchronous copy (``cp.async.bulk``) completing on an
mbarrier, which needs 16-byte aligned rows of a multiple of 16 bytes.
``idx`` is clipped to [0, rows - 1], as K1 clips its ids.

Run the probe's four cases (the TPU probe's A-D) on the card::

    python -m persia_tpu_torch.ops.probe_copy

It prints each case's row bytes, whether the kernel's output equals the
plain version's, and the time per call on the card (CUDA events around
back-to-back calls); it exits non-zero if a case failed.
"""

import ctypes
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from persia_tpu_torch.device import DeviceLike, resolve_device
from persia_tpu_torch.ops import _build

KERNEL = "probe_copy"  # K5; also the name of its CUDA source
OUT_FLOATS = 8
# the TPU probe's cases (tools/probe_dma_shapes.py): name -> (row shape,
# table shape); the row is table[3]
CASES = {
    "A_(16,)": ((16,), (8, 16)),
    "B_(128,)": ((128,), (8, 128)),
    "C_(1,128)": ((1, 128), (8, 1, 128)),
    "D_(8,128)": ((8, 128), (32, 8, 128)),
}
PROBE_IDX = 3


def launch_count() -> int:
    """K5's launches since the last reset; the plain version never
    counts."""
    return _build.launch_count(KERNEL)


def reset_launch_count():
    _build.reset_launch_counts([KERNEL])


def probe_copy_reference(src: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """K5's plain version: (1, min(8, row size)) f32."""
    i = idx.clamp(0, src.shape[0] - 1).long()
    return src[i].reshape(1, -1)[:, :OUT_FLOATS].float()


_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3


def probe_copy(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5's wrapper. The plain version for CPU tensors; for CUDA tensors
    the kernel, which takes a contiguous f32 ``src`` whose rows
    (``src[i]``) are a multiple of 16 bytes, and a (1,) int32 ``idx``."""
    shape = src.shape
    if len(shape) < 2 or shape[0] == 0 or idx.shape != (1,):
        raise ValueError(f"expected src (N, ...) and idx (1,), got "
                         f"{tuple(shape)} and {tuple(idx.shape)}")
    device = src.device
    if device != idx.device:
        raise ValueError(f"inputs on several devices: {device}, "
                         f"{idx.device}")
    if device.type == "cpu":
        return probe_copy_reference(src, idx)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if src.dtype != torch.float32 or not src.is_contiguous():
        raise TypeError("K5 takes a contiguous f32 src")
    if idx.dtype != torch.int32:
        raise TypeError(f"K5 takes an int32 idx, got {idx.dtype}")
    row_floats = src.numel() // shape[0]
    ptr = src.data_ptr()
    if (4 * row_floats) % 16 or ptr % 16:
        raise ValueError(
            f"a bulk copy moves 16-byte aligned multiples of 16 bytes; a "
            f"row here is {4 * row_floats} bytes at address {ptr:#x}")
    n_out = min(OUT_FLOATS, row_floats)
    out = torch.empty((1, n_out), dtype=torch.float32, device=device)
    _build.launcher(KERNEL, KERNEL, "persia_probe_copy", _ARGS)(
        device, ptr, idx.data_ptr(), out.data_ptr(), src.shape[0],
        row_floats, n_out)
    return out


def case_inputs(name: str, device) -> tuple:
    """The TPU probe's inputs for case ``name``: ``arange`` f32 in the
    table shape, and idx [3]."""
    _, src_shape = CASES[name]
    src = torch.arange(int(np.prod(src_shape)), dtype=torch.float32,
                       device=device).reshape(src_shape)
    return src, torch.tensor([PROBE_IDX], dtype=torch.int32, device=device)


def run_probe(device: DeviceLike = None, iters: int = 100) -> List[Dict]:
    """Each case once through :func:`probe_copy`, held against the plain
    version; on the card also timed over ``iters`` launches by CUDA events.
    Returns one record per case: name, row_bytes, ok, us_per_call (None
    off the card), error (None unless the launch raised)."""
    dev = resolve_device(device)
    out = []
    for name, (row_shape, _) in CASES.items():
        src, idx = case_inputs(name, dev)
        rec = {"name": name, "row_bytes": 4 * int(np.prod(row_shape)),
               "ok": False, "us_per_call": None, "error": None}
        try:
            got = probe_copy(src, idx)
        except (RuntimeError, ValueError) as e:
            rec["error"] = str(e)
            out.append(rec)
            continue
        rec["ok"] = bool(torch.equal(got, probe_copy_reference(src, idx)))
        if dev.type == "cuda":
            rec["us_per_call"] = 1e3 * _cuda_ms(
                lambda: probe_copy(src, idx), iters)
        out.append(rec)
    return out


def _cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: Optional[List[str]] = None) -> int:
    dev = resolve_device(argv[0] if argv else None)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}")
    results = run_probe(dev)
    for r in results:
        if r["error"] is not None:
            print(f"{r['name']}: row_bytes={r['row_bytes']} REFUSED "
                  f"{r['error'].splitlines()[0][:160]}")
            continue
        us = ("not measured" if r["us_per_call"] is None
              else f"{r['us_per_call']:.3f}")
        print(f"{r['name']}: row_bytes={r['row_bytes']} ok={r['ok']} "
              f"us_per_call={us}")
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
