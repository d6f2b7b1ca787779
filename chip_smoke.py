#!/usr/bin/env python3
"""Chip smoke run of persia_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and the CUDA toolkit.
It imports only the port, torch and numpy, never JAX or the JAX package.

1. Setup: versions, the card's name and power limit, and the build of
   every kernel of the port from the sources in this checkout, one nvcc
   per source, all started together; ptxas's registers and spills of
   every kernel entry, K2's, K3's and K4's shared memory per body, and
   the count of tensor-core (HGMMA) and TMA-load (UTMALDG) instructions
   in each built library.
2. Kernel phase: each kernel is held against its plain PyTorch version on
   the card and timed beside its bound, its plain version and, where one
   exists, a PyTorch library call computing the same function (a
   yardstick only; the port never calls it): K2 (the flash-attention
   forward, here with its logsumexp), K3 and K4 (the backward) at the
   sequence tower's shape, at the attention-bench width with T=2048
   causal and with a ragged key mask (not causal), and timed at the
   attention-bench shape (T=8192, causal), where each record also carries
   its time, TFLOP/s and share of the bound, K2's beside SDPA's forward
   and K3 + K4 between two runs of them beside the library's flash
   backward (``aten._scaled_dot_product_flash_attention_backward`` on the
   outputs of its own forward of the same q, k, v); K1 (the
   embedding bag) at device mode's shape and at the v5e shape of
   ``persia_tpu/ops/embedding_bag.py``.
3. Serving phase: two PS shards hold rows for the whole sign space of the
   ``seqrec`` traffic; an ``InferenceServer`` on the card with
   micro-batching and the hot-row cache serves requests from 8 threads as
   PTB2 bytes through ``SequenceTower(attn_impl="flash")`` at the width of
   ``examples/seq_rec/train.py``. Every prediction must be finite and in
   (0, 1) and agree with a second server whose tower uses the dense
   reference attention; K2 must have launched.
4. Training phase, the sequence tower's main path: ``TrainCtx`` on the
   card trains ``SequenceTower(attn_impl="flash")`` at the example's
   widths over two fresh PS shards (sparse Adagrad, dense Adam) for 300
   steps of batch 256 of ``seqrec`` traffic, then ``eval_ctx`` scores 4096
   held-out samples; the AUC must pass the example's own bar (0.62). The
   launch counters are zeroed just before the 300 steps and read just
   after: K2, K3 and K4 must each have launched. Before that, a flash
   tower and a reference tower train 3 steps from the same weights and
   fresh PS rows in f32 and must agree.
5. Device-mode phase, K1's main path, at ``bench.py``'s ``bench_device``
   configuration (26 hashed tables of 2^20 x 16 resident on the card,
   ``DLRM(embedding_dim=16)`` in bf16, ``OptaxAdagrad(0.02)``, batch
   4096): first a kernel tower and a plain tower train 3 steps from one
   weight set with an f32 tower and must agree, each table's change
   and the loss held to their own movement; then warm-up, timed
   loops (one synchronize at the end, or one per step; the repeated batch
   and 4 rotating fresh-id batches), a stage split and a profiled window.
   K1's counter is zeroed just before the timed steps and must read 26
   per step; every loss must be finite, the repeated batch's loss must
   fall below step 0's and an eval forward must give predictions in
   (0, 1).
6. Probe phase, K5's path: ``run_probe`` of
   ``python -m persia_tpu_torch.ops.probe_copy``, counters zeroed just
   before; every case (the TPU probe's four) must match. Each case's
   plain version, its library yardstick (``index_select``) and K5's
   device time per launch are then timed beside its bound.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without the ``ok`` line.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import traceback

# Tolerances, each with its reason.
# Kernel against its plain version in bf16: both accumulate in f32 and
# round the output to bf16 once; the summation orders differ, which can
# flip the last bit of the bf16 result (2**-8 relative; outputs are O(1)).
# The tensor-core bodies also round p (K2's p.v, K4's p^T.dO) and ds (K3's
# ds.K, K4's ds^T.Q) to bf16 before the product, as the TPU kernels do,
# where the plain versions keep them in f32: 2**-9 relative a term, and
# over T terms of random sign ~2**-9 sqrt(T) of a term, well inside 2e-2
# on O(1) gradients at T = 2048.
KERNEL_ATOL = 2e-2
KERNEL_RTOL = 2e-2
# The logsumexp is f32 in every path: f32 sums in another order.
LSE_ATOL = 1e-4
# Serving predictions, flash tower against reference tower on the card:
# every product runs in bf16, and the attention output is rounded to bf16
# at a different point (kernel output vs. input of the output projection);
# one-ulp differences pass through three more bf16 layers to a sigmoid.
SERVING_ATOL = 2e-2
# Training, flash tower against reference tower, f32 compute, f32 wire, no
# TF32: the same math in another summation order, carried through three
# Adam steps (a gradient near 0 whose sign differs moves its parameter by
# up to 2 lr = 2e-3). Loss and predictions absolute; each slot's embedding
# gradient relative to its largest element.
TRAIN_ATOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# the example's own pass bar (examples/seq_rec/train.py:166)
AUC_BAR = 0.62
# K1 against its plain version: at S = 1 each output is one rounded
# product in both, so they must be bit-equal; at S > 1 both round every
# product and every sum in f32, possibly adding in another order.
BAG_ATOL = 1e-6
BAG_RTOL = 1e-5
# Device mode, kernel tower against plain tower from the same weights,
# f32 tower, no TF32, 3 steps: the pooled sums may differ by an ulp, which
# can flip the bf16 rounding of a pooled embedding (the collection keeps
# bf16), and the dense table gradients are scatter-added in another order
# (index_add_ against the plain gather's autograd). The steps move the
# loss by only ~1e-5 and a table row by ~1e-6, so both are held to their
# own movement over the 3 steps, not to a fixed limit:
# - loss: a one-ulp bf16 flip moves one prediction by ~1e-5 and the mean
#   loss over 4096 samples by ~5e-9; 5% of the plain tower's movement
#   leaves room for dozens of flips, and a step that did nothing misses
#   by 100%;
# - tables: each table's change from its start, kernel against plain,
#   within 1% of the largest plain change (a flip changes one sample's
#   row gradients by at most 2**-8 of themselves) plus 3 f32 ulps of a
#   table value below 2**-6 (one rounding of p - update a step); a missed
#   or misplaced row update misses by 100%;
# - predictions: a one-ulp bf16 flip moves a prediction by ~1e-5.
DM_LOSS_MOVE_RTOL = 5e-2
DM_TABLE_MOVE_RTOL = 1e-2
DM_TABLE_ULPS_ATOL = 3 * 2.0 ** -30
DM_PRED_ATOL = 1e-4

# H100 SXM published dense peaks (NVIDIA data sheet, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12

# the model: examples/seq_rec/train.py's widths
DIM = 16
HEADS = 4
T_HIST = 64
ITEM_VOCAB = 50_000
N_PS = 2
MLP = (256, 128)
REQUEST_ROWS = 32
N_THREADS = 8
REQUESTS_PER_THREAD = 50
SEED = 0
TRAIN_SEED = 42  # the example's --seed
TRAIN_STEPS = 300
TRAIN_BATCH = 256
EVAL_SAMPLES = 4096
# device mode: bench.py's bench_device configuration (26 hashed slots of
# 2^20 x 16, 13 dense features, DLRM(embedding_dim=16), adagrad(0.02),
# batch 4096)
DM_SLOTS = 26
DM_VOCAB = 1 << 20
DM_DIM = 16
DM_DENSE = 13
DM_BATCH = 4096
DM_LR = 0.02
DM_WARMUP = 5
DM_STEPS = 30  # per timed loop, as tools/probe_device_step.py
DM_SPLIT_STEPS = 10
DM_PROFILE_STEPS = 5
DM_AGREE_SFS = 4

KERNEL_INFO = {
    # name -> (source, the TPU kernel it replaces)
    "flash_attention_fwd": ("persia_tpu_torch/csrc/flash_attention_fwd.cu",
                            "persia_tpu/ops/flash_attention.py:43"),
    "flash_attention_bwd_dq": ("persia_tpu_torch/csrc/flash_attention_bwd.cu",
                               "persia_tpu/ops/flash_attention.py:237"),
    "flash_attention_bwd_dkv": (
        "persia_tpu_torch/csrc/flash_attention_bwd.cu",
        "persia_tpu/ops/flash_attention.py:280"),
    "embedding_bag": ("persia_tpu_torch/csrc/embedding_bag.cu",
                      "persia_tpu/ops/embedding_bag.py:90"),
    "probe_copy": ("persia_tpu_torch/csrc/probe_copy.cu",
                   "tools/probe_dma_shapes.py:38"),
}
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def _log(*a):
    print(*a, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi gave no output (rc={out.returncode})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def ptxas_report(log: str):
    """(kernel, registers, spill stores, spill loads) of each entry that
    ``nvcc -Xptxas -v`` compiled, in order, and its performance notes (a
    wgmma chain that ptxas serialized, for one)."""
    rows, notes, entry = [], [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            rows.append([entry, None, None, None])
        elif "spill stores" in line and rows:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            rows[-1][2:4] = [int(n) for n, _ in nums][:2]
        elif "Used" in line and "registers" in line and rows:
            rows[-1][1] = int(re.search(r"Used (\d+) registers", line)[1])
        elif "Performance Loss" in line:
            notes.append(line.split("Potential")[1].strip())
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(rows):
        for r, name in zip(rows, names):
            r[0] = name.replace("(anonymous namespace)::", "").split("(")[0]
    return rows, notes


def sass_counts(lib_path) -> str:
    """Counts of tensor-core (HGMMA) and TMA-load (UTMALDG) instructions in
    a built library, by ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return "HGMMA and UTMALDG counts not measured (no cuobjdump)"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        return f"HGMMA and UTMALDG counts not measured (cuobjdump rc " \
               f"{out.returncode})"
    return f"HGMMA={out.stdout.count('HGMMA')} " \
           f"UTMALDG={out.stdout.count('UTMALDG')}"


def report_build(paths, sources):
    """ptxas's registers and spills of every kernel entry, K2's, K3's and
    K4's dynamic shared memory per body, and the SASS instruction
    counts."""
    import ctypes

    from persia_tpu_torch.ops import _build

    for name, path in zip(sources, paths):
        rows, notes = ptxas_report(_build.build_logs.get(name, ""))
        for entry, regs, st, ld in rows:
            _log(f"[setup] ptxas {name}: {entry}: {regs} registers, spill "
                 f"stores {st} B, spill loads {ld} B")
        for note in notes:
            _log(f"[setup] ptxas {name}: {note}")
        _log(f"[setup] sass {name}: {sass_counts(path)}")
    smem = _build.load("flash_attention_fwd").persia_flash_attention_fwd_smem
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_int
    _log("[setup] K2 bf16 body dynamic shared memory per CTA (bytes): "
         + " ".join(f"block_q={bq},dh<={dh}:{smem(bq, dh)}"
                    for bq in (64, 128) for dh in (16, 32, 64, 128)))
    smem = _build.load("flash_attention_bwd").persia_flash_attention_bwd_smem
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_int
    for kernel, tag in ((0, "K3"), (1, "K4")):
        _log(f"[setup] {tag} bf16 body dynamic shared memory per CTA "
             f"(bytes): " + " ".join(
                 f"rows={rows},dh<={dh}:{smem(kernel, rows, dh)}"
                 for rows in (64, 128) for dh in (16, 32, 64, 128)))


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls."""
    for _ in range(warmup):
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


def visible_pairs(q, k, kv_mask, causal: bool) -> int:
    """(query, key) pairs this run's data leaves visible."""
    b, h, t_q, _ = q.shape
    t_k = k.shape[2]
    if causal:
        per_bh = sum(min(i + 1, t_k) for i in range(t_q))
        return b * h * per_bh
    if kv_mask is not None:
        return h * t_q * int((kv_mask > 0).sum().item())
    return b * h * t_q * t_k


def bound_ms(nbytes: int, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """Least time on an H100: bytes over the memory rate or operations
    over their type's peak (the bf16 tensor cores unless given),
    whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_bounds(q, k, kv_mask, causal: bool, with_lse: bool):
    """Bounds of K2 (two products), K3 (three) and K4 (four): each input
    read once and each output written once; 2 FLOP per multiply-add over
    the visible pairs."""
    dh = q.shape[-1]
    rows = q.shape[0] * q.shape[1] * q.shape[2]  # lse / delta entries
    qb = q.numel() * q.element_size()  # one (B, H, T, Dh) operand
    kb = k.numel() * k.element_size()
    mb = 0 if kv_mask is None else kv_mask.numel()  # one byte a key
    pairs = visible_pairs(q, k, kv_mask, causal)
    fwd = bound_ms(2 * qb + 2 * kb + mb + (4 * rows if with_lse else 0),
                   4.0 * pairs * dh)
    # K3 reads q, k, v, out, dO, lse and the mask, writes dq and delta
    dq = bound_ms(4 * qb + 2 * kb + mb + 8 * rows, 6.0 * pairs * dh)
    # K4 reads q, k, v, dO, lse, delta and the mask, writes dk and dv
    dkv = bound_ms(2 * qb + 4 * kb + mb + 8 * rows, 8.0 * pairs * dh)
    return fwd, dq, dkv


def profile_window(torch, fn):
    """Run ``fn`` under torch.profiler (CUPTI). Returns (wall s, device
    busy s, the six device kernels with the most time as (us, name,
    count)); busy is 0 when the trace holds no device time. User
    annotations (``Optimizer.step#...`` ranges on the device's timeline)
    are spans over kernels already counted, not work of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((float(us), e.key, e.count))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows) / 1e6, rows[:6]


def kernel_phase(torch, card: str) -> dict:
    """K2 with its lse, K3 and K4 against their plain versions, timed.
    Returns name -> record (without launches)."""
    import torch.nn.functional as F

    from persia_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(b, h, t, dh, n=3):
        return [torch.randn((b, h, t, dh), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
                for _ in range(n)]

    def compare(name, got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
        err = (got.float() - want.float()).abs()
        bad = err > atol + rtol * want.float().abs()
        if not torch.isfinite(got.float()).all() or bool(bad.any()):
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"(max abs err {float(err.max()):.3e}, {int(bad.sum())} "
                f"elements beyond atol={atol} rtol={rtol})")
        return float(err.max())

    def check_all(tag, q, k, v, do, kv_mask, causal):
        """Each kernel against its plain version on the same inputs;
        returns the max abs error of each."""
        out, lse = fa.flash_attention_fwd(q, k, v, kv_mask, causal,
                                          return_lse=True)
        w_out, w_lse = fa.flash_attention_fwd_reference(
            q, k, v, kv_mask, causal, return_lse=True)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do,
                                              kv_mask, causal)
        w_dq, w_delta = fa.flash_attention_bwd_dq_reference(
            q, k, v, out, lse, do, kv_mask, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                            kv_mask, causal)
        w_dk, w_dv = fa.flash_attention_bwd_dkv_reference(
            q, k, v, do, lse, delta, kv_mask, causal)
        torch.cuda.synchronize()
        live = lse > fa.NEG_INF / 2
        if not torch.equal(live, w_lse > fa.NEG_INF / 2):
            raise AssertionError(f"{tag}: fully masked rows differ")
        errs = {
            "flash_attention_fwd": max(
                compare(f"{tag} K2 out", out, w_out),
                compare(f"{tag} K2 lse", torch.where(live, lse, 0),
                        torch.where(live, w_lse, 0), LSE_ATOL, 0)),
            "flash_attention_bwd_dq": max(
                compare(f"{tag} K3 dq", dq, w_dq),
                compare(f"{tag} K3 delta", delta, w_delta, LSE_ATOL, 1e-5)),
            "flash_attention_bwd_dkv": max(compare(f"{tag} K4 dk", dk, w_dk),
                                           compare(f"{tag} K4 dv", dv, w_dv)),
        }
        return errs, (out, lse, delta, dq, dk, dv)

    def time_all(q, k, v, do, kv_mask, causal, iters, plain_iters):
        out, lse = fa.flash_attention_fwd(q, k, v, kv_mask, causal,
                                          return_lse=True)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, kv_mask,
                                             causal)
        kernel = {
            "flash_attention_fwd": lambda: fa.flash_attention_fwd(
                q, k, v, kv_mask, causal, return_lse=True),
            "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq(
                q, k, v, out, lse, do, kv_mask, causal),
            "flash_attention_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, kv_mask, causal),
        }
        plain = {
            "flash_attention_fwd": lambda: fa.flash_attention_fwd_reference(
                q, k, v, kv_mask, causal, return_lse=True),
            "flash_attention_bwd_dq":
                lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, out, lse, do, kv_mask, causal),
            "flash_attention_bwd_dkv":
                lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, do, lse, delta, kv_mask, causal),
        }
        ms = {n: cuda_ms(torch, f, iters) for n, f in kernel.items()}
        plain_ms = ({n: cuda_ms(torch, f, plain_iters, warmup=1)
                     for n, f in plain.items()} if plain_iters else None)
        return ms, plain_ms

    def sdpa_ms(q, k, v, do, kv_mask, causal, iters):
        """SDPA forward alone, and forward plus one autograd.grad."""
        mask = None if kv_mask is None else kv_mask[:, None, None, :]

        def fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  is_causal=causal)

        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                               is_causal=causal)
            return torch.autograd.grad(o, (qg, kg, vg), do)

        with torch.inference_mode():
            f_ms = cuda_ms(torch, fwd, iters)
        return f_ms, cuda_ms(torch, fwd_bwd, iters)

    def aten_flash_backward(q, k, v, do, causal):
        """One PyTorch call computing (dq, dk, dv) like K3 + K4: the
        library's flash backward, fed the outputs of its own flash forward
        on the same q, k, v (a yardstick; the port never calls it)."""
        scale = 1.0 / float(q.shape[-1]) ** 0.5
        with torch.no_grad():
            (out, lse, cum_q, cum_k, max_q, max_k, seed, offset,
             _) = torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, 0.0, causal, False, scale=scale)
        return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal,
            seed, offset, scale=scale)

    records = {}
    # the training path's shape: batch 256, 4 heads, t_hist 64, dh 4, a
    # key mask from ragged history lengths, some of them empty
    b, h, t, dh = 256, HEADS, T_HIST, DIM // HEADS
    q, k, v, do = rand(b, h, t, dh, 4)
    lengths = torch.randint(0, t + 1, (b,), generator=gen, device=dev)
    lengths[:8] = 0  # fully masked rows must give 0, not NaN
    kv_mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    errs, (out, lse, _, dq, dk, dv) = check_all("model shape", q, k, v, do,
                                                kv_mask, False)
    if any(bool(x[:8].float().abs().max() != 0) for x in (out, dq, dk, dv)):
        raise AssertionError("fully masked rows: output or gradients not 0")
    if not bool((lse[:8] <= fa.NEG_INF / 2).all()):
        raise AssertionError("fully masked rows: lse above -1e30 / 2")
    ms, plain_ms = time_all(q, k, v, do, kv_mask, False, 200, 50)
    serve_ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, kv_mask), iters=200)
    # the per-call times here are host time: K2 (lse) once more, after the
    # others, shows their spread
    again_ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, kv_mask, return_lse=True), iters=200)
    lib_fwd, lib_fwd_bwd = sdpa_ms(q, k, v, do, kv_mask, False, 200)
    bounds = dict(zip(FLASH_KERNELS, attention_bounds(q, k, kv_mask, False,
                                                      True)))
    for name in FLASH_KERNELS:
        src, replaces = KERNEL_INFO[name]
        records[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            # one PyTorch call computes the forward (SDPA); none computes
            # dq or dk/dv alone: the backward's yardstick is printed below
            "library_ms": lib_fwd if name == "flash_attention_fwd" else None,
        }
        _log(f"[kernel] {name} model shape B={b} H={h} T={t} Dh={dh} bf16 "
             f"kv_mask: max_abs_err={errs[name]:.3e} kernel_ms="
             f"{ms[name]:.6f} bound_ms={bounds[name][0]:.6f} "
             f"({bounds[name][1]}) plain_ms={plain_ms[name]:.6f} | card: "
             f"{card}")
    ours = sum(ms.values())
    _log(f"[kernel] model shape: K2 serving variant (no lse) kernel_ms="
         f"{serve_ms:.6f}; K2 (lse) timed again kernel_ms={again_ms:.6f}; "
         f"library sdpa forward ms={lib_fwd:.6f}; "
         f"sdpa forward+backward ms={lib_fwd_bwd:.6f} vs K2(lse)+K3+K4 ms="
         f"{ours:.6f} | card: {card}")
    _, _, top = profile_window(torch, lambda: [time_all(
        q, k, v, do, kv_mask, False, 20, 0)])
    for us, name, count in top:
        for kernel, tag in zip(FLASH_KERNELS, ("fwd", "bwd_dq", "bwd_dkv")):
            if f"{tag}_kernel" in name:
                records[kernel]["device_ms_per_launch"] = us / count / 1e3
                _log(f"[kernel] model shape device time per launch "
                     f"{us / count / 1e3:.6f} ms ({count} x {name[:70]}) | "
                     f"card: {card}")
    del q, k, v, do, out, lse, dq, dk, dv

    # the attention-bench shape of bench.py --mode attn, causal
    b, h, dh = 4, 8, 128
    q, k, v, do = rand(b, h, 2048, dh, 4)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    errs_b, _ = check_all("bench shape T=2048 causal", q, k, v, do, None,
                          True)
    plain_peak_2048 = torch.cuda.max_memory_allocated() - base
    # the model path's key mask at long length, not causal: ragged
    # lengths, batch row 0 empty
    lengths = torch.randint(1, 2048 + 1, (b,), generator=gen, device=dev)
    lengths[0] = 0
    kv_mask = torch.arange(2048, device=dev)[None, :] < lengths[:, None]
    errs_m, (out, lse, _, dq, dk, dv) = check_all(
        "bench shape T=2048 key mask", q, k, v, do, kv_mask, False)
    if any(bool(x[0].float().abs().max() != 0) for x in (out, dq, dk, dv)) \
            or not bool((lse[0] <= fa.NEG_INF / 2).all()):
        raise AssertionError("bench shape, key mask: the empty batch row's "
                             "output or gradients are not 0, or its lse is "
                             "above -1e30 / 2")
    for name in FLASH_KERNELS:
        records[name]["max_abs_err"] = max(errs[name], errs_b[name],
                                           errs_m[name])
        _log(f"[kernel] {name} bench width B={b} H={h} T=2048 Dh={dh} bf16 "
             f"key mask (lengths {lengths.tolist()}): max_abs_err="
             f"{errs_m[name]:.3e} | card: {card}")
    del q, k, v, do, out, lse, dq, dk, dv, kv_mask
    torch.cuda.empty_cache()
    q, k, v, do = rand(b, h, 8192, dh, 4)
    # the plain versions hold a few (B, H, T, T) f32 matrices: time them at
    # 8192 if the peak measured at 2048, scaled by T^2, fits in free memory
    free = torch.cuda.mem_get_info()[0]
    plain_t = 8192
    while plain_peak_2048 * (plain_t / 2048) ** 2 > 0.8 * free:
        plain_t //= 2
    ms_b, _ = time_all(q, k, v, do, None, True, 10, 0)
    # K3 + K4 between two runs of the library's flash backward
    out_b, lse_b = fa.flash_attention_fwd(q, k, v, None, True,
                                          return_lse=True)
    lib_bwd = aten_flash_backward(q, k, v, do, True)
    k34_ms = [cuda_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out_b, lse_b, do, None, True), 10)]
    lib_bwd_ms = cuda_ms(torch, lib_bwd, 10)
    k34_ms.append(cuda_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out_b, lse_b, do, None, True), 10))
    ours_g = fa.flash_attention_bwd(q, k, v, out_b, lse_b, do, None, True)
    lib_g = lib_bwd()
    lib_gap = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(ours_g, lib_g))
    del out_b, lse_b, ours_g, lib_g, lib_bwd
    # K2 again over more launches, with and without its lse, between two
    # timings of SDPA's forward
    lib_b_fwd, lib_b_fwd_bwd = sdpa_ms(q, k, v, do, None, True, 20)
    ms_b["flash_attention_fwd"] = cuda_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, None, True, return_lse=True), 20)
    serve_b = cuda_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, None, True), 20)
    lib_b_fwd2, _ = sdpa_ms(q, k, v, do, None, True, 20)
    bounds_b = dict(zip(FLASH_KERNELS, attention_bounds(q, k, None, True,
                                                        True)))
    pairs_b = visible_pairs(q, k, None, True)
    flops_b = {"flash_attention_fwd": 4.0 * pairs_b * dh,
               "flash_attention_bwd_dq": 6.0 * pairs_b * dh,
               "flash_attention_bwd_dkv": 8.0 * pairs_b * dh}
    k2_flops = flops_b["flash_attention_fwd"]
    if plain_t != 8192:
        del q, k, v, do
        torch.cuda.empty_cache()
        q, k, v, do = rand(b, h, plain_t, dh, 4)
    _, plain_b = time_all(q, k, v, do, None, True, 1, 1)
    del q, k, v, do
    torch.cuda.empty_cache()
    for name in FLASH_KERNELS:
        _log(f"[kernel] {name} bench shape B={b} H={h} T=8192 Dh={dh} bf16 "
             f"causal: max_abs_err(T=2048)={errs_b[name]:.3e} kernel_ms="
             f"{ms_b[name]:.4f} bound_ms={bounds_b[name][0]:.4f} "
             f"({bounds_b[name][1]}) plain_ms(T={plain_t})="
             f"{plain_b[name]:.4f} | card: {card}")
    _log(f"[kernel] bench shape T=8192: library sdpa forward ms="
         f"{lib_b_fwd:.4f}; sdpa forward+backward ms={lib_b_fwd_bwd:.4f} "
         f"vs K2(lse)+K3+K4 ms={sum(ms_b.values()):.4f} | card: {card}")
    _log(f"[kernel] bench shape T=8192: K3+K4 ms={k34_ms[0]:.4f} before, "
         f"{k34_ms[1]:.4f} after the library flash backward "
         f"(aten._scaled_dot_product_flash_attention_backward) ms="
         f"{lib_bwd_ms:.4f}: K3+K4 / library = "
         f"{min(k34_ms) / lib_bwd_ms:.3f}; max abs gap between the two "
         f"gradients {lib_gap:.3e} | card: {card}")
    for name in FLASH_KERNELS[1:]:
        t_ms, bound = ms_b[name], bounds_b[name][0]
        records[name].update({
            "bench_shape": f"B={b} H={h} T=8192 Dh={dh} bf16 causal",
            "bench_ms": t_ms, "bench_bound_ms": bound,
            "bench_tflops": flops_b[name] / t_ms / 1e9,
            "bench_bound_share": bound / t_ms,
            # one library call computes dq, dk and dv together
            "bench_library_ms_k3_plus_k4": lib_bwd_ms,
            "bench_k3_plus_k4_ms": k34_ms})
        _log(f"[kernel] {name} bench shape: {t_ms:.4f} ms over 10 launches, "
             f"{flops_b[name] / t_ms / 1e9:.1f} TFLOP/s, {bound / t_ms:.4f} "
             f"of its bound {bound:.4f} ms | card: {card}")
    k2 = ms_b["flash_attention_fwd"]
    k2_bound = bounds_b["flash_attention_fwd"][0]
    records["flash_attention_fwd"].update({
        "bench_shape": f"B={b} H={h} T=8192 Dh={dh} bf16 causal",
        "bench_ms": k2, "bench_serving_ms": serve_b,
        "bench_library_ms": min(lib_b_fwd, lib_b_fwd2),
        "bench_bound_ms": k2_bound,
        "bench_tflops": k2_flops / k2 / 1e9,
        "bench_bound_share": k2_bound / k2})
    _log(f"[kernel] K2 bench shape: lse ms={k2:.4f} serving (no lse) ms="
         f"{serve_b:.4f}, {k2_flops / k2 / 1e9:.1f} TFLOP/s, "
         f"{k2_bound / k2:.4f} of its bound {k2_bound:.4f} ms; sdpa forward "
         f"ms={lib_b_fwd:.4f} before, {lib_b_fwd2:.4f} after | card: {card}")
    return records


def kernel_device_ms(torch, fn, kernel_name: str, calls: int = 50):
    """Device time per launch of the kernel whose name contains
    ``kernel_name``, from a profiler window of ``calls`` calls of ``fn``;
    None when the trace holds no such kernel."""
    _, _, top = profile_window(torch, lambda: [fn() for _ in range(calls)])
    for us, name, count in top:
        if kernel_name in name:
            return us / count / 1e3
    return None


def bag_inputs(torch, gen, vocab, dim, batch, bag, edge_ids: bool):
    """A (vocab, dim) f32 table, (batch, bag) int32 ids and f32 weights
    on the card. With ``edge_ids``: duplicates inside and across bags,
    zero-weight padding, and ids -1, V and V + 7."""
    dev = torch.device("cuda")
    table = torch.randn((vocab, dim), generator=gen, device=dev)
    ids = torch.randint(0, vocab, (batch, bag), generator=gen, device=dev,
                        dtype=torch.int32)
    weights = torch.randn((batch, bag), generator=gen, device=dev)
    if edge_ids:
        ids[:64, :] = ids[:64, :1]  # one id repeated through a bag
        ids[64:128, 0] = 7  # one id in many bags
        pad = torch.rand((batch, bag), generator=gen, device=dev) < 0.25
        weights[pad] = 0.0
        ids[200:203, -1] = torch.tensor([-1, vocab, vocab + 7], device=dev,
                                        dtype=torch.int32)
    return table, ids, weights


def sparse_kernel_phase(torch, card: str) -> dict:
    """K1 at device mode's shape and at the v5e shape of
    persia_tpu/ops/embedding_bag.py:21, against its plain version and
    timed. Returns K1's record (without launches)."""
    import torch.nn.functional as F

    from persia_tpu_torch.ops import embedding_bag as eb

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = {}
    k1 = {}
    for tag, (vocab, dim, batch, bag, edge) in {
            "device-mode": (DM_VOCAB, DM_DIM, DM_BATCH, 1, False),
            "v5e": (1 << 16, 16, 4096, 8, True)}.items():
        table, ids, weights = bag_inputs(torch, gen, vocab, dim, batch, bag,
                                         edge)
        got = eb.embedding_bag_fwd(table, ids, weights)
        want = eb.embedding_bag_reference(table, ids, weights)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if bag == 1:
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {tag}: not bit-equal to its plain "
                                     f"version at S=1 (max abs err {err})")
        elif not bool(torch.isfinite(got).all()) or bool(
                ((got - want).abs() > BAG_ATOL + BAG_RTOL * want.abs())
                .any()):
            raise AssertionError(f"K1 {tag}: kernel disagrees with its plain "
                                 f"version (max abs err {err:.3e})")
        clipped = eb.clip_ids(ids, vocab)
        ms = cuda_ms(torch, lambda: eb.embedding_bag_fwd(table, ids,
                                                         weights), 200)
        plain = cuda_ms(torch, lambda: eb.embedding_bag_reference(
            table, ids, weights), 200)
        lib = cuda_ms(torch, lambda: F.embedding_bag(
            clipped, table, per_sample_weights=weights, mode="sum"), 200)
        dev_ms = kernel_device_ms(torch, lambda: eb.embedding_bag_fwd(
            table, ids, weights), "embedding_bag_kernel")
        # the rows this run's ids read once each, the ids and weights, and
        # the output; 2 FLOP per element of a gathered row on the f32 cores
        rows = int(torch.unique(clipped).numel())
        bound = bound_ms(rows * 4 * dim + batch * bag * 8 + 4 * batch * dim,
                         2.0 * batch * bag * dim, PEAK_F32_FLOPS)
        k1[tag] = (err, ms, plain, lib, bound)
        _log(f"[kernel] embedding_bag {tag} shape V={vocab} D={dim} "
             f"B={batch} S={bag}: max_abs_err={err:.3e}"
             f"{' (bit-equal)' if bag == 1 else ''} kernel_ms={ms:.6f} "
             f"device_ms_per_launch="
             f"{'not measured' if dev_ms is None else f'{dev_ms:.6f}'} "
             f"bound_ms={bound[0]:.6f} ({bound[1]}, {rows} distinct rows) "
             f"plain_ms={plain:.6f} library F.embedding_bag ms={lib:.6f} | "
             f"card: {card}")
        del table, ids, weights, got, want, clipped
    err, ms, plain, lib, bound = k1["device-mode"]
    src, replaces = KERNEL_INFO["embedding_bag"]
    records["embedding_bag"] = {
        "name": "embedding_bag", "route": "cuda", "source": src,
        "replaces": replaces, "launches": None,
        "max_abs_err": max(v[0] for v in k1.values()), "ms": ms,
        "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": lib}
    return records


def probe_phase(torch, card: str) -> dict:
    """K5's own path, ``python -m persia_tpu_torch.ops.probe_copy``'s
    ``run_probe`` on the card, its counter zeroed just before: every case
    must equal the plain version. Then each case's plain version, the
    library yardstick and K5's device time per launch are timed beside
    its bound. Returns K5's record, from case D (the largest row)."""
    from persia_tpu_torch.ops import probe_copy as pc

    pc.reset_launch_count()
    results = pc.run_probe("cuda")
    torch.cuda.synchronize()
    launches = pc.launch_count()
    if not all(r["ok"] for r in results) or launches <= 0:
        raise AssertionError(f"the copy-shape probe failed: {results}, "
                             f"{launches} launches")
    for r in results:
        src_t, idx = pc.case_inputs(r["name"], "cuda")
        want = pc.probe_copy_reference(src_t, idx)
        # one PyTorch call gives the same floats: index_select of the row
        # of the flattened table, whose first 8 columns are a view
        rows = src_t.view(src_t.shape[0], -1)

        def library(rows=rows, idx=idx):
            return torch.index_select(rows, 0, idx)[:, :pc.OUT_FLOATS]

        if not torch.equal(library(), want):
            raise AssertionError(f"K5 case {r['name']}: the library "
                                 f"yardstick computes another function")
        r["ms"] = r["us_per_call"] / 1e3
        r["plain_ms"] = cuda_ms(torch, lambda: pc.probe_copy_reference(
            src_t, idx), 200)
        r["library_ms"] = cuda_ms(torch, library, 200)
        dev_ms = kernel_device_ms(torch, lambda: pc.probe_copy(src_t, idx),
                                  "probe_copy_kernel")
        # the row, the index and the floats written
        r["bound"] = bound_ms(r["row_bytes"] + 4 + 4 * want.numel(), 0.0)
        _log(f"[probe] case {r['name']} row_bytes={r['row_bytes']}: equal "
             f"to plain, kernel_ms={r['ms']:.6f} device_ms_per_launch="
             f"{'not measured' if dev_ms is None else f'{dev_ms:.6f}'} "
             f"bound_ms={r['bound'][0]:.8f} ({r['bound'][1]}) plain_ms="
             f"{r['plain_ms']:.6f} library index_select ms="
             f"{r['library_ms']:.6f} | card: {card}")
    _log(f"[probe] K5 launches on the probe's path: {launches} | card: "
         f"{card}")
    d = results[-1]  # case D, a 4096-byte row
    src, replaces = KERNEL_INFO["probe_copy"]
    return {"name": "probe_copy", "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": 0.0,
            "ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound"][0], "bound_by": d["bound"][1],
            "library_ms": d["library_ms"]}


def build_schema():
    from persia_tpu_torch.config import EmbeddingSchema, SlotConfig, \
        uniform_slots
    from persia_tpu_torch.workloads.generator import (
        SEQ_CLICKS_SLOT, SEQ_HISTORY_SLOT, SEQ_PROFILE_SLOTS,
        SEQ_TARGET_SLOT)

    slots = uniform_slots([*SEQ_PROFILE_SLOTS, SEQ_TARGET_SLOT], dim=DIM)
    slots[SEQ_HISTORY_SLOT] = SlotConfig(
        name=SEQ_HISTORY_SLOT, dim=DIM, embedding_summation=False,
        sample_fixed_size=T_HIST)
    slots[SEQ_CLICKS_SLOT] = SlotConfig(
        name=SEQ_CLICKS_SLOT, dim=DIM, pooling="last4")
    return EmbeddingSchema(slots_config=slots)


def fresh_worker(schema):
    """A worker over ``N_PS`` empty PS shards, as the example builds."""
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    return EmbeddingWorker(
        schema, [EmbeddingHolder(2_000_000, 8) for _ in range(N_PS)])


def build_world():
    """Two PS shards holding rows for every sign of the traffic, and the
    worker over them."""
    from persia_tpu_torch.ps.rng import initialize_entries
    from persia_tpu_torch.workloads.generator import SeqRecSpec

    schema = build_schema()
    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    worker = fresh_worker(schema)
    signs = spec.all_signs()
    worker.set_rows(signs, initialize_entries(
        signs, DIM, "bounded_uniform", {"lower": -0.05, "upper": 0.05}), DIM)
    return schema, worker, spec


def build_tower(num_dense: int, attn_impl: str, state_dict=None,
                compute_dtype=None):
    """The SequenceTower on the card, with seeded weights or a copy of
    ``state_dict``."""
    import torch

    from persia_tpu_torch.models import SequenceTower
    from persia_tpu_torch.weights import init_params

    # the batch's feature order: 2 profiles, history (raw), clicks, target
    slots = [(DIM, False), (DIM, False), (DIM, True), (DIM, False),
             (DIM, False)]
    model = SequenceTower(num_dense, slots, mlp=MLP, num_heads=HEADS,
                          attn_impl=attn_impl, device="cuda",
                          compute_dtype=compute_dtype or torch.bfloat16)
    if state_dict is None:
        return init_params(model, SEED)
    model.load_state_dict(state_dict)
    return model


def run_clients(server, payloads):
    """``N_THREADS`` closed-loop clients, each sending its share of the
    PTB2 payloads one after another. Returns (predictions, per-request
    latencies in s, wall s)."""
    n = len(payloads)
    preds = [None] * n
    lat = [0.0] * n
    errors = []

    def client(ci):
        try:
            for i in range(ci, n, N_THREADS):
                t = time.perf_counter()
                preds[i] = server.predict_bytes(payloads[i])
                lat[i] = time.perf_counter() - t
        except Exception as e:  # re-raised below, fails the run
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(N_THREADS)]
    t_start = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t_start
    if any(th.is_alive() for th in threads):
        raise AssertionError("serving clients did not finish")
    if errors:
        raise errors[0]
    return preds, lat, wall


def serving_phase(torch, card: str):
    import numpy as np

    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.serving import InferenceServer
    from persia_tpu_torch.workloads.generator import seqrec_batches

    t0 = time.perf_counter()
    schema, worker, spec = build_world()
    model = build_tower(spec.num_dense, "flash")
    n_req = N_THREADS * REQUESTS_PER_THREAD
    payloads = [b.to_bytes() for b in seqrec_batches(
        n_req * REQUEST_ROWS, REQUEST_ROWS, seed=SEED + 1, spec=spec,
        requires_grad=False)]
    warm = [b.to_bytes() for b in seqrec_batches(
        16 * REQUEST_ROWS, REQUEST_ROWS, seed=SEED + 2, spec=spec,
        requires_grad=False)]
    _log(f"[serving] setup {time.perf_counter() - t0:.2f}s: "
         f"{len(spec.all_signs())} PS rows over {N_PS} shards, "
         f"{n_req} requests of {REQUEST_ROWS} rows")
    server = InferenceServer(model, schema, worker, device="cuda",
                             max_batch_rows=256, cache_rows=100_000)
    try:
        server.predict_many(warm)  # first-use allocations, cuBLAS handles
        torch.cuda.synchronize()

        fa.reset_launch_count()
        preds, lat, wall = run_clients(server, payloads)
        launches = [fa.launch_count(n) for n in FLASH_KERNELS]
        stats = server.stats()
        window = profile_window(
            torch, lambda: run_clients(server, payloads[:16 * N_THREADS]))
    finally:
        server.stop()

    rows = n_req * REQUEST_ROWS
    for p in preds:
        if p.shape != (REQUEST_ROWS, 1) or not np.isfinite(p).all() \
                or not ((p > 0) & (p < 1)).all():
            raise AssertionError(f"bad predictions: shape {p.shape}, "
                                 f"range [{p.min()}, {p.max()}]")
    if launches[0] <= 0 or any(launches[1:]):
        raise AssertionError(
            f"the serving path must launch K2 and no backward kernel: "
            f"launches {launches}")
    lat_ms = np.asarray(lat) * 1e3
    _log(f"[serving] {rows} rows in {wall:.3f}s: rows_per_s="
         f"{rows / wall:.1f} request_p50_ms={np.percentile(lat_ms, 50):.3f} "
         f"request_p99_ms={np.percentile(lat_ms, 99):.3f} "
         f"batches={stats['batches']} avg_coalesce="
         f"{stats['avg_coalesce']:.2f} lookup_p50_ms="
         f"{stats['lookup_p50_ms']:.3f} forward_p50_ms="
         f"{stats['forward_p50_ms']:.3f} cache_hit_rate="
         f"{stats['cache_hit_rate']:.3f} flash_launches={launches[0]} "
         f"({launches[0] / n_req:.3f} per request) | card: {card}")
    report_window("serving", f"{16 * N_THREADS} requests", window, card)

    # the same requests through a tower with the dense reference attention
    ref_model = build_tower(spec.num_dense, "reference",
                            state_dict=model.state_dict())
    ref_server = InferenceServer(ref_model, schema, worker, device="cuda")
    try:
        ref = ref_server.predict_many(payloads)
    finally:
        ref_server.stop()
    err = max(float(np.abs(a - b).max()) for a, b in zip(preds, ref))
    if not err <= SERVING_ATOL:
        raise AssertionError(
            f"flash and reference towers disagree: max abs err {err:.3e} > "
            f"{SERVING_ATOL}")
    _log(f"[serving] flash vs reference attention: max_abs_err={err:.3e} "
         f"(atol {SERVING_ATOL}) | card: {card}")


def report_window(phase: str, what: str, window, card: str):
    wall, busy, top = window
    if busy <= 0:
        _log(f"[{phase}] profiled window: the trace holds no device time; "
             f"device busy share not measured")
        return
    _log(f"[{phase}] profiled window of {what}: wall={wall:.3f}s "
         f"device_busy={busy:.4f}s device_busy_share={busy / wall:.4f} | "
         f"card: {card}")
    for us, name, count in top:
        _log(f"[{phase}]   device {us / 1e3:.3f} ms in {count} x "
             f"{name[:200]} | card: {card}")


def train_ctx(torch, schema, model, global_config=None):
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad

    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                    Adagrad(lr=1e-2), schema, fresh_worker(schema),
                    embedding_config=EmbeddingConfig(
                        emb_initialization=(-0.05, 0.05)),
                    global_config=global_config, device="cuda")


def training_agreement(torch, card: str, spec):
    """A flash tower and a reference tower, from the same weights and
    fresh PS rows, train 3 steps in f32 (f32 wire, no TF32) and must
    agree on loss, predictions and each slot's embedding gradients."""
    import numpy as np

    from persia_tpu_torch.config import CommonConfig, GlobalConfig
    from persia_tpu_torch.workloads.generator import seqrec_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    schema = build_schema()
    flash = build_tower(spec.num_dense, "flash",
                        compute_dtype=torch.float32)
    ref = build_tower(spec.num_dense, "reference",
                      state_dict=flash.state_dict(),
                      compute_dtype=torch.float32)
    runs = []
    for model in (flash, ref):
        ctx = train_ctx(torch, schema, model,
                        GlobalConfig(CommonConfig("f32")))
        grads = []
        inner = ctx.worker.update_gradients

        def record(ref_id, g, inner=inner, grads=grads):
            grads.append({k: np.array(v) for k, v in g.items()})
            return inner(ref_id, g)

        ctx.worker.update_gradients = record
        out = []
        with ctx:
            for b in seqrec_batches(3 * TRAIN_BATCH, TRAIN_BATCH,
                                    seed=TRAIN_SEED, spec=spec):
                loss, pred = ctx.train_step(b)
                out.append((float(loss), pred.cpu().numpy()))
        runs.append((out, grads))
    worst = [0.0, 0.0, 0.0]
    for step, ((fl, fp), (rl, rp), fg, rg) in enumerate(zip(
            runs[0][0], runs[1][0], runs[0][1], runs[1][1])):
        if not (np.isfinite(fl) and np.isfinite(fp).all()):
            raise AssertionError(f"flash tower step {step}: non-finite")
        worst[0] = max(worst[0], abs(fl - rl))
        worst[1] = max(worst[1], float(np.abs(fp - rp).max()))
        for name in rg:
            scale = float(np.abs(rg[name]).max())
            err = float(np.abs(fg[name] - rg[name]).max())
            worst[2] = max(worst[2], err / max(scale, 1e-30))
    _log(f"[training] flash vs reference tower, 3 steps f32: loss "
         f"max_abs_err={worst[0]:.3e} pred max_abs_err={worst[1]:.3e} "
         f"(atol {TRAIN_ATOL}); embedding grads max err / max |grad| = "
         f"{worst[2]:.3e} (rtol {TRAIN_GRAD_RTOL}) | card: {card}")
    if not (worst[0] <= TRAIN_ATOL and worst[1] <= TRAIN_ATOL
            and worst[2] <= TRAIN_GRAD_RTOL):
        raise AssertionError("flash and reference towers disagree in "
                             "training")


def training_phase(torch, card: str):
    """The main path: 300 steps of TrainCtx on the card, then the AUC.
    Returns the launches of each kernel during the 300 steps."""
    import numpy as np

    from persia_tpu_torch.ctx import STAGES, eval_ctx
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.utils import roc_auc
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    training_agreement(torch, card, spec)

    t0 = time.perf_counter()
    schema = build_schema()
    model = build_tower(spec.num_dense, "flash")
    ctx = train_ctx(torch, schema, model)
    batches = list(seqrec_batches(TRAIN_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                                  seed=TRAIN_SEED, spec=spec))
    _log(f"[training] setup {time.perf_counter() - t0:.2f}s: "
         f"{TRAIN_STEPS} batches of {TRAIN_BATCH}, fresh PS of {N_PS} "
         f"shards")
    # steps [0, 250) are timed as they run; [250, 270) synchronize after
    # every stage for an honest split; [270, 275) run under the profiler
    timed, split, prof = range(0, 250), range(250, 270), range(270, 275)
    step_s, losses = [], {}
    window = None
    with ctx:
        fa.reset_launch_count()
        for step, batch in enumerate(batches):
            if step == split.start:
                ctx.sync_stages = True
                ctx.stage_seconds = dict.fromkeys(STAGES, 0.0)
            if step == prof.start:
                split_s = dict(ctx.stage_seconds)
                ctx.sync_stages = False
                window = profile_window(torch, lambda: [
                    ctx.train_step(batches[s]) for s in prof])
            if step in prof:
                continue
            t = time.perf_counter()
            loss, pred = ctx.train_step(batch)
            step_s.append(time.perf_counter() - t)
            if step % 50 == 0:
                losses[step] = float(loss)
                if not (np.isfinite(losses[step])
                        and bool(torch.isfinite(pred).all())):
                    raise AssertionError(f"step {step}: non-finite output")
        torch.cuda.synchronize()
        launches = {n: fa.launch_count(n) for n in FLASH_KERNELS}

        preds, labels = [], []
        with eval_ctx(ctx) as ectx:
            for b in seqrec_batches(EVAL_SAMPLES, TRAIN_BATCH,
                                    seed=TRAIN_SEED + 1000, spec=spec,
                                    requires_grad=False):
                pred, lab = ectx.forward(b)
                preds.append(pred.float().cpu().numpy().reshape(-1))
                labels.append(lab[0].numpy().reshape(-1))
    preds = np.concatenate(preds)
    if not np.isfinite(preds).all():
        raise AssertionError("non-finite eval predictions")
    auc = roc_auc(np.concatenate(labels), preds)

    steady = np.asarray(step_s[10:len(timed)]) * 1e3  # past the warm-up
    _log(f"[training] {len(steady)} steady steps of batch {TRAIN_BATCH}: "
         f"samples_per_s={TRAIN_BATCH / (steady.mean() / 1e3):.1f} "
         f"step_p50_ms={np.percentile(steady, 50):.3f} "
         f"step_p99_ms={np.percentile(steady, 99):.3f} | card: {card}")
    n_split = len(split)
    _log("[training] step split over steps "
         f"{split.start}-{split.stop - 1}, device synchronized after each "
         "stage (ms per step): " + " ".join(
             f"{k}={split_s[k] / n_split * 1e3:.3f}" for k in STAGES)
         + f" | card: {card}")
    _log("[training] loss " + " ".join(
        f"step{s}={v:.4f}" for s, v in sorted(losses.items()))
        + f" | card: {card}")
    _log(f"[training] launches in {TRAIN_STEPS} steps: " + " ".join(
        f"{n}={c}" for n, c in launches.items())
        + f" ({launches['flash_attention_fwd'] / TRAIN_STEPS:.3f} K2 per "
        f"step) | card: {card}")
    _log(f"[training] test AUC on {EVAL_SAMPLES} held-out samples: "
         f"{auc:.4f} (bar {AUC_BAR}) | card: {card}")
    report_window("training", f"{len(prof)} steps", window, card)
    if any(c <= 0 for c in launches.values()):
        raise AssertionError(f"a kernel of the training path never "
                             f"launched: {launches}")
    if not auc > AUC_BAR:
        raise AssertionError(f"test AUC {auc:.4f} is not above {AUC_BAR}")
    return launches


def device_mode_model(torch, bag_impl: str, compute_dtype):
    """bench_device's DeviceModeModel(DLRM) on the card, weights not yet
    drawn. Returns (slot specs, model)."""
    from persia_tpu_torch.models.dlrm import DLRM
    from persia_tpu_torch.parallel.device_mode import (
        DeviceModeModel,
        criteo_like_specs,
    )

    specs = criteo_like_specs(DM_SLOTS, DM_VOCAB, DM_DIM)
    tower = DLRM(DM_DENSE, DM_SLOTS, embedding_dim=DM_DIM,
                 compute_dtype=compute_dtype, device="cuda")
    return specs, DeviceModeModel(specs, tower, bag_impl=bag_impl,
                                  device="cuda")


def dm_adagrad(params):
    """optax.adagrad(0.02), bench_device's optimizer."""
    from persia_tpu_torch.parallel.optim import OptaxAdagrad

    return OptaxAdagrad(params, DM_LR)


def device_mode_agreement(torch, card: str):
    """A kernel tower and a plain tower (``bag_impl="reference"``) from one
    seeded weight set take 3 steps at bench width with an f32 tower on a
    batch of 4 ids a slot, about a quarter of them padding; the losses,
    the predictions and every table's change over the steps must agree,
    and the plain tower must have moved by more than twice each limit."""
    import numpy as np

    from persia_tpu_torch.parallel.device_mode import (
        make_device_mode_trainer,
        synthetic_device_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    specs, kmodel = device_mode_model(torch, "kernel", torch.float32)
    non_id, ids, label = synthetic_device_batch(
        DM_BATCH, DM_DENSE, specs, DM_AGREE_SFS, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for v in ids.values():
        v[torch.rand(v.shape, generator=gen, device="cuda") < 0.25] = 0
    kmodel, _, kstep = make_device_mode_trainer(kmodel, dm_adagrad, non_id,
                                                ids, seed=SEED, device="cuda")
    _, rmodel = device_mode_model(torch, "reference", torch.float32)
    rmodel.load_state_dict(kmodel.state_dict())
    rmodel, _, rstep = make_device_mode_trainer(rmodel, dm_adagrad, non_id,
                                                ids, seed=None, device="cuda")
    start = {n: p.detach().clone() for n, p in kmodel.named_parameters()
             if n.endswith(".table")}
    losses = np.array([[float(step(non_id, ids, label)) for _ in range(3)]
                       for step in (kstep, rstep)])
    with torch.inference_mode():
        preds = [m.eval()(non_id, ids) for m in (kmodel, rmodel)]
    loss_err = float(np.abs(losses[0] - losses[1]).max())
    loss_move = float(np.abs(losses[1] - losses[1][0]).max())
    loss_lim = DM_LOSS_MOVE_RTOL * loss_move
    pred_err = float((preds[0] - preds[1]).abs().max())
    rparams = dict(rmodel.named_parameters())
    table_err = table_move = 0.0
    with torch.no_grad():
        for n, p in kmodel.named_parameters():
            if n in start:
                moved = rparams[n] - start[n]
                table_err = max(table_err, float(
                    ((p - start[n]) - moved).abs().max()))
                table_move = max(table_move, float(moved.abs().max()))
    del start
    table_lim = DM_TABLE_ULPS_ATOL + DM_TABLE_MOVE_RTOL * table_move
    _log(f"[device_mode] kernel vs plain tower, 3 steps of batch {DM_BATCH}"
         f" with {DM_AGREE_SFS} ids a slot, f32 tower: loss max_abs_err="
         f"{loss_err:.3e} (limit {loss_lim:.3e} = {DM_LOSS_MOVE_RTOL} x the "
         f"plain loss's movement {loss_move:.3e}) pred max_abs_err="
         f"{pred_err:.3e} (atol {DM_PRED_ATOL}) table change max_abs_err="
         f"{table_err:.3e} (limit {table_lim:.3e} = {DM_TABLE_MOVE_RTOL} x "
         f"the largest plain change {table_move:.3e} + 3 ulps); kernel "
         f"tower losses {' '.join(f'{x:.8f}' for x in losses[0])} | card: "
         f"{card}")
    if not np.isfinite(losses).all() or not all(
            bool(torch.isfinite(p).all()) for p in preds):
        raise AssertionError("non-finite loss or prediction in the "
                             "device-mode agreement steps")
    if not (loss_move > 2 * loss_lim and table_move > 2 * table_lim):
        raise AssertionError("the plain tower's loss or tables barely moved "
                             "in 3 steps: the agreement could not see a "
                             "step that did nothing")
    if not (loss_err <= loss_lim and pred_err <= DM_PRED_ATOL
            and table_err <= table_lim):
        raise AssertionError("the kernel and plain device-mode towers "
                             "disagree")


def device_mode_phase(torch, card: str) -> int:
    """Device mode's main path at bench_device's configuration: the
    agreement check, then warm-up, timed loops (end-sync and per-step
    sync, on the repeated batch and on 4 rotating fresh-id batches), a
    stage split, a profiled window, and an eval forward. K1's counter is
    zeroed just before the timed steps and must read 26 per step after
    them. Returns K1's launches."""
    import numpy as np

    from persia_tpu_torch.ops import embedding_bag as eb
    from persia_tpu_torch.parallel.device_mode import (
        STAGES,
        make_device_mode_trainer,
        synthetic_device_batch,
    )
    from persia_tpu_torch.parallel.train import bce_loss

    device_mode_agreement(torch, card)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    specs, model = device_mode_model(torch, "kernel", torch.bfloat16)
    non_id, ids, label = synthetic_device_batch(DM_BATCH, DM_DENSE, specs,
                                                seed=SEED, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    model, _, step = make_device_mode_trainer(model, dm_adagrad, non_id, ids,
                                              seed=SEED, device="cuda")
    # 4 rotating fresh-id batches, as tools/probe_device_step.py:55-60
    rng = np.random.default_rng(1)
    fresh = [{name: torch.from_numpy(rng.integers(
        1, 1 << 31, size=(DM_BATCH, 1)).astype(np.int32)).cuda()
        for name, _, _ in specs} for _ in range(4)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()

    losses = [step(non_id, ids, label) for _ in range(DM_WARMUP)]
    torch.cuda.synchronize()
    loss0 = float(losses[0])

    def loop(id_sets, sync_each: bool) -> float:
        """DM_STEPS steps; samples/s by the host clock, which ends in a
        synchronize after the last step (or after every step)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(DM_STEPS):
            losses.append(step(non_id, id_sets[i % len(id_sets)], label))
            if sync_each:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return DM_STEPS * DM_BATCH / (time.perf_counter() - t)

    eb.reset_launch_count()
    # the two end-sync loops first, back to back after the warm-up, so
    # that the repeated and the fresh ids meet the card in the same state
    rates = {"end_sync": loop([ids], False),
             "fresh_end_sync": loop(fresh, False)}
    rates["per_sync"] = loop([ids], True)
    rates["fresh_per_sync"] = loop(fresh, True)
    step.sync_stages = True
    step.stage_seconds = dict.fromkeys(STAGES, 0.0)
    for _ in range(DM_SPLIT_STEPS):
        losses.append(step(non_id, ids, label))
    split = {k: v / DM_SPLIT_STEPS * 1e3 for k, v in step.stage_seconds.items()}
    step.sync_stages = False
    window = profile_window(torch, lambda: [
        losses.append(step(non_id, ids, label))
        for _ in range(DM_PROFILE_STEPS)])
    torch.cuda.synchronize()
    launches = eb.launch_count()
    n_steps = 4 * DM_STEPS + DM_SPLIT_STEPS + DM_PROFILE_STEPS
    peak = torch.cuda.max_memory_allocated()

    with torch.inference_mode():
        pred = model.eval()(non_id, ids)
        eval_loss = float(bce_loss(pred, label))
    all_losses = torch.stack(losses).float().cpu().numpy()

    rate_s = " ".join(f"{k}={v:.1f}" for k, v in rates.items())
    _log(f"[device_mode] DeviceModeModel(DLRM(embedding_dim={DM_DIM})) "
         f"{DM_SLOTS} slots x {DM_VOCAB} x {DM_DIM}, {DM_DENSE} dense, bf16 "
         f"tower, OptaxAdagrad({DM_LR}), batch {DM_BATCH}: samples_per_s "
         f"{rate_s} | card: {card}")
    _log(f"[device_mode] step split over {DM_SPLIT_STEPS} steps, device "
         f"synchronized after each stage (ms per step): " + " ".join(
             f"{k}={v:.3f}" for k, v in split.items()) + f" | card: {card}")
    _log(f"[device_mode] memory: {resident / 1e9:.3f} GB allocated after "
         f"init (the tables and the tower), "
         f"max_memory_allocated {peak / 1e9:.3f} GB; setup "
         f"{setup_s:.2f}s | card: {card}")
    _log(f"[device_mode] loss step0={loss0:.6f} last={float(all_losses[-1]):.6f}"
         f" eval on the repeated batch after {DM_WARMUP + n_steps} steps="
         f"{eval_loss:.6f}; K1 launches in {n_steps} steps: {launches} "
         f"({launches / n_steps:.3f} per step) | card: {card}")
    report_window("device_mode", f"{DM_PROFILE_STEPS} steps", window, card)
    if window[1] > 0:
        # the profiler slows the host, so the window's own busy share
        # (above) is low; the device time per profiled step over the
        # unprofiled end-sync step is a ratio across two windows
        dev_ms = window[1] / DM_PROFILE_STEPS * 1e3
        step_ms = DM_BATCH / rates["end_sync"] * 1e3
        _log(f"[device_mode] device time per step {dev_ms:.3f} ms (profiled "
             f"window) over the unprofiled end-sync step {step_ms:.3f} ms: "
             f"ratio across two windows {dev_ms / step_ms:.4f}; the profiled"
             f" window's own busy share {window[1] / window[0]:.4f} | card: "
             f"{card}")
    if not np.isfinite(all_losses).all():
        raise AssertionError("a device-mode loss is not finite")
    if not (bool(torch.isfinite(pred).all()) and bool(((pred > 0)
                                                       & (pred < 1)).all())):
        raise AssertionError("device-mode eval predictions not in (0, 1)")
    if not eval_loss < loss0:
        raise AssertionError(f"the repeated batch's loss did not fall: "
                             f"{eval_loss} >= step 0's {loss0}")
    if launches != DM_SLOTS * n_steps:
        raise AssertionError(f"K1 launched {launches} times in {n_steps} "
                             f"steps, not {DM_SLOTS} per step")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from persia_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run it "
              f"from the root of a checkout", file=sys.stderr)
        return 2
    try:
        card = card_line()
        _log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
             f"python {sys.version.split()[0]}")
        _log(f"[setup] card: {card}")
        sources = sorted({s.split("/")[-1][:-3] for s, _ in
                          KERNEL_INFO.values()})
        t0 = time.perf_counter()
        paths = _build.build(sources)
        _log(f"[setup] built {sources} in {time.perf_counter() - t0:.1f}s")
        report_build(paths, sources)
        records = kernel_phase(torch, card)
        records.update(sparse_kernel_phase(torch, card))
        serving_phase(torch, card)
        for name, n in training_phase(torch, card).items():
            records[name]["launches"] = n
        records["embedding_bag"]["launches"] = device_mode_phase(torch, card)
        records["probe_copy"] = probe_phase(torch, card)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
