#!/usr/bin/env python3
"""Chip smoke run of persia_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and the CUDA toolkit.
It imports only the port, torch and numpy, never JAX or the JAX package.

1. Setup: versions, the card's name and power limit, and the build of
   every kernel of the port from the sources in this checkout, one nvcc
   per source, all started together.
2. Kernel phase: each kernel is held against its plain PyTorch version on
   the card, at the serving path's shape and at the attention-bench shape,
   and timed beside its bound, its plain version and one PyTorch library
   call computing the same function (a yardstick only; the port never
   calls it).
3. Serving phase: the port's main path. Two PS shards hold rows for the
   whole sign space of the ``seqrec`` traffic; an ``InferenceServer`` on
   the card with micro-batching and the hot-row cache serves a few hundred
   requests from 8 threads as PTB2 bytes through ``SequenceTower(
   attn_impl="flash")`` at the width of ``examples/seq_rec/train.py``.
   The launch counters are zeroed just before and read just after; every
   prediction must be finite and in (0, 1) and agree with a second server
   whose tower uses the dense reference attention.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without the ``ok`` line.
"""

import json
import subprocess
import sys
import threading
import time
import traceback

# Tolerances, each with its reason.
# Kernel against its plain version in bf16: both accumulate in f32 and
# round the output to bf16 once; the summation orders differ, which can
# flip the last bit of the bf16 result (2**-8 relative; outputs are O(1)).
KERNEL_ATOL = 2e-2
KERNEL_RTOL = 2e-2
# Serving predictions, flash tower against reference tower on the card:
# every product runs in bf16, and the attention output is rounded to bf16
# at a different point (kernel output vs. input of the output projection);
# one-ulp differences pass through three more bf16 layers to a sigmoid.
SERVING_ATOL = 2e-2

# H100 SXM published dense peaks (NVIDIA data sheet, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the serving model: examples/seq_rec/train.py's widths
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


def attention_bound_ms(q, k, v, kv_mask, causal: bool):
    """Least time for one attention forward on an H100: bytes (q, k, v and
    the mask read once, the output written once) over the memory rate, or
    the products' operations on the keys this run's data leaves visible
    over the bf16 tensor-core peak, whichever is larger."""
    b, h, t_q, dh = q.shape
    t_k = k.shape[2]
    nbytes = 4 * q.numel() * q.element_size()
    if kv_mask is not None:
        nbytes += kv_mask.numel() * kv_mask.element_size()
    if causal:
        pairs_per_bh = sum(min(i + 1, t_k) for i in range(t_q))
        pairs = b * h * pairs_per_bh
    elif kv_mask is not None:
        pairs = h * t_q * int((kv_mask > 0).sum().item())
    else:
        pairs = b * h * t_q * t_k
    flops = 4.0 * pairs * dh  # q·k and p·v, 2 FLOP per multiply-add
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, card: str) -> dict:
    import torch.nn.functional as F

    from persia_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(b, h, t, dh):
        return [torch.randn((b, h, t, dh), generator=gen, device=dev,
                            dtype=torch.float32).to(torch.bfloat16)
                for _ in range(3)]

    def compare(name, got, want):
        err = (got.float() - want.float()).abs()
        bad = err > KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
        if not torch.isfinite(got.float()).all() or bool(bad.any()):
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"(max abs err {float(err.max()):.3e}, {int(bad.sum())} "
                f"elements beyond atol={KERNEL_ATOL} rtol={KERNEL_RTOL})")
        return float(err.max())

    with torch.inference_mode():
        # the serving path's shape: batch 256, 4 heads, t_hist 64, dh 4,
        # a key mask from ragged history lengths, some of them empty
        b, h, t, dh = 256, HEADS, T_HIST, DIM // HEADS
        q, k, v = qkv(b, h, t, dh)
        lengths = torch.randint(0, t + 1, (b,), generator=gen, device=dev)
        lengths[:8] = 0  # fully masked rows must give 0, not NaN
        kv_mask = torch.arange(t, device=dev)[None, :] < lengths[:, None]
        got = fa.flash_attention_fwd(q, k, v, kv_mask=kv_mask)
        want = fa.flash_attention_fwd_reference(q, k, v, kv_mask=kv_mask)
        torch.cuda.synchronize()
        err_model = compare("model shape", got, want)
        if bool(got[:8].float().abs().max() != 0):
            raise AssertionError("fully masked rows are not 0")
        ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, kv_mask=kv_mask), iters=200)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_fwd_reference(
            q, k, v, kv_mask=kv_mask), iters=50)
        sdpa_mask = kv_mask[:, None, None, :]
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask), iters=200)
        bound_ms, bound_by = attention_bound_ms(q, k, v, kv_mask, False)
        _log(f"[kernel] flash_attention_fwd model shape B={b} H={h} T={t} "
             f"Dh={dh} bf16 kv_mask: max_abs_err={err_model:.3e} "
             f"kernel_ms={ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}) "
             f"plain_ms={plain_ms:.6f} library_ms(sdpa)={library_ms:.6f} "
             f"| card: {card}")
        # kernel_ms above is per wrapper call on the device timeline, back
        # to back, so it includes the host's launch cost when that is the
        # longer; the profiler gives the kernel's own device time
        _, _, top = profile_window(torch, lambda: [fa.flash_attention_fwd(
            q, k, v, kv_mask=kv_mask) for _ in range(50)])
        for us, name, count in top:
            if "fwd_kernel" in name:
                _log(f"[kernel] flash_attention_fwd model shape: device time "
                     f"per launch {us / count / 1e3:.6f} ms ({count} launches "
                     f"profiled) | card: {card}")

        # the attention-bench shape of bench.py --mode attn
        b, h, dh = 4, 8, 128
        q2, k2, v2 = qkv(b, h, 2048, dh)
        err_bench = compare(
            "bench shape T=2048 causal",
            fa.flash_attention_fwd(q2, k2, v2, causal=True),
            fa.flash_attention_fwd_reference(q2, k2, v2, causal=True))
        del q2, k2, v2
        q3, k3, v3 = qkv(b, h, 8192, dh)
        b_ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(
            q3, k3, v3, causal=True), iters=5, warmup=1)
        b_plain = cuda_ms(torch, lambda: fa.flash_attention_fwd_reference(
            q3, k3, v3, causal=True), iters=2, warmup=1)
        b_lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q3, k3, v3, is_causal=True), iters=10)
        b_bound, b_by = attention_bound_ms(q3, k3, v3, None, True)
        del q3, k3, v3
        torch.cuda.empty_cache()
        _log(f"[kernel] flash_attention_fwd bench shape B={b} H={h} T=8192 "
             f"Dh={dh} bf16 causal: max_abs_err(T=2048)={err_bench:.3e} "
             f"kernel_ms={b_ms:.4f} bound_ms={b_bound:.4f} ({b_by}) "
             f"plain_ms={b_plain:.4f} library_ms(sdpa)={b_lib:.4f} "
             f"| card: {card}")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "persia_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "persia_tpu/ops/flash_attention.py:43",
        "launches": None,  # filled from the serving phase
        "max_abs_err": err_model,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def build_world():
    """Two PS shards holding rows for every sign of the traffic, and the
    worker over them."""
    from persia_tpu_torch.config import EmbeddingSchema, SlotConfig, \
        uniform_slots
    from persia_tpu_torch.ps.rng import initialize_entries
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.worker.worker import EmbeddingWorker
    from persia_tpu_torch.workloads.generator import (
        SEQ_CLICKS_SLOT, SEQ_HISTORY_SLOT, SEQ_PROFILE_SLOTS,
        SEQ_TARGET_SLOT, SeqRecSpec)

    slots = uniform_slots([*SEQ_PROFILE_SLOTS, SEQ_TARGET_SLOT], dim=DIM)
    slots[SEQ_HISTORY_SLOT] = SlotConfig(
        name=SEQ_HISTORY_SLOT, dim=DIM, embedding_summation=False,
        sample_fixed_size=T_HIST)
    slots[SEQ_CLICKS_SLOT] = SlotConfig(
        name=SEQ_CLICKS_SLOT, dim=DIM, pooling="last4")
    schema = EmbeddingSchema(slots_config=slots)
    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    worker = EmbeddingWorker(
        schema, [EmbeddingHolder(2_000_000, 8) for _ in range(N_PS)])
    signs = spec.all_signs()
    worker.set_rows(signs, initialize_entries(
        signs, DIM, "bounded_uniform", {"lower": -0.05, "upper": 0.05}), DIM)
    return schema, worker, spec


def build_tower(num_dense: int, attn_impl: str, state_dict=None):
    """The SequenceTower on the card, with seeded weights or a copy of
    ``state_dict``."""
    from persia_tpu_torch.models import SequenceTower
    from persia_tpu_torch.weights import init_params

    # the batch's feature order: 2 profiles, history (raw), clicks, target
    slots = [(DIM, False), (DIM, False), (DIM, True), (DIM, False),
             (DIM, False)]
    model = SequenceTower(num_dense, slots, mlp=MLP, num_heads=HEADS,
                          attn_impl=attn_impl, device="cuda")
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


def profile_window(torch, fn):
    """Run ``fn`` under torch.profiler (CUPTI). Returns (wall s, device
    busy s, the six device kernels with the most time as (us, name,
    count)); busy is 0 when the trace holds no device time."""
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
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((float(us), e.key, e.count))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows) / 1e6, rows[:6]


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
        launches = fa.launch_count()
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
    if launches <= 0:
        raise AssertionError(
            "the serving path launched no flash_attention_fwd kernel")
    lat_ms = np.asarray(lat) * 1e3
    _log(f"[serving] {rows} rows in {wall:.3f}s: rows_per_s="
         f"{rows / wall:.1f} request_p50_ms={np.percentile(lat_ms, 50):.3f} "
         f"request_p99_ms={np.percentile(lat_ms, 99):.3f} "
         f"batches={stats['batches']} avg_coalesce="
         f"{stats['avg_coalesce']:.2f} lookup_p50_ms="
         f"{stats['lookup_p50_ms']:.3f} forward_p50_ms="
         f"{stats['forward_p50_ms']:.3f} cache_hit_rate="
         f"{stats['cache_hit_rate']:.3f} flash_launches={launches} "
         f"({launches / n_req:.3f} per request) | card: {card}")
    w_wall, busy, top = window
    if busy > 0:
        _log(f"[serving] profiled window of {16 * N_THREADS} requests: "
             f"wall={w_wall:.3f}s device_busy={busy:.4f}s "
             f"device_busy_share={busy / w_wall:.4f} | card: {card}")
        for us, name, count in top:
            _log(f"[serving]   device {us / 1e3:.3f} ms in {count} x "
                 f"{name[:90]}")
    else:
        _log("[serving] profiled window: the trace holds no device time; "
             "device busy share not measured")

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
         f"(atol {SERVING_ATOL})")
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
        kernels = ["flash_attention_fwd"]
        t0 = time.perf_counter()
        _build.build(kernels)
        _log(f"[setup] built {kernels} in {time.perf_counter() - t0:.1f}s")
        for name in kernels:
            for line in _build.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    _log(f"[setup] ptxas {name}: {line.strip()}")
        record = kernel_phase(torch, card)
        record["launches"] = serving_phase(torch, card)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
