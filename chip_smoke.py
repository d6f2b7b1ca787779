#!/usr/bin/env python3
"""Chip smoke run of persia_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and the CUDA toolkit.
It imports only the port, torch and numpy, never JAX or the JAX package.

1. Setup: versions, the card's name and power limit, and the build of
   every kernel of the port from the sources in this checkout, one nvcc
   per source, all started together with the g++ build of the native PS
   library from ``native/src/`` (its SIMD path and the host's cores);
   ptxas's registers and spills of every kernel entry, K2's, K3's and
   K4's shared memory per body, and
   the count of tensor-core (HGMMA) and TMA-load (UTMALDG) instructions
   in each built library. Then the launch path: the launch floor (the
   device and host time of ``torch.cuda._sleep(0)``) and the host time of
   each piece of ``ops/_build.Launcher``'s path.
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
   outputs of its own forward of the same q, k, v); SDPA's forward and
   backward with each backend forced (flash, efficient, cuDNN; "refused"
   where one does not take the inputs) at both shapes, and the backend
   its default picks. K1's multi-slot entry at device mode's shape (26
   tables, hash fused, bit-equal to its plain version, beside its bound
   and the old per-slot cost), and its single-table entry at device
   mode's shape and at the v5e shape of ``persia_tpu/ops/embedding_bag.py``
   beside ``F.embedding_bag``. Each wrapper's host time a call.
3. Serving phase: two PS shards hold rows for the whole sign space of the
   ``seqrec`` traffic; an ``InferenceServer`` on the card with
   micro-batching and the hot-row cache serves requests from 8 threads as
   PTB2 bytes through ``SequenceTower(attn_impl="flash")`` at the width of
   ``examples/seq_rec/train.py``. Every prediction must be finite and in
   (0, 1) and agree with a second server whose tower uses the dense
   reference attention; K2 must have launched.
4. Training phase, the sequence tower's synchronous path: ``TrainCtx``
   on the card trains ``SequenceTower(attn_impl="flash")`` at the
   example's widths over two fresh PS shards, each
   ``make_holder(2_000_000, 8)`` (the native C++ store; sparse Adagrad,
   dense Adam), for 300 steps of batch 256 of ``seqrec`` traffic, then
   ``eval_ctx`` scores 4096 held-out samples; the AUC must pass the
   example's own bar (0.62). The launch counters are zeroed just before
   the 300 steps and read just after: K2, K3 and K4 must each have
   launched. Before that, a flash tower and a reference tower train 3
   steps from the same weights and fresh PS rows in f32 and must agree.
   After it, the A/B of the PS holder: the first 45 steps again on the
   Python arena holder (``backend="arena"``) and the first 30 on the
   per-entry holder (``backend="python-legacy"``); each run prints
   samples/s, step p50/p99, host CPU by thread and the split synchronized
   after each stage, the arena its shard calls by path (batched, rounds,
   sequential), the native store its threads a call and SIMD path.
5. Pipelined phase, the sequence tower's pipelined path:
   ``DataLoader`` (4 lookup workers, embedding staleness 8, forward
   buffer 8: ``bench.py``'s ``bench_hybrid``) over the same 300 batches
   into a fresh ``TrainCtx`` on the native store; samples/s, step
   p50/p99, host CPU by thread, the training thread's split, a profiled
   window's device busy share, the
   AUC on the same 4096 held-out samples (bar 0.62), K2, K3 and K4
   launched (counters zeroed just before, read just after), and after
   the loop the pipeline at rest: worker staleness 0, every permit back,
   no lost update. Before that, 10 pipelined steps (reproducible,
   staleness 1) must agree with 10 synchronous steps from the same
   weights in f32, losses and PS rows. After it, the A/B: the first 50
   batches pipelined on the arena holder, with the same numbers and the
   pipeline at rest; a summary line gives every training run's samples/s
   and the pipelined / synchronous ratio of each holder.
6. The dense model zoo on the hybrid path, on the native PS, none of
   whose phases may launch K1-K5 (the towers read PS rows and have no
   attention):
   - ``dlrm_hybrid``: ``bench.py``'s ``bench_hybrid`` configuration
     (``DLRM(embedding_dim=16)`` over 26 slots of dim 16 and 13 dense
     features, 2 shards of ``make_holder(50_000_000, 16)``,
     ``OptaxAdagrad(0.02)`` dense, ``Adagrad(0.02)`` sparse, batch 4096
     of fresh uniform signs): 3 steps in f32 on the card must agree with
     the same 3 steps of the port on the CPU (loss, dense parameters and
     touched PS rows), 10 reproducible pipelined steps at staleness 1
     must equal 10 synchronous ones, then a synchronous and a pipelined
     run (4 workers, staleness 8, buffer 8) report samples/s, step
     p50/p99, host CPU by thread, the synchronized split, the busy share,
     the resident PS rows and the process RSS;
   - ``dlrm_cached``: ``bench.py``'s ``bench_cached`` configuration, the
     same stack with ``TrainCtx(device_cache_capacity=...)`` on batches
     of 4096 of ``make_zipf_batches`` (``zipf_bench_batches``: Zipf
     a=1.2 over 2^20 ids a slot): (a) the cached path against the
     uncached one on the card from the same weights and batches, f32
     tower and wire, 8 single-id steps through 65,536 rows and 3 bag
     steps (1-4 ids a bag, the last slot sqrt-scaled) through a cache a
     quarter above one batch's distinct signs: losses within 1e-4, every
     touched PS row after ``flush_device_cache`` within 1e-4 of the
     largest element, evictions and write-backs both > 0; (b) 75 steps
     through the 2,000,000-row cache with the bf16 tower (steps 10-59
     timed between two synchronizations, 60-69 split into prepare, h2d,
     the device step and finish, 70-74 profiled) beside the uncached
     synchronous path on the same batches: samples/s and their ratio,
     host ms a step p50/p99, the cache's counters, ``wire_bytes_saved``,
     the busy share, ``torch.cuda.max_memory_allocated``, host CPU by
     thread (the flush thread included); (c) ``lru`` against
     ``hotness`` admission at 131,072 rows over the first 30 batches:
     hit rate, promotions, samples/s;
   - ``zoo``: the registry's ``dlrm``, ``seqrec`` and ``multitask``
     scenarios at full size on ``bench.py``'s e2e stack, 200 steps at
     each bench batch: samples/s, the loss falling, the held-out AUC of
     each task at the scenario's bar;
   - ``adult_income``: ``DNN`` with its two batch norms at
     ``examples/adult_income/train.py``'s widths and optimizers, 300
     steps of batch 256 synchronous and pipelined: AUC above 0.70 on
     both, the running statistics moved from their init;
   - ``criteo_towers``: ``DCNv2``, ``DeepFM`` and ``WideAndDeep`` at the
     criteo example's widths and optimizers, 50 steps of batch 4096 of
     ``criteo_learnable_batches``: every loss finite, the last 10 steps'
     mean below the first 10's, eval predictions in (0, 1).
7. ``snapshot_resume``, the spill tier, the hotness sketches, job
   snapshots and ``TrainCtx(resume_from=)``:
   - seq_rec at the example's widths through K2-K4, on 2 ×
     ``make_holder(10_000, 8, spill_dir=..., hotness=True)`` (the 60
     batches touch 40,945 rows, about twice what the replicas keep
     resident; spill packets of 256 KiB, so rows reach the disk), batches
     from a ``ResumableDataset``: run A trains 60 steps straight; run B
     trains 30, ``ctx.snapshot(dir, cursor=ds.cursor(30))`` and is
     closed; a fresh stack (new holders and spill directories, a fresh
     tower and optimizer) built with ``TrainCtx(resume_from=dir)`` trains
     the other 30 from the cursor. Its losses, its dense state (model and
     optimizer) and its PS rows (resident and spilled, from a dump of
     each replica) must equal run A's bit for bit; both runs must spill
     to disk and fault back in, the hotness snapshots must be non-empty,
     and K2, K3 and K4 must launch once a step in every run (counters
     zeroed before each run, read after it). Run A again at the spill
     store's default 4 MiB packets (every spilled row stays staged in
     memory) must give the same losses. Printed: samples/s with the tier
     armed, at 256 KiB and at 4 MiB packets, against the same steps on
     the plain native holder at full capacity, ``spill_stats``, the snapshot's wall ms and bytes on
     disk, the restore ms (construction to the end of the first resumed
     step), the launches;
   - ``bench.py``'s ``_chaos_job_convergence_cell`` on the registry's
     ``dlrm`` scenario at full size: 120 steps of batch 2048 straight
     against 60, a snapshot and 60 resumed; the suffix losses and the
     dense parameters within 1e-5, the held-out AUC within 1e-6, and no
     kernel launched.
8. Device-mode phase, K1's main path, at ``bench.py``'s ``bench_device``
   configuration (26 hashed tables of 2^20 x 16 resident on the card,
   ``DLRM(embedding_dim=16)`` in bf16, ``OptaxAdagrad(0.02)``, batch
   4096): first a kernel tower and a plain tower train 3 steps from one
   weight set with an f32 tower and must agree, each table's change
   and the loss held to their own movement; then warm-up, timed
   loops (one synchronize at the end, or one per step; the repeated batch
   and 4 rotating fresh-id batches), a stage split and a profiled window.
   K1's counter is zeroed just before the timed steps and must read one
   per step (the collection pools its 26 slots in one call); every loss
   must be finite, the repeated batch's loss must fall below step 0's
   and an eval forward must give predictions in (0, 1).
9. Probe phase, K5's path: ``run_probe`` of
   ``python -m persia_tpu_torch.ops.probe_copy``, counters zeroed just
   before; every case (the TPU probe's four) must match. Each case's
   plain version, its library yardstick (``index_select``), K5's device
   time per launch and its host time a call are then timed beside its
   bound.
10. ``multi_rank`` (run right after the kernel phase, while the main
   process holds little of the card and the cores), data and context
   parallelism
   (``persia_tpu_torch.distributed``, ``parallel/mesh.py``,
   ``parallel/collectives.py``, the DDP step, ``parallel/ulysses.py``,
   ``parallel/ring_attention.py``): this script is started again as two
   ranks of a gloo world sharing the one card and as a world of one NCCL
   rank, all three once, before the kernel build, so that their start-up
   and warm-up (imports, the card, cuBLAS, the first optimizer, the
   collectives) overlap it; each then waits for its go file
   (``tests/test_torch_ranks.py``, under a deadline; a rank that fails
   fails the phase). gloo on one shared card is not the transport
   of a multi-card job: the phase shows that the paths run and agree,
   and claims no multi-card rate. On the two gloo ranks:
   - (a) ``dlrm_hybrid``'s configuration on ``TrainCtx(mesh=make_mesh((2,
     1)))``, the leader (rank 0) on the PS, global batch 4096, 16 steps
     of fresh signs in f32, bf16 and int8_ef reduction, against rank 0
     alone on the same batches: f32 within 2e-3, bf16 within 0.05 of
     f32, int8_ef's last 4 within 0.08 (the JAX test's gates), every
     loss finite, the two ranks' dense parameters bit-equal after each
     run; each run's dense-parameter change within 8 ulps + 5% of one
     rank's largest change (which must exceed twice that); the last
     reduced gradient made of bf16 values after bf16 and of at most 255
     values a 1024-bucket after int8_ef, and neither after f32;
     samples/s of each;
   - (b) device mode at ``bench_device``'s width (26 x 2^20 x 16) over
     the data axis with an f32 tower, 5 steps against rank 0 alone under
     device mode's agreement rule; K1 once a step on each rank; the two
     ranks' tables equal (a digest of their bits); step ms and peak
     memory;
   - (c) the seq_rec tower over ``make_mesh((1, 2))``: Ulysses with the
     flash kernels and the ring, 3 f32 ``TrainCtx`` steps against the
     single-rank flash tower from the same weights (the training phase's
     1e-4 / 1e-3), then 10 bf16 Ulysses steps in which K2, K3 and K4 each
     launch once a step on every rank; one Ulysses forward and backward
     at the attention bench's shape against K2-K4 on one rank (2e-2),
     each rank's ms.
   On the NCCL rank, once the gloo ranks are done: (d) f32 and int8_ef
   DDP steps of (a)'s model, which must take NCCL's all_reduce,
   all_to_all, all_gather and broadcast.
   Last, one line gives every wrapper's host time a call at its
   main-path shape beside the launch floor. A ``[time]`` line follows
   each phase.

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
# Also the pipelined run (reproducible, staleness 1) against the
# synchronous run in f32: the same operations in the same order, so equal
# unless a stream ordering across threads is wrong.
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
# the A/B runs carry no gate; their depth was cut (from 60 and 100) to pay
# for the multi_rank phase (PERF.md section 4)
AB_STEPS = 45  # synchronous steps on the arena PS holder (the A/B)
LEGACY_STEPS = 30  # synchronous steps on the per-entry PS holder
PIPE_AB_STEPS = 50  # pipelined steps on the arena PS holder
AB_KEY = f"synchronous arena, steps 10-{AB_STEPS * 2 // 3 - 1}"
PIPE_AB_KEY = f"pipelined arena, steps 10-{PIPE_AB_STEPS * 7 // 10 - 1}"
# the pipelined phase: bench.py's bench_hybrid and the criteo example
PIPE_WORKERS = 4
PIPE_STALENESS = 8
PIPE_BUFFER = 8
PIPE_AGREE_STEPS = 10
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

# training / dlrm_hybrid: bench.py's bench_hybrid configuration, not cut
# (26 slots of dim 16 over 2 x make_holder(50_000_000, 16), 13 dense,
# DLRM(embedding_dim=16), adagrad(0.02) dense and sparse, batch 4096);
# every step inserts ~26 x 4096 fresh PS rows, so the runs are short
DH_SLOTS = 26
DH_DIM = 16
DH_DENSE = 13
DH_BATCH = 4096
DH_LR = 0.02
DH_PS_CAPACITY = 50_000_000
DH_PS_SHARDS = 16
DH_STEPS = 75  # each run: [10, 60) timed, [60, 70) split, [70, 75) profiled
DH_AGREE_STEPS = 3
# DLRM on the card against the port on the CPU, f32 tower and wire, no
# TF32, 3 steps: the same math in another summation order (cuBLAS against
# the CPU's GEMM, ~1e-7 relative an operation) carried through three
# Adagrad steps, which move a weight by lr g / sqrt(s) and so carry the
# gradients' relative error; the loss absolute, each dense tensor and the
# touched PS rows relative to their largest element.
DH_LOSS_ATOL = 1e-4
DH_REL_TOL = 1e-4
# training / dlrm_cached: bench.py's bench_cached configuration, not cut
# in width (dlrm_hybrid's stack with a 2,000,000-row device cache, batch
# 4096 of make_zipf_batches: Zipf a=1.2 over 2^20 ids a slot)
DC_VOCAB = 1 << 20
DC_ZIPF_A = 1.2
DC_CAPACITY = 2_000_000
DC_STEPS = 75  # (b): [10, 60) timed, [60, 70) split, [70, 75) profiled
# (a) 8 single-id steps through 65,536 rows, ~1.9x the ~35,000 distinct
# signs of one batch, so rows evict and come back from step 2 on; 3 bag
# steps (1-4 ids a bag, the last slot sqrt-scaled) through a cache a
# quarter above one batch's distinct signs
DC_AGREE_STEPS = 8
DC_AGREE_CAPACITY = 65_536
DC_BAG_STEPS = 3
DC_BAG_IDS = (1, 4)
# cached against uncached on the card, f32 tower and wire, no TF32: the
# same Adagrad in another order (the cache dedup-sums a sign's gradients
# on the device with index_add_'s atomics, the worker on the host), ~1e-7
# relative an operation over 8 steps; DLRM's rule, the loss absolute and
# the touched PS rows relative to their largest element
DC_LOSS_ATOL = 1e-4
DC_REL_TOL = 1e-4
# (c) the two admission policies over the first 30 batches
DC_ADMIT_STEPS = 30
DC_ADMIT_CAPACITY = 131_072
# training / zoo: the registry's scenarios at full size on bench.py's e2e
# stack, at least 200 steps each (bench.py --mode e2e)
ZOO_STEPS = 200
ZOO_EVAL = 8192
# training / adult_income: examples/adult_income/train.py's widths and
# optimizers; the AUC bar of tests/test_e2e_local.py
AI_DIM = 8
AI_SEED = 42
AI_STEPS = 300
AI_BATCH = 256
AI_EVAL = 4096
AI_BAR = 0.70
# training / criteo_towers: examples/criteo/train.py's widths
CT_STEPS = 50
CT_BATCH = 4096
# snapshot_resume: seq_rec at the example's widths on spill-armed native
# holders. Run A trains 2 N steps straight; run B trains N, snapshots and
# is closed; a fresh stack resumes from the snapshot and trains N more.
# The 2 N batches touch 40,945 PS rows, ~20.5k a replica; a replica of
# SR_CAPACITY keeps under half of them resident.
SR_STEPS = 30  # N
SR_CAPACITY = 10_000
SR_SHARDS = 8
SR_TIMED_FROM = 10
# The example's whole sign space (50,564 signs, ~25k a replica at 128
# bytes a row) fits in one of the spill store's 4 MiB packets, so at the
# default no row would reach the disk at any capacity: runs A-C take
# 256 KiB packets, and fault-ins read rows back from packet files. Run D
# repeats run A at the default packet size, for the rate a user of
# make_holder gets.
SR_PACKET_BYTES = 256 << 10
# bench.py's _chaos_job_convergence_cell on the registry's dlrm scenario:
# 120 steps of its bench batch, resumed at 60, with bench.py's gates
DRILL_STEPS = 120
DRILL_EVAL = 2048
DRILL_ATOL = 1e-5  # suffix losses and dense parameters
DRILL_AUC_ATOL = 1e-6

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


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` in us: the host clock around ``calls``
    back-to-back calls with no synchronize among them (what a caller
    waits before it can enqueue its next op)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


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


def launch_path_phase(torch, card: str) -> dict:
    """The launch floor on this card and host: the device time of the
    smallest PyTorch kernel, ``torch.cuda._sleep(0)``, from the profiler,
    and its host time a call. Also holds the raw current stream that
    ``ops/_build.Launcher`` reads to ``torch.cuda.current_stream()``."""
    if torch._C._cuda_getCurrentRawStream(0) != torch.cuda.current_stream(
            0).cuda_stream:
        raise AssertionError("the raw current stream differs from "
                             "torch.cuda.current_stream().cuda_stream")
    floor_dev = kernel_device_ms(torch, lambda: torch.cuda._sleep(0),
                                 "spin_kernel", calls=200)
    floor_host = host_us(torch, lambda: torch.cuda._sleep(0), 2000)
    _log(f"[launch] launch floor: torch.cuda._sleep(0) device_ms_per_launch="
         f"{'not measured' if floor_dev is None else f'{floor_dev:.6f}'} "
         f"host_us_per_call={floor_host:.3f} | card: {card}")
    return {"floor_device_ms": floor_dev, "floor_host_us": floor_host}


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_backend_of(names) -> str:
    """The SDPA backend whose kernels a profiler trace names; MATH when
    the trace holds no fused attention kernel (the math path is plain
    matrix products and a softmax)."""
    text = " ".join(names).lower()
    for backend, marks in (("CUDNN_ATTENTION", ("cudnn",)),
                           ("EFFICIENT_ATTENTION", ("fmha", "efficient",
                                                    "mem_eff")),
                           ("FLASH_ATTENTION", ("flash",))):
        if any(m in text for m in marks):
            return backend
    return "MATH"


def sdpa_backends(torch, q, k, v, do, kv_mask, causal: bool, iters: int):
    """SDPA's forward and its backward alone (``autograd.grad`` of one
    retained forward) with each backend forced by ``sdpa_kernel``, and
    which backend the default picks (from the profiler's kernel names).
    Returns ({backend: (fwd_ms, bwd_ms) or "refused"}, default backend,
    its kernels). A yardstick only: the port never calls SDPA."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = None if kv_mask is None else kv_mask[:, None, None, :]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal)

    def fwd_grad():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                              is_causal=causal)

    out = {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                with torch.inference_mode():
                    f_ms = cuda_ms(torch, fwd, iters)
                o = fwd_grad()
                b_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                    o, (qg, kg, vg), do, retain_graph=True), iters)
                del o
            out[name] = (f_ms, b_ms)
        except RuntimeError as e:  # the backend does not take these inputs
            out[name] = "refused: " + str(e).splitlines()[0][:100]
    _, _, top = profile_window(torch, lambda: torch.autograd.grad(
        fwd_grad(), (qg, kg, vg), do))
    names = [n for _, n, _ in top]
    return out, sdpa_backend_of(names), names


def report_sdpa(tag: str, backends, default, names, card: str):
    parts = []
    for name, r in backends.items():
        parts.append(f"{name}: " + (r if isinstance(r, str) else
                                     f"fwd_ms={r[0]:.6f} bwd_ms={r[1]:.6f}"))
    _log(f"[kernel] {tag} sdpa backends: " + "; ".join(parts)
         + f"; the default picks {default} (kernels "
         + ", ".join(n[:60] for n in names[:3]) + f") | card: {card}")
    timed = [r for r in backends.values() if not isinstance(r, str)]
    return (min(r[0] for r in timed) if timed else None,
            min(r[1] for r in timed) if timed else None)


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
    model_backends = sdpa_backends(torch, q, k, v, do, kv_mask, False, 100)
    best_fwd, best_bwd = report_sdpa(f"model shape B={b} H={h} T={t} "
                                     f"Dh={dh} key mask", *model_backends,
                                     card)
    out_m, lse_m = fa.flash_attention_fwd(q, k, v, kv_mask, False,
                                          return_lse=True)
    _, delta_m = fa.flash_attention_bwd_dq(q, k, v, out_m, lse_m, do,
                                           kv_mask, False)
    host = {
        "flash_attention_fwd": host_us(torch, lambda: fa.flash_attention_fwd(
            q, k, v, kv_mask, False, return_lse=True)),
        "flash_attention_bwd_dq": host_us(
            torch, lambda: fa.flash_attention_bwd_dq(
                q, k, v, out_m, lse_m, do, kv_mask, False)),
        "flash_attention_bwd_dkv": host_us(
            torch, lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse_m, delta_m, kv_mask, False)),
    }
    del out_m, lse_m, delta_m
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
            # one PyTorch call computes the forward (SDPA's fastest
            # backend here); none computes dq or dk/dv alone: SDPA's
            # backward (dq, dk and dv together) is kept beside K3 and K4
            "library_ms": (min(lib_fwd, best_fwd or lib_fwd)
                           if name == "flash_attention_fwd" else None),
            "host_us_per_call": host[name],
            "sdpa_model_shape": {
                "backends": {n: r if isinstance(r, str) else
                             {"fwd_ms": r[0], "bwd_ms": r[1]}
                             for n, r in model_backends[0].items()},
                "default": model_backends[1],
                "fastest_bwd_ms": best_bwd},
        }
        _log(f"[kernel] {name} model shape B={b} H={h} T={t} Dh={dh} bf16 "
             f"kv_mask: max_abs_err={errs[name]:.3e} kernel_ms="
             f"{ms[name]:.6f} host_us_per_call={host[name]:.3f} bound_ms="
             f"{bounds[name][0]:.6f} ({bounds[name][1]}) plain_ms="
             f"{plain_ms[name]:.6f} | card: {card}")
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
    bench_backends = sdpa_backends(torch, q, k, v, do, None, True, 10)
    best_b_fwd, best_b_bwd = report_sdpa(f"bench shape B={b} H={h} T=8192 "
                                         f"Dh={dh} causal", *bench_backends,
                                         card)
    sdpa_bench = {
        "backends": {n: r if isinstance(r, str) else
                     {"fwd_ms": r[0], "bwd_ms": r[1]}
                     for n, r in bench_backends[0].items()},
        "default": bench_backends[1], "fastest_fwd_ms": best_b_fwd,
        "fastest_bwd_ms": best_b_bwd}
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
    _log(f"[kernel] bench shape T=8192: K3+K4 ms={min(k34_ms):.4f} against "
         f"the fastest SDPA backward alone ms="
         f"{'refused' if best_b_bwd is None else f'{best_b_bwd:.4f}'} "
         f"(default backend {bench_backends[1]}) | card: {card}")
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
            "bench_k3_plus_k4_ms": k34_ms,
            "bench_sdpa": sdpa_bench})
        _log(f"[kernel] {name} bench shape: {t_ms:.4f} ms over 10 launches, "
             f"{flops_b[name] / t_ms / 1e9:.1f} TFLOP/s, {bound / t_ms:.4f} "
             f"of its bound {bound:.4f} ms | card: {card}")
    k2 = ms_b["flash_attention_fwd"]
    k2_bound = bounds_b["flash_attention_fwd"][0]
    records["flash_attention_fwd"].update({
        "bench_shape": f"B={b} H={h} T=8192 Dh={dh} bf16 causal",
        "bench_ms": k2, "bench_serving_ms": serve_b,
        "bench_library_ms": min(lib_b_fwd, lib_b_fwd2,
                                best_b_fwd or lib_b_fwd),
        "bench_sdpa": sdpa_bench,
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


def slot_inputs(torch, gen):
    """Device mode's multi-slot call: ``DM_SLOTS`` (DM_VOCAB, DM_DIM) f32
    tables; the ids of the main path's batch, drawn by
    ``synthetic_device_batch`` with the main path's arguments (every id in
    [1, 2^31), one a slot, no padding); and, for the bit-equality check
    alone, a copy of them with about a quarter turned to padding (0, or -1
    in every 7th)."""
    from persia_tpu_torch.parallel.device_mode import (
        criteo_like_specs,
        synthetic_device_batch,
    )

    dev = torch.device("cuda")
    specs = criteo_like_specs(DM_SLOTS, DM_VOCAB, DM_DIM)
    tables = [torch.randn((vocab, dim), generator=gen, device=dev)
              for _, vocab, dim in specs]
    _, batch_ids, _ = synthetic_device_batch(DM_BATCH, DM_DENSE, specs,
                                             seed=SEED, device=dev)
    ids = [batch_ids[name] for name, _, _ in specs]
    padded = []
    for i in ids:
        i = i.clone()
        pad = torch.rand(i.shape, generator=gen, device=dev) < 0.25
        i[pad] = 0
        i.view(-1)[::7][pad.view(-1)[::7]] = -1
        padded.append(i)
    return tables, ids, padded


def sparse_kernel_phase(torch, card: str) -> dict:
    """K1's multi-slot entry at device mode's shape (26 tables of 2^20 x
    16, B = 4096, one id a slot: the main path's one call a step),
    bit-equal to its plain version, timed beside its bound and, for
    information, the old per-slot cost (26 x the hash ops and
    ``F.embedding_bag``: no one PyTorch call pools 26 tables); then the
    single-table entry at device mode's shape and at the v5e shape of
    persia_tpu/ops/embedding_bag.py:21, against its plain version and
    ``F.embedding_bag``. Returns K1's record (without launches)."""
    import torch.nn.functional as F

    from persia_tpu_torch.ops import embedding_bag as eb

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tables, ids, padded = slot_inputs(torch, gen)
    multi_err = 0.0
    # the main path's ids last: what follows times them, with their rows
    for tag, slot_ids in (("with padding", padded), ("main-path ids", ids)):
        got, rows = eb.embedding_bag_slots_fwd(tables, slot_ids)
        want, want_rows = eb.embedding_bag_slots_reference(tables, slot_ids)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not (torch.equal(got, want) and torch.equal(rows, want_rows)):
            raise AssertionError(
                f"K1 multi-slot, {tag}: not bit-equal to its plain version "
                f"at S=1 (max abs err {err}, rows equal "
                f"{torch.equal(rows, want_rows)})")
        multi_err = max(multi_err, err)

    def old_path():
        """The per-slot work the call replaces, with the library's bag."""
        for t, i in zip(tables, ids):
            mask = i > 0
            hashed = ((i % (DM_VOCAB - 1)) + 1).to(torch.int32) * mask
            F.embedding_bag(hashed, t, per_sample_weights=mask.float(),
                            mode="sum").to(torch.bfloat16)

    ms = cuda_ms(torch, lambda: eb.embedding_bag_slots_fwd(tables, ids), 200)
    plain = cuda_ms(torch, lambda: eb.embedding_bag_slots_reference(
        tables, ids), 50)
    old_ms = cuda_ms(torch, old_path, 50)
    ms_again = cuda_ms(torch, lambda: eb.embedding_bag_slots_fwd(tables, ids),
                       200)
    host = host_us(torch, lambda: eb.embedding_bag_slots_fwd(tables, ids))
    dev_ms = kernel_device_ms(torch, lambda: eb.embedding_bag_slots_fwd(
        tables, ids), "bag_kernel")
    # each slot's distinct rows read once, the ids read, the int32 rows and
    # the bf16 output written
    distinct = sum(int(torch.unique(r).numel()) for r in
                   eb.slot_rows(rows, DM_BATCH, [1] * DM_SLOTS))
    bound = bound_ms(distinct * 4 * DM_DIM + DM_SLOTS * DM_BATCH * (4 + 4)
                     + DM_SLOTS * DM_BATCH * DM_DIM * 2,
                     2.0 * DM_SLOTS * DM_BATCH * DM_DIM, PEAK_F32_FLOPS)
    share = "not measured" if dev_ms is None else f"{bound[0] / dev_ms:.4f}"
    _log(f"[kernel] embedding_bag multi-slot device-mode shape {DM_SLOTS} x "
         f"V={DM_VOCAB} D={DM_DIM} B={DM_BATCH} S=1, hash fused, bf16 out, "
         f"the main path's ids (synthetic_device_batch, seed {SEED}): "
         f"bit-equal (outputs and rows; also with ~25% padding) "
         f"kernel_ms={ms:.6f} (again "
         f"{ms_again:.6f}) host_us_per_call={host:.3f} device_ms_per_launch="
         f"{'not measured' if dev_ms is None else f'{dev_ms:.6f}'} "
         f"bound_ms={bound[0]:.6f} ({bound[1]}, {distinct} distinct rows) "
         f"share_of_bound={share} plain_ms={plain:.6f}; no one PyTorch call "
         f"pools 26 tables (library_ms null); the old per-slot path, 26 x "
         f"(hash ops + F.embedding_bag), ms={old_ms:.6f} | card: {card}")
    src, replaces = KERNEL_INFO["embedding_bag"]
    record = {
        "name": "embedding_bag", "route": "cuda", "source": src,
        "replaces": replaces, "launches": None, "max_abs_err": multi_err,
        "ms": min(ms, ms_again), "plain_ms": plain, "bound_ms": bound[0],
        "bound_by": bound[1], "library_ms": None,
        "shape": f"{DM_SLOTS} slots x V={DM_VOCAB} D={DM_DIM} B={DM_BATCH} "
                 f"S=1 (one call)",
        "device_ms_per_launch": dev_ms, "host_us_per_call": host,
        "old_per_slot_path_ms": old_ms}
    del tables, ids, padded, got, want, rows, want_rows
    torch.cuda.empty_cache()

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
        # kernel, library, library, kernel: the two compared in turns
        ms = [cuda_ms(torch, lambda: eb.embedding_bag_fwd(table, ids,
                                                          weights), 200)]
        lib = [cuda_ms(torch, lambda: F.embedding_bag(
            clipped, table, per_sample_weights=weights, mode="sum"), 200)
            for _ in range(2)]
        ms.append(cuda_ms(torch, lambda: eb.embedding_bag_fwd(
            table, ids, weights), 200))
        plain = cuda_ms(torch, lambda: eb.embedding_bag_reference(
            table, ids, weights), 200)
        host = host_us(torch, lambda: eb.embedding_bag_fwd(table, ids,
                                                           weights))
        dev_ms = kernel_device_ms(torch, lambda: eb.embedding_bag_fwd(
            table, ids, weights), "bag_kernel")
        # the rows this run's ids read once each, the ids and weights, and
        # the output; 2 FLOP per element of a gathered row on the f32 cores
        distinct = int(torch.unique(clipped).numel())
        bound = bound_ms(distinct * 4 * dim + batch * bag * 8
                         + 4 * batch * dim, 2.0 * batch * bag * dim,
                         PEAK_F32_FLOPS)
        share = ("not measured" if dev_ms is None
                 else f"{bound[0] / dev_ms:.4f}")
        _log(f"[kernel] embedding_bag single-table {tag} shape V={vocab} "
             f"D={dim} B={batch} S={bag}: max_abs_err={err:.3e}"
             f"{' (bit-equal)' if bag == 1 else ''} kernel_ms={ms[0]:.6f} / "
             f"{ms[1]:.6f} host_us_per_call={host:.3f} device_ms_per_launch="
             f"{'not measured' if dev_ms is None else f'{dev_ms:.6f}'} "
             f"bound_ms={bound[0]:.6f} ({bound[1]}, {distinct} distinct "
             f"rows) share_of_bound={share} plain_ms={plain:.6f} library "
             f"F.embedding_bag ms={lib[0]:.6f} / {lib[1]:.6f} (kernel / "
             f"library = {min(ms) / min(lib):.3f}) | card: {card}")
        record[f"single_table_{tag}"] = {
            "shape": f"V={vocab} D={dim} B={batch} S={bag}", "ms": min(ms),
            "host_us_per_call": host, "device_ms_per_launch": dev_ms,
            "bound_ms": bound[0], "plain_ms": plain, "library_ms": min(lib),
            "max_abs_err": err}
        record["max_abs_err"] = max(record["max_abs_err"], err)
        del table, ids, weights, got, want, clipped
    return {"embedding_bag": record}


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
        # both host-bound calls of ~20 us on a shared host: kernel (the
        # probe's own timing) and library in turns, three rounds, each at
        # its best
        kernel, lib = [r["us_per_call"] / 1e3], []
        for _ in range(3):
            lib.append(cuda_ms(torch, library, 200))
            kernel.append(cuda_ms(torch, lambda: pc.probe_copy(src_t, idx),
                                  200))
        r["ms"], r["library_ms"] = min(kernel), min(lib)
        r["plain_ms"] = cuda_ms(torch, lambda: pc.probe_copy_reference(
            src_t, idx), 200)
        dev_ms = kernel_device_ms(torch, lambda: pc.probe_copy(src_t, idx),
                                  "probe_copy_kernel")
        r["host_us"] = host_us(torch, lambda: pc.probe_copy(src_t, idx))
        r["device_ms"] = dev_ms
        # the row, the index and the floats written
        r["bound"] = bound_ms(r["row_bytes"] + 4 + 4 * want.numel(), 0.0)
        _log(f"[probe] case {r['name']} row_bytes={r['row_bytes']}: equal "
             f"to plain, kernel_ms={r['ms']:.6f} device_ms_per_launch="
             f"{'not measured' if dev_ms is None else f'{dev_ms:.6f}'} "
             f"host_us_per_call={r['host_us']:.3f} "
             f"bound_ms={r['bound'][0]:.8f} ({r['bound'][1]}) plain_ms="
             f"{r['plain_ms']:.6f} library index_select ms="
             f"{r['library_ms']:.6f} (kernel / library = "
             f"{r['ms'] / r['library_ms']:.3f}) | card: {card}")
    _log(f"[probe] K5 launches on the probe's path: {launches} | card: "
         f"{card}")
    d = results[-1]  # case D, a 4096-byte row
    src, replaces = KERNEL_INFO["probe_copy"]
    return {"name": "probe_copy", "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": 0.0,
            "ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound"][0], "bound_by": d["bound"][1],
            "library_ms": d["library_ms"], "host_us_per_call": d["host_us"],
            "device_ms_per_launch": d["device_ms"],
            "cases": {r["name"]: {"ms": r["ms"], "library_ms": r["library_ms"],
                                  "device_ms_per_launch": r["device_ms"],
                                  "host_us_per_call": r["host_us"]}
                      for r in results}}


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


def fresh_worker(schema, backend=None):
    """A worker over ``N_PS`` empty PS shards, each
    ``make_holder(2_000_000, 8)`` as the example builds them (the native
    C++ store); ``backend="arena"`` gives the Python arena holder,
    ``"python-legacy"`` the per-entry holder."""
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    return EmbeddingWorker(
        schema, [make_holder(2_000_000, 8, backend=backend)
                 for _ in range(N_PS)])


def ps_paths(worker) -> str:
    """The arena holders' shard calls by path, summed over the PS."""
    from persia_tpu_torch.ps.arena import PATHS

    stats = [h.arena_stats() for h in worker.ps_clients]
    return " ".join(f"{k}={sum(int(st[k]) for st in stats)}" for k in PATHS)


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
                compute_dtype=None, mesh=None, context_parallel="ring"):
    """The SequenceTower on the card, with seeded weights or a copy of
    ``state_dict``; context-parallel over ``mesh``'s model axis."""
    import torch

    from persia_tpu_torch.models import SequenceTower
    from persia_tpu_torch.weights import init_params

    # the batch's feature order: 2 profiles, history (raw), clicks, target
    slots = [(DIM, False), (DIM, False), (DIM, True), (DIM, False),
             (DIM, False)]
    model = SequenceTower(num_dense, slots, mlp=MLP, num_heads=HEADS,
                          attn_impl=attn_impl, device="cuda",
                          compute_dtype=compute_dtype or torch.bfloat16,
                          mesh=mesh, context_parallel=context_parallel)
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


def thread_cpu_s() -> dict:
    """CPU seconds (user + system, from /proc) of this process's threads
    so far, by group: each Python thread by its name without the worker
    number, every other thread (the intra-op pool, CUDA's and autograd's
    threads) as "other"."""
    tick = os.sysconf("SC_CLK_TCK")
    named = {t.native_id: re.sub(r"[-_]\d+$", "", t.name)
             for t in threading.enumerate()}
    out: dict = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except FileNotFoundError:  # the thread ended meanwhile
            continue
        group = named.get(int(tid), "other")
        out[group] = out.get(group, 0.0) + (
            int(fields[11]) + int(fields[12])) / tick
    return out


def cpu_by_thread(before: dict, after: dict, steps: int) -> str:
    """Host CPU ms a step between two ``thread_cpu_s`` readings, by
    group (threads that ended in between count from ``after`` alone)."""
    return " ".join(
        f"{g}={max(0.0, after[g] - before.get(g, 0.0)) / steps * 1e3:.1f}"
        for g in sorted(after))


def report_steps(phase: str, what: str, steps_ms, card: str,
                 batch: int = TRAIN_BATCH):
    import numpy as np

    _log(f"[{phase}] {what}: {len(steps_ms)} steady steps of batch "
         f"{batch}: samples_per_s="
         f"{batch / (steps_ms.mean() / 1e3):.1f} "
         f"step_p50_ms={np.percentile(steps_ms, 50):.3f} "
         f"step_p99_ms={np.percentile(steps_ms, 99):.3f} | card: {card}")


def report_split(phase: str, what: str, steps, split_s, stages, card: str):
    _log(f"[{phase}] {what}: step split over steps {steps.start}-"
         f"{steps.stop - 1}, device synchronized after each stage (ms per "
         "step): " + " ".join(f"{k}={split_s[k] / len(steps) * 1e3:.3f}"
                              for k in stages) + f" | card: {card}")


def holder_ab(torch, card: str, spec, batches, backend: str, what: str):
    """The A/B of the PS holder: the first steps again, synchronous, on
    ``make_holder(..., backend=backend)`` from the same seeded weights:
    steps 10 to two thirds timed (with host CPU by thread), the rest
    synchronized after each stage. Returns the worker and its samples/s
    over the timed steps."""
    import numpy as np

    from persia_tpu_torch.ctx import STAGES

    ctx = train_ctx(torch, build_schema(),
                    build_tower(spec.num_dense, "flash"), backend=backend)
    split = range(len(batches) * 2 // 3, len(batches))
    step_s = []
    with ctx:
        for step, batch in enumerate(batches):
            if step == 10:
                cpu0 = thread_cpu_s()
            if step == split.start:
                cpu = cpu_by_thread(cpu0, thread_cpu_s(), split.start - 10)
                ctx.sync_stages = True
                ctx.stage_seconds = dict.fromkeys(STAGES, 0.0)
            t = time.perf_counter()
            loss, _ = ctx.train_step(batch)
            step_s.append(time.perf_counter() - t)
            if not np.isfinite(float(loss)):
                raise AssertionError(f"{what} step {step}: non-finite loss")
    steps_ms = np.asarray(step_s[10:split.start]) * 1e3
    report_steps("training", f"{what}, steps 10-{split.start - 1}",
                 steps_ms, card)
    _log(f"[training] {what}: host CPU ms a step over steps 10-"
         f"{split.start - 1}, by thread: {cpu} | card: {card}")
    report_split("training", what, split, ctx.stage_seconds, STAGES, card)
    ctx.worker.close()
    return ctx.worker, TRAIN_BATCH / (steps_ms.mean() / 1e3)


def holder_info(worker) -> str:
    """The native store's threads for one call and SIMD path, beside the
    host's cores: the fan-out, lookup and backward threads all share
    them."""
    h = worker.ps_clients[0]
    return (f"os.cpu_count()={os.cpu_count()} {type(h).__name__} "
            f"parallel_info={h.parallel_info()} simd_path={h.simd_path} "
            f"fan-out threads="
            f"{worker._fanout._max_workers if worker._fanout else 0}")


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


# samples/s of each training run in this call, for the summary line
RATES = {}


def train_ctx(torch, schema, model, global_config=None, backend=None,
              mesh=None):
    """The seq_rec example's stack (Adam(1e-3), Adagrad(1e-2), rows from
    U(-0.05, 0.05), 2 fresh shards of make_holder(2_000_000, 8) of
    ``backend``), the tower's weights as they are."""
    return hybrid_ctx(torch, model, schema, [(2_000_000, 8)] * N_PS,
                      lambda p: torch.optim.Adam(p, lr=1e-3), 1e-2,
                      (-0.05, 0.05), global_config, seed=None,
                      backend=backend, mesh=mesh)


def hybrid_ctx(torch, model, schema, holders, dense_optimizer, sparse_lr,
               emb_init, global_config=None, loss_fn=None, seed=SEED,
               backend=None, spill_root=None, hotness=None,
               resume_from=None, mesh=None, grad_reduce_dtype=None,
               device_cache_capacity=0, device_cache_admission=None):
    """A TrainCtx on the model's device over a fresh worker whose PS
    shards are ``make_holder(capacity, shards, backend=backend)`` for each
    ``(capacity, shards)`` of ``holders``; the tower seeded unless
    ``seed`` is None. ``spill_root`` arms each shard's spill tier in
    ``<spill_root>/spill_<i>``, ``hotness`` its sketches; ``resume_from``
    and the device cache's arguments go to the TrainCtx. Over a ``mesh``
    only its leader builds the worker."""
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.parallel.mesh import is_leader
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    worker = None
    if mesh is None or is_leader(mesh):
        worker = EmbeddingWorker(schema, [
            make_holder(c, n, backend=backend, hotness=hotness,
                        spill_dir=(os.path.join(spill_root, f"spill_{i}")
                                   if spill_root else None))
            for i, (c, n) in enumerate(holders)])
    return TrainCtx(model, dense_optimizer(model.parameters()),
                    Adagrad(lr=sparse_lr), schema, worker,
                    embedding_config=EmbeddingConfig(emb_init),
                    global_config=global_config, loss_fn=loss_fn, seed=seed,
                    device=next(model.parameters()).device,
                    resume_from=resume_from, mesh=mesh,
                    grad_reduce_dtype=grad_reduce_dtype,
                    device_cache_capacity=device_cache_capacity,
                    device_cache_admission=device_cache_admission)


def run_errors(run, ref):
    """The worst (loss, prediction, embedding-gradient) disagreement of a
    training run against a reference run over the same batches: absolute
    for the first two, relative to each gradient's largest for the third
    (as ``training_agreement`` holds the flash tower)."""
    import numpy as np

    worst = [0.0, 0.0, 0.0]
    for (loss, pred), (rloss, rpred), g, rg in zip(run[0], ref[0], run[1],
                                                   ref[1]):
        if not (np.isfinite(loss) and np.isfinite(pred).all()):
            raise AssertionError("a training step is not finite")
        worst[0] = max(worst[0], abs(loss - rloss))
        worst[1] = max(worst[1], float(np.abs(pred - rpred).max()))
        for name in rg:
            scale = float(np.abs(rg[name]).max())
            err = float(np.abs(g[name] - rg[name]).max())
            worst[2] = max(worst[2], err / max(scale, 1e-30))
    return worst


def seq_run(ctx, batches):
    """Train ``batches``: [(loss, pred)] and, on the leader, the shipped
    embedding gradients of each step."""
    import numpy as np

    grads = []
    if ctx.worker is not None:
        inner = ctx.worker.update_gradients

        def record(ref_id, g, inner=inner):
            grads.append({k: np.array(v) for k, v in g.items()})
            return inner(ref_id, g)

        ctx.worker.update_gradients = record
    out = []
    with ctx:
        for b in batches:
            loss, pred = ctx.train_step(b)
            out.append((float(loss), pred.float().cpu().numpy()))
    if ctx.worker is not None:
        ctx.worker.close()
    return out, grads


def training_agreement(torch, card: str, spec):
    """A flash tower and a reference tower, from the same weights and
    fresh PS rows, train 3 steps in f32 (f32 wire, no TF32) and must
    agree on loss, predictions and each slot's embedding gradients."""
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
    batches = list(seqrec_batches(3 * TRAIN_BATCH, TRAIN_BATCH,
                                  seed=TRAIN_SEED, spec=spec))
    runs = [seq_run(train_ctx(torch, schema, model,
                              GlobalConfig(CommonConfig("f32"))), batches)
            for model in (flash, ref)]
    worst = run_errors(*runs)
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
            if step == 10:
                cpu0 = thread_cpu_s()
            if step == split.start:
                cpu_split = cpu_by_thread(cpu0, thread_cpu_s(),
                                          split.start - 10)
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
    report_steps("training", "native PS", steady, card)
    RATES["synchronous native"] = TRAIN_BATCH / (steady.mean() / 1e3)
    _log(f"[training] native PS: host CPU ms a step over the steady steps, "
         f"by thread: {cpu_split} | card: {card}")
    _log(f"[training] native PS: {holder_info(ctx.worker)} | card: {card}")
    # the same steps the A/B runs below time
    for end in (AB_STEPS, LEGACY_STEPS):
        steps_ms = np.asarray(step_s[10:end * 2 // 3]) * 1e3
        report_steps("training", f"native PS, steps 10-{end * 2 // 3 - 1}",
                     steps_ms, card)
        RATES[f"synchronous native, steps 10-{end * 2 // 3 - 1}"] = \
            TRAIN_BATCH / (steps_ms.mean() / 1e3)
    report_split("training", "native PS", split, split_s, STAGES, card)
    ctx.worker.close()
    arena, RATES[AB_KEY] = holder_ab(
        torch, card, spec, batches[:AB_STEPS], "arena", "arena PS")
    _log(f"[training] arena PS shard calls by path over {AB_STEPS} steps: "
         f"{ps_paths(arena)} | card: {card}")
    _, RATES[f"synchronous per-entry, steps 10-{LEGACY_STEPS * 2 // 3 - 1}"
             ] = holder_ab(
        torch, card, spec, batches[:LEGACY_STEPS], "python-legacy",
        "per-entry PS")
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


def ps_rows(worker):
    """Every PS row of the worker's shards: (shard, sign) -> f32
    [emb|state], read back from each holder's PSD file."""
    import tempfile

    from persia_tpu_torch.ps.store import iter_psd_records, read_psd_header

    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for r, h in enumerate(worker.ps_clients):
            path = os.path.join(tmp, f"{r}.psd")
            h.dump_file(path)
            with open(path, "rb") as f:
                version, count = read_psd_header(f)
                for sign, _dim, vec in iter_psd_records(f.read, version,
                                                        count):
                    rows[(r, sign)] = vec
    return rows


def pipelined_loader(batches, reproducible=False, staleness=PIPE_STALENESS):
    from persia_tpu_torch.data.dataloader import DataLoader, IterableDataset

    return DataLoader(IterableDataset(iter(batches)), num_workers=PIPE_WORKERS,
                      reproducible=reproducible,
                      embedding_staleness=staleness,
                      forward_buffer_size=PIPE_BUFFER)


def pipelined_agreement(torch, card: str, spec):
    """``PIPE_AGREE_STEPS`` pipelined steps (reproducible, staleness 1)
    against as many synchronous steps from the same weights and fresh PS
    rows, f32 tower, f32 wire, no TF32: the prefetch threads' copies and
    the backward threads' downloads must be ordered with the training
    thread's kernels, so losses and PS rows agree."""
    import numpy as np

    from persia_tpu_torch.config import CommonConfig, GlobalConfig
    from persia_tpu_torch.workloads.generator import seqrec_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    schema = build_schema()
    batches = list(seqrec_batches(PIPE_AGREE_STEPS * TRAIN_BATCH,
                                  TRAIN_BATCH, seed=TRAIN_SEED, spec=spec))
    first = build_tower(spec.num_dense, "flash", compute_dtype=torch.float32)
    second = build_tower(spec.num_dense, "flash",
                         state_dict=first.state_dict(),
                         compute_dtype=torch.float32)
    wire = GlobalConfig(CommonConfig("f32"))
    sync_ctx = train_ctx(torch, schema, first, wire)
    with sync_ctx:
        sync = [float(sync_ctx.train_step(b)[0]) for b in batches]
    pipe_ctx = train_ctx(torch, schema, second, wire)
    loader = pipelined_loader(batches, reproducible=True, staleness=1)
    with pipe_ctx:
        pipe = [float(pipe_ctx.train_step(lb)[0]) for lb in loader]
    loader._engine.shutdown()
    if len(pipe) != len(sync):
        raise AssertionError(f"pipelined run took {len(pipe)} steps, not "
                             f"{len(sync)}")
    loss_err = max(abs(a - b) for a, b in zip(sync, pipe))
    want, got = ps_rows(sync_ctx.worker), ps_rows(pipe_ctx.worker)
    if set(want) != set(got):
        raise AssertionError("pipelined and synchronous runs hold "
                             "different PS rows")
    row_err = max(float(np.abs(want[k] - got[k]).max()) for k in want)
    _log(f"[pipelined] reproducible (staleness 1, {PIPE_WORKERS} workers) "
         f"vs synchronous, {len(sync)} steps f32: loss max_abs_err="
         f"{loss_err:.3e} PS rows ({len(want)}) max_abs_err={row_err:.3e} "
         f"(atol {TRAIN_ATOL}) | card: {card}")
    if not (loss_err <= TRAIN_ATOL and row_err <= TRAIN_ATOL):
        raise AssertionError("pipelined and synchronous runs disagree")


def pipelined_steps(torch, ctx, loader, n_steps: int, timed, split,
                    prof=None) -> dict:
    """``n_steps`` training steps of ``ctx`` on ``loader``'s batches:
    ``timed`` on the host clock, synchronized at both ends (with host
    CPU by thread), ``split`` synchronized after each stage, ``prof``
    under the profiler. Then the iteration ends (the loader flushes the
    updates) and the pipeline must be at rest. Call inside ``with ctx``.
    Returns the measurements."""
    import numpy as np

    from persia_tpu_torch.ctx import STAGES

    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    step_ms, wait_ms, losses, host_allocs = [], [], {}, []
    all_losses = []  # every step's loss, on the device until the end
    out = {"window": None}
    it = iter(loader)
    for step in range(n_steps):
        if step == timed.start:
            torch.cuda.synchronize()
            if host_stats is not None:
                host_allocs.append(host_stats().get("num_host_alloc"))
            t_steady = time.perf_counter()
            cpu0 = thread_cpu_s()
        if step == split.start:
            torch.cuda.synchronize()
            out["steady_wall"] = time.perf_counter() - t_steady
            out["cpu"] = cpu_by_thread(cpu0, thread_cpu_s(), len(timed))
            ctx.sync_stages = True
            ctx.stage_seconds = dict.fromkeys(STAGES, 0.0)
            split_wait = 0.0
        if prof is not None and step == prof.start:
            out["split_s"] = dict(ctx.stage_seconds)
            ctx.sync_stages = False
            out["window"] = profile_window(torch, lambda: [
                all_losses.append(ctx.train_step(next(it))[0])
                for _ in prof])
        if prof is not None and step in prof:
            continue
        t0 = time.perf_counter()
        lb = next(it)
        t1 = time.perf_counter()
        loss, pred = ctx.train_step(lb)
        t2 = time.perf_counter()
        all_losses.append(loss)
        if step in timed:
            step_ms.append((t2 - t0) * 1e3)
            wait_ms.append((t1 - t0) * 1e3)
        if step in split:
            split_wait += t1 - t0
        if step % 50 == 0:
            losses[step] = float(loss)
            if not (np.isfinite(losses[step])
                    and bool(torch.isfinite(pred).all())):
                raise AssertionError(f"step {step}: non-finite output")
    if "split_s" not in out:
        out["split_s"] = dict(ctx.stage_seconds)
        ctx.sync_stages = False
    out["split_s"]["wait"] = split_wait
    for _ in it:  # ends the iteration: the loader flushes the updates
        raise AssertionError("the loader yielded more batches than steps")
    torch.cuda.synchronize()
    if host_stats is not None:
        host_allocs.append(host_stats().get("num_host_alloc"))
    if not bool(torch.isfinite(torch.stack(all_losses)).all()):
        raise AssertionError("a pipelined step's loss is not finite")
    engine = loader._engine
    at_rest = (ctx.worker.staleness, engine.staleness_sem._value,
               engine.backward.lost_updates)
    engine.shutdown()
    if at_rest != (0, PIPE_STALENESS, 0):
        raise AssertionError(f"the pipeline is not at rest after the loop: "
                             f"(staleness, free permits, lost updates) = "
                             f"{at_rest}")
    out.update(step_ms=np.asarray(step_ms), wait_ms=np.asarray(wait_ms),
               losses=losses, host_allocs=host_allocs, at_rest=at_rest)
    return out


def report_pipelined(what: str, run: dict, split, card: str,
                     batch: int = TRAIN_BATCH, phase: str = "pipelined"):
    import numpy as np

    from persia_tpu_torch.ctx import STAGES

    steps = run["step_ms"]
    rate = batch * len(steps) / run["steady_wall"]
    _log(f"[{phase}] {what}: {len(steps)} steady steps of batch "
         f"{batch} in {run['steady_wall']:.3f}s (synchronized at both "
         f"ends): samples_per_s={rate:.1f} "
         f"step_p50_ms={np.percentile(steps, 50):.3f} "
         f"step_p99_ms={np.percentile(steps, 99):.3f} "
         f"wait_for_batch_mean_ms={np.mean(run['wait_ms']):.3f} "
         f"wait_for_batch_p99_ms={np.percentile(run['wait_ms'], 99):.3f} | "
         f"card: {card}")
    _log(f"[{phase}] {what}: host CPU ms a step over the steady steps, "
         f"by thread: {run['cpu']} | card: {card}")
    report_split(phase, f"{what}: training thread (lookup and h2d ran "
                 "in the prefetch workers, d2h and the PS update in the "
                 "backward workers; update = the hand-over)", split,
                 run["split_s"], ("wait",) + STAGES, card)
    _log(f"[{phase}] {what}: at rest after the loop: worker staleness="
         f"{run['at_rest'][0]} free permits={run['at_rest'][1]}/"
         f"{PIPE_STALENESS} lost_updates={run['at_rest'][2]} | card: {card}")
    return rate


def pipelined_phase(torch, card: str) -> dict:
    """The pipelined main path: ``DataLoader`` (4 lookup workers,
    staleness 8, buffer 8) over the training phase's 300 batches into a
    fresh ``TrainCtx`` on the native PS; the AUC, the launches, and the
    pipeline back at rest. Then the A/B: the first ``PIPE_AB_STEPS`` of
    them on the arena PS. Returns the main run's launches of each
    kernel."""
    import numpy as np

    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.utils import roc_auc
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    pipelined_agreement(torch, card, spec)

    schema = build_schema()
    model = build_tower(spec.num_dense, "flash")
    ctx = train_ctx(torch, schema, model)
    batches = list(seqrec_batches(TRAIN_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                                  seed=TRAIN_SEED, spec=spec))
    # as the training phase: [10, 250) timed, [250, 270) synchronized
    # after each stage, [270, 275) under the profiler
    timed, split, prof = range(10, 250), range(250, 270), range(270, 275)
    with ctx:
        fa.reset_launch_count()
        run = pipelined_steps(torch, ctx, pipelined_loader(batches),
                              TRAIN_STEPS, timed, split, prof)
        launches = {n: fa.launch_count(n) for n in FLASH_KERNELS}

        preds, labels = [], []
        with eval_ctx(ctx) as ectx:
            for b in seqrec_batches(EVAL_SAMPLES, TRAIN_BATCH,
                                    seed=TRAIN_SEED + 1000, spec=spec,
                                    requires_grad=False):
                pred, lab = ectx.forward(b)
                preds.append(pred.float().cpu().numpy().reshape(-1))
                labels.append(lab[0].numpy().reshape(-1))
    ctx.worker.close()
    preds = np.concatenate(preds)
    if not np.isfinite(preds).all():
        raise AssertionError("non-finite eval predictions")
    auc = roc_auc(np.concatenate(labels), preds)

    what = (f"native PS, {PIPE_WORKERS} lookup workers, staleness "
            f"{PIPE_STALENESS}, buffer {PIPE_BUFFER}")
    RATES["pipelined native"] = report_pipelined(what, run, split, card)
    host_allocs = run["host_allocs"]
    _log("[pipelined] cudaHostAlloc calls (caching host allocator) after "
         "the warm-up / at the end: "
         + ("not measured (no torch.cuda.host_memory_stats)"
            if not host_allocs else f"{host_allocs[0]} / {host_allocs[1]}")
         + f" | card: {card}")
    _log("[pipelined] loss " + " ".join(
        f"step{s}={v:.4f}" for s, v in sorted(run["losses"].items()))
        + f" | card: {card}")
    _log(f"[pipelined] launches in {TRAIN_STEPS} steps: " + " ".join(
        f"{n}={c}" for n, c in launches.items()) + f" | card: {card}")
    _log(f"[pipelined] test AUC on {EVAL_SAMPLES} held-out samples: "
         f"{auc:.4f} (bar {AUC_BAR}) | card: {card}")
    report_window("pipelined", f"{len(prof)} steps", run["window"], card)
    if any(c <= 0 for c in launches.values()):
        raise AssertionError(f"a kernel of the pipelined path never "
                             f"launched: {launches}")
    if not auc > AUC_BAR:
        raise AssertionError(f"test AUC {auc:.4f} is not above {AUC_BAR}")

    # the A/B on the arena PS: [10, 35) timed, [35, 50) synchronized
    ab_timed = range(10, PIPE_AB_STEPS * 7 // 10)
    ab_split = range(ab_timed.stop, PIPE_AB_STEPS)
    ctx = train_ctx(torch, schema, build_tower(spec.num_dense, "flash"),
                    backend="arena")
    with ctx:
        run = pipelined_steps(torch, ctx,
                              pipelined_loader(batches[:PIPE_AB_STEPS]),
                              PIPE_AB_STEPS, ab_timed, ab_split)
    ctx.worker.close()
    RATES[PIPE_AB_KEY] = report_pipelined(
        "arena PS", run, ab_split, card)
    _log(f"[pipelined] arena PS shard calls by path: {ps_paths(ctx.worker)}"
         f" | card: {card}")
    return launches


# --- the dense model zoo on the hybrid path --------------------------------


def reset_launch_counts():
    """Every kernel's launch count (K1-K5) set to 0, just before a path
    that must launch none of them."""
    from persia_tpu_torch.ops import embedding_bag as eb
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.ops import probe_copy as pc

    for module in (eb, fa, pc):
        module.reset_launch_count()


def assert_no_kernel_launched(phase: str, card: str):
    """Read just after the path: the hybrid towers read PS rows and have
    no attention, so none of K1-K5 may have launched."""
    from persia_tpu_torch.ops import embedding_bag as eb
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.ops import probe_copy as pc

    counts = {n: fa.launch_count(n) for n in FLASH_KERNELS}
    counts.update(embedding_bag=eb.launch_count(),
                  probe_copy=pc.launch_count())
    _log(f"[{phase}] kernel launches over the phase: " + " ".join(
        f"{n}={c}" for n, c in counts.items()) + f" | card: {card}")
    if any(counts.values()):
        raise AssertionError(f"{phase}: a kernel launched on a path that "
                             f"runs none: {counts}")
    return counts


def rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def dh_schema(sqrt_scaled=()):
    """bench_hybrid's 26 summed slots of dim 16; the slots numbered in
    ``sqrt_scaled`` take sqrt scaling."""
    from persia_tpu_torch.config import EmbeddingSchema, SlotConfig

    return EmbeddingSchema(slots_config={
        f"slot_{s}": SlotConfig(name=f"slot_{s}", dim=DH_DIM,
                                sqrt_scaling=s in sqrt_scaled)
        for s in range(DH_SLOTS)})


def dh_ctx(torch, device: str, compute_dtype=None, global_config=None,
           state_dict=None, mesh=None, grad_reduce_dtype=None, schema=None,
           device_cache_capacity=0, device_cache_admission=None):
    """bench_hybrid's stack: DLRM(embedding_dim=16) over 26 slots and 13
    dense features, OptaxAdagrad(0.02) dense, Adagrad(0.02) sparse at the
    default row init, 2 shards of make_holder(50_000_000, 16); seeded
    weights, or a copy of ``state_dict``; over ``mesh`` the leader holds
    the PS; bench_cached's with ``device_cache_capacity``."""
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.optim import OptaxAdagrad

    schema = schema or dh_schema()
    model = DLRM(DH_DENSE, DH_SLOTS, embedding_dim=DH_DIM,
                 compute_dtype=compute_dtype or torch.bfloat16,
                 device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return hybrid_ctx(
        torch, model, schema, [(DH_PS_CAPACITY, DH_PS_SHARDS)] * N_PS,
        lambda p: OptaxAdagrad(p, DH_LR), DH_LR, (-0.01, 0.01),
        global_config=global_config,
        seed=SEED if state_dict is None else None, mesh=mesh,
        grad_reduce_dtype=grad_reduce_dtype,
        device_cache_capacity=device_cache_capacity,
        device_cache_admission=device_cache_admission)


def touched_rows(worker, signs):
    """[embedding | Adagrad state] of ``signs`` from the worker's PS
    shards: (how many shards hold each sign, the rows; zeros where none
    does)."""
    import numpy as np

    got = [h.get_entries(signs, 2 * DH_DIM) for h in worker.ps_clients]
    return (np.sum([f for f, _ in got], axis=0),
            np.sum([v for _, v in got], axis=0))


def batch_signs(batches):
    import numpy as np

    return np.unique(np.concatenate([f.data for b in batches
                                     for f in b.id_type_features]))


def dlrm_hybrid_agreement(torch, card: str, batches):
    """The card against the port on the CPU: 3 steps from one weight set
    and fresh PS rows, f32 tower and wire, no TF32; then 10 pipelined
    steps (reproducible, staleness 1) against 10 synchronous ones on the
    card, which must be equal."""
    import numpy as np

    from persia_tpu_torch.config import CommonConfig, GlobalConfig
    from persia_tpu_torch.weights import flax_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wire = GlobalConfig(CommonConfig("f32"))
    agree = batches[:DH_AGREE_STEPS]
    runs, start = [], None
    for device in ("cuda", "cpu"):
        ctx = dh_ctx(torch, device, torch.float32, wire, state_dict=start)
        if start is None:
            start = {k: v.clone() for k, v in ctx.model.state_dict().items()}
        with ctx:
            losses = [float(ctx.train_step(b)[0]) for b in agree]
        runs.append((losses, flax_params(ctx.model)[0],
                     touched_rows(ctx.worker, batch_signs(agree))))
        ctx.worker.close()
    (gl, gp, (gf, gr)), (cl, cp, (cf, cr)) = runs
    loss_err = max(abs(a - b) for a, b in zip(gl, cl))
    param_err = 0.0
    for layer, leaves in gp.items():
        for name, leaf in leaves.items():
            for k, v in leaf.items():
                ref = cp[layer][name][k]
                param_err = max(param_err, float(np.abs(v - ref).max())
                                / max(float(np.abs(ref).max()), 1e-30))
    if not ((gf == 1).all() and (cf == 1).all()):
        raise AssertionError("a touched PS row is missing after 3 steps")
    row_err = float(np.abs(gr - cr).max()) / float(np.abs(cr).max())
    _log(f"[dlrm_hybrid] card vs CPU, {DH_AGREE_STEPS} steps of batch "
         f"{DH_BATCH} f32: loss max_abs_err={loss_err:.3e} (atol "
         f"{DH_LOSS_ATOL}); dense params max_abs_err / max|param| per "
         f"tensor={param_err:.3e}, {len(gf)} touched PS rows max_abs_err / "
         f"max|row|={row_err:.3e} (rtol {DH_REL_TOL}) | card: {card}")
    if not (loss_err <= DH_LOSS_ATOL and param_err <= DH_REL_TOL
            and row_err <= DH_REL_TOL and np.isfinite(gl).all()):
        raise AssertionError("DLRM on the card and on the CPU disagree")

    repro = batches[:PIPE_AGREE_STEPS]
    sync_ctx = dh_ctx(torch, "cuda", torch.float32, wire)
    with sync_ctx:
        sync = [float(sync_ctx.train_step(b)[0]) for b in repro]
    pipe_ctx = dh_ctx(torch, "cuda", torch.float32, wire)
    loader = pipelined_loader(repro, reproducible=True, staleness=1)
    with pipe_ctx:
        pipe = [float(pipe_ctx.train_step(lb)[0]) for lb in loader]
    loader._engine.shutdown()
    signs = batch_signs(repro)
    (sf, sr), (pf, pr) = (touched_rows(c.worker, signs)
                          for c in (sync_ctx, pipe_ctx))
    rows = [sum(len(h) for h in c.worker.ps_clients)
            for c in (sync_ctx, pipe_ctx)]
    for c in (sync_ctx, pipe_ctx):
        c.worker.close()
    loss_err = max(abs(a - b) for a, b in zip(sync, pipe))
    row_diff = int((sr.view(np.uint32) != pr.view(np.uint32))
                   .any(axis=-1).sum())
    _log(f"[dlrm_hybrid] reproducible (staleness 1, {PIPE_WORKERS} workers) "
         f"vs synchronous, {len(sync)} steps f32: loss max_abs_err="
         f"{loss_err:.3e}; PS rows {rows[0]} / {rows[1]}, rows that differ "
         f"in any bit: {row_diff} | card: {card}")
    if not (len(pipe) == len(sync) and loss_err == 0.0 and row_diff == 0
            and rows[0] == rows[1] == len(signs) and (sf == 1).all()
            and (pf == 1).all()):
        raise AssertionError("DLRM's pipelined and synchronous runs differ")


def dlrm_hybrid_phase(torch, card: str):
    """bench_hybrid's configuration on the card: the agreements, then a
    synchronous and a pipelined run (4 workers, staleness 8, buffer 8) of
    ``DH_STEPS`` steps of fresh signs each: steps [10, 60) timed, [60,
    70) synchronized after each stage, [70, 75) profiled."""
    import numpy as np

    from persia_tpu_torch.ctx import STAGES
    from persia_tpu_torch.workloads.generator import hybrid_bench_batches

    reset_launch_counts()
    t0 = time.perf_counter()
    batches = list(hybrid_bench_batches(DH_STEPS, DH_BATCH, seed=SEED))
    _log(f"[dlrm_hybrid] setup {time.perf_counter() - t0:.2f}s: "
         f"{DH_STEPS} batches of {DH_BATCH} x {DH_SLOTS} fresh signs; "
         f"process RSS {rss_gb():.2f} GiB")
    dlrm_hybrid_agreement(torch, card, batches)

    what = (f"DLRM(embedding_dim={DH_DIM}) {DH_SLOTS} slots, {N_PS} x "
            f"make_holder({DH_PS_CAPACITY}, {DH_PS_SHARDS})")
    timed, split, prof = range(10, 60), range(60, 70), range(70, DH_STEPS)
    ctx = dh_ctx(torch, "cuda")
    step_s, losses = [], []
    with ctx:
        for step, batch in enumerate(batches):
            if step == timed.start:
                cpu0 = thread_cpu_s()
            if step == split.start:
                cpu = cpu_by_thread(cpu0, thread_cpu_s(), len(timed))
                ctx.sync_stages = True
                ctx.stage_seconds = dict.fromkeys(STAGES, 0.0)
            if step == prof.start:
                split_s = dict(ctx.stage_seconds)
                ctx.sync_stages = False
                window = profile_window(torch, lambda: [
                    losses.append(ctx.train_step(batches[s])[0])
                    for s in prof])
            if step in prof:
                continue
            t = time.perf_counter()
            loss, _ = ctx.train_step(batch)
            step_s.append(time.perf_counter() - t)
            losses.append(loss)
        torch.cuda.synchronize()
    rows = sum(len(h) for h in ctx.worker.ps_clients)
    rss = rss_gb()
    ctx.worker.close()
    del ctx
    steady = np.asarray(step_s[timed.start:timed.stop]) * 1e3
    report_steps("dlrm_hybrid", f"synchronous, {what}", steady, card,
                 DH_BATCH)
    sync_key = "dlrm_hybrid synchronous"
    RATES[sync_key] = DH_BATCH / (steady.mean() / 1e3)
    _log(f"[dlrm_hybrid] synchronous: host CPU ms a step over steps "
         f"{timed.start}-{timed.stop - 1}, by thread: {cpu} | card: {card}")
    report_split("dlrm_hybrid", "synchronous", split, split_s, STAGES, card)
    report_window("dlrm_hybrid", f"{len(prof)} synchronous steps", window,
                  card)
    all_losses = torch.stack(losses).float().cpu().numpy()
    _log(f"[dlrm_hybrid] synchronous: {rows} PS rows resident after "
         f"{DH_STEPS} steps, process RSS {rss:.2f} GiB (after its PS is "
         f"freed {rss_gb():.2f}); loss "
         f"step0={all_losses[0]:.4f} last={all_losses[-1]:.4f} | card: "
         f"{card}")
    if not np.isfinite(all_losses).all():
        raise AssertionError("a synchronous DLRM loss is not finite")

    ctx = dh_ctx(torch, "cuda")
    with ctx:
        run = pipelined_steps(torch, ctx, pipelined_loader(batches),
                              DH_STEPS, timed, split, prof)
    rows = sum(len(h) for h in ctx.worker.ps_clients)
    rss = rss_gb()
    ctx.worker.close()
    del ctx
    RATES["dlrm_hybrid pipelined"] = report_pipelined(
        f"pipelined, {what}, {PIPE_WORKERS} lookup workers, staleness "
        f"{PIPE_STALENESS}, buffer {PIPE_BUFFER}", run, split, card,
        DH_BATCH, "dlrm_hybrid")
    report_window("dlrm_hybrid", f"{len(prof)} pipelined steps",
                  run["window"], card)
    _log(f"[dlrm_hybrid] pipelined: {rows} PS rows resident after "
         f"{DH_STEPS} steps, process RSS {rss:.2f} GiB (after its PS is "
         f"freed {rss_gb():.2f}); pipelined / synchronous samples/s "
         f"{RATES['dlrm_hybrid pipelined'] / RATES[sync_key]:.3f} | card: "
         f"{card}")
    assert_no_kernel_launched("dlrm_hybrid", card)


def dc_bag_batches(num: int, batch: int, seed: int):
    """bench_cached's traffic as bags: every (sample, slot) a bag of 1-4
    Zipf ids (a=1.2 over 2^20, one sign range a slot), 13 normal dense
    floats, random labels."""
    import numpy as np

    from persia_tpu_torch.data.batch import (
        IDTypeFeature,
        Label,
        NonIDTypeFeature,
        PersiaBatch,
    )

    rng = np.random.default_rng(seed)
    lo, hi = DC_BAG_IDS
    for i in range(num):
        feats = []
        for s in range(DH_SLOTS):
            counts = rng.integers(lo, hi + 1, size=batch)
            ids = rng.zipf(DC_ZIPF_A, size=int(counts.sum())) % DC_VOCAB
            offsets = np.zeros(batch + 1, np.uint32)
            np.cumsum(counts, out=offsets[1:])
            feats.append(IDTypeFeature.from_csr(
                f"slot_{s}", offsets,
                (ids + s * DC_VOCAB + 1).astype(np.uint64)))
        yield PersiaBatch(
            feats, non_id_type_features=[NonIDTypeFeature(
                rng.normal(size=(batch, DH_DENSE)).astype(np.float32))],
            labels=[Label(rng.integers(0, 2, size=(batch, 1))
                          .astype(np.float32))], batch_id=i)


def dc_signs(batches):
    import numpy as np

    return np.unique(np.concatenate([f.signs for b in batches
                                     for f in b.id_type_features]))


def dc_f32_run(torch, batches, capacity: int, schema=None) -> dict:
    """One f32 run (tower and wire) of ``batches`` on the card, cached at
    ``capacity`` rows or uncached (0), from the seeded weights: losses, the
    touched PS rows after the cache's flush, the cache's counters."""
    from persia_tpu_torch.config import CommonConfig, GlobalConfig

    ctx = dh_ctx(torch, "cuda", torch.float32,
                 GlobalConfig(CommonConfig("f32")), schema=schema,
                 device_cache_capacity=capacity)
    out = {}
    with ctx:
        out["losses"] = [float(ctx.train_step(b)[0]) for b in batches]
        if capacity:
            out["flushed"] = ctx.flush_device_cache()
            eng = ctx._cache_engine
            out["stats"], out["hit_rate"] = eng.stats(), eng.hit_rate
    out["rows"] = touched_rows(ctx.worker, dc_signs(batches))
    ctx.worker.close()
    return out


def dc_agree(torch, card: str, what: str, batches, capacity: int,
             schema=None):
    """The cached path against the uncached path on the card, same
    weights and batches, f32: losses within ``DC_LOSS_ATOL``, every
    touched PS row (after the flush) within ``DC_REL_TOL`` of the largest
    element, and the cache must have evicted and written back."""
    import numpy as np

    ref = dc_f32_run(torch, batches, 0, schema)
    got = dc_f32_run(torch, batches, capacity, schema)
    (rf, rr), (cf, cr) = ref["rows"], got["rows"]
    loss_err = max(abs(a - b) for a, b in zip(ref["losses"], got["losses"]))
    row_err = float(np.abs(cr - rr).max()) / float(np.abs(rr).max())
    st = got["stats"]
    _log(f"[dlrm_cached] (a) {what}, {len(batches)} steps of batch "
         f"{DH_BATCH} f32 through {capacity} cache rows against the "
         f"uncached path: loss max_abs_err={loss_err:.3e} (atol "
         f"{DC_LOSS_ATOL}); {len(rf)} touched PS rows max_abs_err / "
         f"max|row|={row_err:.3e} (rtol {DC_REL_TOL}); hit_rate="
         f"{got['hit_rate']:.4f} misses={st['misses']} evictions="
         f"{st['evictions']} writeback_rows={st['writeback_rows']} (flush "
         f"{got['flushed']}) | card: {card}")
    if not ((rf == 1).all() and (cf == 1).all()):
        raise AssertionError(f"{what}: a touched PS row is missing")
    if not (np.isfinite(got["losses"]).all() and loss_err <= DC_LOSS_ATOL
            and row_err <= DC_REL_TOL):
        raise AssertionError(f"{what}: the cached and uncached paths "
                             f"disagree")
    if not (st["evictions"] > 0 and st["writeback_rows"] > 0):
        raise AssertionError(f"{what}: the cache neither evicted nor wrote "
                             f"back: {st}")


def dc_run(torch, batches, capacity: int, timed, split=None, prof=None,
           admission=None) -> dict:
    """bench_cached's stack (the bf16 tower), cached at ``capacity`` rows
    or uncached (0), over ``batches``: the steps of ``timed`` between two
    synchronizations (host time a step too, and host CPU by thread), those
    of ``split`` synchronized after each stage, those of ``prof`` under the
    profiler. Returns what it measured."""
    import numpy as np

    from persia_tpu_torch.ctx import STAGES

    ctx = dh_ctx(torch, "cuda", device_cache_capacity=capacity,
                 device_cache_admission=admission)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, step_s, losses = {}, [], []

    def timed_end():
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - out.pop("t0")
        out["cpu"] = cpu_by_thread(out.pop("cpu0"), thread_cpu_s(),
                                   len(timed))

    with ctx:
        for step, batch in enumerate(batches):
            if step == timed.start:
                torch.cuda.synchronize()
                out["cpu0"], out["t0"] = thread_cpu_s(), time.perf_counter()
            if step == timed.stop:
                timed_end()
            if split is not None and step == split.start:
                ctx.sync_stages = True
                ctx.stage_seconds = dict.fromkeys(STAGES, 0.0)
            if prof is not None and step == prof.start:
                out["split"] = dict(ctx.stage_seconds)
                ctx.sync_stages = False
                out["window"] = profile_window(torch, lambda: [
                    losses.append(ctx.train_step(batches[s])[0])
                    for s in prof])
            if prof is not None and step in prof:
                continue
            t = time.perf_counter()
            loss, _ = ctx.train_step(batch)
            step_s.append(time.perf_counter() - t)
            losses.append(loss)
        if timed.stop == len(batches):
            timed_end()
        torch.cuda.synchronize()
        out["max_mem"] = torch.cuda.max_memory_allocated()
        if capacity:
            eng = ctx._cache_engine
            out["stats"], out["hit_rate"] = eng.stats(), eng.hit_rate
            out["wire_saved"] = eng.wire_bytes_saved
    out["rows"] = sum(len(h) for h in ctx.worker.ps_clients)
    ctx.worker.close()
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("a dlrm_cached loss is not finite")
    out["losses"] = losses
    out["steps_ms"] = np.asarray(step_s[timed.start:timed.stop]) * 1e3
    out["rate"] = DH_BATCH * len(timed) / out["wall"]
    return out


def dc_report(what: str, run: dict, card: str):
    import numpy as np

    ms = run["steps_ms"]
    _log(f"[dlrm_cached] {what}: {len(ms)} steady steps of batch "
         f"{DH_BATCH}, synchronized at both ends: samples_per_s="
         f"{run['rate']:.1f}; host ms a step p50={np.percentile(ms, 50):.3f}"
         f" p99={np.percentile(ms, 99):.3f}; host CPU ms a step by thread: "
         f"{run['cpu']}; max_memory_allocated="
         f"{run['max_mem'] / 2**30:.3f} GiB; {run['rows']} PS rows | card: "
         f"{card}")
    if "stats" in run:
        st = run["stats"]
        _log(f"[dlrm_cached] {what}: hit_rate={run['hit_rate']:.4f} "
             f"hits={st['hits']} misses={st['misses']} evictions="
             f"{st['evictions']} promotions={st['promotions']} "
             f"writeback_rows={st['writeback_rows']} resident_rows="
             f"{st['resident_rows']} wire_bytes_saved={run['wire_saved']} "
             f"({run['wire_saved'] / len(run['losses']) / 1e6:.3f} MB a "
             f"step) | card: {card}")


def dlrm_cached_phase(torch, card: str) -> dict:
    """bench_cached's configuration on the card: (a) the cached path
    against the uncached one in f32 (single-id, then bags); (b) 75 steps
    through the 2,000,000-row cache beside the uncached synchronous path
    on the same batches; (c) lru against hotness admission. No kernel may
    launch. Returns the kernels' launch counts over the phase."""
    import numpy as np

    from persia_tpu_torch.workloads.generator import zipf_bench_batches

    reset_launch_counts()
    t0 = time.perf_counter()
    batches = list(zipf_bench_batches(DC_STEPS, DH_BATCH, vocab=DC_VOCAB,
                                      a=DC_ZIPF_A, seed=SEED))
    distinct = [len(dc_signs([b])) for b in batches[:DC_AGREE_STEPS]]
    bags = list(dc_bag_batches(DC_BAG_STEPS, DH_BATCH, seed=SEED + 1))
    bag_distinct = max(len(dc_signs([b])) for b in bags)
    _log(f"[dlrm_cached] setup {time.perf_counter() - t0:.2f}s: "
         f"{DC_STEPS} batches of {DH_BATCH} x {DH_SLOTS} Zipf(a={DC_ZIPF_A}) "
         f"ids over {DC_VOCAB} a slot; distinct signs a batch "
         f"{min(distinct)}-{max(distinct)} (first {DC_AGREE_STEPS}); "
         f"{DC_BAG_STEPS} bag batches of {DC_BAG_IDS[0]}-{DC_BAG_IDS[1]} ids, "
         f"up to {bag_distinct} distinct signs a batch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dc_agree(torch, card, "single-id", batches[:DC_AGREE_STEPS],
             DC_AGREE_CAPACITY)
    dc_agree(torch, card, "bags, the last slot sqrt-scaled",
             bags, bag_distinct + bag_distinct // 4,
             schema=dh_schema(sqrt_scaled=(DH_SLOTS - 1,)))

    what = (f"DLRM(embedding_dim={DH_DIM}) {DH_SLOTS} slots, {N_PS} x "
            f"make_holder({DH_PS_CAPACITY}, {DH_PS_SHARDS})")
    timed, split, prof = range(10, 60), range(60, 70), range(70, DC_STEPS)
    ref = dc_run(torch, batches, 0, timed)
    dc_report(f"(b) uncached synchronous, {what}", ref, card)
    run = dc_run(torch, batches, DC_CAPACITY, timed, split, prof)
    dc_report(f"(b) cached, {DC_CAPACITY} rows, {what}", run, card)
    sp = {k: run["split"][k] / len(split) * 1e3 for k in run["split"]}
    _log(f"[dlrm_cached] (b) cached: step split over steps {split.start}-"
         f"{split.stop - 1}, device synchronized after each stage (ms a "
         f"step): prepare (mapper + miss import)={sp['lookup']:.3f} "
         f"h2d={sp['h2d']:.3f} device step={sp['dense']:.3f} "
         f"finish={sp['update']:.3f} | card: {card}")
    report_window("dlrm_cached", f"{len(prof)} cached steps", run["window"],
                  card)
    RATES["dlrm_cached uncached"] = ref["rate"]
    RATES["dlrm_cached cached"] = run["rate"]
    _log(f"[dlrm_cached] (b) cached / uncached samples/s "
         f"{run['rate'] / ref['rate']:.3f}; loss step0={run['losses'][0]:.4f}"
         f" last={run['losses'][-1]:.4f} | card: {card}")

    admit = batches[:DC_ADMIT_STEPS]
    for admission in ("lru", "hotness"):
        r = dc_run(torch, admit, DC_ADMIT_CAPACITY, range(10, len(admit)),
                   admission=admission)
        st = r["stats"]
        _log(f"[dlrm_cached] (c) {admission} admission, "
             f"{DC_ADMIT_CAPACITY} rows, {len(admit)} steps: hit_rate="
             f"{r['hit_rate']:.4f} promotions={st['promotions']} "
             f"evictions={st['evictions']} samples_per_s={r['rate']:.1f} "
             f"(steps 10-{len(admit) - 1}) | card: {card}")
    return assert_no_kernel_launched("dlrm_cached", card)


def train_run(torch, ctx, batches, pipelined: bool, steady_from: int):
    """Every batch through ``ctx.train_step`` (call inside ``with ctx``),
    synchronously or through a ``DataLoader`` (``PIPE_WORKERS`` lookup
    workers, staleness ``PIPE_STALENESS``), which must end at rest.
    Returns (every step's loss, all finite; the seconds from step
    ``steady_from`` to the end, synchronized at both ends)."""
    import numpy as np

    loader = pipelined_loader(batches) if pipelined else None
    losses = []
    for i, b in enumerate(loader or batches):
        if i == steady_from:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(ctx.train_step(b)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if loader is not None:
        staleness = ctx.worker.staleness
        loader._engine.shutdown()
        if staleness != 0:
            raise AssertionError(f"worker staleness {staleness} after the "
                                 f"pipelined loop")
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("a training loss is not finite")
    return losses, wall


PATHS = {False: "synchronous",
         True: f"pipelined ({PIPE_WORKERS} workers, staleness "
               f"{PIPE_STALENESS})"}


def zoo_phase(torch, card: str):
    """The zoo's three scenarios at full size on bench.py's e2e stack
    (adam(2e-3) dense, Adagrad(0.1) sparse, rows from U(-0.05, 0.05), 2
    shards of make_holder(2_000_000, 8)): ``ZOO_STEPS`` steps at each
    scenario's bench batch, synchronous then pipelined, each with
    samples/s over the steps past the first fifth, the loss falling and
    the held-out AUC of each task at the scenario's bar."""
    from persia_tpu_torch.workloads import (
        evaluate_auc,
        get_scenario,
        scenario_names,
    )

    reset_launch_counts()
    for name in scenario_names():
        sc = get_scenario(name)
        bs = sc.bench_batch_size
        batches = list(sc.batches(ZOO_STEPS * bs, bs))
        for pipelined, how in PATHS.items():
            ctx = hybrid_ctx(
                torch, sc.model(device="cuda"), sc.schema,
                [(2_000_000, 8)] * N_PS,
                lambda p: torch.optim.Adam(p, lr=2e-3), 0.1, (-0.05, 0.05),
                loss_fn=sc.loss_fn, seed=sc.seed)
            steady_from = ZOO_STEPS // 5
            with ctx:
                losses, wall = train_run(torch, ctx, batches, pipelined,
                                         steady_from)
                aucs = evaluate_auc(ctx, sc, num_samples=ZOO_EVAL,
                                    batch_size=min(bs, 512))
            ctx.worker.close()
            sps = (ZOO_STEPS - steady_from) * bs / wall
            RATES[f"zoo {name} {how.split()[0]}"] = sps
            first5, last5 = float(losses[:5].mean()), float(losses[-5:].mean())
            _log(f"[zoo] {name}: {type(ctx.model).__name__}, {how}, "
                 f"{ZOO_STEPS} steps of batch {bs}: samples_per_s={sps:.1f} "
                 f"(steps {steady_from}-{ZOO_STEPS - 1}, synchronized at both "
                 f"ends); loss {first5:.4f} -> {last5:.4f}; held-out AUC on "
                 f"{ZOO_EVAL} samples "
                 + ", ".join(f"{t}={v:.4f}" for t, v in aucs.items())
                 + f" (bar {sc.auc_gate}) | card: {card}")
            if not last5 < first5:
                raise AssertionError(f"zoo {name} {how}: the loss did not "
                                     f"fall ({first5} -> {last5})")
            if min(aucs.values()) < sc.auc_gate:
                raise AssertionError(f"zoo {name} {how}: held-out AUC {aucs}"
                                     f" below {sc.auc_gate}")
    assert_no_kernel_launched("zoo", card)


def adult_income_phase(torch, card: str):
    """examples/adult_income/train.py on the card: DNN (two batch norms)
    over 8 slots of dim 8 and 5 dense features, Adam(1e-3) dense,
    Adagrad(1e-2) sparse, rows from U(-0.05, 0.05), 2 shards of
    make_holder(1_000_000, 8), seed 42; ``AI_STEPS`` steps of batch
    ``AI_BATCH`` synchronous, then pipelined, each with the test AUC (bar
    0.70) and the running statistics, which must have moved."""
    import numpy as np

    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.utils import roc_auc
    from persia_tpu_torch.workloads.generator import (
        ADULT_NUM_DENSE,
        ADULT_NUM_SLOTS,
        adult_income_batches,
    )

    reset_launch_counts()
    schema = EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{s}" for s in range(ADULT_NUM_SLOTS)], dim=AI_DIM))
    batches = list(adult_income_batches(AI_STEPS * AI_BATCH, AI_BATCH,
                                        seed=1))
    for pipelined, how in PATHS.items():
        model = DNN(ADULT_NUM_DENSE, [AI_DIM] * ADULT_NUM_SLOTS,
                    sparse_mlp_output_size=128, device="cuda")
        ctx = hybrid_ctx(torch, model, schema, [(1_000_000, 8)] * N_PS,
                         lambda p: torch.optim.Adam(p, lr=1e-3), 1e-2,
                         (-0.05, 0.05), seed=AI_SEED)
        with ctx:
            losses, wall = train_run(torch, ctx, batches, pipelined, 10)
            preds, labels = [], []
            with eval_ctx(ctx) as ectx:
                for b in adult_income_batches(AI_EVAL, 512, seed=99,
                                              requires_grad=False):
                    pred, lab = ectx.forward(b)
                    preds.append(pred.float().cpu().numpy().reshape(-1))
                    labels.append(lab[0].numpy().reshape(-1))
        ctx.worker.close()
        preds = np.concatenate(preds)
        auc = roc_auc(np.concatenate(labels), preds)
        sps = (AI_STEPS - 10) * AI_BATCH / wall
        RATES[f"adult_income {how.split()[0]}"] = sps
        stats = {n: (float(getattr(model, n).mean.abs().mean()),
                     float(getattr(model, n).var.mean()))
                 for n in ("BatchNorm_0", "BatchNorm_1")}
        _log(f"[adult_income] DNN, {how}, {AI_STEPS} steps of batch "
             f"{AI_BATCH}: samples_per_s={sps:.1f} (steps 10-{AI_STEPS - 1}, "
             f"synchronized at both ends); loss step0={losses[0]:.4f} last="
             f"{losses[-1]:.4f}; test AUC on {AI_EVAL} samples {auc:.4f} "
             f"(bar {AI_BAR}); running statistics mean |mean| / mean var: "
             + ", ".join(f"{n} {m:.4f} / {v:.4f}" for n, (m, v)
                         in stats.items()) + " (init 0 / 1) | card: "
             + card)
        if not np.isfinite(preds).all():
            raise AssertionError(f"adult_income {how}: non-finite prediction")
        if not auc > AI_BAR:
            raise AssertionError(f"adult_income {how}: AUC {auc:.4f} is not "
                                 f"above {AI_BAR}")
        if any(m == 0.0 or v == 1.0 for m, v in stats.values()):
            raise AssertionError(f"adult_income {how}: a batch norm's running "
                                 f"statistics did not move: {stats}")
    assert_no_kernel_launched("adult_income", card)


def criteo_towers_phase(torch, card: str):
    """DCNv2, DeepFM and WideAndDeep at examples/criteo/train.py's widths
    and optimizers (26 slots of dim 16, 13 dense features, OptaxAdagrad
    (0.02) dense, Adagrad(0.02) sparse, rows from U(-0.01, 0.01), 2 shards
    of make_holder(1_000_000_000, 16)): ``CT_STEPS`` steps of batch
    ``CT_BATCH`` of criteo_learnable_batches each, synchronous then
    pipelined; every loss finite, the last 10 steps' mean loss below the
    first 10's, eval predictions in (0, 1)."""
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.models import DCNv2, DeepFM, WideAndDeep
    from persia_tpu_torch.parallel.optim import OptaxAdagrad
    from persia_tpu_torch.workloads.generator import (
        CRITEO_SLOT_NAMES,
        NUM_DENSE,
        NUM_TABLES,
        criteo_learnable_batches,
    )

    reset_launch_counts()
    schema = EmbeddingSchema(slots_config=uniform_slots(CRITEO_SLOT_NAMES,
                                                        dim=DH_DIM))
    batches = list(criteo_learnable_batches(CT_STEPS * CT_BATCH, CT_BATCH,
                                            seed=SEED))
    held = next(criteo_learnable_batches(CT_BATCH, CT_BATCH, seed=99,
                                         requires_grad=False))
    towers = {
        "DCNv2": lambda: DCNv2(NUM_DENSE, [DH_DIM] * NUM_TABLES,
                               device="cuda"),
        "DeepFM": lambda: DeepFM(NUM_DENSE, NUM_TABLES,
                                 embedding_dim=DH_DIM, device="cuda"),
        "WideAndDeep": lambda: WideAndDeep(NUM_DENSE, [DH_DIM] * NUM_TABLES,
                                           device="cuda"),
    }
    for name, build in towers.items():
        for pipelined, how in PATHS.items():
            ctx = hybrid_ctx(torch, build(), schema,
                             [(1_000_000_000, 16)] * N_PS,
                             lambda p: OptaxAdagrad(p, 0.02), 0.02,
                             (-0.01, 0.01))
            with ctx:
                losses, wall = train_run(torch, ctx, batches, pipelined, 10)
                with eval_ctx(ctx) as ectx:
                    pred, _ = ectx.forward(held)
                pred = pred.float().cpu().numpy()
            ctx.worker.close()
            sps = (CT_STEPS - 10) * CT_BATCH / wall
            RATES[f"criteo_towers {name} {how.split()[0]}"] = sps
            first, last = float(losses[:10].mean()), float(losses[-10:].mean())
            _log(f"[criteo_towers] {name}, {how}: {CT_STEPS} steps of batch "
                 f"{CT_BATCH}: samples_per_s={sps:.1f} (steps 10-"
                 f"{CT_STEPS - 1}, synchronized at both ends); mean loss of "
                 f"the first / last 10 steps {first:.4f} / {last:.4f}; eval "
                 f"predictions in [{pred.min():.4f}, {pred.max():.4f}] | "
                 f"card: {card}")
            if not last < first:
                raise AssertionError(f"criteo_towers {name} {how}: the loss "
                                     f"did not fall ({first} -> {last})")
            if not ((pred > 0) & (pred < 1)).all():
                raise AssertionError(f"criteo_towers {name} {how}: eval "
                                     f"predictions outside (0, 1)")
    assert_no_kernel_launched("criteo_towers", card)


def ps_map(worker, tmp: str) -> dict:
    """(replica, sign) -> the row's f32 [emb|state] bytes over resident
    and spilled rows, from a PSD dump of each replica."""
    from persia_tpu_torch.checkpoint import iter_psd_entries

    out = {}
    for r, h in enumerate(worker.ps_clients):
        path = os.path.join(tmp, f"ps_map_{r}.psd")
        h.dump_file(path)
        for sign, _dim, vec in iter_psd_entries(path):
            out[(r, sign)] = vec.tobytes()
        os.remove(path)
    return out


def dense_state(ctx) -> dict:
    """The model's and the dense optimizer's tensors, copied to the host."""
    import torch

    out = {f"model.{k}": v.detach().cpu().clone()
           for k, v in ctx.model.state_dict().items()}
    for i, st in ctx.dense_optimizer.state_dict()["state"].items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                out[f"optimizer.{i}.{k}"] = v.detach().cpu().clone()
    return out


def first_difference(want: dict, got: dict) -> str:
    """The first tensor of ``got`` that differs from ``want`` and its max
    abs delta, or '' when they are equal bit for bit."""
    import torch

    if set(want) != set(got):
        return f"tensor names differ: {sorted(set(want) ^ set(got))[:5]}"
    for k in want:
        if not torch.equal(want[k], got[k]):
            delta = float((want[k].double() - got[k].double()).abs().max())
            return f"{k} (max |delta| {delta:.3e})"
    return ""


def seqrec_resume(torch, card: str, tmp: str) -> dict:
    """seq_rec through K2-K4 on spill-armed native holders: run A trains
    2 ``SR_STEPS`` steps straight; run B trains ``SR_STEPS``, takes a job
    snapshot with its data cursor and is closed; run C, a fresh stack
    (new holders and spill directories, a fresh tower and optimizer),
    resumes with ``TrainCtx(resume_from=)`` and trains the rest from the
    cursor. C must equal A bit for bit: the suffix losses, the dense
    state and the PS rows, resident and spilled. Then the same 2 N steps
    on the plain native holder at full capacity, and run D, run A again
    at the spill store's default packet size, for the throughput of the
    armed tier. Returns the K2-K4 launches of runs A, B and C."""
    import itertools

    import numpy as np

    from persia_tpu_torch.data.dataloader import ResumableDataset
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.ps.spill import SpillStore
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    schema = build_schema()
    n = SR_STEPS
    snap_dir = os.path.join(tmp, "seqrec_snapshots")

    def factory(stop):
        return lambda seed: itertools.islice(seqrec_batches(
            2 * n * TRAIN_BATCH, TRAIN_BATCH, seed=seed, spec=spec), stop)

    def stack(tag, capacity, armed, resume_from=None,
              packet_bytes=SR_PACKET_BYTES):
        """A fresh seq_rec stack; its spill stores, if armed, flush
        packets of ``packet_bytes``."""
        default_packet_bytes = SpillStore.PACKET_BYTES
        SpillStore.PACKET_BYTES = packet_bytes
        try:
            return hybrid_ctx(
                torch, build_tower(spec.num_dense, "flash"), schema,
                [(capacity, SR_SHARDS)] * N_PS,
                lambda p: torch.optim.Adam(p, lr=1e-3), 1e-2, (-0.05, 0.05),
                seed=None,
                spill_root=os.path.join(tmp, tag) if armed else None,
                hotness=armed, resume_from=resume_from)
        finally:
            SpillStore.PACKET_BYTES = default_packet_bytes

    def run(ctx, dataset, t_start=None):
        """Every batch of ``dataset`` through ``ctx.train_step``, counters
        zeroed just before and read just after. Returns (losses, seconds
        from step SR_TIMED_FROM to the end, the time from ``t_start`` to
        the end of the first step in ms, launches)."""
        fa.reset_launch_count()
        losses, first_ms, t0 = [], None, None
        for i, b in enumerate(dataset):
            if i == SR_TIMED_FROM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(ctx.train_step(b)[0])
            if i == 0 and t_start is not None:
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t_start) * 1e3
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 if t0 is not None else float("nan")
        launches = {k: fa.launch_count(k) for k in FLASH_KERNELS}
        losses = torch.stack(losses).float().cpu().numpy()
        if not np.isfinite(losses).all():
            raise AssertionError("snapshot_resume: a loss is not finite")
        return losses, wall, first_ms, launches

    def tier(ctx):
        stats = [h.spill_stats() for h in ctx.worker.ps_clients]
        hot = [h.hotness_snapshot() for h in ctx.worker.ps_clients]
        return stats, hot

    # A: 2 N steps straight
    ctx_a = stack("a", SR_CAPACITY, True)
    with ctx_a:
        losses_a, wall_a, _, launch_a = run(
            ctx_a, ResumableDataset(factory(2 * n), seed=TRAIN_SEED))
        state_a = dense_state(ctx_a)
        map_a = ps_map(ctx_a.worker, tmp)
        spill_a, hot_a = tier(ctx_a)
    ctx_a.worker.close()

    # B: N steps, the snapshot, closed
    ctx_b = stack("b", SR_CAPACITY, True)
    ds_b = ResumableDataset(factory(n), seed=TRAIN_SEED)
    with ctx_b:
        losses_b, _, _, launch_b = run(ctx_b, ds_b)
        t0 = time.perf_counter()
        snap = ctx_b.snapshot(snap_dir, cursor=ds_b.cursor(n))
        snap_ms = (time.perf_counter() - t0) * 1e3
    ctx_b.worker.close()
    snap_bytes = sum(os.path.getsize(os.path.join(snap, f))
                     for f in os.listdir(snap))
    snap_files = len(os.listdir(snap))

    # C: a fresh stack resumes from the snapshot and trains the rest
    t0 = time.perf_counter()
    ctx_c = stack("c", SR_CAPACITY, True, resume_from=snap_dir)
    with ctx_c:
        ds_c = ResumableDataset.from_cursor(factory(2 * n),
                                            ctx_c.resume_cursor)
        losses_c, _, restore_ms, launch_c = run(ctx_c, ds_c, t_start=t0)
        state_c = dense_state(ctx_c)
        map_c = ps_map(ctx_c.worker, tmp)
        spill_c, hot_c = tier(ctx_c)
    ctx_c.worker.close()

    # the plain native holder at full capacity, the same 2 N steps
    ctx_p = stack("p", 2_000_000, False)
    with ctx_p:
        losses_p, wall_p, _, launch_p = run(
            ctx_p, ResumableDataset(factory(2 * n), seed=TRAIN_SEED))
    ctx_p.worker.close()

    # D: run A at the spill store's default packet size
    ctx_d = stack("d", SR_CAPACITY, True,
                  packet_bytes=SpillStore.PACKET_BYTES)
    with ctx_d:
        losses_d, wall_d, _, launch_d = run(
            ctx_d, ResumableDataset(factory(2 * n), seed=TRAIN_SEED))
        spill_d, _ = tier(ctx_d)
    ctx_d.worker.close()

    timed = 2 * n - SR_TIMED_FROM
    sps_a = timed * TRAIN_BATCH / wall_a
    sps_p = timed * TRAIN_BATCH / wall_p
    sps_d = timed * TRAIN_BATCH / wall_d
    RATES["synchronous native, spill + hotness armed, capacity "
          f"{SR_CAPACITY}, {SR_PACKET_BYTES >> 10} KiB packets"] = sps_a
    RATES["synchronous native, spill + hotness armed, capacity "
          f"{SR_CAPACITY}, default {SpillStore.PACKET_BYTES >> 20} MiB "
          f"packets"] = sps_d
    RATES["synchronous native, full capacity, the same steps"] = sps_p
    packet_delta = float(np.abs(losses_d - losses_a).max())
    loss_delta = float(np.abs(losses_c - losses_a[n:]).max())
    prefix_delta = float(np.abs(losses_b - losses_a[:n]).max())
    dense_diff = first_difference(state_a, state_c)
    rows_equal = map_a == map_c
    first_step = next((i for i in range(n)
                       if losses_c[i] != losses_a[n + i]), None)
    _log(f"[snapshot_resume] seq_rec SequenceTower(num_heads={HEADS}, "
         f"attn_impl='flash') dim {DIM} t_hist {T_HIST} MLP {MLP}, batch "
         f"{TRAIN_BATCH}, {N_PS} x make_holder({SR_CAPACITY}, {SR_SHARDS}, "
         f"spill_dir, hotness=True): {2 * n} steps touch {len(map_a)} PS "
         f"rows ({len(map_a) / (N_PS * SR_CAPACITY):.2f} x the resident "
         f"capacity) | card: {card}")
    _log(f"[snapshot_resume] resumed run vs unbroken run: suffix losses "
         f"max |delta| {loss_delta:.3e} (first differing step "
         f"{first_step}), prefix {prefix_delta:.3e}; dense state "
         f"({len(state_a)} tensors) "
         f"{'equal' if not dense_diff else 'first differs at ' + dense_diff}"
         f"; PS rows {len(map_c)} vs {len(map_a)}, "
         f"{'equal' if rows_equal else 'DIFFER'} | card: {card}")
    _log(f"[snapshot_resume] samples_per_s over steps {SR_TIMED_FROM}-"
         f"{2 * n - 1} (synchronized at both ends): spill + hotness armed "
         f"at capacity {SR_CAPACITY}, {SR_PACKET_BYTES >> 10} KiB packets "
         f"{sps_a:.1f} (ratio {sps_a / sps_p:.3f}), default "
         f"{SpillStore.PACKET_BYTES >> 20} MiB packets {sps_d:.1f} (ratio "
         f"{sps_d / sps_p:.3f}; losses against the 256 KiB run max |delta| "
         f"{packet_delta:.3e}), plain native holder at full capacity "
         f"{sps_p:.1f} | card: {card}")
    for what, stats, hot in (("unbroken", spill_a, hot_a),
                             ("resumed", spill_c, hot_c),
                             ("default-packet", spill_d, None)):
        _log(f"[snapshot_resume] {what} run, spill_stats by replica: "
             + "; ".join(
                 f"puts={st['spilled_rows_total']} "
                 f"takes={st['spill_fault_ins_total']} "
                 f"spilled={st['spilled_rows']} "
                 f"disk_bytes={st['spill_disk_bytes']} "
                 f"staged_bytes={st['spill_staged_bytes']} "
                 f"packets={st['spill_packets']}" for st in stats)
             + ("; hotness totals " + ", ".join(
                 f"{h['total']} over {len(h['tables'])} table(s), top-K "
                 f"{sum(len(t['topk']) for t in h['tables'].values())}"
                 for h in hot) if hot else "") + f" | card: {card}")
    _log(f"[snapshot_resume] snapshot after step {n}: {snap_ms:.1f} ms "
         f"wall, {snap_files} files, {snap_bytes} bytes on disk; restore "
         f"(TrainCtx(resume_from=) construction to the end of the first "
         f"resumed step) {restore_ms:.1f} ms | card: {card}")
    launches = {k: launch_a[k] + launch_b[k] + launch_c[k]
                for k in FLASH_KERNELS}
    _log("[snapshot_resume] K2-K4 launches: unbroken "
         + " ".join(f"{k}={v}" for k, v in launch_a.items())
         + f" in {2 * n} steps; first half "
         + " ".join(f"{k}={v}" for k, v in launch_b.items())
         + f" in {n}; resumed " + " ".join(
             f"{k}={v}" for k, v in launch_c.items())
         + f" in {n}; plain holder " + " ".join(
             f"{k}={v}" for k, v in launch_p.items())
         + f" in {2 * n}; default packets " + " ".join(
             f"{k}={v}" for k, v in launch_d.items())
         + f" in {2 * n} | card: {card}")
    for what, counts, steps in (("unbroken", launch_a, 2 * n),
                                ("first half", launch_b, n),
                                ("resumed", launch_c, n),
                                ("plain", launch_p, 2 * n),
                                ("default-packet", launch_d, 2 * n)):
        if any(c != steps for c in counts.values()):
            raise AssertionError(f"snapshot_resume {what} run: K2-K4 "
                                 f"launched {counts}, not once in each "
                                 f"of its {steps} steps")
    if prefix_delta != 0.0 or loss_delta != 0.0:
        raise AssertionError(
            f"snapshot_resume: the resumed run's losses differ from the "
            f"unbroken run's (prefix {prefix_delta}, suffix {loss_delta}, "
            f"first at resumed step {first_step})")
    if packet_delta != 0.0:
        raise AssertionError(f"snapshot_resume: the default-packet run's "
                             f"losses differ from the unbroken run's "
                             f"(max |delta| {packet_delta})")
    if dense_diff:
        raise AssertionError(f"snapshot_resume: the resumed dense state "
                             f"differs: {dense_diff}")
    if not rows_equal:
        diff = sorted(k for k in set(map_a) | set(map_c)
                      if map_a.get(k) != map_c.get(k))
        raise AssertionError(f"snapshot_resume: {len(diff)} PS rows differ,"
                             f" first {diff[:3]}")
    for stats in (spill_a, spill_c):
        if not all(st["spilled_rows_total"] > 0
                   and st["spill_fault_ins_total"] > 0
                   and st["spill_packets"] > 0 for st in stats):
            raise AssertionError(f"snapshot_resume: a replica did not spill "
                                 f"to disk and fault back in: {stats}")
    for hot in (hot_a, hot_c):
        if not all(h["enabled"] and h["total"] > 0 and h["tables"]
                   for h in hot):
            raise AssertionError("snapshot_resume: a hotness snapshot is "
                                 "empty")
    return launches


def dlrm_resume_drill(torch, card: str, tmp: str):
    """bench.py's _chaos_job_convergence_cell on the registry's dlrm
    scenario at full size: a baseline trains ``DRILL_STEPS`` steps of the
    bench batch straight; a second run trains half, snapshots and is
    closed; a fresh stack resumes from the snapshot and trains the rest.
    The suffix losses and the dense parameters within ``DRILL_ATOL`` of
    the baseline's, the held-out AUC within ``DRILL_AUC_ATOL``."""
    import numpy as np

    from persia_tpu_torch import snapshot as snapmod
    from persia_tpu_torch.workloads import evaluate_auc, get_scenario

    sc = get_scenario("dlrm")
    bs = sc.bench_batch_size
    half = DRILL_STEPS // 2
    snap_dir = os.path.join(tmp, "dlrm_snapshots")
    batches = list(sc.batches(DRILL_STEPS * bs, bs))

    def run(start=0, stop=None, resume_from=None):
        ctx = hybrid_ctx(
            torch, sc.model(device="cuda"), sc.schema,
            [(2_000_000, 8)] * N_PS, lambda p: torch.optim.Adam(p, lr=2e-3),
            0.1, (-0.05, 0.05), loss_fn=sc.loss_fn, seed=sc.seed,
            resume_from=resume_from)
        aucs = params = None
        with ctx:
            losses = torch.stack([ctx.train_step(b)[0]
                                  for b in batches[start:stop]])
            losses = losses.float().cpu().numpy()
            if stop is not None:
                ctx.snapshot(snap_dir,
                             cursor={"seed": sc.seed, "consumed": stop})
            else:
                aucs = evaluate_auc(ctx, sc, num_samples=DRILL_EVAL,
                                    batch_size=min(bs, 512))
                params = {k: v.detach().double().cpu()
                          for k, v in ctx.model.state_dict().items()}
        ctx.worker.close()
        return losses, aucs, params

    reset_launch_counts()
    base_losses, base_aucs, base_params = run()
    run(stop=half)
    found = snapmod.latest_snapshot(snap_dir)
    if found is None:
        raise AssertionError("dlrm drill: the mid-run snapshot is missing")
    start = int((found[1].get("cursor") or {}).get("consumed", 0))
    if start != half:
        raise AssertionError(f"dlrm drill: snapshot cursor {start}, wanted "
                             f"{half}")
    res_losses, res_aucs, res_params = run(start=start,
                                           resume_from=snap_dir)
    dl = float(np.max(np.abs(base_losses[half:] - res_losses)))
    dp = max(float((base_params[k] - res_params[k]).abs().max())
             for k in base_params)
    da = max(abs(base_aucs[k] - res_aucs[k]) for k in base_aucs)
    _log(f"[snapshot_resume] dlrm drill (scenario {sc.name}, "
         f"{len(sc.schema.slots_config)} slots, batch {bs}, {DRILL_STEPS} "
         f"steps resumed at {half}): suffix losses max |delta| {dl:.3e}, "
         f"dense parameters {dp:.3e} (gates {DRILL_ATOL}), held-out AUC "
         f"baseline {base_aucs} resumed {res_aucs} |delta| {da:.3e} (gate "
         f"{DRILL_AUC_ATOL}) | card: {card}")
    assert_no_kernel_launched("snapshot_resume dlrm drill", card)
    if dl > DRILL_ATOL:
        raise AssertionError(f"dlrm drill: replayed-suffix losses diverged "
                             f"(max |delta| {dl:.2e})")
    if dp > DRILL_ATOL:
        raise AssertionError(f"dlrm drill: final dense parameters diverged "
                             f"(max |delta| {dp:.2e})")
    if da > DRILL_AUC_ATOL:
        raise AssertionError(f"dlrm drill: held-out AUC diverged: baseline "
                             f"{base_aucs}, resumed {res_aucs}")


def snapshot_resume_phase(torch, card: str) -> dict:
    """Job snapshots and resume on the card (the spill tier, the hotness
    sketches, checkpoints, snapshots and ``TrainCtx(resume_from=)``):
    seq_rec through K2-K4 (:func:`seqrec_resume`), then the zoo DLRM
    drill (:func:`dlrm_resume_drill`). Returns the K2-K4 launches of the
    seq_rec runs A-C."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as tmp:
        launches = seqrec_resume(torch, card, tmp)
        dlrm_resume_drill(torch, card, tmp)
    _log(f"[snapshot_resume] phase wall {time.perf_counter() - t0:.1f}s | "
         f"card: {card}")
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
    zeroed just before the timed steps and must read one per step after
    them: the collection pools its 26 slots in one call. Returns K1's
    launches."""
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
    if launches != n_steps:
        raise AssertionError(f"K1 launched {launches} times in {n_steps} "
                             f"steps, not once per step (all {DM_SLOTS} "
                             f"slots in one call)")
    return launches


# --- multi_rank: data and context parallelism over ranks --------------------

MR_WORLD = 2  # two ranks share the one card, over gloo
MR_DDP_STEPS = 16
MR_DDP_TIMED_FROM = 4
# the gates of tests/test_models_parallel.py:235-255: the f32 reduction
# against one rank, bf16 against the f32 reduction, int8_ef's last 4
MR_F32_TOL = 2e-3
MR_BF16_TOL = 0.05
MR_EF_TOL = 0.08
# (a)'s dense parameters: each run's change over its steps against one
# rank's, within 8 f32 ulps of the largest parameter plus MR_PARAM_RTOL
# of one rank's largest change. The bf16 tower's rounding of each rank's
# gradient GEMM over its half batch puts every reduction ~1% off one rank
# (a CPU rehearsal at batch 512: 0.9% f32, 1.2% int8_ef); a skipped dense
# update, or gradients averaged at the wrong scale, miss by 50-100%
# (OptaxAdagrad's accumulator starts at 0.1 and these gradients are
# ~3e-3, so the update is near linear in the gradient's scale).
MR_PARAM_RTOL = 5e-2
MR_PARAM_ULPS = 8 * 2.0 ** -23
MR_DM_STEPS = 5
MR_CP_AGREE_STEPS = 3
MR_CP_STEPS = 10
MR_NCCL_STEPS = 3
MR_BENCH_SHAPE = (4, 8, 8192, 128)  # the attention bench's B, H, T, Dh
MR_BENCH_ITERS = 3
MR_TIMEOUT_S = 300  # a collective that waits on a dead peer fails then
MR_DEADLINE_S = 480  # a rank group that outlives this is killed
MR_WAIT_S = 900  # a rank started before the build waits this for its go


def _ranks_setup(inputs, backend: str):
    """A rank's start, while the parent builds the kernels: no TF32 (as
    the single-rank runs it is held against), the process group, and the
    card, cuBLAS, the first optimizer (~6 s: torch.optim's first use
    imports its compiler hooks) and the data axis's collectives warmed by
    a bf16 DLRM step of its own; then it waits for its go file. Returns
    (torch, the mesh, the group's rendezvous s, the start-up s before the
    wait)."""
    t0 = time.perf_counter()
    parent = os.getppid()
    import torch

    import persia_tpu_torch.ctx  # noqa: F401  (the parts' imports, now)
    import persia_tpu_torch.worker.worker  # noqa: F401
    from persia_tpu_torch.distributed import DistributedOption
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel import collectives as coll
    from persia_tpu_torch.parallel.mesh import DATA_AXIS, axis_group
    from persia_tpu_torch.parallel.optim import OptaxAdagrad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    mesh = DistributedOption(backend=backend, device="cuda",
                             timeout=MR_TIMEOUT_S).initialize()
    init_s = time.perf_counter() - t
    model = DLRM(DH_DENSE, DH_SLOTS, embedding_dim=DH_DIM, device="cuda")
    emb = [torch.randn(64, DH_DIM, device="cuda", requires_grad=True)
           for _ in range(DH_SLOTS)]
    model([torch.randn(64, DH_DENSE, device="cuda")], emb).sum().backward()
    OptaxAdagrad(model.parameters(), DH_LR).step()
    x = torch.ones(8 * MR_WORLD, device="cuda")
    data = axis_group(mesh, DATA_AXIS)  # NCCL makes its communicator here
    coll.pmean_([x], data)
    coll.broadcast_([x], 0, data)
    coll.all_gather(x[None], data)
    coll.all_to_all(x, data, 0, 0)
    torch.cuda.synchronize()
    del model, emb, x
    torch.cuda.empty_cache()
    coll.calls.clear()
    warm_s = time.perf_counter() - t0
    end = time.monotonic() + MR_WAIT_S
    while not os.path.exists(inputs["go"]):
        if os.getppid() != parent:
            raise SystemExit("the process that started this rank is gone")
        if time.monotonic() > end:
            raise TimeoutError("chip_smoke never reached multi_rank")
        time.sleep(0.05)
    return torch, mesh, init_s, warm_s


def _ranks_module():
    """``tests/test_torch_ranks.py``, which starts the rank groups."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import test_torch_ranks

    return test_torch_ranks


def mr_hybrid_run(torch, ctx, batches, timed_from=None):
    """Train ``batches``: the losses and, from step ``timed_from`` on,
    samples/s of the global batch by the host clock, synchronized at both
    ends."""
    losses, t = [], None
    with ctx:
        for i, b in enumerate(batches):
            if i == timed_from:
                torch.cuda.synchronize()
                t = time.perf_counter()
            losses.append(ctx.train_step(b)[0])
        torch.cuda.synchronize()
    out = {"losses": [float(x) for x in losses], "ddp": ctx._ddp}
    if t is not None:
        out["samples_per_s"] = (DH_BATCH * (len(batches) - timed_from)
                                / (time.perf_counter() - t))
    if ctx.worker is not None:
        ctx.worker.close()
    return out


def _dense_flat(torch, ctx):
    return torch.cat([p.detach().reshape(-1).float()
                      for p in ctx.model.parameters()])


def _grad_signature(torch, ctx) -> dict:
    """What the last step's reduced dense gradient shows of the reduction
    that made it: how many elements are not bf16 values (0 after the bf16
    reduction) and the most distinct values in one 1024-element bucket
    of the flat gradient (at most 255 after int8_ef's stage-2 codes, one
    scale a bucket)."""
    from persia_tpu_torch.parallel.train import _EF_BUCKET

    g = torch.cat([p.grad.reshape(-1).float()
                   for p in ctx.model.parameters()])
    rows = torch.nn.functional.pad(g, (0, -g.numel() % _EF_BUCKET))
    rows = rows.view(-1, _EF_BUCKET).sort(dim=1).values
    levels = 1 + (rows[:, 1:] != rows[:, :-1]).sum(dim=1)
    return {"not_bf16": int((g != g.bfloat16().float()).sum()),
            "max_levels": int(levels.max())}


def mr_ddp(torch, mesh):
    """(a) bench_hybrid's DLRM on TrainCtx over the (2, 1) mesh in f32,
    bf16 and int8_ef reduction, against one rank on the same batches: on
    rank 0, each run's change of the dense parameters beside one rank's
    (and bf16's and int8_ef's beside f32's); the dense parameters of the
    two ranks compared bit for bit after each run."""
    import torch.distributed as dist

    from persia_tpu_torch.parallel import collectives as coll
    from persia_tpu_torch.workloads.generator import hybrid_bench_batches

    batches = list(hybrid_bench_batches(MR_DDP_STEPS, DH_BATCH,
                                        seed=SEED + 11))
    out, moved = {}, {}
    if dist.get_rank() == 0:
        ctx = dh_ctx(torch, "cuda")
        start = _dense_flat(torch, ctx)
        out["single"] = mr_hybrid_run(torch, ctx, batches, MR_DDP_TIMED_FROM)
        moved["single"] = _dense_flat(torch, ctx) - start
    dist.barrier()
    for mode in (None, "bf16", "int8_ef"):
        ctx = dh_ctx(torch, "cuda", mesh=mesh, grad_reduce_dtype=mode)
        start = _dense_flat(torch, ctx)
        run = mr_hybrid_run(torch, ctx, batches, MR_DDP_TIMED_FROM)
        end = _dense_flat(torch, ctx)
        both = coll.all_gather(end[None], None, 0)
        run["params_equal"] = bool(torch.equal(both[0], both[1]))
        run["grad"] = _grad_signature(torch, ctx)
        moved[str(mode)] = end - start
        out[str(mode)] = run
    if dist.get_rank() == 0:
        ref = moved["single"]
        out["dense"] = {
            "move": float(ref.abs().max()),
            "scale": float(start.abs().max()),
            **{m: float((moved[m] - ref).abs().max())
               for m in ("None", "bf16", "int8_ef")},
            **{f"{m}_vs_f32": float((moved[m] - moved["None"]).abs().max())
               for m in ("bf16", "int8_ef")}}
    return out


def _digest(torch, t):
    """Two int64 sums over a tensor's bits: equal tables give equal
    digests; tables that differ in any bit almost surely do not."""
    bits = t.detach().reshape(-1).view(torch.int32).long()
    w = torch.arange(bits.numel(), device=t.device) % 65521 + 1
    return torch.stack([bits.sum(), (bits * w).sum()])


def mr_device_mode(torch, mesh):
    """(b) bench_device's width over the (2, 1) mesh with an f32 tower:
    each rank pools its half of the batch through K1, the table and tower
    gradients are averaged through gloo; against one rank on the same
    batch under device mode's agreement rule, the tables of the two
    ranks compared by digest."""
    import numpy as np
    import torch.distributed as dist

    from persia_tpu_torch.ops import embedding_bag as eb
    from persia_tpu_torch.parallel import collectives as coll
    from persia_tpu_torch.parallel.device_mode import (
        make_device_mode_trainer,
        synthetic_device_batch,
    )

    rank = dist.get_rank()
    specs, model = device_mode_model(torch, "kernel", torch.float32)
    non_id, ids, label = synthetic_device_batch(
        DM_BATCH, DM_DENSE, specs, DM_AGREE_SFS, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for v in ids.values():
        v[torch.rand(v.shape, generator=gen, device="cuda") < 0.25] = 0

    def steps(step):
        losses, ms = [], []
        for _ in range(MR_DM_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(step(non_id, ids, label)))
            ms.append((time.perf_counter() - t) * 1e3)
        return losses, ms

    out = {}
    if rank == 0:
        _, smodel = device_mode_model(torch, "kernel", torch.float32)
        smodel, _, sstep = make_device_mode_trainer(
            smodel, dm_adagrad, non_id, ids, seed=SEED, device="cuda")
        start = {n: p.detach().clone() for n, p in smodel.named_parameters()
                 if n.endswith(".table")}
        out["single_losses"], out["single_ms"] = steps(sstep)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, _, step = make_device_mode_trainer(model, dm_adagrad, non_id, ids,
                                              seed=SEED, device="cuda",
                                              mesh=mesh)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t
    eb.reset_launch_count()
    out["losses"], out["ms"] = steps(step)
    out["launches"] = eb.launch_count()
    out["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    digest = torch.stack([_digest(torch, p) for n, p in
                          model.named_parameters() if n.endswith(".table")])
    both = coll.all_gather(digest[None], None, 0)
    out["tables_equal"] = bool(torch.equal(both[0], both[1]))
    if rank == 0:
        with torch.inference_mode():
            preds = [m.eval()(non_id, ids) for m in (model, smodel)]
        plain = dict(smodel.named_parameters())
        table_err = table_move = 0.0
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in start:
                    moved = plain[n] - start[n]
                    table_err = max(table_err, float(
                        ((p - start[n]) - moved).abs().max()))
                    table_move = max(table_move, float(moved.abs().max()))
        losses, single = np.array(out["losses"]), np.array(
            out["single_losses"])
        out["agree"] = {
            "loss_err": float(np.abs(losses - single).max()),
            "loss_move": float(np.abs(single - single[0]).max()),
            "pred_err": float((preds[0] - preds[1]).abs().max()),
            "table_err": table_err, "table_move": table_move}
        del smodel, sstep, start, plain, preds
    del model, step
    torch.cuda.empty_cache()
    return out


def mr_bench_shape(torch, mesh):
    """One Ulysses forward and backward at the attention bench's shape
    (causal, bf16) over the sequence axis, against K2-K4 on this rank
    alone; host ms of each, synchronized at both ends."""
    from persia_tpu_torch.ops.flash_attention import flash_attention_masked
    from persia_tpu_torch.parallel.ulysses import ulysses_self_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, k, v, do = (torch.randn(MR_BENCH_SHAPE, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))

    def run(fn):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*x)
        out.backward(do)
        return [out.detach()] + [t.grad for t in x]

    def ulysses(*x):
        return ulysses_self_attention(*x, mesh, causal=True, impl="flash")

    def single(*x):
        return flash_attention_masked(*x, causal=True)

    def timed(fn):
        ms = []
        for _ in range(MR_BENCH_ITERS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = run(fn)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return got, ms

    run(ulysses)  # warm-up
    got, ms = timed(ulysses)
    want, single_ms = timed(single)
    errs, bad = [], False
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        errs.append(float(err.max()))
        bad |= bool((err > KERNEL_ATOL + KERNEL_RTOL * w.float().abs()).any()
                    ) or not bool(torch.isfinite(g.float()).all())
    return {"ms": ms, "single_ms": single_ms, "max_abs_err": errs,
            "ok": not bad}


def mr_context_parallel(torch, mesh):
    """(c) the seq_rec tower over the (1, 2) mesh: Ulysses with the flash
    kernels and the ring, 3 f32 steps against the single-rank flash tower
    from the same weights and fresh PS rows; then bf16 Ulysses steps, K2,
    K3 and K4's main path over the mesh; then the bench shape."""
    import torch.distributed as dist

    from persia_tpu_torch.config import CommonConfig, GlobalConfig
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.workloads.generator import (
        SeqRecSpec,
        seqrec_batches,
    )

    schema = build_schema()
    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    f32 = GlobalConfig(CommonConfig("f32"))
    batches = list(seqrec_batches(MR_CP_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                                  seed=TRAIN_SEED, spec=spec))
    agree = batches[:MR_CP_AGREE_STEPS]
    single = build_tower(spec.num_dense, "flash", compute_dtype=torch.float32)
    state = {k: v.clone() for k, v in single.state_dict().items()}
    out, runs = {}, {}
    if dist.get_rank() == 0:
        runs["single"] = seq_run(train_ctx(torch, schema, single, f32),
                                    agree)
    dist.barrier()
    for strategy, impl in (("ulysses", "flash"), ("ring", "reference")):
        tower = build_tower(spec.num_dense, impl, state_dict=state,
                            compute_dtype=torch.float32, mesh=mesh,
                            context_parallel=strategy)
        runs[strategy] = seq_run(
            train_ctx(torch, schema, tower, f32, mesh=mesh), agree)
    if dist.get_rank() == 0:
        out["agree"] = {s: run_errors(runs[s], runs["single"])
                        for s in ("ulysses", "ring")}
    tower = build_tower(spec.num_dense, "flash", state_dict=state, mesh=mesh,
                        context_parallel="ulysses")
    ctx = train_ctx(torch, schema, tower, mesh=mesh)
    fa.reset_launch_count()
    with ctx:
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = [ctx.train_step(b)[0] for b in batches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    out["launches"] = {n: fa.launch_count(n) for n in FLASH_KERNELS}
    if ctx.worker is not None:
        ctx.worker.close()
    out["bf16_losses"] = [float(x) for x in losses]
    out["bf16_samples_per_s"] = TRAIN_BATCH * len(batches) / wall
    out["bench"] = mr_bench_shape(torch, mesh)
    return out


def mr_gloo_body(inputs):
    """The rank body of the two gloo ranks: (a), (b), (c)."""
    import torch.distributed as dist

    from persia_tpu_torch.parallel import collectives as coll
    from persia_tpu_torch.parallel.mesh import make_mesh

    torch, mesh, init_s, warm_s = _ranks_setup(inputs, "gloo")
    out = {"rank": dist.get_rank(), "init_s": init_s, "warm_s": warm_s}
    for part, fn in (("a", mr_ddp), ("b", mr_device_mode)):
        t = time.perf_counter()
        out[part] = fn(torch, mesh)
        out[part]["wall_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["c"] = mr_context_parallel(torch,
                                   make_mesh((1, MR_WORLD), device="cuda"))
    out["c"]["wall_s"] = time.perf_counter() - t
    out["calls"] = dict(coll.calls)
    dist.destroy_process_group()
    return out


def mr_nccl_body(inputs):
    """(d) a world of one rank over NCCL: once the gloo ranks are done
    (its go file), f32 and int8_ef DDP steps of (a)'s model; which
    collectives ran on which backend."""
    import torch.distributed as dist

    from persia_tpu_torch.parallel import collectives as coll
    from persia_tpu_torch.workloads.generator import hybrid_bench_batches

    torch, mesh, _, _ = _ranks_setup(inputs, "nccl")
    batches = list(hybrid_bench_batches(MR_NCCL_STEPS, DH_BATCH,
                                        seed=SEED + 12))
    out = {"backend": str(dist.get_backend()),
           "world": dist.get_world_size()}
    for mode in (None, "int8_ef"):
        out[str(mode)] = mr_hybrid_run(
            torch, dh_ctx(torch, "cuda", mesh=mesh,
                          grad_reduce_dtype=mode), batches)
    out["calls"] = dict(coll.calls)
    dist.destroy_process_group()
    return out


RANK_BODIES = {"mr_gloo": mr_gloo_body, "mr_nccl": mr_nccl_body}


def _close(name, got, want, tol, last=None):
    import numpy as np

    got, want = np.asarray(got[-last:] if last else got), np.asarray(
        want[-last:] if last else want)
    err = float(np.abs(got - want).max())
    if not (np.isfinite(got).all()
            and np.allclose(got, want, rtol=tol, atol=tol)):
        raise AssertionError(f"multi_rank: {name} off by {err:.3e} "
                             f"(rtol = atol = {tol})")
    return err


def check_ddp(a, card: str):
    """(a)'s gates and line, over each gloo rank's results: the ranks
    agree, the loss gates of tests/test_models_parallel.py:235-255, each
    run's dense-parameter change against one rank's, and the gradient of
    each reduction carrying its mark."""
    single = a[0]["single"]
    runs = {m: a[0][m] for m in ("None", "bf16", "int8_ef")}
    for r in a[1:]:
        for m in runs:
            if r[m]["losses"] != runs[m]["losses"]:
                raise AssertionError(f"multi_rank (a) {m}: the ranks' "
                                     f"averaged losses differ")
    if not all(r[m]["params_equal"] and r[m]["ddp"] for r in a
               for m in runs):
        raise AssertionError("multi_rank (a): a run left the DDP path or "
                             "the ranks' dense parameters differ")
    errs = [_close("(a) f32 against one rank", runs["None"]["losses"],
                   single["losses"], MR_F32_TOL),
            _close("(a) bf16 against f32", runs["bf16"]["losses"],
                   runs["None"]["losses"], MR_BF16_TOL),
            _close("(a) int8_ef against f32, last 4",
                   runs["int8_ef"]["losses"], runs["None"]["losses"],
                   MR_EF_TOL, last=4)]
    dense = a[0]["dense"]
    param_lim = (MR_PARAM_ULPS * dense["scale"]
                 + MR_PARAM_RTOL * dense["move"])
    sig = {m: runs[m]["grad"] for m in runs}
    _log(f"[multi_rank] (a) DLRM(embedding_dim={DH_DIM}) {DH_SLOTS} slots, "
         f"{N_PS} x make_holder({DH_PS_CAPACITY}, {DH_PS_SHARDS}) on the "
         f"leader, global batch {DH_BATCH} ({DH_BATCH // MR_WORLD} a rank), "
         f"{MR_DDP_STEPS} steps of fresh signs: samples/s over steps "
         f"{MR_DDP_TIMED_FROM}-{MR_DDP_STEPS - 1}: one rank "
         f"{single['samples_per_s']:.1f}, DDP f32 "
         f"{runs['None']['samples_per_s']:.1f} ("
         f"{runs['None']['samples_per_s'] / single['samples_per_s']:.3f}x), "
         f"bf16 {runs['bf16']['samples_per_s']:.1f}, int8_ef "
         f"{runs['int8_ef']['samples_per_s']:.1f}; loss max_abs_err f32 vs "
         f"one rank {errs[0]:.3e} (tol {MR_F32_TOL}), bf16 vs f32 "
         f"{errs[1]:.3e} (tol {MR_BF16_TOL}), int8_ef vs f32 last 4 "
         f"{errs[2]:.3e} (tol {MR_EF_TOL}); dense parameters bit-equal on "
         f"both ranks after every run; dense change max_abs_err against "
         f"one rank's (largest change {dense['move']:.3e}, limit "
         f"{param_lim:.3e}): f32 {dense['None']:.3e}, bf16 "
         f"{dense['bf16']:.3e}, int8_ef {dense['int8_ef']:.3e}; against "
         f"f32's: bf16 {dense['bf16_vs_f32']:.3e}, int8_ef "
         f"{dense['int8_ef_vs_f32']:.3e}; last reduced gradient, elements "
         f"not bf16 / most values in a 1024 bucket: "
         f"{', '.join(f'{m} {g['not_bf16']} / {g['max_levels']}' for m, g in sig.items())}"
         f"; losses f32 "
         f"{' '.join(f'{x:.5f}' for x in runs['None']['losses'][-3:])} "
         f"(last 3) | card: {card}")
    if not (dense["move"] > 2 * param_lim
            and all(dense[m] <= param_lim for m in runs)):
        raise AssertionError("multi_rank (a): a DDP run's dense-parameter "
                             "change disagrees with one rank's, or the "
                             "parameters did not move")
    if not (dense["bf16_vs_f32"] > 0 and dense["int8_ef_vs_f32"] > 0
            and sig["None"]["not_bf16"] > 0 and sig["bf16"]["not_bf16"] == 0
            and sig["None"]["max_levels"] > 255
            and sig["int8_ef"]["max_levels"] <= 255):
        raise AssertionError("multi_rank (a): the bf16 or int8_ef run did "
                             "not reduce as asked (its gradients read as "
                             "f32's)")


class MultiRankProcs:
    """The multi_rank phase's processes, two gloo ranks and a world of one
    NCCL rank, started once before the kernel build so that their
    start-up overlaps it; each waits for its go file. :meth:`stop` kills
    whatever still runs."""

    def __init__(self):
        import tempfile
        from pathlib import Path

        self.launch = _ranks_module()
        self._tmp = tempfile.TemporaryDirectory()
        self.gdir, self.ndir = Path(self._tmp.name, "gloo"), Path(
            self._tmp.name, "nccl")
        self.gdir.mkdir()
        self.ndir.mkdir()
        script = os.path.abspath(__file__)
        self.gloo = self.launch.start_ranks(
            script, "mr_gloo", MR_WORLD, {"go": str(self.gdir / "go")},
            self.gdir)
        self.nccl = self.launch.start_ranks(
            script, "mr_nccl", 1, {"go": str(self.ndir / "go")}, self.ndir)

    def run(self):
        """The gloo ranks' results, then the NCCL rank's, and the NCCL
        rank's seconds after the gloo ranks ended."""
        (self.gdir / "go").touch()
        ranks = self.launch.collect(self.gloo, self.gdir, MR_DEADLINE_S)
        (self.ndir / "go").touch()
        t = time.perf_counter()
        (solo,) = self.launch.collect(self.nccl, self.ndir, MR_DEADLINE_S)
        return ranks, solo, time.perf_counter() - t

    def stop(self):
        self.gloo.kill()
        self.nccl.kill()
        self._tmp.cleanup()


def multi_rank_phase(torch, card: str, procs: MultiRankProcs) -> dict:
    """Lets the ranks of ``procs`` run (a)-(d), holds them to their gates
    and prints them. Returns each kernel's launches on each rank's main
    path."""
    import numpy as np

    t0 = time.perf_counter()
    ranks, solo, solo_s = procs.run()
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    staged = sum(r["calls"].get("ppermute/gloo-host", 0) for r in ranks)
    _log(f"[multi_rank] {MR_WORLD} ranks over gloo on one card (not the "
         f"transport of a multi-card job) and one NCCL rank, started once "
         f"before the build (start-up, warmed by a DLRM step, "
         f"{r0['warm_s']:.1f}s on rank 0): phase {wall:.1f}s, rank init "
         f"{r0['init_s']:.1f}s, parts a/b/c "
         f"{r0['a']['wall_s']:.1f}/{r0['b']['wall_s']:.1f}/"
         f"{r0['c']['wall_s']:.1f}s, (d) after them {solo_s:.1f}s; gloo's point-to-point ring shifts of "
         f"device tensors staged through host memory "
         f"(collectives._p2p_exchange): {staged}; collectives by backend, "
         f"rank 0: {r0['calls']} | card: {card}")

    check_ddp([r["a"] for r in ranks], card)

    # (b)
    b = [r["b"] for r in ranks]
    ag = b[0]["agree"]
    loss_lim = DM_LOSS_MOVE_RTOL * ag["loss_move"]
    table_lim = DM_TABLE_ULPS_ATOL + DM_TABLE_MOVE_RTOL * ag["table_move"]
    _log(f"[multi_rank] (b) device mode {DM_SLOTS} x {DM_VOCAB} x {DM_DIM} "
         f"tables replicated on {MR_WORLD} ranks, f32 tower, batch "
         f"{DM_BATCH} ({DM_BATCH // MR_WORLD} a rank, {DM_AGREE_SFS} ids a "
         f"slot), {MR_DM_STEPS} steps: step ms rank 0 "
         f"{' '.join(f'{x:.1f}' for x in b[0]['ms'])}, rank 1 "
         f"{' '.join(f'{x:.1f}' for x in b[1]['ms'])} (the gradients' "
         f"all-reduce through gloo inside), one rank "
         f"{' '.join(f'{x:.2f}' for x in b[0]['single_ms'])}; setup "
         f"{b[0]['setup_s']:.2f}s; max_memory_allocated "
         f"{' / '.join(f'{r['max_memory_gb']:.3f}' for r in b)} GB; "
         f"against one rank: loss max_abs_err {ag['loss_err']:.3e} (limit "
         f"{loss_lim:.3e}) pred {ag['pred_err']:.3e} (atol {DM_PRED_ATOL}) "
         f"table change {ag['table_err']:.3e} (limit {table_lim:.3e}); K1 "
         f"launches {[r['launches'] for r in b]} in {MR_DM_STEPS} steps; "
         f"tables bit-equal on both ranks: "
         f"{all(r['tables_equal'] for r in b)} | card: {card}")
    if not (np.isfinite([x for r in b for x in r["losses"]]).all()
            and ag["loss_move"] > 2 * loss_lim
            and ag["table_move"] > 2 * table_lim
            and ag["loss_err"] <= loss_lim and ag["pred_err"] <= DM_PRED_ATOL
            and ag["table_err"] <= table_lim):
        raise AssertionError("multi_rank (b): device mode over the data "
                             "axis disagrees with one rank")
    if not all(r["tables_equal"] for r in b):
        raise AssertionError("multi_rank (b): the ranks' tables differ")
    if any(r["launches"] != MR_DM_STEPS for r in b):
        raise AssertionError("multi_rank (b): K1 did not launch once a "
                             "step on every rank")

    # (c)
    c = [r["c"] for r in ranks]
    agree = c[0]["agree"]
    bench = [r["bench"] for r in c]
    _log(f"[multi_rank] (c) SequenceTower(num_heads={HEADS}) dim {DIM}, "
         f"t_hist {T_HIST}, MLP {MLP} over make_mesh((1, {MR_WORLD})), batch "
         f"{TRAIN_BATCH}: {MR_CP_AGREE_STEPS} f32 steps against the "
         f"single-rank flash tower, loss / pred max_abs_err and grad "
         f"max err / max |grad|: ulysses+flash "
         f"{' '.join(f'{x:.3e}' for x in agree['ulysses'])}, ring "
         f"{' '.join(f'{x:.3e}' for x in agree['ring'])} (atol "
         f"{TRAIN_ATOL}, rtol {TRAIN_GRAD_RTOL}); {MR_CP_STEPS} bf16 "
         f"ulysses+flash steps {c[0]['bf16_samples_per_s']:.1f} samples/s, "
         f"K2/K3/K4 launches by rank "
         f"{[[r['launches'][n] for n in FLASH_KERNELS] for r in c]} | card: "
         f"{card}")
    _log(f"[multi_rank] (c) bench shape B,H,T,Dh={MR_BENCH_SHAPE} causal "
         f"bf16: ulysses fwd+bwd over {MR_WORLD} ranks, host ms (synchronized"
         f") rank 0 {' '.join(f'{x:.2f}' for x in bench[0]['ms'])}, rank 1 "
         f"{' '.join(f'{x:.2f}' for x in bench[1]['ms'])}; K2-K4 on one rank "
         f"{' '.join(f'{x:.2f}' for x in bench[0]['single_ms'])}; max_abs_err "
         f"(out, dq, dk, dv) {[[round(e, 5) for e in r['max_abs_err']] for r in bench]}"
         f" (atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}) | card: {card}")
    for s, (le, pe, ge) in agree.items():
        if not (le <= TRAIN_ATOL and pe <= TRAIN_ATOL
                and ge <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"multi_rank (c): the {s} tower disagrees "
                                 f"with the single-rank flash tower")
    if not np.isfinite([x for r in c for x in r["bf16_losses"]]).all():
        raise AssertionError("multi_rank (c): a bf16 loss is not finite")
    if not all(r["ok"] for r in bench):
        raise AssertionError("multi_rank (c): Ulysses at the bench shape "
                             "disagrees with K2-K4 on one rank")
    if any(r["launches"][n] != MR_CP_STEPS for r in c for n in FLASH_KERNELS):
        raise AssertionError("multi_rank (c): K2, K3 and K4 did not each "
                             "launch once a step on every rank")

    # (d)
    need = {"all_reduce", "all_to_all", "all_gather", "broadcast"}
    taken = {k.split("/")[0] for k in solo["calls"] if k.endswith("/nccl")}
    _log(f"[multi_rank] (d) a world of {solo['world']} over "
         f"{solo['backend']}: (a)'s model, {MR_NCCL_STEPS} steps f32 "
         f"losses {' '.join(f'{x:.5f}' for x in solo['None']['losses'])}, "
         f"int8_ef {' '.join(f'{x:.5f}' for x in solo['int8_ef']['losses'])}"
         f"; collectives {solo['calls']} (no rate is claimed for NCCL here)"
         f" | card: {card}")
    if not (solo["backend"] == "nccl" and solo["world"] == 1
            and need <= taken and solo["None"]["ddp"]
            and solo["int8_ef"]["ddp"]
            and np.isfinite(solo["None"]["losses"]
                            + solo["int8_ef"]["losses"]).all()):
        raise AssertionError("multi_rank (d): the NCCL world did not take "
                             "its collectives or its losses are not finite")
    return {"embedding_bag": [r["launches"] for r in b],
            **{n: [r["launches"][n] for r in c] for n in FLASH_KERNELS}}


class _PhaseClock:
    """Logs each phase's wall time and the run's, for the time budget."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def __call__(self, phase: str):
        now = time.perf_counter()
        _log(f"[time] {phase} {now - self.t:.1f}s (run {now - self.t0:.1f}s)")
        self.t = now


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
    procs = None
    try:
        clock = _PhaseClock()
        card = card_line()
        _log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
             f"python {sys.version.split()[0]}")
        _log(f"[setup] card: {card}")
        procs = MultiRankProcs()
        sources = sorted({s.split("/")[-1][:-3] for s, _ in
                          KERNEL_INFO.values()})
        t0 = time.perf_counter()
        # the native PS library (g++) builds beside the kernels (nvcc)
        from persia_tpu_torch.ps import native
        paths = _build.build(sources, extra_jobs=native.native_jobs())
        native.load_native_lib()
        _log(f"[setup] built {sources} and the native PS library "
             f"{native.native_lib_path().name} in "
             f"{time.perf_counter() - t0:.1f}s; its SIMD path "
             f"{native.native_simd_path()}, os.cpu_count()={os.cpu_count()}")
        report_build(paths, sources)
        clock("setup")
        floor = launch_path_phase(torch, card)
        clock("launch_path")
        records = kernel_phase(torch, card)
        records.update(sparse_kernel_phase(torch, card))
        clock("kernel")
        # early, while this process holds little: the ranks share its
        # card and cores
        torch.cuda.empty_cache()
        for name, n in multi_rank_phase(torch, card, procs).items():
            records[name]["launches_multi_rank"] = n
        clock("multi_rank")
        serving_phase(torch, card)
        clock("serving")
        for name, n in training_phase(torch, card).items():
            records[name]["launches"] = n
        clock("training")
        for name, n in pipelined_phase(torch, card).items():
            records[name]["launches_pipelined"] = n
        clock("pipelined")
        dlrm_hybrid_phase(torch, card)
        clock("dlrm_hybrid")
        cached_launches = dlrm_cached_phase(torch, card)
        clock("dlrm_cached")
        zoo_phase(torch, card)
        clock("zoo")
        adult_income_phase(torch, card)
        clock("adult_income")
        criteo_towers_phase(torch, card)
        clock("criteo_towers")
        for name, n in snapshot_resume_phase(torch, card).items():
            records[name]["launches_snapshot_resume"] = n
        clock("snapshot_resume")
        native_ratio = (RATES["pipelined native"]
                        / RATES["synchronous native"])
        arena_ratio = RATES[PIPE_AB_KEY] / RATES[AB_KEY]
        _log("[summary] training samples/s in this call: " + ", ".join(
            f"{k} {v:.1f}" for k, v in RATES.items())
            + f"; pipelined / synchronous: native {native_ratio:.3f}, "
            f"arena {arena_ratio:.3f} | card: {card}")
        records["embedding_bag"]["launches"] = device_mode_phase(torch, card)
        clock("device_mode")
        records["probe_copy"] = probe_phase(torch, card)
        clock("probe")
        for name, n in cached_launches.items():
            records[name]["launches_dlrm_cached"] = n
        k1 = records["embedding_bag"]
        _log("[launch] host us a wrapper call at its main-path shape: K1 "
             f"multi-slot (26 slots) {k1['host_us_per_call']:.3f}, K1 "
             "single-table device-mode / v5e "
             f"{k1['single_table_device-mode']['host_us_per_call']:.3f} / "
             f"{k1['single_table_v5e']['host_us_per_call']:.3f}, " + ", ".join(
                 f"{tag} {records[n]['host_us_per_call']:.3f}"
                 for tag, n in zip(("K2", "K3", "K4"), FLASH_KERNELS))
             + f", K5 {records['probe_copy']['host_us_per_call']:.3f}; the "
             f"launch floor {floor['floor_host_us']:.3f} host us, "
             f"{floor['floor_device_ms']} device ms | card: {card}")
        for r in records.values():
            r["launch_floor_device_ms"] = floor["floor_device_ms"]
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if procs is not None:
            procs.stop()
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:  # a rank of the multi_rank phase
        _ranks_module().rank_main(RANK_BODIES)
    else:
        sys.exit(main())
