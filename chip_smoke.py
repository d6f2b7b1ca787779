#!/usr/bin/env python3
"""Chip smoke run of persia_tpu_torch, the PyTorch / CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and the CUDA toolkit.
It imports only the port, torch and numpy, never JAX or the JAX package.

1. Setup: versions, the card's name and power limit, and the build of
   every kernel of the port from the sources in this checkout, one nvcc
   per source, all started together on a thread while this one builds
   the native PS library from ``native/src/`` with g++ (its SIMD path
   and the host's cores) and then starts the services, supervision,
   online and reshard phases' clusters (their processes load that
   library);
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
   and the old per-slot cost); the same entry under a shard window at
   (b2)'s shape (26 shards of half the rows, 2^19 x 16, of 2^20-row
   tables; B = 4096, 4 ids a slot, ~25% padding; f32 partials) against
   its windowed plain version (bit-equal at the main path's one id a
   slot), timed by CUDA events and the profiler beside its bound (the
   in-shard rows read, the ids, the rows and the output); and its
   single-table entry at device
   mode's shape and at the v5e shape of ``persia_tpu/ops/embedding_bag.py``
   beside ``F.embedding_bag``. Each wrapper's host time a call.
3. Serving phase: two PS shards hold rows for the whole sign space of the
   ``seqrec`` traffic; an ``InferenceServer`` on the card with
   micro-batching and the hot-row cache serves requests from 8 threads as
   PTB2 bytes through ``SequenceTower(attn_impl="flash")`` at the width of
   ``examples/seq_rec/train.py``. Every prediction must be finite and in
   (0, 1) and agree with a second server whose tower uses the dense
   reference attention; K2 must have launched.
   Then ``serving_rpc``, the serving wire: the ``InferenceServer`` as an
   RPC server on the card, reached over loopback sockets by
   ``InferenceClient``s. (a) The same tower, world and 400 requests from
   8 closed-loop clients, one connection each, into a micro-batched
   server (``max_batch_rows=256``, ``cache_rows=100_000``): predictions
   within ``SERVING_ATOL`` of the reference tower, K2 launched and no
   other kernel (counters zeroed just before the clients, read just
   after); then a serialized server's 64 wire replies must equal, bit
   for bit, its in-process ``predict_bytes`` of the same payloads;
   rows/s and p50 / p99 beside the in-process rate of the same run.
   (b) ``bench.py``'s ``bench_infer`` at full width (``DLRM(
   embedding_dim=16)``, 26 single-id slots, 13 dense features, 2 x
   ``make_holder(5_000_000, 8)``, 64 Zipf(1.2) requests of 128 rows
   admitted by training lookups): serialized against micro-batched
   (``max_batch_rows=1024``, ``cache_rows=2_000_000``), every bucket
   warmed, at 1 and 8 clients of 50 requests each (the bench's 300 cut):
   req/s, p50 / p99, the ratio at 8 clients, coalescing, fill and hit
   rate; no kernel may launch. (c) A second variant added over
   ``variant_admin`` from a ``dense.pt`` the phase writes must serve the
   route keys as ``route_bucket`` splits them and equal a solo server of
   its model; a worker whose lookups raise ``ConnectionError`` while
   armed makes the server serve zero rows (counted), and the next clean
   request serves real rows. (d) The sidecar's ``/metrics`` must count
   the requests sent, and ``/healthz?ready=1`` answer 200.
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
   After it, the A/B of the PS holder: the first 30 steps again on the
   Python arena holder (``backend="arena"``) and the first 24 on the
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
   weights in f32, losses and PS rows. After it, the A/B: the first 30
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
     largest element, evictions and write-backs both > 0; (b) 60 steps
     through the 2,000,000-row cache with the bf16 tower (steps 10-44
     timed between two synchronizations, 45-54 split into prepare, h2d,
     the device step and finish, 55-59 profiled) beside the uncached
     synchronous path on the same batches: samples/s and their ratio,
     host ms a step p50/p99, the cache's counters, ``wire_bytes_saved``,
     the busy share, ``torch.cuda.max_memory_allocated``, host CPU by
     thread (the flush thread included); (c) ``lru`` against
     ``hotness`` admission at 131,072 rows over the first 30 batches:
     hit rate, promotions, samples/s;
   - ``zoo``: the registry's ``dlrm``, ``seqrec`` and ``multitask``
     scenarios at full size on ``bench.py``'s e2e stack, 80 steps at
     each bench batch: samples/s, the loss falling, the held-out AUC of
     each task at the scenario's bar;
   - ``adult_income``: ``DNN`` with its two batch norms at
     ``examples/adult_income/train.py``'s widths and optimizers, 300
     steps of batch 256 synchronous and pipelined: AUC above 0.70 on
     both, the running statistics moved from their init;
   - ``criteo_towers``: ``DCNv2``, ``DeepFM`` and ``WideAndDeep`` at the
     criteo example's widths and optimizers, 30 steps of batch 4096 of
     ``criteo_learnable_batches``: every loss finite, the last 10 steps'
     mean below the first 10's, eval predictions in (0, 1).
   - ``criteo_tsv``: the Criteo job on Criteo TSV files, through its
     scripts' own functions. A child process started with the setup writes
     16 × 4096 train and 4 × 4096 test lines with the port's
     ``write_synthetic_tsv`` (seeds 0 and 1), a ``.gz`` copy of the train
     file and the reference-format npz of ``tests/test_e2e_local.py``.
     (a) ``criteo_batches`` reads the plain and the ``.gz`` file twice
     each: every read bit-equal to the first (digests of each batch's
     bytes); ``train.py``'s ``main`` with ``--local --train --test
     --device cuda --model dlrm`` at the job's widths (26 slots of dim 16,
     prefix bit 12, batch 4096, 2 in-process native PS): one step a batch
     of 4096 lines, every loss finite, a finite test AUC (the labels are
     noise: no bar). Printed: the reader's lines/s on the host and the
     steps/s. (b) ``adult_income/train.py``'s ``main_npz`` on the npz at
     batch 256 for 4 epochs on the card: AUC above 0.68. No kernel may
     launch.
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
     ``dlrm`` scenario at full size: 60 steps of batch 2048 straight
     against 30, a snapshot and 30 resumed (the cell's 120 cut); the
     suffix losses and the dense parameters within 1e-5, the held-out AUC
     within 1e-6, and no kernel launched.
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
     the data axis with an f32 tower, 3 steps (5 before (e) came)
     against rank 0 alone under
     device mode's agreement rule; K1 once a step on each rank; the two
     ranks' tables equal (a digest of their bits); step ms and peak
     memory;
   - (b2) the same width with every table row-sharded over
     ``make_mesh((1, 2))``: each rank holds 2^19 rows of each table (the
     model built on the CPU and cut by the trainer before its move, so
     no table sits whole on the card), pools the whole batch through
     windowed K1 into f32 partials and sums them over the model axis
     (``collectives.sum_partials``), 3 steps against the same one-rank
     run under device mode's agreement rule (the tables gathered);
     windowed K1 and the sum once a step on each rank; the two ranks'
     towers bit-equal (digest); step ms, the tables' GB a rank and peak
     memory beside (b)'s;
   - (c) the seq_rec tower over ``make_mesh((1, 2))``: Ulysses with the
     flash kernels and the ring, 3 f32 ``TrainCtx`` steps against the
     single-rank flash tower from the same weights (the training phase's
     1e-4 / 1e-3), then 10 bf16 Ulysses steps in which K2, K3 and K4 each
     launch once a step on every rank; one Ulysses forward and backward
     at the attention bench's shape against K2-K4 on one rank (2e-2),
     each rank's ms;
   - (e) seq_rec at the example's widths (bf16 flash tower) on
     ``TrainCtx(mesh=make_mesh((2, 1)))``, the native PS in the leader's
     process, through the ``DataLoader`` on the mesh (the leader reads
     the dataset; rank 1 is given none and trains the leader's batches):
     (e1) 24 steps (4 lookup workers, staleness 8): every loss finite,
     K2, K3 and K4 once a step on each rank, the ranks' dense parameters
     bit-equal, no permit held at the end; (e2) 10 reproducible
     staleness-1 steps equal 10 synchronous mesh steps bit for bit
     (losses, model and Adam state on each rank, every touched PS row);
     (e3) a collective ``ctx.snapshot`` at step 12 of 24 and a fresh
     ``TrainCtx(mesh=, resume_from=)`` on both ranks running steps 13-24
     from the cursor equal the unbroken run bit for bit (the same three);
     (e4) ``eval_ctx`` of the f32 Ulysses tower over ``make_mesh((1,
     2))`` on 4 held-out batches on every rank, within 1e-4 of the
     single-rank flash tower, K2 once a batch on each rank; (e5) a
     ``StepProfiler`` window of steps 10-12 of (e1) on rank 0: its
     Chrome trace parses and holds exactly 3 ``trainer/train_step``
     ranges and K2, K3 and K4 3 times each (when the card's CUPTI gives
     device events; without them only the ranges are held), with the
     card's busy share of the window and its top kernels printed.
   On the NCCL rank, once the gloo ranks are done: (d) f32 and int8_ef
   DDP steps of (a)'s model, which must take NCCL's all_reduce,
   all_to_all, all_gather and broadcast.
11. ``services`` (after ``dlrm_hybrid``), the service tier as
   processes: two ``ServiceCtx(n_workers=1, n_ps=2)`` clusters, started
   in setup, with global configs written by the port's YAML writer: (a)
   seq_rec at the training phase's widths over ``make_holder(2_000_000,
   8)``-sized PS processes, the first 10 synchronous steps bit-equal to
   an in-process native-PS run from the same weights and batches
   (losses, dense parameters and Adam's state, every touched PS row read
   back through ``PsClient.get_entries``), K2, K3 and K4 once a step and
   K1, K5 never, then 60 synchronous and 60 pipelined steps (4 lookup
   workers, staleness 8) timed over steps 10-59 beside the in-process
   rates of this call, with each process's CPU ms a step; (b)
   ``dlrm_hybrid``'s DLRM over PS processes of ``make_holder(50_000_000,
   16)``'s size: 3 f32 steps bit-equal to the in-process path on the
   card, 40 synchronous and 40 pipelined steps of fresh signs timed over
   steps 10-39, the busy share of 5 profiled steps, no kernel; (c)
   ``InferenceServer(worker_addrs=)`` on (a)'s cluster: 64 serialized
   replies bit-equal to an in-process server whose worker reads the same
   PS processes through ``PsClient`` s, K2 and no other kernel, the
   rows/s and p50 / p99 of 200 requests from 8 clients; (d) no child of
   either cluster among the card's compute apps or with a
   ``/dev/nvidia*`` file open.
12. ``supervision`` (right after setup, so that its clusters are down
   before anything is timed), the supervised job
   (``service/trainer_service.py``, ``ServiceCtx``'s supervisors,
   ``fleet.FlightRecorder``): nine ``ServiceCtx(n_workers=1, n_ps=2)``
   clusters started in setup beside the kernel build, at ``bench.py``'s
   chaos cells' sizes (dim 8, 2 slots, pool 2048, batch 64, 20 steps,
   a snapshot every 4, 0.15 s between steps), the parts run concurrently:
   (a) a supervised trainer on the card (``--device cuda``) SIGKILLed at
   ``mid_step``, ``mid_snapshot`` and ``between_snapshots``: exit 0, one
   recovery for the one kill, a postmortem bundle with a span chain, the
   resume from ``snap_000000`` (behind the torn ``snap_000001`` for
   ``mid_snapshot``), the counting identity exact for every sign, at most
   ``PERSIA_SNAPSHOT_KEEP`` complete snapshots; (b) a torn manifest and
   the fallback to ``snap_000000``, its exact cut restored; (c) a
   supervised worker killed under a driving loop: no confirmed update
   lost, the loss within the declared ambiguity, over-application within
   the failed cycles, a bundle with the worker's health doc; (d) a
   supervised PS killed after a checkpoint: ``Idle`` at a new address,
   its rows the checkpoint's; and one whose training PS dump
   incremental-update packets (``ServiceCtx(ps_inc_dir=)``), killed 4
   steps after the checkpoint: the replacement replays its packets over
   the checkpoint (``--replay-inc-dir``), and every row of the checkpoint
   and of its packets, overlaid in replay order, reads back exactly
   (``tests/test_faults.py:488``); the two ``Idle`` times side by side;
   (e) a group of two trainers (gloo ranks
   sharing the card) and a group of one (NCCL) with the int8-EF dense
   rider on the card every 2 local steps: the shards' union is the
   stream (labeled shipments, the identity over the group), every rider
   loss finite, the ranks' parameters bit-equal after every round, the
   group of one's rounds within 0.08 of its CPU run. The detection,
   respawn and resumed first-step times of each kill are printed; no
   kernel may launch.
13. ``online`` (right after ``supervision``, so that its clusters too are
   down before the timed phases), the train-to-serve loop
   (``inc_update.py``, ``online.py``, the versioned hot-row cache): (a)
   ``bench.py``'s ``bench_online`` at its smoke depth (3 freshness
   rounds): 2 ``PsService`` over sockets with incremental-update dumpers
   (flushed by the phase), 2 x ``make_holder(2_000_000, 8)``, 4 slots,
   ``DLRM(embedding_dim=16)`` on the card, a live training thread; a
   TTL-only server (4 s) against one whose cache is subscribed to the
   packets (TTL 3600 s, a scan every 0.15 s): the subscriber's end-to-end
   lag p99 must be at least 5x smaller, and a scan must add no PS RPC;
   the paired predict p99 inflation is printed beside the bench's 3%
   contract; no kernel. (b) seq_rec at the training phase's widths over
   two ``ServiceCtx(n_workers=1, n_ps=2)`` clusters started in setup: a
   training cluster whose PS dump packets and an infer cluster
   (``job_type: Infer``) whose PS load them; the trainer on the card, 3
   rounds of 4 steps, and an ``InferenceServer(worker_addrs=)`` over the
   infer tier with the trainer's start weights and its cache subscribed:
   a round's probe must change within 20 s of the round's last step, K2-K4
   must launch once a trainer step and K2 on serving; at the end every
   touched row on the infer PS must equal the training PS's bit for bit,
   and every resident cache row its embedding slice.
14. ``reshard`` (right after ``online``, so that its clusters too are
   down before the timed phases), live resharding of the PS tier
   (``routing.py``, ``reshard.py``, the PS's reshard surface, the
   worker's settle loops): (b) seq_rec at the training phase's widths
   over two ``ServiceCtx(n_workers=1, n_ps=2)`` clusters started in setup
   and a third ``PsService`` process beside the first: 16 synchronous
   steps of 256 while a ``ReshardController`` takes the first cluster
   2→3 on a thread from step 4 (writes that meet the freeze bounce with
   ``routing_stale`` and settle), against the same steps on the unbroken
   cluster: losses, dense parameters with Adam's state and every touched
   row (read from its owner under the final table) bit-equal; K2-K4 once
   a step, K1 and K5 never; the worker's, each PS's and the controller's
   routing epochs equal, and a snapshot's manifest carries that epoch.
   (a) ``bench.py``'s ``bench_reshard`` at its smoke depth on the port's
   services (dim 8, 2 slots, batch 256, the counting optimizer): a live
   2→4→3 under two trainer threads with the counting identity exact at
   the new owners, the worker-cycle p99 during the migrations within 25x
   of the quiet p99 (above a 1 s floor), the skew A/B (under Zipf(1.05)
   the hotness-planned table's max-replica share, measured server-side,
   below hash-even's), a uniform-table checkpoint byte-identical to the
   legacy dump; no kernel.
15. ``fleet`` (right after ``reshard``, so that its processes too are
   down before the timed phases), the fleet monitor and SLO engine
   (``fleet.py``, ``slos.py``), the native service binaries and the
   serving CLI, every process started right after setup: (b) seq_rec at
   the training phase's widths, 20 synchronous steps over a
   ``ServiceCtx(n_workers=1, n_ps=2, http_all=True)`` watched by
   ``svc.fleet_monitor`` (the default rules, a scrape every 0.5 s, the
   trainer's sidecar added), PS 1 SIGSTOPped for 4 scrape intervals
   between steps 10 and 11: no rule fires before the stall,
   ``target_down`` on ps1 within 2 intervals with a postmortem bundle
   and cleared after SIGCONT, ``fleet_status`` lists the trainer, the
   worker and both PS up without version skew, ``fleet_history`` has a
   rate of ``ps_lookup_rows_total`` above 0, and losses, dense state and
   every touched row equal, bit for bit, a second cluster's 20 steps with
   no monitor; K2-K4 once a step, K1 and K5 never. (c) ``python -m
   persia_tpu_torch.serving --model dlrm`` on a ``dense.pt`` of seeded
   weights over (b)'s worker (``--max-batch-rows 256 --cache-rows
   100000``, registered with the coordinator): 64 serialized replies
   bit-equal to an in-process server from the same ``dense.pt`` and
   worker, its row up in ``fleet_status``, no kernel; the seconds from its
   spawn to its first reply. (d) seq_rec's slots (the clicks slot summed:
   the C++ worker has no last-k pooling), 10 synchronous steps over
   ``ServiceCtx(native_ps=True, native_worker=True, ps_capacity=2_000_000,
   ps_num_shards=8)`` against the Python services on the same batches:
   losses, dense state and every touched row bit-equal; each tier's
   samples/s. (a) ``bench.py``'s ``bench_fleet`` at batch 512 over the
   port's worker and two PS processes: no PS request added by a
   scrape-only window, a SIGSTOPped PS tripping ``target_down`` within
   2 scrape intervals with a bundle, and the federated views (labels,
   status, one trace_id across the trainer and both PS), in a process of
   its own that loads no torch; the paired interleaved cycle inflation
   (one full re-measure when over 3%) is printed beside the bench's 3%
   contract, not enforced.
   The registry series are read where their phases already run:
   ``services`` (a) scrapes each PS's and the worker's ``/metrics``
   (``ps_lookup_rows_total`` grows by the rows the worker sent,
   ``ps_served_requests_total`` equals the health doc's ``served_rpcs``,
   the worker's stage breakdown is printed); ``dlrm_cached`` (b) reads
   the engine's ``device_cache_*`` series (probes = hits + misses =
   ``stats()``); ``pipelined`` reads ``pipeline_staleness_permits_in_use``
   (0 at rest) and one ``pipeline_gradient_staleness_steps`` observation
   a step.
16. ``orchestration`` (last; every process of it starts with it), the
   launcher, the k8s manifests and operator and
   the autopilot: (a) ``examples/criteo/job.yml`` rendered by the port's
   ``k8s_utils.gen_manifests``, cut to 2 PS, 1 embedding worker, 2 data
   loaders and 1 nnWorker of ``gpu: {count: 1}`` (``PERSIA_MESH`` 2,1,
   ``PERSIA_TRAINER_PROCESSES`` 2, the port's entry scripts), every pod's
   rendered command and env run as a local process (the coordinator's
   address handed over by addr file): the launcher's group of two gloo
   ranks sharing the card trains DLRM on the loaders' learnable batches
   over the remote worker and the dataflow; every process exits 0, the
   ranks together count at least the samples sent, their dense
   parameters agree by digest, the held-out AUC is above 0.60
   (``tests/test_flagship_e2e.py``'s bar), no K1-K5 launch. (b) seq_rec
   at the training phase's widths over a ``ServiceCtx`` of 2 PS, each
   behind its sidecar, watched by ``svc.fleet_monitor``; an enforce-mode
   ``Autopilot`` with ``PsScalePolicy`` (scale-out above 0.30 of the
   fleet's ``ps_lookup_row_rate`` over the first scrapes) and a shadow
   recommend-mode one tick at the same instants and scale the tier 2→3
   mid-run through ``Operator(FakeKubeApi(), reshard_driver=...)`` and a
   ``ReshardController``: exactly that action, the same decisions, the
   journal re-read with its evidence, losses, dense state and every
   touched row bit-equal to an unbroken cluster's run of the same
   batches, K2-K4 once a step. (c) ``bench.py``'s ``bench_autopilot``
   at its smoke depth on the port, in a child that loads no torch:
   scale_out → rebalance → scale_in, each verified improved, no update
   lost, recommend == enforce, the worker p99 through the actions within
   25x of quiet above a 1 s floor. (c) runs first, beside only the
   start-up of (a)'s and (b)'s processes; then (a) beside (b), each one's
   rates under the other's load.
   Last, one line gives every wrapper's host time a call at its
   main-path shape beside the launch floor. A ``[time]`` line follows
   each phase.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without the ``ok`` line.
"""

import json
import math
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
# the example's own pass bar (examples/seq_rec/train.py:166, the port's
# script's AUC_BAR)
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

# the model: the widths of the port's seq_rec example
# (persia_tpu_torch/examples/seq_rec/train.py, its defaults), read from the
# script, whose top imports only the standard library and numpy; without
# the port here they stay None and main() exits 2
try:
    from persia_tpu_torch.examples.seq_rec import train as seq_rec
except ImportError:
    seq_rec = None
SEQ_ARGS = seq_rec.parse_args([]) if seq_rec else None
DIM = seq_rec.DIM if seq_rec else None
HEADS = SEQ_ARGS.heads if seq_rec else None
T_HIST = SEQ_ARGS.t_hist if seq_rec else None
ITEM_VOCAB = SEQ_ARGS.vocab if seq_rec else None
N_PS = SEQ_ARGS.n_ps if seq_rec else None
MLP = seq_rec.MLP if seq_rec else None
REQUEST_ROWS = 32
N_THREADS = 8
REQUESTS_PER_THREAD = 50
SEED = 0
TRAIN_SEED = SEQ_ARGS.seed if seq_rec else None  # the example's --seed
TRAIN_STEPS = SEQ_ARGS.steps if seq_rec else None
TRAIN_BATCH = SEQ_ARGS.batch_size if seq_rec else None
# the A/B runs carry no gate; their depth was cut (from 60 and 100) to pay
# for the multi_rank phase (PERF.md section 4)
AB_STEPS = 30  # synchronous steps on the arena PS holder (the A/B)
LEGACY_STEPS = 24  # synchronous steps on the per-entry PS holder
PIPE_AB_STEPS = 30  # pipelined steps on the arena PS holder
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
DH_STEPS = 50  # each run: [10, 35) timed, [35, 45) split, [45, 50) profiled
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
DC_STEPS = 60  # (b): [10, 45) timed, [45, 55) split, [55, 60) profiled
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
# stack; bench.py --mode e2e runs at least 200 steps each, cut here to pay
# for the fleet (120) and orchestration (80) phases' time (PERF.md §4)
ZOO_STEPS = 80
ZOO_EVAL = 8192
# training / adult_income: examples/adult_income/train.py's widths and
# optimizers; the AUC bar of tests/test_e2e_local.py
AI_DIM = 8
AI_SEED = 42
AI_STEPS = 300
AI_BATCH = 256
AI_EVAL = 4096
AI_BAR = 0.70
# training / criteo_towers: examples/criteo/train.py's widths; 50 steps a
# tower until the orchestration phase came (PERF.md §4)
CT_STEPS = 30
CT_BATCH = 4096
# criteo_tsv: the Criteo job's TSV path at its full width
# (examples/criteo/config: 26 slots of dim 16, feature_index_prefix_bit 12;
# DLRM over 13 dense features; batch 4096; 2 in-process native PS), on
# files write_synthetic_tsv writes from these seeds in a child process
# started with the setup; then adult-income's main_npz on the npz of
# tests/test_e2e_local.py (generate(6144, seed=5)) at its batch, epochs and
# bar
CTSV_BATCH = 4096
CTSV_TRAIN_LINES = 16 * CTSV_BATCH
CTSV_TEST_LINES = 4 * CTSV_BATCH
CTSV_SEEDS = {"train": 0, "test": 1}
CTSV_NPZ_BATCH = 256
CTSV_NPZ_EPOCHS = 4
CTSV_NPZ_BAR = 0.68
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
# 80 steps of its bench batch (the cell's 120, cut when the online phase
# came), resumed at 40, with bench.py's gates
DRILL_STEPS = 60  # 80 until the orchestration phase came (PERF.md §4)
DRILL_EVAL = 2048
DRILL_ATOL = 1e-5  # suffix losses and dense parameters
DRILL_AUC_ATOL = 1e-6

# serving_rpc: (a) the serialized server's wire replies held bit for bit
# to in-process predicts, and (c) the route keys sent to two variants
RPC_EQUAL_REQUESTS = 64
RPC_VARIANT_KEYS = 64
# serving_rpc (b): bench.py's bench_infer configuration (bench.py:5236-5332)
# at its full width, rows = min(4096, 128): 26 single-id slots of dim 16,
# 13 dense features, DLRM(embedding_dim=16), 2 x make_holder(5_000_000, 8),
# 64 Zipf(1.2) requests, 8 clients; each client's warm-up is the bench's
# max(2 x warmup, 4) at its default warmup of 5. Cut: 50 requests a
# client (100 before the online phase came), the bench's default is 300
# (PERF.md section 4).
SI_ROWS = 128
SI_SLOTS = 26
SI_DIM = 16
SI_DENSE = 13
SI_BLOBS = 64
SI_CLIENTS = 8
SI_PER_CLIENT = 50
SI_WARM_PER_CLIENT = 10
SI_PS_CAPACITY = 5_000_000
SI_PS_SHARDS = 8

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


def windowed_slots_check(torch, gen, card: str) -> dict:
    """K1's multi-slot entry under a shard window at (b2)'s shape: 26
    shards of half the rows (2^19 x 16) of a 2^20-row vocab, the
    agreement batch (B = 4096, ``DM_AGREE_SFS`` ids a slot, ~25% padding),
    f32 partials. The second half (lo = 2^19: local row 0 is a real row,
    padding lies outside) against its windowed plain version within
    BAG_ATOL + BAG_RTOL (S > 1), the local rows equal; the first half
    (lo = 0, the padding row inside) at the main path's S = 1 ids
    bit-equal. Timed by CUDA events and the profiler's device ms beside
    its bound (the in-shard rows it reads, the ids, the rows and the f32
    output) and its plain version. Returns the record."""
    from persia_tpu_torch.ops import embedding_bag as eb
    from persia_tpu_torch.parallel.device_mode import (
        criteo_like_specs,
        synthetic_device_batch,
    )

    dev = torch.device("cuda")
    n = DM_VOCAB // MR_WORLD
    specs = criteo_like_specs(DM_SLOTS, DM_VOCAB, DM_DIM)
    shards = [torch.randn((n, DM_DIM), generator=gen, device=dev)
              for _ in specs]
    _, ids4, _ = dm_agree_batch(torch, specs)
    ids = [ids4[name] for name, _, _ in specs]
    _, ids1, _ = synthetic_device_batch(DM_BATCH, DM_DENSE, specs,
                                        seed=SEED, device=dev)
    err = 0.0
    for lo, slot_ids in ((0, [ids1[name] for name, _, _ in specs]),
                         (n, ids)):
        wins = [(lo, DM_VOCAB)] * DM_SLOTS
        got, rows = eb.embedding_bag_slots_fwd(shards, slot_ids,
                                               torch.float32, wins)
        want, want_rows = eb.embedding_bag_slots_reference(
            shards, slot_ids, torch.float32, wins)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        same = torch.equal(got, want) if lo == 0 else not bool(
            ((got - want).abs() > BAG_ATOL + BAG_RTOL * want.abs()).any())
        if not (same and torch.equal(rows, want_rows)
                and bool((rows == -1).any())):
            raise AssertionError(
                f"K1 windowed (lo={lo}, n={n}): kernel disagrees with its "
                f"plain version (max abs err {e:.3e}, rows equal "
                f"{torch.equal(rows, want_rows)})")
        err = max(err, e)
    wins = [(n, DM_VOCAB)] * DM_SLOTS

    def call():
        return eb.embedding_bag_slots_fwd(shards, ids, torch.float32, wins)

    ms = [cuda_ms(torch, call, 200)]
    plain = cuda_ms(torch, lambda: eb.embedding_bag_slots_reference(
        shards, ids, torch.float32, wins), 50)
    ms.append(cuda_ms(torch, call, 200))
    dev_ms = kernel_device_ms(torch, call, "bag_kernel")
    # the in-shard rows this run's ids read, each once; every id read and
    # its local row written (int32); the f32 partial written; 2 FLOP per
    # element of an in-shard row read
    inside = rows >= 0
    distinct = sum(int(torch.unique(r[r >= 0]).numel()) for r in
                   eb.slot_rows(rows, DM_BATCH, [DM_AGREE_SFS] * DM_SLOTS))
    items = int(inside.sum())
    bound = bound_ms(distinct * 4 * DM_DIM + rows.numel() * (4 + 4)
                     + DM_SLOTS * DM_BATCH * DM_DIM * 4,
                     2.0 * items * DM_DIM, PEAK_F32_FLOPS)
    share = "not measured" if dev_ms is None else f"{bound[0] / dev_ms:.4f}"
    _log(f"[kernel] embedding_bag windowed multi-slot, (b2)'s shape "
         f"{DM_SLOTS} shards of {n} x {DM_DIM} (lo={n}) of V={DM_VOCAB}, "
         f"B={DM_BATCH} S={DM_AGREE_SFS} (~25% padding, all outside the "
         f"window), f32 partials: max_abs_err={err:.3e} (atol {BAG_ATOL} + "
         f"rtol {BAG_RTOL}; bit-equal at lo=0 with the S=1 ids) "
         f"kernel_ms={ms[0]:.6f} / {ms[1]:.6f} device_ms_per_launch="
         f"{'not measured' if dev_ms is None else f'{dev_ms:.6f}'} "
         f"bound_ms={bound[0]:.6f} ({bound[1]}, {distinct} distinct in-shard "
         f"rows, {items} of {rows.numel()} ids inside) share_of_bound="
         f"{share} plain_ms={plain:.6f} | card: {card}")
    del shards, ids, ids4, ids1, got, want, rows, want_rows, inside
    torch.cuda.empty_cache()
    return {"shape": f"{DM_SLOTS} shards of {n} x {DM_DIM} (lo={n}) of "
                     f"V={DM_VOCAB}, B={DM_BATCH} S={DM_AGREE_SFS}, f32",
            "ms": min(ms), "device_ms_per_launch": dev_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "plain_ms": plain,
            "max_abs_err": err}


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
    record["windowed"] = windowed_slots_check(torch, gen, card)
    record["max_abs_err"] = max(record["max_abs_err"],
                                record["windowed"]["max_abs_err"])

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


def seq_args(**overrides):
    """The seq_rec script's default arguments, with ``overrides``."""
    import argparse

    return argparse.Namespace(**{**vars(SEQ_ARGS), **overrides})


def build_schema():
    """The seq_rec script's schema (its ``build_schema``)."""
    return seq_rec.build_schema(SEQ_ARGS)


def fresh_worker(schema, backend=None):
    """A worker over ``N_PS`` empty PS shards, each
    ``make_holder(2_000_000, 8)`` as the example builds them (its
    ``build_worker``: the native C++ store); ``backend="arena"`` gives the
    Python arena holder, ``"python-legacy"`` the per-entry holder."""
    return seq_rec.build_worker(SEQ_ARGS, schema, backend=backend)


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
    """The seq_rec script's SequenceTower (its ``build_model``) on the card,
    with seeded weights or a copy of ``state_dict``; context-parallel over
    ``mesh``'s model axis."""
    from persia_tpu_torch.weights import init_params

    model = seq_rec.build_model(
        seq_args(context_parallel=context_parallel), num_dense, mesh=mesh,
        compute_dtype=compute_dtype, attn_impl=attn_impl, device="cuda")
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


def serving_phase(torch, card: str) -> float:
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
    return rows / wall


def kernel_launches() -> dict:
    """Every kernel's launch count (K1-K5) now."""
    from persia_tpu_torch.ops import embedding_bag as eb
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.ops import probe_copy as pc

    counts = {n: fa.launch_count(n) for n in FLASH_KERNELS}
    counts.update(embedding_bag=eb.launch_count(),
                  probe_copy=pc.launch_count())
    return counts


def drive_clients(addr: str, payloads, n_clients: int, per_client: int):
    """``bench.py``'s ``_drive_clients``: ``n_clients`` closed-loop
    ``InferenceClient``s, one thread and one connection each, dial and
    warm one request, then all start together and each sends
    ``per_client`` requests (client ``ci`` sends ``payloads[(ci *
    per_client + k) % len]``). Returns (wall s, per-request latencies in
    s, predictions by payload index)."""
    from persia_tpu_torch.serving import InferenceClient

    lat = [[] for _ in range(n_clients)]
    preds = {}
    errors = []
    start = threading.Barrier(n_clients + 1, timeout=600)

    def run(ci):
        cl = InferenceClient(addr, timeout=600)
        try:
            cl.predict_bytes(payloads[ci % len(payloads)])
            start.wait()
            for k in range(per_client):
                i = (ci * per_client + k) % len(payloads)
                t0 = time.perf_counter()
                preds[i] = cl.predict_bytes(payloads[i])
                lat[ci].append(time.perf_counter() - t0)
        except threading.BrokenBarrierError:
            pass  # another client failed; its error is re-raised below
        except Exception as e:  # re-raised below, fails the run
            errors.append(e)
            start.abort()
        finally:
            cl.close()

    threads = [threading.Thread(target=run, args=(ci,))
               for ci in range(n_clients)]
    for t in threads:
        t.start()
    try:
        start.wait()
    except threading.BrokenBarrierError:
        pass
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("serving_rpc clients did not finish")
    if errors:
        raise errors[0]
    return wall, [x for per in lat for x in per], preds


def lat_line(n: int, wall: float, lat) -> str:
    import numpy as np

    ms = np.asarray(lat) * 1e3
    return (f"req/s={n / wall:.1f} p50_ms={np.percentile(ms, 50):.3f} "
            f"p99_ms={np.percentile(ms, 99):.3f}")


class _FailingLookupWorker:
    """A worker whose lookups raise ``ConnectionError`` while armed (the
    JAX package's ``tests/test_faults.py`` wrapper): the serving tier's
    degraded path."""

    def __init__(self, inner):
        self.inner = inner
        self.schema = inner.schema
        self.failing = False

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def lookup_signs(self, signs, dim):
        if self.failing:
            raise ConnectionError("armed: embedding tier unreachable")
        return self.inner.lookup_signs(signs, dim)

    def lookup_direct(self, feats, training=False):
        if self.failing:
            raise ConnectionError("armed: embedding tier unreachable")
        return self.inner.lookup_direct(feats, training=training)


def si_world(torch):
    """bench_infer's stack: 26 single-id slots of dim 16 over 2 x
    make_holder(5_000_000, 8) with its Adagrad, DLRM(embedding_dim=16)
    with seeded weights on the card, and its 64 requests of 128 rows,
    admitted once by training lookups."""
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.data.batch import PersiaBatch
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.weights import init_params
    from persia_tpu_torch.worker.worker import EmbeddingWorker
    from persia_tpu_torch.workloads.generator import make_infer_requests

    schema = EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{s}" for s in range(SI_SLOTS)], dim=SI_DIM))
    worker = EmbeddingWorker(schema, [
        make_holder(SI_PS_CAPACITY, SI_PS_SHARDS) for _ in range(N_PS)])
    worker.configure_parameter_servers(
        "bounded_uniform", {"lower": -0.01, "upper": 0.01}, 1.0, 10.0)
    worker.register_optimizer({
        "type": "adagrad", "lr": 0.02, "initial_accumulator_value": 0.1,
        "g_square_momentum": 1.0, "vectorwise_shared": False})
    model = init_params(DLRM(SI_DENSE, SI_SLOTS, embedding_dim=SI_DIM,
                             device="cuda"), SEED).eval()
    blobs = make_infer_requests(SI_BLOBS, SI_ROWS, SI_SLOTS, SI_DENSE)
    for blob in blobs:
        worker.lookup_direct(PersiaBatch.from_bytes(blob).id_type_features,
                             training=True)
    return schema, worker, model, blobs


def serving_rpc_phase(torch, card: str, in_process_rows_per_s: float
                      ) -> dict:
    """The serving wire: ``InferenceServer`` as an RPC server on the card,
    reached by ``InferenceClient``s over loopback sockets. (a) the seq_rec
    tower through K2, (b) bench_infer's DLRM configuration, serialized
    against micro-batched, (c) variants and degradation, (d) the
    sidecar. Returns each kernel's launches in (a)."""
    import tempfile
    import urllib.request

    import numpy as np

    from persia_tpu_torch import checkpoint as ckpt
    from persia_tpu_torch.data.batch import PersiaBatch
    from persia_tpu_torch.metrics import parse_exposition
    from persia_tpu_torch.rpc import pack_arrays
    from persia_tpu_torch.serving import InferenceClient, InferenceServer
    from persia_tpu_torch.variants import VariantRegistry
    from persia_tpu_torch.workloads.generator import (make_infer_requests,
                                                      seqrec_batches)

    # (a) seq_rec over the wire: serving_phase's world, tower and requests
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
    server = InferenceServer(model, schema, worker, device="cuda",
                             max_batch_rows=256, cache_rows=100_000)
    server.serve_background()
    try:
        warm_client = InferenceClient(server.addr)
        warm_client.predict_many(warm)
        warm_client.close()
        torch.cuda.synchronize()
        reset_launch_counts()
        wall, lat, preds = drive_clients(server.addr, payloads, N_THREADS,
                                         REQUESTS_PER_THREAD)
        launches = kernel_launches()
        stats = server.stats()
    finally:
        server.stop()
    preds = [preds[i] for i in range(n_req)]
    for p in preds:
        if p.shape != (REQUEST_ROWS, 1) or not np.isfinite(p).all() \
                or not ((p > 0) & (p < 1)).all():
            raise AssertionError(f"serving_rpc (a): bad predictions: shape "
                                 f"{p.shape}, range [{p.min()}, {p.max()}]")
    flash = [launches[n] for n in FLASH_KERNELS]
    if flash[0] <= 0 or any(flash[1:]) or launches["embedding_bag"] \
            or launches["probe_copy"]:
        raise AssertionError(f"serving_rpc (a): the path must launch K2 and "
                             f"no other kernel: {launches}")
    ref_model = build_tower(spec.num_dense, "reference",
                            state_dict=model.state_dict())
    ref_server = InferenceServer(ref_model, schema, worker, device="cuda")
    try:
        ref = ref_server.predict_many(payloads)
    finally:
        ref_server.stop()
    err = max(float(np.abs(a - b).max()) for a, b in zip(preds, ref))
    if not err <= SERVING_ATOL:
        raise AssertionError(f"serving_rpc (a): flash over the wire and the "
                             f"reference tower disagree: max abs err "
                             f"{err:.3e} > {SERVING_ATOL}")
    rows = n_req * REQUEST_ROWS
    _log(f"[serving_rpc] (a) seq_rec over the wire, {N_THREADS} "
         f"InferenceClients x {REQUESTS_PER_THREAD} requests of "
         f"{REQUEST_ROWS} rows, max_batch_rows=256 cache_rows=100000: "
         f"rows_per_s={rows / wall:.1f} (in-process serving phase "
         f"{in_process_rows_per_s:.1f}, ratio "
         f"{rows / wall / in_process_rows_per_s:.3f}) "
         f"{lat_line(n_req, wall, lat)} avg_coalesce="
         f"{stats['avg_coalesce']:.2f} batch_fill_ratio="
         f"{stats['batch_fill_ratio']:.3f} cache_hit_rate="
         f"{stats['cache_hit_rate']:.3f} lookup_p50_ms="
         f"{stats['lookup_p50_ms']:.3f} forward_p50_ms="
         f"{stats['forward_p50_ms']:.3f}; launches {launches} "
         f"({flash[0] / n_req:.3f} K2 a request); against the reference "
         f"tower max_abs_err={err:.3e} (atol {SERVING_ATOL}) | card: {card}")
    # the serialized server: wire replies against in-process predicts
    serial = InferenceServer(model, schema, worker, device="cuda")
    serial.serve_background()
    client = InferenceClient(serial.addr)
    try:
        wire = [bytes(client.client.call("predict", p))
                for p in payloads[:RPC_EQUAL_REQUESTS]]
        local = [pack_arrays({}, [serial.predict_bytes(p)])
                 for p in payloads[:RPC_EQUAL_REQUESTS]]
    finally:
        client.close()
        serial.stop()
    unequal = sum(w != loc for w, loc in zip(wire, local))
    _log(f"[serving_rpc] (a) serialized server: {RPC_EQUAL_REQUESTS} "
         f"replies over the wire against in-process predict_bytes of the "
         f"same payloads: {unequal} differ | card: {card}")
    if unequal:
        raise AssertionError("serving_rpc (a): a wire reply differs from "
                             "the in-process prediction")
    t_a = time.perf_counter() - t0
    _log(f"[time] serving_rpc (a) {t_a:.1f}s")

    # (b) bench_infer's configuration, serialized against micro-batched
    t0 = time.perf_counter()
    schema, worker, model, blobs = si_world(torch)
    reset_launch_counts()
    qps = {}
    configs = [
        ("serialized", dict(max_batch_rows=0, cache_rows=0)),
        ("microbatched", dict(max_batch_rows=SI_ROWS * SI_CLIENTS,
                              max_wait_us=2000, cache_rows=2_000_000,
                              cache_ttl_sec=60.0)),
    ]
    try:
        for name, kw in configs:
            server = InferenceServer(model, schema, worker, device="cuda",
                                     **kw)
            server.serve_background()
            try:
                # every bucket shape first (a b-row request is bucket b),
                # then the coalescing path under concurrency
                warm = InferenceClient(server.addr)
                for b in (server.buckets or (SI_ROWS,)):
                    warm.predict_bytes(make_infer_requests(
                        1, b, SI_SLOTS, SI_DENSE, seed=1000 + b)[0])
                warm.close()
                drive_clients(server.addr, blobs, SI_CLIENTS,
                              SI_WARM_PER_CLIENT)
                for nc in (1, SI_CLIENTS):
                    wall, lat, got = drive_clients(server.addr, blobs, nc,
                                                   SI_PER_CLIENT)
                    qps[(name, nc)] = len(lat) / wall
                    bad = [i for i, p in got.items()
                           if p.shape != (SI_ROWS, 1)
                           or not np.isfinite(p).all()]
                    if bad:
                        raise AssertionError(f"serving_rpc (b): bad "
                                             f"predictions for {bad[:4]}")
                    _log(f"[serving_rpc] (b) {name} clients={nc}: "
                         f"{lat_line(len(lat), wall, lat)} (n={len(lat)}) "
                         f"| card: {card}")
                stats = server.stats()
                _log(f"[serving_rpc] (b) {name}: avg_coalesce="
                     f"{stats['avg_coalesce']:.2f} batch_fill_ratio="
                     f"{stats['batch_fill_ratio']:.3f} cache_hit_rate="
                     f"{stats.get('cache_hit_rate', 0.0):.3f} "
                     f"compiled_buckets={stats['compiled_buckets']} "
                     f"lookup_p50_ms={stats['lookup_p50_ms']:.3f} "
                     f"forward_p50_ms={stats['forward_p50_ms']:.3f} "
                     f"| card: {card}")
            finally:
                server.stop()
        ratio = qps[("microbatched", SI_CLIENTS)] / qps[("serialized",
                                                         SI_CLIENTS)]
        _log(f"[serving_rpc] (b) bench_infer DLRM(embedding_dim={SI_DIM}) "
             f"{SI_SLOTS} slots, {SI_ROWS} rows a request, {SI_PER_CLIENT} "
             f"requests a client: infer_microbatched_qps="
             f"{qps[('microbatched', SI_CLIENTS)]:.1f} vs_baseline "
             f"(micro-batched / serialized at {SI_CLIENTS} clients)="
             f"{ratio:.3f} | card: {card}")
        assert_no_kernel_launched("serving_rpc (b)", card)
        t_b = time.perf_counter() - t0
        _log(f"[time] serving_rpc (b) {t_b:.1f}s")

        # (c) variants and degradation, (d) the sidecar, on (b)'s stack
        t0 = time.perf_counter()
        failing = _FailingLookupWorker(worker)
        server = InferenceServer(model, schema, failing, device="cuda",
                                 cache_rows=100_000, http_port=0,
                                 variant_name="base")
        server.serve_background()
        client = InferenceClient(server.addr)
        sent = 0
        try:
            with tempfile.TemporaryDirectory() as tmp:
                from persia_tpu_torch.models import DLRM
                from persia_tpu_torch.weights import init_params

                donor = init_params(DLRM(SI_DENSE, SI_SLOTS,
                                         embedding_dim=SI_DIM,
                                         device="cuda"), SEED + 1).eval()
                with open(os.path.join(tmp, ckpt.DENSE_FILE), "wb") as f:
                    f.write(ckpt.dense_state_bytes((donor, None)))
                client.variant_admin("add", name="v2", model="dlrm",
                                     dense_checkpoint=tmp,
                                     num_dense=SI_DENSE, weight=1.0)
            keys = [f"user-{i}".encode() for i in range(RPC_VARIANT_KEYS)]
            want = VariantRegistry()
            want.add("base", weight=1.0, default=True)
            want.add("v2", weight=1.0)
            served = []
            for i, k in enumerate(keys):
                pred, v = client.predict_variant(blobs[i % len(blobs)],
                                                 key=k)
                served.append(v)
                if not (np.isfinite(pred).all() and pred.shape == (SI_ROWS,
                                                                   1)):
                    raise AssertionError("serving_rpc (c): bad variant "
                                         "prediction")
            sent += len(keys)
            solo = InferenceServer(donor, schema, worker, device="cuda")
            try:
                v2_ref = solo.predict_bytes(blobs[0])
            finally:
                solo.stop()
            v2_pred, _ = client.predict_variant(blobs[0], variant="v2")
            sent += 1
            split = {n: served.count(n) for n in ("base", "v2")}
            stats = client.stats()
            with urllib.request.urlopen(
                    f"http://{server.http.addr}/variants", timeout=30) as r:
                http_names = sorted(v["name"] for v in json.loads(
                    r.read())["variants"])
            stats_names = sorted(v["name"] for v in stats["variants"])
            _log(f"[serving_rpc] (c) variant v2 added over variant_admin "
                 f"from dense.pt; {len(keys)} route keys split {split} "
                 f"(route_bucket expects {want.expected_split(keys)}); "
                 f"stats and /variants name {stats_names} / {http_names}; "
                 f"v2 against a solo server of its model max_abs_err="
                 f"{float(np.abs(v2_pred - v2_ref).max()):.3e} | card: {card}")
            if served != [want.route(key=k) for k in keys] \
                    or stats_names != ["base", "v2"] \
                    or http_names != ["base", "v2"] \
                    or not np.array_equal(v2_pred, v2_ref):
                raise AssertionError("serving_rpc (c): the variants did not "
                                     "route or serve as route_bucket says")
            client.variant_admin("remove", name="v2")
            # degradation: cached signs, then misses while armed
            prime = blobs[1]
            healthy = client.predict_bytes(prime)
            failing.failing = True
            same = client.predict_bytes(prime)
            fresh = make_infer_requests(1, SI_ROWS, SI_SLOTS, SI_DENSE,
                                        seed=4242, vocab=1 << 30)[0]
            degraded = client.predict_bytes(fresh)
            failing.failing = False
            st_deg = client.stats()
            worker.lookup_direct(PersiaBatch.from_bytes(
                fresh).id_type_features, training=True)
            recovered = client.predict_bytes(fresh)
            sent += 4
            st_rec = client.stats()
            _log(f"[serving_rpc] (c) degraded: armed lookups raise "
                 f"ConnectionError; cached request bit-equal "
                 f"{np.array_equal(healthy, same)}; fresh signs "
                 f"degraded_lookups={st_deg['degraded_lookups']} "
                 f"zero_fallback_rows={st_deg['zero_fallback_rows']}; after "
                 f"disarming, the next request degraded_lookups="
                 f"{st_rec['degraded_lookups']} and differs from the "
                 f"zero-row answer: {not np.array_equal(degraded, recovered)}"
                 f" | card: {card}")
            if not (np.array_equal(healthy, same)
                    and st_deg["degraded_lookups"] >= 1
                    and st_deg["zero_fallback_rows"] >= 1
                    and st_rec["degraded_lookups"]
                    == st_deg["degraded_lookups"]
                    and not np.array_equal(degraded, recovered)
                    and np.isfinite(degraded).all()):
                raise AssertionError("serving_rpc (c): the degraded path "
                                     "did not serve zero rows and recover")
            t_c = time.perf_counter() - t0
            _log(f"[time] serving_rpc (c) {t_c:.1f}s")
            # (d) the sidecar
            with urllib.request.urlopen(f"http://{server.http.addr}/metrics",
                                        timeout=30) as r:
                samples, _ = parse_exposition(r.read().decode())
            scraped = [v for n, lab, v in samples
                       if n == "inference_requests_total"
                       and lab == server._metric_labels]
            with urllib.request.urlopen(
                    f"http://{server.http.addr}/healthz?ready=1",
                    timeout=30) as r:
                health_status = r.status
            _log(f"[serving_rpc] (d) sidecar /metrics "
                 f"inference_requests_total={scraped} ({sent} requests "
                 f"sent), /healthz?ready=1 -> {health_status} | card: {card}")
            if scraped != [float(sent)] or health_status != 200:
                raise AssertionError("serving_rpc (d): the sidecar's count "
                                     "or health is wrong")
        finally:
            client.close()
            server.stop()
    finally:
        worker.close()
    return {n: launches[n] for n in launches}


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
        except (FileNotFoundError, ProcessLookupError):
            continue  # the thread ended meanwhile (ENOENT or ESRCH)
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
              mesh=None, worker=None):
    """The seq_rec example's stack (the script's Adam(1e-3), Adagrad(1e-2),
    rows from U(-0.05, 0.05), 2 fresh shards of make_holder(2_000_000, 8)
    of ``backend``, or ``worker``), the tower's weights as they are."""
    return hybrid_ctx(torch, model, schema,
                      [(seq_rec.PS_CAPACITY, seq_rec.PS_SHARDS)] * N_PS,
                      lambda p: torch.optim.Adam(p, lr=seq_rec.DENSE_LR),
                      seq_rec.SPARSE_LR, seq_rec.EMB_INIT, global_config,
                      seed=None, backend=backend, mesh=mesh, worker=worker)


def hybrid_ctx(torch, model, schema, holders, dense_optimizer, sparse_lr,
               emb_init, global_config=None, loss_fn=None, seed=SEED,
               backend=None, spill_root=None, hotness=None,
               resume_from=None, mesh=None, grad_reduce_dtype=None,
               device_cache_capacity=0, device_cache_admission=None,
               worker=None, profiler=None):
    """A TrainCtx on the model's device over a fresh worker whose PS
    shards are ``make_holder(capacity, shards, backend=backend)`` for each
    ``(capacity, shards)`` of ``holders`` (or over ``worker``, a remote
    one); the tower seeded unless ``seed`` is None. ``spill_root`` arms
    each shard's spill tier in ``<spill_root>/spill_<i>``, ``hotness`` its
    sketches; ``resume_from`` and the device cache's arguments go to the
    TrainCtx, as does ``profiler``. Over a ``mesh`` only its leader builds
    the worker."""
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.parallel.mesh import is_leader
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    if worker is None and (mesh is None or is_leader(mesh)):
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
                    device_cache_admission=device_cache_admission,
                    profiler=profiler)


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

    from persia_tpu_torch.metrics import default_registry

    reg = default_registry()
    staleness_h = reg.histogram("pipeline_gradient_staleness_steps")
    applied0 = staleness_h.count
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
               engine.backward.lost_updates,
               reg.gauge("pipeline_staleness_permits_in_use").value,
               staleness_h.count - applied0)
    engine.shutdown()
    if at_rest != (0, PIPE_STALENESS, 0, 0, n_steps):
        raise AssertionError(f"the pipeline is not at rest after the loop: "
                             f"(staleness, free permits, lost updates, "
                             f"permits in use, staleness observations) = "
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
         f"{PIPE_STALENESS} lost_updates={run['at_rest'][2]}; registry: "
         f"pipeline_staleness_permits_in_use={run['at_rest'][3]}, "
         f"pipeline_gradient_staleness_steps observations="
         f"{run['at_rest'][4]} | card: {card}")
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


def kernel_counts() -> dict:
    """K1-K5's launch counts now."""
    from persia_tpu_torch.ops import embedding_bag as eb
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.ops import probe_copy as pc

    counts = {n: fa.launch_count(n) for n in FLASH_KERNELS}
    counts.update(embedding_bag=eb.launch_count(),
                  probe_copy=pc.launch_count())
    return counts


def assert_no_kernel_launched(phase: str, card: str):
    """Read just after the path: the hybrid towers read PS rows and have
    no attention, so none of K1-K5 may have launched."""
    counts = kernel_counts()
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
           device_cache_capacity=0, device_cache_admission=None,
           worker=None):
    """bench_hybrid's stack: DLRM(embedding_dim=16) over 26 slots and 13
    dense features, OptaxAdagrad(0.02) dense, Adagrad(0.02) sparse at the
    default row init, 2 shards of make_holder(50_000_000, 16) (or
    ``worker``, a remote one); seeded weights, or a copy of
    ``state_dict``; over ``mesh`` the leader holds the PS; bench_cached's
    with ``device_cache_capacity``."""
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
        device_cache_admission=device_cache_admission, worker=worker)


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
    ``DH_STEPS`` steps of fresh signs each: steps [10, 35) timed, [35,
    45) synchronized after each stage, [45, 50) profiled."""
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
    timed, split, prof = (range(10, DH_STEPS - 15),
                          range(DH_STEPS - 15, DH_STEPS - 5),
                          range(DH_STEPS - 5, DH_STEPS))
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
            out["mapper"] = (eng.mapper.hits, eng.mapper.misses)
            out["series"] = cache_series(eng.series_labels)
    out["rows"] = sum(len(h) for h in ctx.worker.ps_clients)
    ctx.worker.close()
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("a dlrm_cached loss is not finite")
    out["losses"] = losses
    out["steps_ms"] = np.asarray(step_s[timed.start:timed.stop]) * 1e3
    out["rate"] = DH_BATCH * len(timed) / out["wall"]
    return out


def cache_series(labels: dict) -> dict:
    """The ``device_cache_*`` series of the engine with ``labels``, read
    from the registry's exposition."""
    from persia_tpu_torch.metrics import default_registry, parse_exposition

    samples, _ = parse_exposition(default_registry().render())
    return {name: v for name, lab, v in samples
            if name.startswith("device_cache_") and lab == labels}


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
    against the uncached one in f32 (single-id, then bags); (b) 60 steps
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
    timed, split, prof = (range(10, DC_STEPS - 15),
                          range(DC_STEPS - 15, DC_STEPS - 5),
                          range(DC_STEPS - 5, DC_STEPS))
    ref = dc_run(torch, batches, 0, timed)
    dc_report(f"(b) uncached synchronous, {what}", ref, card)
    run = dc_run(torch, batches, DC_CAPACITY, timed, split, prof)
    dc_report(f"(b) cached, {DC_CAPACITY} rows, {what}", run, card)
    sp = {k: run["split"][k] / len(split) * 1e3 for k in run["split"]}
    _log(f"[dlrm_cached] (b) cached: step split over steps {split.start}-"
         f"{split.stop - 1}, device synchronized after each stage (ms a "
         f"step): prepare (mapper, miss import, their upload)="
         f"{sp['lookup']:.3f} h2d (dense features, labels)="
         f"{sp['h2d']:.3f} device step={sp['dense']:.3f} "
         f"finish={sp['update']:.3f} | card: {card}")
    report_window("dlrm_cached", f"{len(prof)} cached steps", run["window"],
                  card)
    RATES["dlrm_cached uncached"] = ref["rate"]
    RATES["dlrm_cached cached"] = run["rate"]
    _log(f"[dlrm_cached] (b) cached / uncached samples/s "
         f"{run['rate'] / ref['rate']:.3f}; loss step0={run['losses'][0]:.4f}"
         f" last={run['losses'][-1]:.4f} | card: {card}")
    ser, st = run["series"], run["stats"]
    _log(f"[dlrm_cached] (b) the engine's registry series: "
         + " ".join(f"{k}={int(v)}" for k, v in sorted(ser.items()))
         + f"; the mapper's hits/misses {run['mapper']} | card: {card}")
    probes = ser.get("device_cache_probes_total")
    if not (probes == ser.get("device_cache_hits_total", 0)
            + ser.get("device_cache_misses_total", 0)
            == st["probes"] == st["hits"] + st["misses"]
            == sum(run["mapper"]) and all(
                ser.get(f"device_cache_{k}_total") == st[k]
                for k in ("hits", "misses", "evictions", "promotions",
                          "writeback_rows"))
            and ser.get("device_cache_resident_rows") == st[
                "resident_rows"]):
        raise AssertionError(f"dlrm_cached (b): the device_cache series "
                             f"disagree: {ser} against stats {st}")

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


def criteo_tsv_files_main(out_dir: str) -> int:
    """The child of :class:`CriteoTsvFiles`: the phase's input files,
    written with the port's own writers, and the seconds each took."""
    import gzip

    import numpy as np

    from persia_tpu_torch.examples.adult_income import data_generator as ai
    from persia_tpu_torch.examples.criteo.criteo_data import (
        write_synthetic_tsv,
    )

    took = {}
    for name, lines in (("train", CTSV_TRAIN_LINES),
                        ("test", CTSV_TEST_LINES)):
        t = time.perf_counter()
        write_synthetic_tsv(os.path.join(out_dir, f"{name}.tsv"), lines,
                            seed=CTSV_SEEDS[name])
        took[name] = time.perf_counter() - t
    t = time.perf_counter()
    with open(os.path.join(out_dir, "train.tsv"), "rb") as src, \
            gzip.open(os.path.join(out_dir, "train.tsv.gz"), "wb",
                      compresslevel=1) as dst:
        shutil.copyfileobj(src, dst)
    took["gz"] = time.perf_counter() - t
    # tests/test_e2e_local.py's reference-format file: raw per-column
    # codes, every column starting at 0
    signs, dense, labels = ai.generate(6144, seed=5)
    codes = signs - (np.arange(signs.shape[1], dtype=np.uint64)[None, :]
                     * np.uint64(ai.VOCAB_PER_SLOT))
    np.savez_compressed(
        os.path.join(out_dir, "adult.npz"),
        target=labels.ravel().astype(np.float32), continuous_data=dense,
        categorical_data=codes, categorical_columns=np.array([
            "workclass", "education", "marital_status", "occupation",
            "relationship", "race", "gender", "native_country"]))
    with open(os.path.join(out_dir, "took.json.tmp"), "w") as f:
        json.dump(took, f)
    os.replace(os.path.join(out_dir, "took.json.tmp"),
               os.path.join(out_dir, "took.json"))
    return 0


class CriteoTsvFiles:
    """The phase's files, written by a child process from the setup on
    (the writer draws every field from the generator in turn, ~150 us a
    line on one core), so that the phase itself only reads them."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="criteo_tsv_")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "criteo_tsv_files",
             self.dir])

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def wait(self) -> dict:
        """The files' seconds to write; raises if the writer failed."""
        rc = self.proc.wait(timeout=600)
        waited = time.perf_counter() - self.t0
        if rc != 0:
            raise RuntimeError(f"criteo_tsv: the file writer exited {rc}")
        with open(self.path("took.json")) as f:
            return dict(json.load(f), since_setup=waited)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def tsv_digests(path: str) -> list:
    """Each batch of ``criteo_batches(path, CTSV_BATCH)``: its id and a
    digest of its bytes (labels, dense features, every slot's signs, the
    id and ``requires_grad``)."""
    import hashlib

    from persia_tpu_torch.examples.criteo.criteo_data import criteo_batches

    return [(b.batch_id, hashlib.sha256(b.to_bytes()).hexdigest())
            for b in criteo_batches(path, CTSV_BATCH)]


def criteo_tsv_phase(torch, card: str, files: CriteoTsvFiles) -> dict:
    """(a) the Criteo job's ``--train`` / ``--test`` on the card, (b)
    adult-income's ``main_npz`` (the module docstring); no kernel may
    launch. Returns the kernels' launch counts."""
    import numpy as np

    from persia_tpu_torch.examples.adult_income import train as ai_train
    from persia_tpu_torch.examples.criteo import train as criteo_train

    took = files.wait()
    _log(f"[criteo_tsv] files written by the child process: train "
         f"{CTSV_TRAIN_LINES} lines {took['train']:.1f}s, test "
         f"{CTSV_TEST_LINES} lines {took['test']:.1f}s, gzip "
         f"{took['gz']:.1f}s (ready {took['since_setup']:.1f}s after the "
         f"setup began) | card: {card}")
    reset_launch_counts()
    reads = {}
    for name in ("train.tsv", "train.tsv.gz"):
        for i in range(2):
            t = time.perf_counter()
            reads[name, i] = tsv_digests(files.path(name))
            wall = time.perf_counter() - t
            _log(f"[criteo_tsv] (a) read {i + 1} of {name}: "
                 f"{len(reads[name, i])} batches, "
                 f"{CTSV_TRAIN_LINES / wall:.1f} lines/s on the host | "
                 f"card: {card}")
    first = reads["train.tsv", 0]
    if len(first) != math.ceil(CTSV_TRAIN_LINES / CTSV_BATCH):
        raise AssertionError(f"criteo_tsv: {len(first)} batches")
    for key, got in reads.items():
        if got != first:
            raise AssertionError(f"criteo_tsv: read {key} differs from the "
                                 f"first read of the plain file")
    out = os.path.join(files.dir, "result")
    auc = criteo_train.main([
        "--local", "--train", files.path("train.tsv"), "--test",
        files.path("test.tsv"), "--device", "cuda", "--model", "dlrm",
        "--batch-size", str(CTSV_BATCH), "--samples",
        str(CTSV_TRAIN_LINES), "--test-samples", str(CTSV_TEST_LINES),
        "--result-dir", out])
    with open(os.path.join(out, "rank0.json")) as f:
        run = json.load(f)
    steps = math.ceil(CTSV_TRAIN_LINES / CTSV_BATCH)
    _log(f"[criteo_tsv] (a) train.py --local --train --test --model dlrm "
         f"(26 slots of dim 16, batch {CTSV_BATCH}): {run['steps']} steps, "
         f"{run['steps'] / run['wall_s']:.3f} steps/s "
         f"({run['rows'] / run['wall_s']:.1f} samples/s, the loop's wall "
         f"{run['wall_s']:.2f}s with its DataLoader's parse), loss first "
         f"{run['loss_first']:.5f} last {run['loss_last']:.5f}, test AUC "
         f"on {CTSV_TEST_LINES} lines {auc:.4f} (noise labels: no bar) | "
         f"card: {card}")
    if run["steps"] != steps or run["rows"] != CTSV_TRAIN_LINES:
        raise AssertionError(f"criteo_tsv: {run['steps']} steps of "
                             f"{run['rows']} rows, not {steps} of "
                             f"{CTSV_TRAIN_LINES}")
    if not (np.isfinite(run["loss_first"]) and np.isfinite(run["loss_last"])
            and np.isfinite(auc)):
        raise AssertionError(f"criteo_tsv: a loss or the AUC is not "
                             f"finite: {run}, {auc}")
    t = time.perf_counter()
    npz_auc = ai_train.main_npz(files.path("adult.npz"),
                                files.path("adult.npz"),
                                batch_size=CTSV_NPZ_BATCH,
                                epochs=CTSV_NPZ_EPOCHS, device="cuda")
    _log(f"[criteo_tsv] (b) adult_income main_npz, batch {CTSV_NPZ_BATCH}, "
         f"{CTSV_NPZ_EPOCHS} epochs of 6144 samples: AUC {npz_auc:.4f} "
         f"(bar {CTSV_NPZ_BAR}) in {time.perf_counter() - t:.1f}s | card: "
         f"{card}")
    if not npz_auc > CTSV_NPZ_BAR:
        raise AssertionError(f"criteo_tsv (b): AUC {npz_auc:.4f} is not "
                             f"above {CTSV_NPZ_BAR}")
    return assert_no_kernel_launched("criteo_tsv", card)


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


def device_mode_model(torch, bag_impl: str, compute_dtype,
                      device: str = "cuda"):
    """bench_device's DeviceModeModel(DLRM) on ``device`` (the card, or the
    CPU for a model whose tables the trainer shards before it moves them),
    weights not yet drawn. Returns (slot specs, model)."""
    from persia_tpu_torch.models.dlrm import DLRM
    from persia_tpu_torch.parallel.device_mode import (
        DeviceModeModel,
        criteo_like_specs,
    )

    specs = criteo_like_specs(DM_SLOTS, DM_VOCAB, DM_DIM)
    tower = DLRM(DM_DENSE, DM_SLOTS, embedding_dim=DM_DIM,
                 compute_dtype=compute_dtype, device=device)
    return specs, DeviceModeModel(specs, tower, bag_impl=bag_impl,
                                  device=device)


def dm_agree_batch(torch, specs):
    """The agreement batch of device mode: ``synthetic_device_batch`` at
    bench width with ``DM_AGREE_SFS`` ids a slot, about a quarter of them
    turned to padding, on the card."""
    from persia_tpu_torch.parallel.device_mode import synthetic_device_batch

    non_id, ids, label = synthetic_device_batch(
        DM_BATCH, DM_DENSE, specs, DM_AGREE_SFS, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for v in ids.values():
        v[torch.rand(v.shape, generator=gen, device="cuda") < 0.25] = 0
    return non_id, ids, label


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

    from persia_tpu_torch.parallel.device_mode import make_device_mode_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    specs, kmodel = device_mode_model(torch, "kernel", torch.float32)
    non_id, ids, label = dm_agree_batch(torch, specs)
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
    them: the collection pools its 26 slots in one call; the row-wise
    Adagrad kernel's counter must read one per step too (the 26 tables'
    row gradients in one update). Returns K1's launches."""
    import numpy as np

    from persia_tpu_torch.ops import embedding_bag as eb
    from persia_tpu_torch.ops import rowwise_adagrad as rw
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
    rw.reset_launch_count()
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
    rw_launches = rw.launch_count()
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
         f"({launches / n_steps:.3f} per step), row-wise Adagrad's "
         f"{rw_launches} | card: {card}")
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
    if rw_launches != n_steps:
        raise AssertionError(f"the row-wise Adagrad launched {rw_launches} "
                             f"times in {n_steps} steps, not once per step")
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
MR_DM_STEPS = 3  # 5 before (e) came
MR_CP_AGREE_STEPS = 3
MR_CP_STEPS = 10
MR_NCCL_STEPS = 3
MR_BENCH_SHAPE = (4, 8, 8192, 128)  # the attention bench's B, H, T, Dh
MR_BENCH_ITERS = 3
# (e) seq_rec through the DataLoader on the (2, 1) mesh
MR_PIPE_STEPS = 24  # (e1): 4 lookup workers, staleness 8
MR_PIPE_AGREE_STEPS = 10  # (e2): reproducible, staleness 1, vs synchronous
MR_RESUME_STEPS, MR_RESUME_AT = 24, 12  # (e3): snapshot at 12 of 24
MR_EVAL_BATCHES = 4  # (e4): held-out batches through the CP eval
MR_EVAL_ATOL = 1e-4
MR_PROF_START, MR_PROF_STEPS = 10, 3  # (e5): the window inside (e1)
# K2, K3, K4 in a Chrome trace: the port's kernels' names after their
# namespace (the library's own flash kernels are flash_fwd_kernel ...)
MR_PROF_KERNELS = {"flash_attention_fwd": "::fwd_kernel<",
                   "flash_attention_bwd_dq": "::bwd_dq_kernel<",
                   "flash_attention_bwd_dkv": "::bwd_dkv_kernel<"}
# (f) bench_cached's traffic through the device cache sharded over the two
# ranks, on (2, 1) and (1, 2): 3 f32 steps a mesh against one rank at
# DC_CAPACITY and at a cache a quarter above one batch's distinct signs
# (it evicts from step 2 on); 30 bf16 steps a mesh, timed over 10-29
MR_CACHE_MESHES = ((2, 1), (1, 2))
MR_CACHE_AGREE_STEPS = 3
MR_CACHE_STEPS = 30
MR_CACHE_TIMED_FROM = 10
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


def _dm_agreement(torch, model, smodel, start, losses, single):
    """Device mode's agreement numbers of a mesh run (``model``, its tables
    gathered when sharded) against one rank's (``smodel``, rank 0 only,
    from the same start tables): the loss, the predictions (an eval
    forward on every rank, a collective when the tables are sharded) and
    each table's change. Returns them on rank 0, None elsewhere."""
    import numpy as np

    from persia_tpu_torch.parallel.device_embedding import DeviceEmbeddingBag
    from persia_tpu_torch.weights import gather_table

    with torch.inference_mode():
        pred = model.eval()(*start["batch"])
    tables = {n: gather_table(m) for n, m in model.named_modules()
              if isinstance(m, DeviceEmbeddingBag)}
    if smodel is None:
        return None
    with torch.inference_mode():
        spred = smodel.eval()(*start["batch"])
    plain = dict(smodel.named_parameters())
    table_err = table_move = 0.0
    with torch.no_grad():
        for n, t in tables.items():
            key = n + ".table"
            moved = plain[key] - start["tables"][key]
            table_err = max(table_err, float(
                ((t - start["tables"][key]) - moved).abs().max()))
            table_move = max(table_move, float(moved.abs().max()))
    losses, single = np.array(losses), np.array(single)
    return {"loss_err": float(np.abs(losses - single).max()),
            "loss_move": float(np.abs(single - single[0]).max()),
            "pred_err": float((pred - spred).abs().max()),
            "table_err": table_err, "table_move": table_move}


def mr_device_mode(torch, mesh):
    """(b) bench_device's width over the (2, 1) mesh with an f32 tower:
    each rank pools its half of the batch through K1, the table and tower
    gradients are averaged through gloo; against one rank on the same
    batch under device mode's agreement rule, the tables of the two
    ranks compared by digest. (b2) the same width over make_mesh((1, 2)):
    each rank holds half of every table's rows (built on the CPU, cut by
    the trainer before the move, so no table sits whole on the card),
    pools the whole batch through windowed K1 and sums the f32 partials
    over the model axis; against the same single-rank run, its tables
    gathered; the two ranks' towers compared by digest."""
    import torch.distributed as dist

    from persia_tpu_torch.ops import embedding_bag as eb
    from persia_tpu_torch.parallel import collectives as coll
    from persia_tpu_torch.parallel.device_mode import make_device_mode_trainer
    from persia_tpu_torch.parallel.mesh import make_mesh

    rank = dist.get_rank()
    specs, model = device_mode_model(torch, "kernel", torch.float32)
    batch = dm_agree_batch(torch, specs)

    def steps(step):
        losses, ms = [], []
        for _ in range(MR_DM_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(step(*batch)))
            ms.append((time.perf_counter() - t) * 1e3)
        return losses, ms

    out, smodel, start = {}, None, {"batch": batch[:2]}
    if rank == 0:
        _, smodel = device_mode_model(torch, "kernel", torch.float32)
        smodel, _, sstep = make_device_mode_trainer(
            smodel, dm_adagrad, *batch[:2], seed=SEED, device="cuda")
        start["tables"] = {n: p.detach().clone()
                           for n, p in smodel.named_parameters()
                           if n.endswith(".table")}
        out["single_losses"], out["single_ms"] = steps(sstep)
        del sstep
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, _, step = make_device_mode_trainer(model, dm_adagrad, *batch[:2],
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
    out["agree"] = _dm_agreement(torch, model, smodel, start, out["losses"],
                                 out.get("single_losses"))
    del model, step
    torch.cuda.empty_cache()

    # (b2)
    b2 = out["b2"] = {}
    sharded = make_mesh((1, MR_WORLD), device="cuda")
    _, model = device_mode_model(torch, "kernel", torch.float32, "cpu")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, _, step = make_device_mode_trainer(model, dm_adagrad, *batch[:2],
                                              seed=SEED, device="cuda",
                                              mesh=sharded)
    torch.cuda.synchronize()
    b2["setup_s"] = time.perf_counter() - t
    bag = getattr(model.DeviceEmbeddingCollection_0, f"bag_{specs[0][0]}")
    b2["rows"] = [(bag.window[0], bag.table.shape[0])]
    eb.reset_launch_count()
    sums = coll.calls.copy()
    b2["losses"], b2["ms"] = steps(step)
    b2["launches"] = eb.launch_count()
    b2["sums"] = sum((coll.calls - sums).get(k, 0) for k in coll.calls
                     if k.startswith("sum_partials/"))
    b2["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    b2["table_gb"] = sum(p.numel() * 4 for n, p in model.named_parameters()
                         if n.endswith(".table")) / 1e9
    digest = torch.stack([_digest(torch, p) for n, p in
                          model.named_parameters()
                          if not n.endswith(".table")])
    both = coll.all_gather(digest[None], None, 0)
    b2["towers_equal"] = bool(torch.equal(both[0], both[1]))
    b2["agree"] = _dm_agreement(torch, model, smodel, start, b2["losses"],
                                out.get("single_losses"))
    del model, step, smodel, start
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


def rows_equal(want: dict, got: dict) -> bool:
    """Two ``ps_rows`` maps hold the same rows, bit for bit."""
    import numpy as np

    return set(want) == set(got) and all(
        np.array_equal(want[k].view(np.uint32), got[k].view(np.uint32))
        for k in want)


def trace_summary(path: str) -> dict:
    """A step profiler's Chrome trace: its events, the ``trainer/train_step``
    ranges, the card's kernels by name pattern (``MR_PROF_KERNELS``), the
    card's busy share of the window (the union of its kernels, copies and
    fills over the first step's start to the last event's end), the mean
    device ms of K2-K4 and the 5 kernels with the most time."""
    from collections import Counter

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") == "trainer/train_step"]
    gpu = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in gpu if e["cat"] == "kernel"]
    mine = {k: [float(e["dur"]) for e in kernels if pat in e["name"]]
            for k, pat in MR_PROF_KERNELS.items()}
    out = {"events": len(events), "steps": len(steps),
           "gpu_events": len(gpu),
           "counts": {k: len(v) for k, v in mine.items()},
           "kernel_ms": {k: round(sum(v) / len(v) / 1e3, 6) if v else None
                         for k, v in mine.items()}}
    if not steps or not gpu:
        return out
    t0 = min(float(e["ts"]) for e in steps)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in steps + gpu)
    busy, end = 0.0, t0
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in gpu):
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    by_name = Counter()
    for e in kernels:
        name = e["name"].replace("(anonymous namespace)::", "")
        by_name[name.split("(")[0].replace("void ", "")[:70]] += float(
            e["dur"])
    out.update(window_ms=(t1 - t0) / 1e3, busy_share=busy / (t1 - t0),
               top_ms=[(n, round(us / 1e3, 4))
                       for n, us in by_name.most_common(5)])
    return out


def mr_mesh_pipeline(torch, mesh):
    """(e) seq_rec at the example's widths (bf16 flash tower) over the
    (2, 1) mesh, the native PS in the leader's process: (e1) 24
    ``DataLoader`` steps (4 lookup workers, staleness 8; the other rank's
    dataset is empty: it trains the leader's batches), with (e5) a step
    profiler window of 3 steps on rank 0; (e2) 10 reproducible
    staleness-1 ``DataLoader`` steps against 10 synchronous mesh steps;
    (e3) a collective snapshot at step 12 of 24 and a fresh
    ``TrainCtx(mesh=, resume_from=)`` that runs the other 12 from the
    cursor, against the unbroken run; (e4) ``eval_ctx`` of the f32
    Ulysses tower over (1, 2) on 4 held-out batches against the
    single-rank flash tower on rank 0."""
    import itertools
    import tempfile

    import torch.distributed as dist

    from persia_tpu_torch.config import CommonConfig, GlobalConfig
    from persia_tpu_torch.ctx import eval_ctx
    from persia_tpu_torch.data.dataloader import DataLoader, ResumableDataset
    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.parallel import collectives as coll
    from persia_tpu_torch.parallel.mesh import is_leader, make_mesh
    from persia_tpu_torch.tracing import StepProfiler
    from persia_tpu_torch.workloads.generator import (
        SeqRecSpec,
        seqrec_batches,
    )

    leader = is_leader(mesh)
    schema = build_schema()
    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    state = build_tower(spec.num_dense, "flash").state_dict()
    tmp = tempfile.mkdtemp(prefix="mr_e_")
    out = {}

    def ctx_of(resume_from=None, profiler=None):
        return hybrid_ctx(
            torch, build_tower(spec.num_dense, "flash", state_dict=state),
            schema, [(2_000_000, 8)] * N_PS,
            lambda p: torch.optim.Adam(p, lr=1e-3), 1e-2, (-0.05, 0.05),
            seed=None, mesh=mesh, resume_from=resume_from,
            profiler=profiler)

    def done(ctx, rows=False):
        """The run's dense state, and its PS rows on the leader; the
        leader's worker closed."""
        got = {"dense": dense_state(ctx)}
        if ctx.worker is not None:
            got["rows"] = ps_rows(ctx.worker) if rows else None
            ctx.worker.close()
        return got

    # (e1), (e5)
    batches = list(seqrec_batches(MR_PIPE_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                                  seed=TRAIN_SEED, spec=spec))
    prof = (StepProfiler(os.path.join(tmp, "prof"), MR_PROF_START,
                         MR_PROF_STEPS) if dist.get_rank() == 0 else None)
    ctx = ctx_of(profiler=prof)
    fa.reset_launch_count()
    with ctx:
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = [ctx.train_step(lb)[0]
                  for lb in pipelined_loader(batches if leader else [])]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = {n: fa.launch_count(n) for n in FLASH_KERNELS}
    end = _dense_flat(torch, ctx)
    both = coll.all_gather(end[None], None, 0)
    out["e1"] = {"losses": [float(x) for x in losses], "launches": launches,
                 "params_equal": bool(torch.equal(both[0], both[1])),
                 "samples_per_s": TRAIN_BATCH * len(losses) / wall,
                 "staleness": (ctx.worker.staleness if leader else 0)}
    done(ctx)
    if prof is not None:
        out["e5"] = {"trace": prof.trace_path, **(
            trace_summary(prof.trace_path) if prof.trace_path else {})}

    # (e2)
    agree = batches[:MR_PIPE_AGREE_STEPS]
    runs = {}
    for name in ("synchronous", "pipelined"):
        ctx = ctx_of()
        with ctx:
            src = (pipelined_loader(agree if leader else [],
                                    reproducible=True, staleness=1)
                   if name == "pipelined" else agree)
            runs[name] = [float(ctx.train_step(b)[0]) for b in src]
        runs[name] = {"losses": runs[name], **done(ctx, rows=True)}
    sync, pipe = runs["synchronous"], runs["pipelined"]
    out["e2"] = {"losses_equal": sync["losses"] == pipe["losses"],
                 "dense": first_difference(sync["dense"], pipe["dense"]),
                 "rows": (len(sync["rows"]),
                          rows_equal(sync["rows"], pipe["rows"]))
                 if leader else None}

    # (e3)
    snaps = os.path.join(tmp, "snaps")

    def factory(seed):
        return iter(seqrec_batches(MR_RESUME_STEPS * TRAIN_BATCH,
                                   TRAIN_BATCH, seed=seed, spec=spec))

    def run(ctx, ds, snapshot=False):
        got = {}
        with ctx:
            got["losses"] = [float(ctx.train_step(lb)[0]) for lb in
                             DataLoader(ds, num_workers=PIPE_WORKERS,
                                        reproducible=True,
                                        embedding_staleness=1)]
            if snapshot:
                t = time.perf_counter()
                got["snap"] = ctx.snapshot(
                    snaps, cursor=ds.cursor(len(got["losses"])))
                got["snapshot_ms"] = 1e3 * (time.perf_counter() - t)
        return {**got, **done(ctx, rows=True)}

    seed = TRAIN_SEED + 3
    a = run(ctx_of(), ResumableDataset(factory, seed=seed))
    b = run(ctx_of(), ResumableDataset(
        lambda s: itertools.islice(factory(s), MR_RESUME_AT), seed=seed),
        snapshot=True)
    t = time.perf_counter()
    c_ctx = ctx_of(resume_from=snaps)
    with c_ctx:  # the rollback runs on the first entry
        construct_rollback_ms = 1e3 * (time.perf_counter() - t)
    c = run(c_ctx, ResumableDataset.from_cursor(factory,
                                                c_ctx.resume_cursor))
    out["e3"] = {
        "prefix_equal": b["losses"] == a["losses"][:MR_RESUME_AT],
        "suffix_equal": c["losses"] == a["losses"][MR_RESUME_AT:],
        "dense": first_difference(a["dense"], c["dense"]),
        "rows": (len(a["rows"]), rows_equal(a["rows"], c["rows"]))
        if leader else None,
        "cursor": c_ctx.resume_cursor, "snap": b["snap"],
        "snapshot_ms": b["snapshot_ms"],
        "construct_rollback_ms": construct_rollback_ms}

    # (e4)
    mesh12 = make_mesh((1, MR_WORLD), device="cuda")
    cp_leader = is_leader(mesh12)
    f32 = GlobalConfig(CommonConfig("f32"))
    held = list(seqrec_batches(MR_EVAL_BATCHES * TRAIN_BATCH, TRAIN_BATCH,
                               seed=TRAIN_SEED + 7, spec=spec))
    world = build_world()[1] if cp_leader else None
    single = None
    if cp_leader:
        sctx = train_ctx(torch, schema, build_tower(
            spec.num_dense, "flash", state_dict=state,
            compute_dtype=torch.float32), f32, worker=world)
        with eval_ctx(sctx) as e:
            single = torch.cat([e.forward(x)[0].float() for x in held])
    dist.barrier()
    cctx = train_ctx(torch, schema, build_tower(
        spec.num_dense, "flash", state_dict=state,
        compute_dtype=torch.float32, mesh=mesh12,
        context_parallel="ulysses"), f32, mesh=mesh12, worker=world)
    fa.reset_launch_count()
    with eval_ctx(cctx) as e:
        preds = torch.cat([e.forward(x)[0].float() for x in held])
    eval_launches = {n: fa.launch_count(n) for n in FLASH_KERNELS}
    both = coll.all_gather(preds[None], None, 0)
    out["e4"] = {"launches": eval_launches,
                 "finite": bool(torch.isfinite(preds).all())}
    if cp_leader:
        out["e4"]["max_abs_err"] = [float((p - single).abs().max())
                                    for p in both]
        world.close()
    return out


def mr_cached_run(torch, batches, capacity: int, mesh=None, f32=True,
                  timed_from=None) -> dict:
    """``batches`` through ``dh_ctx`` cached at ``capacity`` rows (over
    ``mesh``, or one rank), f32 tower and wire or bench_cached's bf16
    tower: losses, the leader's touched PS rows after the flush and its
    counters, this rank's block bytes and peak memory, the dense
    parameters' bit-equality over the mesh, and from ``timed_from`` on
    host ms a step and samples/s, synchronized at both ends."""
    import numpy as np

    from persia_tpu_torch.config import CommonConfig, GlobalConfig
    from persia_tpu_torch.parallel import collectives as coll

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx = (dh_ctx(torch, "cuda", torch.float32,
                  GlobalConfig(CommonConfig("f32")), mesh=mesh,
                  device_cache_capacity=capacity) if f32 else
           dh_ctx(torch, "cuda", mesh=mesh, device_cache_capacity=capacity))
    out, losses, step_ms, t = {}, [], [], None
    with ctx:
        for i, b in enumerate(batches):
            if i == timed_from:
                torch.cuda.synchronize()
                t = time.perf_counter()
            t1 = time.perf_counter()
            losses.append(ctx.train_step(b)[0])
            step_ms.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        if t is not None:
            out["samples_per_s"] = (DH_BATCH * (len(batches) - timed_from)
                                    / (time.perf_counter() - t))
            out["step_ms"] = step_ms[timed_from:]
        out["flushed"] = ctx.flush_device_cache()
        eng = ctx._cache_engine
        out["block_bytes"] = eng.cache_vals.nbytes + eng.cache_acc.nbytes
        out["window"] = eng._rows.window
        out["max_mem"] = torch.cuda.max_memory_allocated()
        if eng.leader:
            out["stats"] = eng.stats()
    out["losses"] = [float(x) for x in losses]
    if not np.isfinite(out["losses"]).all():
        raise AssertionError("multi_rank (f): a loss is not finite")
    if mesh is not None:
        flat = _dense_flat(torch, ctx)
        both = coll.all_gather(flat[None], None, 0)
        out["params_equal"] = bool(all(torch.equal(both[0], x)
                                       for x in both[1:]))
    if ctx.worker is not None:
        out["rows"] = touched_rows(ctx.worker, dc_signs(batches))
        ctx.worker.close()
    del ctx, eng
    torch.cuda.empty_cache()
    return out


def mr_cached(torch):
    """(f) bench_cached at full width (DLRM, 26 slots x 16, batch 4096,
    Zipf(1.2) over 2^20 ids a slot, the 2,000,000-row cache) with the
    cache's rows sharded over the two ranks, on make_mesh((2, 1)) and
    make_mesh((1, 2)): f32 agreement with one rank at the full and at a
    small, evicting capacity, then 30 bf16 steps a mesh. Every launch
    count is 0 just before the mesh runs and read just after."""
    import torch.distributed as dist

    from persia_tpu_torch.parallel.mesh import make_mesh
    from persia_tpu_torch.workloads.generator import zipf_bench_batches

    t0 = time.perf_counter()
    batches = list(zipf_bench_batches(MR_CACHE_STEPS, DH_BATCH,
                                      vocab=DC_VOCAB, a=DC_ZIPF_A,
                                      seed=SEED))
    agree = batches[:MR_CACHE_AGREE_STEPS]
    distinct = max(len(dc_signs([b])) for b in agree)
    small = distinct + distinct // 4
    out = {"setup_s": time.perf_counter() - t0, "small": small,
           "distinct": distinct}
    if dist.get_rank() == 0:
        out["one"] = {cap: mr_cached_run(torch, agree, cap)
                      for cap in (DC_CAPACITY, small)}
    dist.barrier()
    meshes = [make_mesh(shape, device="cuda") for shape in MR_CACHE_MESHES]
    reset_launch_counts()
    for shape, mesh in zip(MR_CACHE_MESHES, meshes):
        t = time.perf_counter()
        out[shape] = {
            "agree": mr_cached_run(torch, agree, DC_CAPACITY, mesh),
            "small": mr_cached_run(torch, agree, small, mesh),
            "timed": mr_cached_run(torch, batches, DC_CAPACITY, mesh,
                                   f32=False,
                                   timed_from=MR_CACHE_TIMED_FROM)}
        out[shape]["wall_s"] = time.perf_counter() - t
    out["launches"] = kernel_counts()
    return out


def mr_gloo_body(inputs):
    """The rank body of the two gloo ranks: (a), (b), (c), (e), (f)."""
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
    t = time.perf_counter()
    out["e"] = mr_mesh_pipeline(torch, mesh)
    out["e"]["wall_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["f"] = mr_cached(torch)
    out["f"]["wall_s"] = time.perf_counter() - t
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
    """Lets the ranks of ``procs`` run (a)-(f), holds them to their gates
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
         f"{r0['init_s']:.1f}s, parts a/b/c/e/f "
         f"{r0['a']['wall_s']:.1f}/{r0['b']['wall_s']:.1f}/"
         f"{r0['c']['wall_s']:.1f}/{r0['e']['wall_s']:.1f}/"
         f"{r0['f']['wall_s']:.1f}s, (d) after "
         f"them {solo_s:.1f}s; gloo's point-to-point ring shifts of "
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

    # (b2)
    b2 = [r["b2"] for r in b]
    ag = b2[0]["agree"]
    _log(f"[multi_rank] (b2) device mode {DM_SLOTS} x {DM_VOCAB} x {DM_DIM} "
         f"tables row-sharded over make_mesh((1, {MR_WORLD})) (rank rows "
         f"(lo, n) {[r['rows'][0] for r in b2]}), f32 tower, batch "
         f"{DM_BATCH} on each rank ({DM_AGREE_SFS} ids a slot), "
         f"{MR_DM_STEPS} steps: step ms rank 0 "
         f"{' '.join(f'{x:.1f}' for x in b2[0]['ms'])}, rank 1 "
         f"{' '.join(f'{x:.1f}' for x in b2[1]['ms'])} (the partials' sum "
         f"through gloo inside), (b) beside: rank 0 "
         f"{' '.join(f'{x:.1f}' for x in b[0]['ms'])}; setup "
         f"{b2[0]['setup_s']:.2f}s; tables a rank "
         f"{b2[0]['table_gb']:.3f} GB; max_memory_allocated "
         f"{' / '.join(f'{r['max_memory_gb']:.3f}' for r in b2)} GB "
         f"((b): {' / '.join(f'{r['max_memory_gb']:.3f}' for r in b)} GB; "
         f"rank 0 also holds the one-rank model in both); against one rank: "
         f"loss max_abs_err {ag['loss_err']:.3e} (limit "
         f"{DM_LOSS_MOVE_RTOL * ag['loss_move']:.3e}) pred "
         f"{ag['pred_err']:.3e} (atol {DM_PRED_ATOL}) table change (gathered)"
         f" {ag['table_err']:.3e} (limit "
         f"{DM_TABLE_ULPS_ATOL + DM_TABLE_MOVE_RTOL * ag['table_move']:.3e});"
         f" windowed K1 launches {[r['launches'] for r in b2]} and model-"
         f"axis sums {[r['sums'] for r in b2]} in {MR_DM_STEPS} steps; "
         f"towers bit-equal on both ranks: "
         f"{all(r['towers_equal'] for r in b2)} (no rate is claimed: gloo "
         f"on one card) | card: {card}")
    loss_lim = DM_LOSS_MOVE_RTOL * ag["loss_move"]
    table_lim = DM_TABLE_ULPS_ATOL + DM_TABLE_MOVE_RTOL * ag["table_move"]
    if not (np.isfinite([x for r in b2 for x in r["losses"]]).all()
            and ag["loss_move"] > 2 * loss_lim
            and ag["table_move"] > 2 * table_lim
            and ag["loss_err"] <= loss_lim and ag["pred_err"] <= DM_PRED_ATOL
            and ag["table_err"] <= table_lim):
        raise AssertionError("multi_rank (b2): device mode with tables "
                             "sharded over the model axis disagrees with "
                             "one rank")
    if not all(r["towers_equal"] for r in b2):
        raise AssertionError("multi_rank (b2): the ranks' towers differ")
    if any(r["launches"] != MR_DM_STEPS or r["sums"] != MR_DM_STEPS
           for r in b2):
        raise AssertionError("multi_rank (b2): windowed K1 or the model-"
                             "axis sum did not run once a step on every "
                             "rank")

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

    e = [r["e"] for r in ranks]
    check_mesh_pipeline(e, card)
    f = [r["f"] for r in ranks]
    check_mesh_cache(f, [r["a"] for r in ranks], card)

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
    return {"embedding_bag": {"launches_multi_rank":
                              [r["launches"] for r in b],
                              "launches_mesh_cache":
                              [r["launches"]["embedding_bag"] for r in f],
                              "launches_multi_rank_sharded":
                              [r["launches"] for r in b2]},
            **{n: {"launches_multi_rank": [r["launches"][n] for r in c],
                   "launches_mesh_pipeline": [r["e1"]["launches"][n]
                                              for r in e],
                   "launches_mesh_eval": [r["e4"]["launches"][n]
                                          for r in e],
                   "launches_mesh_cache": [r["launches"][n] for r in f]}
               for n in FLASH_KERNELS}}


def check_mesh_cache(f, a, card: str):
    """(f)'s gates and lines over each gloo rank's results: each mesh's f32
    runs against one rank's within dlrm_cached (a)'s bounds, the small
    cache evicting and writing back, the ranks' losses equal and their
    dense parameters bit-equal, no kernel launched; the rates and memory
    printed beside (a)'s and one rank's, no gate."""
    import numpy as np

    one = f[0]["one"]
    for shape in MR_CACHE_MESHES:
        runs = [r[shape] for r in f]
        errs = {}
        for kind, cap in (("agree", DC_CAPACITY), ("small", f[0]["small"])):
            got, ref = runs[0][kind], one[cap]
            (rf, rr), (cf, cr) = ref["rows"], got["rows"]
            errs[kind] = (
                max(abs(x - y) for x, y in zip(got["losses"],
                                                ref["losses"])),
                float(np.abs(cr - rr).max()) / float(np.abs(rr).max()))
            st = got["stats"]
            _log(f"[multi_rank] (f) make_mesh({shape}) {kind}: "
                 f"{MR_CACHE_AGREE_STEPS} f32 steps of batch {DH_BATCH} "
                 f"through {cap} cache rows sharded over {MR_WORLD} ranks "
                 f"(windows {[r[shape][kind]['window'] for r in f]}) against "
                 f"one rank: loss max_abs_err={errs[kind][0]:.3e} (atol "
                 f"{DC_LOSS_ATOL}); {len(rf)} touched PS rows max_abs_err / "
                 f"max|row|={errs[kind][1]:.3e} (rtol {DC_REL_TOL}); misses="
                 f"{st['misses']} evictions={st['evictions']} writeback_rows="
                 f"{st['writeback_rows']} (one rank: "
                 f"{one[cap]['stats']['evictions']} / "
                 f"{one[cap]['stats']['writeback_rows']}) | card: {card}")
            if not ((rf == 1).all() and (cf == 1).all()):
                raise AssertionError(f"multi_rank (f) {shape} {kind}: a "
                                     f"touched PS row is missing")
            if not (errs[kind][0] <= DC_LOSS_ATOL
                    and errs[kind][1] <= DC_REL_TOL):
                raise AssertionError(f"multi_rank (f) {shape} {kind}: the "
                                     f"mesh cache disagrees with one rank")
            if any(r[shape][kind]["losses"] != got["losses"] for r in f):
                raise AssertionError(f"multi_rank (f) {shape} {kind}: the "
                                     f"ranks' losses differ")
        st = runs[0]["small"]["stats"]
        if not (st["evictions"] > 0 and st["writeback_rows"] > 0):
            raise AssertionError(f"multi_rank (f) {shape}: the small cache "
                                 f"neither evicted nor wrote back: {st}")
        if not all(r[shape][k]["params_equal"] for r in f
                   for k in ("agree", "small", "timed")):
            raise AssertionError(f"multi_rank (f) {shape}: the ranks' dense "
                                 f"parameters differ")
        timed = [r[shape]["timed"] for r in f]
        ms = np.asarray(timed[0]["step_ms"])
        st = timed[0]["stats"]
        _log(f"[multi_rank] (f) make_mesh({shape}) bench_cached bf16, "
             f"{DC_CAPACITY} rows sharded ({f[0]['distinct']} distinct "
             f"signs in a batch at most), {MR_CACHE_STEPS} steps: samples/s "
             f"over steps {MR_CACHE_TIMED_FROM}-{MR_CACHE_STEPS - 1} "
             f"{timed[0]['samples_per_s']:.1f} (rank 0; (a)'s uncached DDP "
             f"f32 on the same ranks {a[0]['None']['samples_per_s']:.1f}, "
             f"one rank uncached {a[0]['single']['samples_per_s']:.1f}); "
             f"host ms a step p50={np.percentile(ms, 50):.3f} "
             f"p99={np.percentile(ms, 99):.3f}; hit_rate "
             f"{st['hits'] / max(1, st['probes']):.4f}; block bytes a rank "
             f"{[r['block_bytes'] for r in timed]} (one rank "
             f"{one[DC_CAPACITY]['block_bytes']}); max_memory_allocated GB "
             f"{' / '.join(f'{r['max_mem'] / 2**30:.3f}' for r in timed)} "
             f"(one rank's f32 run {one[DC_CAPACITY]['max_mem'] / 2**30:.3f})"
             f"; the mesh's wall {runs[0]['wall_s']:.1f}s (no rate is "
             f"claimed: gloo on one card) | card: {card}")
    launches = [r["launches"] for r in f]
    _log(f"[multi_rank] (f) kernel launches over the mesh cache runs, by "
         f"rank: {launches}; setup {f[0]['setup_s']:.2f}s, part "
         f"{f[0]['wall_s']:.1f}s | card: {card}")
    if any(any(c.values()) for c in launches):
        raise AssertionError("multi_rank (f): a kernel launched on the "
                             "cached mesh path")


def check_mesh_pipeline(e, card: str):
    """multi_rank (e)'s lines and gates (``mr_mesh_pipeline``)."""
    import numpy as np

    e1, e2, e3, e4 = ([r[k] for r in e] for k in ("e1", "e2", "e3", "e4"))
    prof = e[0]["e5"]
    _log(f"[multi_rank] (e1) seq_rec (dim {DIM}, {HEADS} heads, t_hist "
         f"{T_HIST}, MLP {MLP}, batch {TRAIN_BATCH}, bf16 flash tower) over "
         f"make_mesh(({MR_WORLD}, 1)) through the DataLoader ({PIPE_WORKERS} "
         f"lookup workers, staleness {PIPE_STALENESS}; rank 1 reads no "
         f"dataset), {MR_PIPE_STEPS} steps: {e1[0]['samples_per_s']:.1f} "
         f"samples/s (host clock, synchronized at both ends, over all "
         f"{MR_PIPE_STEPS} steps, rank 0's profiled steps "
         f"{MR_PROF_START}-{MR_PROF_START + MR_PROF_STEPS - 1} included), "
         f"losses {e1[0]['losses'][0]:.5f} -> {e1[0]['losses'][-1]:.5f}, "
         f"K2/K3/K4 launches by rank "
         f"{[[r['launches'][n] for n in FLASH_KERNELS] for r in e1]}, dense "
         f"parameters bit-equal on the ranks {e1[0]['params_equal']}, "
         f"staleness at rest {e1[0]['staleness']} | card: {card}")
    _log(f"[multi_rank] (e2) {MR_PIPE_AGREE_STEPS} reproducible staleness-1 "
         f"DataLoader steps vs as many synchronous mesh steps: losses equal "
         f"{[r['losses_equal'] for r in e2]}, dense state difference by rank "
         f"{[r['dense'] or 'none' for r in e2]}, PS rows (count, equal) "
         f"{e2[0]['rows']} | card: {card}")
    _log(f"[multi_rank] (e3) collective snapshot at step {MR_RESUME_AT} of "
         f"{MR_RESUME_STEPS} ({e3[0]['snapshot_ms']:.1f} ms on rank 0; path "
         f"the same on both ranks {e3[0]['snap'] == e3[1]['snap']}), "
         f"TrainCtx(mesh=, resume_from=) on both ranks (construction and "
         f"rollback {e3[0]['construct_rollback_ms']:.1f} ms: the tower, the "
         f"worker and its PS holders built, then the rollback, cursor "
         f"{e3[0]['cursor']}): prefix / suffix losses equal "
         f"{[(r['prefix_equal'], r['suffix_equal']) for r in e3]}, model and "
         f"Adam state difference by rank {[r['dense'] or 'none' for r in e3]}"
         f", PS rows (count, equal) {e3[0]['rows']} | card: {card}")
    _log(f"[multi_rank] (e4) eval_ctx of the f32 Ulysses tower over "
         f"make_mesh((1, {MR_WORLD})), {MR_EVAL_BATCHES} held-out batches on "
         f"every rank: max_abs_err against the single-rank flash tower by "
         f"rank {[f'{x:.3e}' for x in e4[0]['max_abs_err']]} (atol "
         f"{MR_EVAL_ATOL}), K2/K3/K4 launches by rank "
         f"{[[r['launches'][n] for n in FLASH_KERNELS] for r in e4]} | card: "
         f"{card}")
    counts = prof.get("counts", {})
    _log(f"[multi_rank] (e5) step profiler window, rank 0, steps "
         f"{MR_PROF_START}-{MR_PROF_START + MR_PROF_STEPS - 1} of (e1): trace "
         f"{prof['trace']}; {prof.get('events')} events, "
         f"{prof.get('steps')} trainer/train_step ranges, "
         f"{prof.get('gpu_events')} card events (kernels, copies, fills); "
         f"K2/K3/K4 kernel events {[counts.get(n) for n in FLASH_KERNELS]}"
         f", device ms a launch "
         f"{[prof.get('kernel_ms', {}).get(n) for n in FLASH_KERNELS]}; "
         f"window {prof.get('window_ms', float('nan')):.3f} ms, the card busy "
         f"{prof.get('busy_share', float('nan')):.4f} of it; top kernels "
         f"(ms) {prof.get('top_ms')} | card: {card}")
    if not (all(np.isfinite(r["losses"]).all() for r in e1)
            and all(r["params_equal"] for r in e1)
            and e1[0]["staleness"] == 0
            and all(r["launches"][n] == MR_PIPE_STEPS for r in e1
                    for n in FLASH_KERNELS)):
        raise AssertionError("multi_rank (e1): a loss is not finite, the "
                             "ranks' parameters differ, a permit is held, "
                             "or K2-K4 did not launch once a step a rank")
    if not (all(r["losses_equal"] and not r["dense"] for r in e2)
            and e2[0]["rows"][0] > 0 and e2[0]["rows"][1]):
        raise AssertionError("multi_rank (e2): the reproducible DataLoader "
                             "run differs from the synchronous one")
    if not (all(r["prefix_equal"] and r["suffix_equal"] and not r["dense"]
                for r in e3)
            and e3[0]["rows"][0] > 0 and e3[0]["rows"][1]
            and e3[0]["snap"] == e3[1]["snap"]
            and e3[1]["cursor"] == e3[0]["cursor"]):
        raise AssertionError("multi_rank (e3): the resumed run differs from "
                             "the unbroken one")
    if not (all(r["finite"] for r in e4)
            and max(e4[0]["max_abs_err"]) <= MR_EVAL_ATOL
            and all(r["launches"]["flash_attention_fwd"] == MR_EVAL_BATCHES
                    for r in e4)):
        raise AssertionError("multi_rank (e4): the context-parallel eval "
                             "disagrees with one rank, or K2 did not launch "
                             "once a batch on every rank")
    if prof.get("steps") != MR_PROF_STEPS:
        raise AssertionError("multi_rank (e5): the profiler window does not "
                             "hold exactly its steps, or wrote no trace")
    if prof.get("gpu_events"):
        if any(counts[n] != MR_PROF_STEPS for n in FLASH_KERNELS):
            raise AssertionError("multi_rank (e5): the window does not hold "
                                 "K2, K3 and K4 once a step")
    else:
        _log(f"[multi_rank] (e5) this card's CUPTI gave the profiler no "
             f"device event: the window is checked on the host ranges alone "
             f"| card: {card}")


# --- services (the service tier as processes) --------------------------------

SV_STEPS = 60  # (a): each run's steps [10, 60) timed
SV_AGREE_STEPS = 10  # (a): bit-equal to the in-process run
SV_TIMED_FROM = 10
SV_DH_STEPS = 40  # (b): each run's steps [10, 40) timed
SV_DH_PROF = 5  # (b): synchronous steps profiled after the timed ones
SV_DH_AGREE_STEPS = 3
SV_SERVE_EQUAL = 64  # (c): serialized requests held bit-equal
SV_SERVE_CLIENTS = 8
SV_SERVE_PER_CLIENT = 25  # (c): 200 requests
SV_START_S = 300  # a cluster's start-up deadline


class ServiceClusters:
    """The services phase's two clusters, (a)'s seq_rec and (b)'s
    bench_hybrid, each a ``ServiceCtx(n_workers=1, n_ps=2)`` whose global
    config is written by the port's YAML writer. Each is entered on a
    thread of its own, so that their processes start while the kernels
    build; :meth:`stop` takes both down."""

    def __init__(self):
        import tempfile

        from persia_tpu_torch.service.helper import ServiceCtx
        from persia_tpu_torch.utils import dump_yaml

        self._tmp = tempfile.TemporaryDirectory()
        self.ctxs = []
        for name, schema, cap, shards in (
                ("seq_rec", build_schema(), 2_000_000, 8),
                ("dlrm_hybrid", dh_schema(), DH_PS_CAPACITY, DH_PS_SHARDS)):
            path = os.path.join(self._tmp.name, f"{name}.yml")
            dump_yaml({"embedding_parameter_server_config": {
                "capacity": cap, "num_hashmap_internal_shards": shards}},
                path)
            self.ctxs.append(ServiceCtx(
                schema, n_workers=1, n_ps=N_PS, global_config_path=path,
                startup_timeout=SV_START_S, env={"LOG_LEVEL": "WARNING"}))
        self.seq, self.dh = self.ctxs
        self._start()

    def _start(self):
        """Enter every cluster of ``self.ctxs`` on a thread of its own."""
        self.t0 = time.perf_counter()
        self._errors = []
        self._up = []  # seconds from the start to each cluster up
        self._threads = [threading.Thread(target=self._enter, args=(c,),
                                          daemon=True) for c in self.ctxs]
        for t in self._threads:
            t.start()

    def _enter(self, ctx):
        try:
            ctx.__enter__()
            self._up.append(time.perf_counter() - self.t0)
        except BaseException as e:  # raised by wait()
            self._errors.append(e)

    def wait(self) -> float:
        """Seconds from the start to both clusters up; raises a start-up
        error."""
        for t in self._threads:
            t.join(timeout=SV_START_S)
        if self._errors:
            raise self._errors[0]
        if any(t.is_alive() for t in self._threads):
            raise TimeoutError(f"the {type(self).__name__} did not come up")
        return max(self._up)

    def pids(self):
        return [p.pid for c in self.ctxs for p in c.procs]

    def stop(self):
        for t in self._threads:
            t.join(timeout=SV_START_S)
        for c in self.ctxs:
            c.__exit__(None, None, None)
        self._tmp.cleanup()


def proc_cpu_s(pid: int) -> float:
    """CPU seconds (user + system) of process ``pid`` so far."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class ProcCpu:
    """CPU ms a step of the trainer (this process) and of each process of
    a cluster, between :meth:`start` and :meth:`line`."""

    def __init__(self, svc):
        self.procs = {"trainer": os.getpid()}
        self.procs.update({p._persia_name: p.pid for p in svc.procs
                           if p._persia_name != "coordinator"})

    def start(self):
        self.t = {n: proc_cpu_s(pid) for n, pid in self.procs.items()}

    def line(self, steps: int) -> str:
        return " ".join(
            f"{n}={(proc_cpu_s(pid) - self.t[n]) / steps * 1e3:.1f}"
            for n, pid in self.procs.items())


def sv_sync_run(torch, ctx, batches, timed_from: int, cpu: ProcCpu,
                after=None):
    """Synchronous steps over ``batches`` (inside ``with ctx``): the host
    ms of each step from ``timed_from``, the CPU line over the timed
    steps, and every step's loss. ``after(step)`` runs after each
    step."""
    import numpy as np

    step_ms, losses = [], []
    for step, b in enumerate(batches):
        if step == timed_from:
            torch.cuda.synchronize()
            cpu.start()
        t = time.perf_counter()
        loss, _ = ctx.train_step(b)
        if step >= timed_from:
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
        if after is not None:
            after(step)
    torch.cuda.synchronize()
    line = cpu.line(len(batches) - timed_from)
    losses = torch.stack(losses).float().cpu().tolist()
    if not np.isfinite(losses).all():
        raise AssertionError("services: a synchronous loss is not finite")
    return np.asarray(step_ms), line, losses


def sv_pipelined_run(torch, ctx, batches, timed_from: int, cpu: ProcCpu):
    """The same steps through ``DataLoader`` (4 lookup workers, staleness
    8): (samples/s over the timed steps synchronized at both ends, the
    step ms, the CPU line); the pipeline must end at rest."""
    import numpy as np

    loader = pipelined_loader(batches)
    step_ms, losses = [], []
    it = iter(loader)
    for step in range(len(batches)):
        if step == timed_from:
            torch.cuda.synchronize()
            cpu.start()
            t_steady = time.perf_counter()
        t = time.perf_counter()
        loss, _ = ctx.train_step(next(it))
        if step >= timed_from:
            step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss)
    for _ in it:  # ends the iteration: the loader flushes the updates
        raise AssertionError("the loader yielded more batches than steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_steady
    line = cpu.line(len(batches) - timed_from)
    engine = loader._engine
    at_rest = (ctx.worker.staleness, engine.staleness_sem._value,
               engine.backward.lost_updates)
    engine.shutdown()
    if at_rest != (0, PIPE_STALENESS, 0) or not bool(
            torch.isfinite(torch.stack(losses)).all()):
        raise AssertionError(f"services: the pipelined run is not at rest "
                             f"or not finite: {at_rest}")
    batch = len(batches[0].labels[0].data)
    return batch * len(step_ms) / wall, np.asarray(step_ms), line


def sv_rate(what: str, batch: int, step_ms, cpu: str, card: str,
            rate=None, beside: str = "") -> float:
    import numpy as np

    rate = rate if rate is not None else batch / (step_ms.mean() / 1e3)
    _log(f"[services] {what}: {len(step_ms)} steady steps of batch {batch}: "
         f"samples_per_s={rate:.1f} step_p50_ms="
         f"{np.percentile(step_ms, 50):.3f} step_p99_ms="
         f"{np.percentile(step_ms, 99):.3f}{beside}; host CPU ms a step by "
         f"process: {cpu} | card: {card}")
    return rate


def ps_clients_of(svc):
    from types import SimpleNamespace

    from persia_tpu_torch.service.ps_service import PsClient

    return SimpleNamespace(ps_clients=[PsClient(a) for a in svc.ps_addrs])


WORKER_STAGES = {"preprocess": "lookup_preprocess_time_cost_sec",
                 "rpc": "lookup_rpc_time_cost_sec",
                 "postprocess": "lookup_postprocess_time_cost_sec",
                 "aggregate": "update_aggregate_time_cost_sec",
                 "ship": "update_ship_time_cost_sec"}


def cluster_series(svc) -> dict:
    """One scrape of the cluster's sidecars: each PS's
    ``ps_lookup_rows_total`` and ``ps_served_requests_total`` with its
    health doc's ``served_rpcs`` read right after, and the worker's stage
    snapshot ({stage: (count, sum)}, as ``EmbeddingWorker.stage_snapshot``
    gives it) from its histograms."""
    from persia_tpu_torch.service.coordinator import ROLE_PS, ROLE_WORKER

    out = {"ps": [], "stages": {k: (0, 0.0) for k in WORKER_STAGES}}
    for t in svc.fleet_targets():
        samples, _ = obs_get(t["http_addr"], "/metrics")
        vals = {}
        for name, _labels, v in samples:
            vals[name] = vals.get(name, 0.0) + v
        if t["role"] == ROLE_PS:
            out["ps"].append((
                vals["ps_lookup_rows_total"],
                vals["ps_served_requests_total"],
                obs_get(t["http_addr"], "/healthz")["served_rpcs"]))
        elif t["role"] == ROLE_WORKER:
            for k, name in WORKER_STAGES.items():
                out["stages"][k] = (int(vals[f"{name}_count"]),
                                    vals[f"{name}_sum"])
    return out


def services_seq_rec(torch, card: str, svc) -> dict:
    """(a) seq_rec at the example's widths over the cluster: 10 steps
    bit-equal to the in-process native-PS run from the same weights and
    batches (losses, dense parameters with Adam's state, every touched PS
    row), K2-K4 once a step, then the rates. Returns the launches of the
    synchronous and the pipelined run."""
    import numpy as np

    from persia_tpu_torch.ops import flash_attention as fa
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    schema = build_schema()
    batches = list(seqrec_batches(SV_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                                  seed=TRAIN_SEED + 14, spec=spec))
    agree = batches[:SV_AGREE_STEPS]
    # the schema has no prefix or hash stack: the PS keys are the signs
    signs = np.unique(np.concatenate([f.signs for b in agree
                                      for f in b.id_type_features]))
    start = build_tower(spec.num_dense, "flash").state_dict()

    ref = train_ctx(torch, schema, build_tower(spec.num_dense, "flash",
                                               state_dict=start))
    with ref:
        ref_losses = [float(ref.train_step(b)[0]) for b in agree]
    torch.cuda.synchronize()
    ref_dense, ref_rows = dense_state(ref), touched_rows(ref.worker, signs)
    ref.worker.close()
    del ref

    ctx = train_ctx(torch, schema, build_tower(spec.num_dense, "flash",
                                               state_dict=start),
                    worker=svc.remote_worker())
    cpu = ProcCpu(svc)
    got = {}

    def snap(step):
        if step == SV_AGREE_STEPS - 1:
            got["dense"] = dense_state(ctx)
            got["rows"] = touched_rows(ps_clients_of(svc), signs)

    launches = {}
    # the registry series: the rows each lookup sends, by the worker's own
    # preprocessing (one row a distinct sign of a feature)
    from persia_tpu_torch.worker import middleware as mw

    sent_rows = 2 * sum(f.num_distinct for b in batches for f in
                        mw.preprocess_batch(b.id_type_features, schema))
    series0 = cluster_series(svc)
    with ctx:
        reset_launch_counts()
        sync_ms, sync_cpu, losses = sv_sync_run(
            torch, ctx, batches, SV_TIMED_FROM, cpu, after=snap)
        launches["synchronous"] = kernel_launches()
        reset_launch_counts()
        pipe_rate, pipe_ms, pipe_cpu = sv_pipelined_run(
            torch, ctx, batches, SV_TIMED_FROM, cpu)
        launches["pipelined"] = kernel_launches()
    series1 = cluster_series(svc)
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    looked_up = sum(a[0] for a in series1["ps"]) - sum(
        a[0] for a in series0["ps"])
    breakdown = EmbeddingWorker.stage_breakdown(series0["stages"],
                                                series1["stages"])
    _log(f"[services] (a) registry series over the synchronous and "
         f"pipelined runs: ps_lookup_rows_total grew {looked_up:.0f} (the "
         f"worker sent {sent_rows}); ps_served_requests_total / health "
         f"served_rpcs at rest, each PS: "
         + ", ".join(f"{int(m)}/{int(h)}" for _r, m, h in series1["ps"])
         + "; the worker's stage breakdown "
         + ", ".join(f"{k} {v['count']} x {v['avg_ms']} ms"
                     for k, v in breakdown.items()) + f" | card: {card}")
    if looked_up != sent_rows or len(series1["ps"]) != N_PS or any(
            m != h for _r, m, h in series1["ps"]) or breakdown["rpc"][
                "count"] != 2 * SV_STEPS:
        raise AssertionError(f"services (a): the registry series disagree "
                             f"with the traffic: rows {looked_up} against "
                             f"{sent_rows}, PS {series1['ps']}, stages "
                             f"{breakdown}")
    loss_diff = sum(a != b for a, b in zip(losses, ref_losses))
    (rf, rr), (sf, sr) = ref_rows, got["rows"]
    dense_diff = first_difference(ref_dense, got["dense"])
    row_diff = int((rr.view(np.uint32) != sr.view(np.uint32))
                   .any(axis=-1).sum())
    n_rows = len(signs)
    sync_rate = sv_rate(
        "(a) seq_rec synchronous over the services", TRAIN_BATCH, sync_ms,
        sync_cpu, card, beside=(
            f" (in process, this call: synchronous native "
            f"{RATES.get('synchronous native', float('nan')):.1f})"))
    sv_rate("(a) seq_rec pipelined over the services (DataLoader, "
            f"{PIPE_WORKERS} lookup workers, staleness {PIPE_STALENESS})",
            TRAIN_BATCH, pipe_ms, pipe_cpu, card, rate=pipe_rate, beside=(
                f" (in process, this call: pipelined native "
                f"{RATES.get('pipelined native', float('nan')):.1f}); "
                f"pipelined / synchronous over the services "
                f"{pipe_rate / sync_rate:.3f}"))
    RATES["services synchronous"] = sync_rate
    RATES["services pipelined"] = pipe_rate
    _log(f"[services] (a) the first {SV_AGREE_STEPS} synchronous steps "
         f"against the in-process native PS from the same weights: "
         f"losses that differ {loss_diff}, dense state "
         f"{dense_diff or 'bit-equal'}; {n_rows} touched PS rows "
         f"through PsClient.get_entries, rows that differ in any bit: "
         f"{row_diff} | card: {card}")
    for run, counts in launches.items():
        _log(f"[services] (a) {run} launches in {SV_STEPS} steps: "
             + " ".join(f"{n}={c}" for n, c in counts.items())
             + f" | card: {card}")
        flash = [counts[n] for n in FLASH_KERNELS]
        if flash != [SV_STEPS] * 3 or counts["embedding_bag"] \
                or counts["probe_copy"]:
            raise AssertionError(f"services (a) {run}: K2-K4 must launch "
                                 f"once a step and K1, K5 never: {counts}")
    if loss_diff or dense_diff or row_diff or not (
            (rf == 1).all() and (sf == 1).all()):
        raise AssertionError(f"services (a): the run over the services "
                             f"differs from the in-process run: "
                             f"{loss_diff} losses, dense {dense_diff!r}, "
                             f"{row_diff} rows")
    ctx.worker.close()
    return {n: launches["synchronous"][n] + launches["pipelined"][n]
            for n in launches["synchronous"]}


def services_dlrm(torch, card: str, svc):
    """(b) bench_hybrid's DLRM over the cluster: 3 f32 steps bit-equal to
    the in-process path on the card, then synchronous and pipelined rates
    beside the dlrm_hybrid phase's; K1-K5 never launch."""
    import numpy as np

    from persia_tpu_torch.config import CommonConfig, GlobalConfig
    from persia_tpu_torch.workloads.generator import hybrid_bench_batches

    reset_launch_counts()
    # fresh signs for every run: the agreement, the synchronous run, its
    # profiled steps, the pipelined run
    batches = list(hybrid_bench_batches(
        SV_DH_AGREE_STEPS + 2 * SV_DH_STEPS + SV_DH_PROF, DH_BATCH,
        seed=SEED + 14))
    agree = batches[:SV_DH_AGREE_STEPS]
    sync_runs = batches[SV_DH_AGREE_STEPS:SV_DH_AGREE_STEPS + SV_DH_STEPS]
    prof = batches[len(agree) + SV_DH_STEPS:][:SV_DH_PROF]
    pipe_runs = batches[-SV_DH_STEPS:]
    signs = batch_signs(agree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wire = GlobalConfig(CommonConfig("f32"))
    ref = dh_ctx(torch, "cuda", torch.float32, wire)
    start = {k: v.clone() for k, v in ref.model.state_dict().items()}
    with ref:
        ref_losses = [float(ref.train_step(b)[0]) for b in agree]
    ref_dense, ref_rows = dense_state(ref), touched_rows(ref.worker, signs)
    ref.worker.close()
    del ref
    ctx = dh_ctx(torch, "cuda", torch.float32, wire, state_dict=start,
                 worker=svc.remote_worker())
    with ctx:
        losses = [float(ctx.train_step(b)[0]) for b in agree]
    dense_diff = first_difference(ref_dense, dense_state(ctx))
    (rf, rr), (sf, sr) = ref_rows, touched_rows(ps_clients_of(svc), signs)
    row_diff = int((rr.view(np.uint32) != sr.view(np.uint32))
                   .any(axis=-1).sum())
    _log(f"[services] (b) dlrm_hybrid, {SV_DH_AGREE_STEPS} f32 steps of "
         f"batch {DH_BATCH} over the services against the in-process "
         f"path from the same weights: losses "
         f"{'bit-equal' if losses == ref_losses else 'differ'}, dense "
         f"state {dense_diff or 'bit-equal'}; {len(signs)} touched PS rows, "
         f"rows that differ in any bit: {row_diff} | card: {card}")
    if losses != ref_losses or dense_diff or row_diff or not (
            (rf == 1).all() and (sf == 1).all()):
        raise AssertionError("services (b): the run over the services "
                             "differs from the in-process path")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    cpu = ProcCpu(svc)
    ctx = dh_ctx(torch, "cuda", worker=svc.remote_worker())
    with ctx:
        sync_ms, sync_cpu, _ = sv_sync_run(torch, ctx, sync_runs,
                                           SV_TIMED_FROM, cpu)
        window = profile_window(torch, lambda: [
            ctx.train_step(b) for b in prof])
    ctx = dh_ctx(torch, "cuda", worker=svc.remote_worker())
    with ctx:
        pipe_rate, pipe_ms, pipe_cpu = sv_pipelined_run(
            torch, ctx, pipe_runs, SV_TIMED_FROM, cpu)
    sync_rate = sv_rate(
        "(b) dlrm_hybrid synchronous over the services", DH_BATCH, sync_ms,
        sync_cpu, card, beside=(
            f" (in process, this call: "
            f"{RATES.get('dlrm_hybrid synchronous', float('nan')):.1f})"))
    sv_rate("(b) dlrm_hybrid pipelined over the services", DH_BATCH,
            pipe_ms, pipe_cpu, card, rate=pipe_rate, beside=(
                f" (in process, this call: "
                f"{RATES.get('dlrm_hybrid pipelined', float('nan')):.1f});"
                f" pipelined / synchronous over the services "
                f"{pipe_rate / sync_rate:.3f}"))
    RATES["services dlrm_hybrid synchronous"] = sync_rate
    RATES["services dlrm_hybrid pipelined"] = pipe_rate
    report_window("services", f"{SV_DH_PROF} synchronous dlrm_hybrid steps "
                  f"over the services", window, card)
    assert_no_kernel_launched("services", card)


def services_serving(torch, card: str, svc,
                     in_process_rows_per_s: float) -> dict:
    """(c) ``InferenceServer(worker_addrs=)`` on (a)'s cluster: 64
    serialized replies bit-equal to an in-process server whose worker
    reads the same PS processes through PsClients; K2 and no other
    kernel; the rate of 200 requests from 8 clients. Returns the
    launches."""
    import numpy as np

    from persia_tpu_torch.serving import InferenceClient, InferenceServer
    from persia_tpu_torch.service.ps_service import PsClient
    from persia_tpu_torch.worker.worker import EmbeddingWorker
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    schema = build_schema()
    model = build_tower(spec.num_dense, "flash")
    n_req = SV_SERVE_CLIENTS * SV_SERVE_PER_CLIENT
    payloads = [b.to_bytes() for b in seqrec_batches(
        n_req * REQUEST_ROWS, REQUEST_ROWS, seed=SEED + 14, spec=spec,
        requires_grad=False)]
    local_worker = EmbeddingWorker(schema, [PsClient(a)
                                            for a in svc.ps_addrs])
    remote = InferenceServer(model, schema, worker_addrs=svc.worker_addrs,
                             device="cuda", max_batch_rows=256)
    local = InferenceServer(model, schema, local_worker, device="cuda",
                            max_batch_rows=256)
    remote.serve_background()
    client = InferenceClient(remote.addr)
    try:
        equal = payloads[:SV_SERVE_EQUAL]
        wire = [client.predict_bytes(p) for p in equal]
        mine = [local.predict_bytes(p) for p in equal]
        torch.cuda.synchronize()
        reset_launch_counts()
        wall, lat, preds = drive_clients(remote.addr, payloads,
                                         SV_SERVE_CLIENTS,
                                         SV_SERVE_PER_CLIENT)
        torch.cuda.synchronize()
        launches = kernel_launches()
        stats = remote.stats()
    finally:
        client.close()
        remote.stop()
        local.stop()
        local_worker.close()
    differ = sum(a.tobytes() != b.tobytes() for a, b in zip(wire, mine))
    bad = [p for p in preds.values() if p.shape != (REQUEST_ROWS, 1)
           or not np.isfinite(p).all()]
    rows = n_req * REQUEST_ROWS
    _log(f"[services] (c) serving through the remote worker tier, "
         f"{SV_SERVE_CLIENTS} InferenceClients x {SV_SERVE_PER_CLIENT} "
         f"requests of {REQUEST_ROWS} rows, max_batch_rows=256: "
         f"rows_per_s={rows / wall:.1f} (in-process serving phase "
         f"{in_process_rows_per_s:.1f}, ratio "
         f"{rows / wall / in_process_rows_per_s:.3f}) "
         f"{lat_line(n_req, wall, lat)} "
         f"avg_coalesce={stats['avg_coalesce']:.2f} lookup_p50_ms="
         f"{stats['lookup_p50_ms']:.3f} forward_p50_ms="
         f"{stats['forward_p50_ms']:.3f}; {SV_SERVE_EQUAL} serialized "
         f"replies against the in-process server over the same PS: "
         f"{differ} differ; launches {launches} | card: {card}")
    flash = [launches[n] for n in FLASH_KERNELS]
    if differ or bad or flash[0] <= 0 or any(flash[1:]) \
            or launches["embedding_bag"] or launches["probe_copy"]:
        raise AssertionError(f"services (c): {differ} replies differ, "
                             f"{len(bad)} bad; launches {launches}")
    return launches


def services_no_cuda_context(card: str, clusters: ServiceClusters):
    """(d) no child of either cluster holds a CUDA context: none is among
    the card's compute apps, and none has a ``/dev/nvidia*`` file open."""
    pids = clusters.pids()
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    apps = {int(x) for x in out.stdout.split() if x.strip().isdigit()}
    opened = []
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except FileNotFoundError:
            raise AssertionError(f"services (d): child {pid} is gone")
        for fd in fds:
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                opened.append((pid, target))
    _log(f"[services] (d) {len(pids)} children {pids}: among the card's "
         f"{len(apps)} compute apps {sorted(apps)} (this process "
         f"{os.getpid()} {'listed' if os.getpid() in apps else 'not listed'}"
         f"): {sorted(apps & set(pids))}; /dev/nvidia* files open in a "
         f"child: {opened} | card: {card}")
    if apps & set(pids) or opened:
        raise AssertionError("services (d): a child holds a CUDA context")


def services_phase(torch, card: str, clusters: ServiceClusters,
                   in_process_rows_per_s: float) -> dict:
    """The service tier as processes: (a) seq_rec, (b) dlrm_hybrid, (c)
    serving through the remote worker tier, (d) no CUDA context in a
    child. Returns each kernel's launches over (a) and (c)."""
    up = clusters.wait()
    _log(f"[services] two clusters of 1 coordinator, {N_PS} PS and 1 "
         f"worker process each, up {up:.1f}s after their start (beside the "
         f"kernel build): seq_rec PS {clusters.seq.ps_addrs} worker "
         f"{clusters.seq.worker_addrs}; dlrm_hybrid PS "
         f"{clusters.dh.ps_addrs} worker {clusters.dh.worker_addrs}")
    launches = services_seq_rec(torch, card, clusters.seq)
    services_dlrm(torch, card, clusters.dh)
    served = services_serving(torch, card, clusters.seq,
                              in_process_rows_per_s)
    services_no_cuda_context(card, clusters)
    for c in clusters.ctxs:
        if c.crashed:
            raise AssertionError(f"services: a child crashed: {c.crashed}")
    return {n: launches[n] + served[n] for n in launches}


# --- supervision: the supervised job -----------------------------------------
# bench.py's chaos cells' sizes (bench.py:1868-1971)
SU_DIM = 8
SU_FEATS = 2
SU_SEED = 3
SU_POOL = 2048
SU_WORKER_POOL = 4096  # (c): _chaos_job_worker_cell's pool
SU_BATCH = 64
SU_STEPS = 20
SU_INTERVAL = 4
SU_STEP_DELAY = 0.15  # lets the flight polls (every 0.3 s) land first
SU_KINDS = ("mid_step", "mid_snapshot", "between_snapshots")
SU_SYNC_EVERY = 2  # (e): the rider every 2 local steps
# (e): the group-of-one rider on the card against its CPU run, the tests'
# rule (tests/test_torch_trainer_group.py): every round's loss within
# rtol = atol = 0.08, the int8-EF gate of
# tests/test_models_parallel.py:235-255; the tower computes in bf16, where
# a GEMM's rounding moves a value by a bf16 ulp (2**-8 relative) and the
# int8 codes and error feedback carry it on
SU_RIDER_TOL = 0.08
SU_INC_BUFFER = 48  # (d) with packets: the dumper's buffer, in signs
SU_DONE_S = 240  # a supervised run's deadline
SU_WAIT_S = 60  # a recovery's deadline


def su_schema():
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots

    return EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{i}" for i in range(SU_FEATS)], dim=SU_DIM))


def su_trainer_args(result_file: str, *extra) -> list:
    return ["--num-workers", "1", "--steps", str(SU_STEPS),
            "--batch-size", str(SU_BATCH), "--n-feats", str(SU_FEATS),
            "--seed", str(SU_SEED), "--pool-size", str(SU_POOL),
            "--result-file", result_file, "--device", "cuda", *extra]


class SupervisionClusters:
    """The supervision phase's nine ``ServiceCtx(n_workers=1, n_ps=2)``
    clusters, each entered on a thread of its own while the kernels
    build: (a) one a die point, its trainer supervised on the card; (b)
    an unsupervised one; (c) supervised workers; (d) a supervised PS, and
    one whose PS dump incremental-update packets; (e) a group of two
    trainers and a group of one, with the rider on the card. The
    trainers of (a) and (e) start once their tier is up and run to their
    end on their own; :meth:`stop` takes every cluster down."""

    def __init__(self):
        import tempfile

        from persia_tpu_torch.service.helper import ServiceCtx
        from persia_tpu_torch.utils import dump_yaml

        self._tmp = tempfile.TemporaryDirectory()
        self.dir = self._tmp.name
        gc = os.path.join(self.dir, "global.yml")
        dump_yaml({"embedding_parameter_server_config": {
            "capacity": 100_000, "num_hashmap_internal_shards": 4}}, gc)
        quiet = {"LOG_LEVEL": "WARNING"}
        traced = {"PERSIA_TRACING": "1", **quiet}
        common = dict(n_workers=1, n_ps=N_PS, global_config_path=gc,
                      startup_timeout=SV_START_S)
        self.ctxs = {}
        for kind in SU_KINDS:
            die = 2 * SU_INTERVAL if kind == "mid_snapshot" \
                else SU_INTERVAL + 2
            self.ctxs[kind] = ServiceCtx(
                su_schema(), supervise_trainer=True,
                trainer_args=su_trainer_args(
                    self.path(kind, "result.json"),
                    "--snapshot-interval", str(SU_INTERVAL), "--die-at",
                    kind, "--die-step", str(die), "--step-delay",
                    str(SU_STEP_DELAY)),
                snapshot_dir=self.path(kind, "snapshots"),
                postmortem_dir=self.path(kind, "postmortems"),
                flight_interval=0.3, env=traced, **common)
        self.ctxs["torn"] = ServiceCtx(su_schema(), env=quiet, **common)
        self.ctxs["worker"] = ServiceCtx(
            su_schema(), supervise_workers=True,
            postmortem_dir=self.path("worker", "postmortems"),
            flight_interval=0.3, env=traced, **common)
        self.ctxs["ps"] = ServiceCtx(
            su_schema(), supervise_ps=True,
            ps_restore_dir=self.path("ps", "ckpt"), ps_probe_interval=0.25,
            postmortem_dir=self.path("ps", "postmortems"),
            flight_interval=0.3, env=traced, **common)
        # (d) again with the training PS dumping incremental-update
        # packets (tests/test_faults.py:488's buffer of 48 signs), which
        # the restarted replica replays over its checkpoint
        inc_gc = self.path("ps_inc.yml")
        dump_yaml({"embedding_parameter_server_config": {
            "capacity": 100_000, "num_hashmap_internal_shards": 4,
            "enable_incremental_update": True,
            "incremental_buffer_size": SU_INC_BUFFER,
            "incremental_dir": self.path("ps_inc", "inc")}}, inc_gc)
        self.ctxs["ps_inc"] = ServiceCtx(
            su_schema(), supervise_ps=True,
            ps_restore_dir=self.path("ps_inc", "ckpt"),
            ps_inc_dir=self.path("ps_inc", "inc"), ps_probe_interval=0.25,
            env=quiet, **{**common, "global_config_path": inc_gc})
        for name, n in (("group2", 2), ("group1", 1)):
            self.ctxs[name] = ServiceCtx(
                su_schema(), supervise_trainer=True,
                trainer_args=su_trainer_args(
                    self.path(name, "result.json"), "--mesh",
                    "--dense-sync-every", str(SU_SYNC_EVERY)),
                n_trainers=n, trainer_max_restarts=0, http_all=True,
                env=quiet, **common)
        self.t0 = time.monotonic()
        self.up = {}  # name -> time.monotonic() once entered
        self.idle_s = {}  # (d): a restarted PS's Idle, by restore kind
        self._errors = []
        self._threads = [threading.Thread(target=self._enter, args=(n, c),
                                          daemon=True)
                         for n, c in self.ctxs.items()]
        for t in self._threads:
            t.start()

    def path(self, *parts) -> str:
        return os.path.join(self.dir, *parts)

    def _enter(self, name, ctx):
        try:
            ctx.__enter__()
            self.up[name] = time.monotonic()
        except BaseException as e:  # raised by wait()
            self._errors.append(e)

    def wait(self) -> float:
        """Seconds from the start to every cluster up; raises a start-up
        error."""
        for t in self._threads:
            t.join(timeout=SV_START_S)
        if self._errors:
            raise self._errors[0]
        if any(t.is_alive() for t in self._threads):
            raise TimeoutError("the supervision clusters did not come up")
        return max(self.up.values()) - self.t0

    def stop(self):
        for t in self._threads:
            t.join(timeout=SV_START_S)
        for c in self.ctxs.values():
            c.__exit__(None, None, None)
        self._tmp.cleanup()


def su_expected(pool, seed: int, steps: int):
    import numpy as np

    from persia_tpu_torch.service.trainer_service import batch_draws

    expected = np.zeros(len(pool), np.int64)
    for k in range(steps):
        draws = batch_draws(pool, seed, k, SU_BATCH, SU_FEATS)
        np.add.at(expected, np.searchsorted(pool, np.concatenate(draws)), 1)
    return expected


def su_identity(tag: str, worker, pool, expected):
    """The counting identity, exact for every sign."""
    import numpy as np

    got = -worker.lookup_signs(pool, SU_DIM).sum(axis=1) / SU_DIM
    bad = np.nonzero(got != expected)[0]
    if len(bad):
        raise AssertionError(
            f"supervision {tag}: counting identity broken on {len(bad)} "
            f"signs (expected {int(expected.sum())} updates, applied "
            f"{got.sum():.1f})")
    return int(expected.sum())


def su_validate_postmortem(tag: str, bundle, health_key: str) -> int:
    """``bench.py``'s ``_validate_postmortem``: a parent -> child span
    chain with no orphan parent, the health doc with ``health_key``, a
    parseable exposition. Returns the spans."""
    from persia_tpu_torch.metrics import parse_exposition

    if not bundle or not os.path.isdir(bundle):
        raise AssertionError(f"supervision {tag}: no postmortem bundle")
    with open(os.path.join(bundle, "trace.json")) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    ids = {e["args"]["span_id"] for e in xs}
    children = [e for e in xs if e["args"].get("parent_id")]
    if not xs or not children or any(
            e["args"]["parent_id"] not in ids for e in children):
        raise AssertionError(f"supervision {tag}: the bundle's trace has "
                             f"no intact parent -> child chain "
                             f"({len(xs)} spans)")
    with open(os.path.join(bundle, "health.json")) as f:
        if health_key not in json.load(f):
            raise AssertionError(f"supervision {tag}: health doc without "
                                 f"{health_key!r}")
    with open(os.path.join(bundle, "metrics.prom")) as f:
        if not parse_exposition(f.read())[0]:
            raise AssertionError(f"supervision {tag}: empty exposition")
    return len(xs)


def su_trainer_kill(kind: str, clusters: SupervisionClusters) -> str:
    """(a) one die point: exit 0, one recovery, a bundle with spans, the
    resume (``snap_000000`` behind the torn ``snap_000001`` for
    ``mid_snapshot``), the identity, the retention."""
    from persia_tpu_torch import knobs
    from persia_tpu_torch import snapshot as snap_mod
    from persia_tpu_torch.service.trainer_service import sign_pool

    svc = clusters.ctxs[kind]
    rc = svc.wait_trainer_done(timeout=SU_DONE_S)
    events = list(svc.trainer_recoveries)
    if rc != 0 or len(events) != 1:
        raise AssertionError(f"supervision (a) {kind}: rc={rc}, "
                             f"{len(events)} recoveries for one kill: "
                             f"{events}")
    ev = events[0]
    spans = su_validate_postmortem(f"(a) {kind}", ev.get("postmortem"),
                                   "model_manager_status")
    with open(clusters.path(kind, "result.json")) as f:
        result = json.load(f)
    if result["steps"] != SU_STEPS or result["resumed_from"] != \
            "snap_000000" or not result["device"].startswith("cuda"):
        raise AssertionError(f"supervision (a) {kind}: {result}")
    pool = sign_pool(SU_POOL)
    acked = su_identity(f"(a) {kind}", svc.remote_worker(), pool,
                        su_expected(pool, SU_SEED, SU_STEPS))
    snap_dir = clusters.path(kind, "snapshots")
    complete = []
    for p in snap_mod.list_snapshots(snap_dir):
        try:
            snap_mod.load_manifest(p)
            complete.append(p)
        except snap_mod.SnapshotError:
            pass
    if not 1 <= len(complete) <= knobs.get("PERSIA_SNAPSHOT_KEEP"):
        raise AssertionError(f"supervision (a) {kind}: retention broken, "
                             f"{len(complete)} complete snapshots")
    die = [n for n in os.listdir(snap_dir) if n.startswith(".die_")]
    with open(os.path.join(snap_dir, die[0])) as f:
        t_kill = float(f.read())
    detect_ms = (ev["t_detected"] - t_kill) * 1e3
    respawn_ms = (ev["t_respawned"] - ev["t_detected"]) * 1e3
    first_s = result["t_first_step"] - ev["t_respawned"]
    main_s = result["t_main"] - ev["t_respawned"]
    context_s = result["t_device"] - result["t_main"]
    return (f"(a) {kind}: exit 0 after 1 recovery, resumed from "
            f"{result['resumed_from']}, {acked} updates exact, "
            f"{len(complete)} complete snapshots, bundle {spans} spans; "
            f"detected {detect_ms:.1f} ms after the kill, respawned "
            f"{respawn_ms:.1f} ms later, the resumed trainer's first step "
            f"{first_s:.3f} s after (its main() at {main_s:.3f} s, its CUDA "
            f"context {context_s:.3f} s)")


def su_torn(clusters: SupervisionClusters) -> str:
    """(b) ``_chaos_job_torn_cell``: a torn payload and a newer
    manifest-less directory; the fallback to ``snap_000000`` restores its
    exact cut."""
    import numpy as np

    from persia_tpu_torch import snapshot as snap_mod
    from persia_tpu_torch.data.batch import IDTypeFeature
    from persia_tpu_torch.service import trainer_service as ts

    seed = 11
    pool = ts.sign_pool(SU_POOL)
    snap_dir = clusters.path("torn", "snapshots")
    w = clusters.ctxs["torn"].remote_worker()
    w.configure_parameter_servers(*ts.ARM_INIT)
    w.register_optimizer(ts.ARM_OPT)

    def train(k0, k1):
        for k in range(k0, k1):
            feats = [IDTypeFeature(f"slot_{i}", [d]) for i, d in enumerate(
                ts.batch_draws(pool, seed, k, SU_BATCH, SU_FEATS))]
            ref, out = w.lookup_direct_training(feats)
            w.update_gradients(ref, {k2: np.ones_like(v.embeddings)
                                     for k2, v in out.items()})

    train(0, 4)
    snap1 = snap_mod.snapshot_job(snap_dir, w, cursor={
        "seed": seed, "consumed": 4}, step=4)
    train(4, 8)
    snap2 = snap_mod.snapshot_job(snap_dir, w, cursor={
        "seed": seed, "consumed": 8}, step=8)
    victim = sorted(snap_mod.load_manifest(snap2)["files"])[0]
    with open(os.path.join(snap2, victim), "wb") as f:
        f.write(b"torn")
    try:
        snap_mod.load_manifest(snap2)
        raise AssertionError("supervision (b): a torn snapshot verified")
    except snap_mod.SnapshotError:
        pass
    os.makedirs(os.path.join(snap_dir, "snap_000099"))
    found = snap_mod.latest_snapshot(snap_dir)
    if found is None or found[0] != snap1:
        raise AssertionError(f"supervision (b): fallback to "
                             f"{found and found[0]}")
    snap_mod.restore_job(found[0], w)
    acked = su_identity("(b)", w, pool, su_expected(pool, seed, 4))
    w.close()
    return (f"(b) torn {victim} of snap_000001 refused, manifest-less "
            f"snap_000099 skipped, fell back to "
            f"{os.path.basename(found[0])}: {acked} updates exact")


def su_worker_kill(clusters: SupervisionClusters) -> str:
    """(c) ``_chaos_job_worker_cell``: a supervised worker killed under a
    driving loop."""
    import numpy as np

    from persia_tpu_torch.data.batch import IDTypeFeature
    from persia_tpu_torch.service import trainer_service as ts
    from persia_tpu_torch.service.worker_service import (
        RemoteEmbeddingWorker,
    )

    svc = clusters.ctxs["worker"]
    pool = ts.sign_pool(SU_WORKER_POOL)
    per = SU_FEATS * SU_BATCH

    def mk_worker():
        w = RemoteEmbeddingWorker(list(svc.worker_addrs))
        w.configure_parameter_servers(*ts.ARM_INIT)
        w.register_optimizer(ts.ARM_OPT)
        return w

    box = [mk_worker()]
    lock = threading.Lock()
    stop = threading.Event()
    expected = np.zeros(len(pool), np.int64)
    confirmed = np.zeros(len(pool), np.int64)
    acked, settled = [0], [0]
    pending, failures = [], []

    def train():
        rng = np.random.default_rng(5)
        while not stop.is_set():
            draws = [rng.choice(pool, size=SU_BATCH)
                     for _ in range(SU_FEATS)]
            feats = [IDTypeFeature(f"slot_{i}", [d])
                     for i, d in enumerate(draws)]
            idx = np.searchsorted(pool, np.concatenate(draws))
            with lock:  # the cycle and its ledger; the kill takes it too
                if stop.is_set():
                    return
                w = box[0]
                try:
                    ref, out = w.lookup_direct_training(feats)
                    w.update_gradients(ref, {k: np.ones_like(v.embeddings)
                                             for k, v in out.items()})
                except Exception:  # noqa: BLE001 — a failed cycle
                    failures.append(per)
                    box[0] = None
                else:
                    acked[0] += per
                    np.add.at(expected, idx, 1)
                    pending.append(idx)
                    try:
                        if w.staleness == 0:
                            for pidx in pending:
                                settled[0] += per
                                np.add.at(confirmed, pidx, 1)
                            pending.clear()
                    except Exception:  # noqa: BLE001 — stays pending
                        pass
            if box[0] is None:
                time.sleep(0.25)
                try:
                    box[0] = mk_worker()
                except Exception:  # noqa: BLE001 — retried
                    pass
            time.sleep(0.01)

    t = threading.Thread(target=train, daemon=True)
    t.start()
    try:
        time.sleep(1.2)
        with lock:
            acked_k, settled_k = acked[0], settled[0]
            confirmed_k = confirmed.copy()
            t_kill = time.monotonic()
            svc.worker_proc(0).kill()
        (ev,) = svc.wait_worker_recoveries(1, timeout=SU_WAIT_S)
        if "failed" in ev:
            raise AssertionError(f"supervision (c): {ev}")
        acked_r = acked[0]
        deadline = time.monotonic() + SU_WAIT_S
        while acked[0] < acked_r + 3 * per:
            if time.monotonic() > deadline:
                raise AssertionError("supervision (c): no cycle landed on "
                                     "the replacement")
            time.sleep(0.05)
    finally:
        stop.set()
        t.join(timeout=SU_WAIT_S)
    if t.is_alive():
        raise AssertionError("supervision (c): the driving loop hangs")
    w = box[0] or mk_worker()
    deadline = time.monotonic() + SU_WAIT_S
    while w.staleness != 0:
        if time.monotonic() > deadline:
            raise AssertionError("supervision (c): the replacement never "
                                 "drained")
        time.sleep(0.1)
    got = -w.lookup_signs(pool, SU_DIM).sum(axis=1) / SU_DIM
    fail = int(sum(failures))
    declared = (acked_k - settled_k) + fail
    lost = float(expected.sum()) - float(got.sum())
    if np.any(confirmed_k - got > 1e-3):
        raise AssertionError("supervision (c): an update confirmed before "
                             "the kill was lost")
    if lost > declared + 1e-3 or -lost > fail + 1e-3 or len(failures) > 60:
        raise AssertionError(f"supervision (c): lost {lost:.1f} against "
                             f"the declared {declared}, {len(failures)} "
                             f"failed cycles ({fail} updates)")
    spans = su_validate_postmortem("(c)", ev.get("postmortem"),
                                   "forward_buffer_depth")
    w.close()
    detect_ms = (ev["t_detected"] - t_kill) * 1e3
    respawn_ms = (ev["t_respawned"] - ev["t_detected"]) * 1e3
    return (f"(c) worker killed under the loop: {int(expected.sum())} "
            f"acked, {got.sum():.1f} applied, lost {lost:.1f} (declared "
            f"ambiguity {declared}), {len(failures)} failed cycles, bundle "
            f"{spans} spans; detected {detect_ms:.1f} ms after the kill, "
            f"re-registered {ev['recovery_sec']:.3f} s after that (respawn "
            f"{respawn_ms:.1f} ms)")


def su_ps_kill(clusters: SupervisionClusters) -> str:
    """(d) a supervised PS killed after a checkpoint: the replacement is
    ``Idle`` at a new address with the checkpoint's rows."""
    import numpy as np

    from persia_tpu_torch.checkpoint import iter_psd_entries
    from persia_tpu_torch.data.batch import IDTypeFeature
    from persia_tpu_torch.service import trainer_service as ts
    from persia_tpu_torch.service.ps_service import PsClient

    svc = clusters.ctxs["ps"]
    ckpt = clusters.path("ps", "ckpt")
    pool = ts.sign_pool(SU_POOL)
    w = svc.remote_worker()
    w.configure_parameter_servers(
        "bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0)
    w.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
    for k in range(8):
        feats = [IDTypeFeature(f"slot_{i}", [d]) for i, d in enumerate(
            ts.batch_draws(pool, SU_SEED, k, SU_BATCH, SU_FEATS))]
        ref, out = w.lookup_direct_training(feats)
        w.update_gradients(ref, {n: np.ones_like(v.embeddings)
                                 for n, v in out.items()})
    w.dump(ckpt)  # and no update after it (the packets' case is d_inc)
    deadline = time.monotonic() + SU_WAIT_S
    while not (svc.flight_recorder.last("ps1") or {}).get("spans"):
        if time.monotonic() > deadline:
            raise AssertionError("supervision (d): no flight with spans")
        time.sleep(0.05)
    old = svc.ps_addrs[1]
    t_kill = time.monotonic()
    svc.ps_proc(1).kill()
    (ev,) = svc.wait_ps_recoveries(1, timeout=SU_WAIT_S)
    if "failed" in ev or ev["addr"] == old:
        raise AssertionError(f"supervision (d): {ev}")
    bundle = ev.get("postmortem")
    with open(os.path.join(bundle, "health.json")) as f:
        if json.load(f).get("model_manager_status") != "Idle":
            raise AssertionError("supervision (d): the bundle's health doc")
    want = {s: v for s, _d, v in iter_psd_entries(
        os.path.join(ckpt, "replica_1.psd"))}
    client = PsClient(ev["addr"])
    if len(client) != len(want):
        raise AssertionError(f"supervision (d): {len(client)} rows, the "
                             f"checkpoint {len(want)}")
    for sign, vec in want.items():
        got = client.get_entry(sign)
        if got is None or not np.array_equal(got[1][:len(vec)], vec):
            raise AssertionError(f"supervision (d): row {sign} differs")
    client.client.close()
    w.close()
    detect_ms = (ev["t_detected"] - t_kill) * 1e3
    respawn_ms = (ev["t_respawned"] - ev["t_detected"]) * 1e3
    clusters.idle_s["checkpoint"] = ev["recovery_sec"]
    return (f"(d) PS 1 killed after a checkpoint: Idle at {ev['addr']} "
            f"(was {old}), {len(want)} rows equal the checkpoint's; "
            f"detected {detect_ms:.1f} ms after the kill, Idle "
            f"{ev['recovery_sec']:.3f} s after that (respawn "
            f"{respawn_ms:.1f} ms)")


def su_ps_inc_kill(clusters: SupervisionClusters) -> str:
    """(d) with packets, ``tests/test_faults.py:488``: the training PS
    dump incremental-update packets; PS 1 is killed after a checkpoint
    and 4 more steps; the replacement replays its packets over the
    checkpoint, and after 4 steps on a disjoint range every row of the
    checkpoint and of replica 1's packets, overlaid in replay order,
    reads back exactly."""
    import numpy as np

    from persia_tpu_torch.checkpoint import iter_psd_entries
    from persia_tpu_torch.data.batch import IDTypeFeature
    from persia_tpu_torch.service.ps_service import PsClient

    svc = clusters.ctxs["ps_inc"]
    ckpt, inc = clusters.path("ps_inc", "ckpt"), clusters.path("ps_inc",
                                                               "inc")
    rng = np.random.default_rng(SU_SEED)
    w = svc.remote_worker()
    w.configure_parameter_servers(
        "bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0)
    w.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})

    def step(lo, hi):
        feats = [IDTypeFeature(f"slot_{i}", [rng.integers(
            lo, hi, size=SU_BATCH, dtype=np.uint64)])
            for i in range(SU_FEATS)]
        ref, out = w.lookup_direct_training(feats)
        w.update_gradients(ref, {n: np.ones_like(v.embeddings)
                                 for n, v in out.items()})

    for _ in range(8):
        step(0, SU_WORKER_POOL)
    w.dump(ckpt)
    for _ in range(4):
        step(0, SU_WORKER_POOL)  # packets past the checkpoint
    old = svc.ps_addrs[1]
    t_kill = time.monotonic()
    svc.ps_proc(1).kill()
    (ev,) = svc.wait_ps_recoveries(1, timeout=SU_WAIT_S)
    if "failed" in ev or ev["addr"] == old:
        raise AssertionError(f"supervision (d) with packets: {ev}")
    for _ in range(4):
        step(1 << 20, (1 << 20) + SU_WORKER_POOL)  # a disjoint range
    if w.staleness:
        raise AssertionError("supervision (d) with packets: staleness "
                             f"{w.staleness}")
    want = {s: v for s, _d, v in iter_psd_entries(
        os.path.join(ckpt, "replica_1.psd"))}
    n_ckpt, packets = len(want), 0
    for name in sorted(os.listdir(inc)):
        path = os.path.join(inc, name, "1.inc")
        if name.startswith("inc_") and os.path.exists(path):
            packets += 1
            for s, _d, v in iter_psd_entries(path):
                if s < (1 << 20):
                    want[s] = v
    client = PsClient(ev["addr"])
    differ = sum(got is None or got[1][:len(v)].tobytes() != v.tobytes()
                 for got, v in ((client.get_entry(s), v)
                                for s, v in want.items()))
    client.client.close()
    w.close()
    clusters.idle_s["checkpoint and packets"] = ev["recovery_sec"]
    line = (f"(d) with packets: PS 1 killed 4 steps after a checkpoint: "
            f"Idle at {ev['addr']} {ev['recovery_sec']:.3f} s after the "
            f"kill was seen (detected "
            f"{(ev['t_detected'] - t_kill) * 1e3:.1f} ms after it), having "
            f"replayed replica 1's {packets} packets over the checkpoint's "
            f"{n_ckpt} rows; {len(want)} rows of the overlay read back, "
            f"{differ} differ")
    if differ or packets < 2 or len(want) <= n_ckpt:
        raise AssertionError(f"supervision {line}")
    return line


def su_rider_cpu(rounds: int) -> list:
    """The group-of-one rider's rounds on the CPU (a world of one, gloo),
    from the same seed."""
    import datetime

    import torch.distributed as dist

    from persia_tpu_torch.distributed import DistributedOption
    from persia_tpu_torch.service import trainer_service as ts

    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=60))
    mesh = DistributedOption(backend="gloo", device="cpu", store=store,
                             world_size=1, rank=0, timeout=60).initialize()
    try:
        sync = ts._dense_rider(mesh, 1, SU_SEED)
        return [sync(r, 0) for r in range(rounds)]
    finally:
        dist.destroy_process_group()


def su_group(clusters: SupervisionClusters) -> str:
    """(e) the group of two (gloo ranks sharing the card) and the group
    of one (NCCL), the rider on the card."""
    import math

    import numpy as np

    from persia_tpu_torch.service.trainer_service import sign_pool

    pool = sign_pool(SU_POOL)
    expected = su_expected(pool, SU_SEED, SU_STEPS)
    out = []
    for name, n, backend in (("group2", 2, "gloo"), ("group1", 1, "nccl")):
        svc = clusters.ctxs[name]
        rc = svc.wait_trainer_done(timeout=SU_DONE_S)
        if rc != 0 or svc.trainer_recoveries:
            raise AssertionError(f"supervision (e) {name}: rc={rc}")
        base = clusters.path(name, "result.json")
        results = []
        for i in range(n):
            with open(f"{base}.p{i}" if n > 1 else base) as f:
                results.append(json.load(f))
        acked = su_identity(f"(e) {name}", svc.remote_worker(), pool,
                            expected)
        if n > 1:
            counts = None
            for t in svc.fleet_targets():
                if t["role"] == "embedding-worker":
                    from persia_tpu_torch.fleet import _http_get

                    counts = json.loads(_http_get(
                        f"http://{t['http_addr']}/healthz", 5.0)).get(
                            "ship_counts")
            if counts != {f"p{i}": SU_STEPS // n for i in range(n)}:
                raise AssertionError(f"supervision (e): the shards' "
                                     f"shipments {counts}")
        losses = [r["dense_losses"] for r in results]
        syncs = SU_STEPS // n // SU_SYNC_EVERY
        if any(r["backend"] != backend or not r["device"].startswith("cuda")
               or r["dense_syncs"] != syncs for r in results):
            raise AssertionError(f"supervision (e) {name}: {results}")
        if not all(math.isfinite(x) for x in sum(losses, [])):
            raise AssertionError(f"supervision (e) {name}: a rider loss "
                                 f"is not finite: {losses}")
        if any(r["dense_digests"] != results[0]["dense_digests"]
               for r in results):
            raise AssertionError(f"supervision (e) {name}: the ranks' "
                                 f"dense parameters differ after a sync")
        line = (f"{name} ({backend}, {n} trainer(s)): {acked} updates "
                f"exact over the group, {syncs} rider rounds a rank, "
                f"losses {[round(x, 6) for x in losses[0]]}")
        if n == 1:
            cpu = su_rider_cpu(syncs)
            err = float(np.max(np.abs(np.array(losses[0]) - cpu)
                               / np.maximum(np.abs(cpu), 1.0)))
            if not np.allclose(losses[0], cpu, rtol=SU_RIDER_TOL,
                               atol=SU_RIDER_TOL):
                raise AssertionError(f"supervision (e): the card's rider "
                                     f"{losses[0]} against its CPU run "
                                     f"{cpu}")
            line += (f", the CPU run's {[round(x, 6) for x in cpu]} "
                     f"(largest difference {err:.3e}, round 0 "
                     f"{abs(losses[0][0] - cpu[0]):.3e})")
        else:
            line += ", the ranks' parameters bit-equal after every round"
        out.append(line)
    return "(e) " + "; ".join(out)


def supervision_phase(torch, card: str, clusters: SupervisionClusters
                      ) -> dict:
    """(a)-(e) over the clusters started in setup, the parts concurrently
    (each its own cluster); returns each kernel's launches over the phase
    (none)."""
    up = clusters.wait()
    _log(f"[supervision] {len(clusters.ctxs)} clusters of 1 coordinator, "
         f"{N_PS} PS and 1 worker process each, up {up:.1f}s after their "
         f"start (beside the kernel build) | card: {card}")
    reset_launch_counts()
    from functools import partial

    jobs = {f"a_{k}": partial(su_trainer_kill, k, clusters)
            for k in SU_KINDS}
    jobs.update(b=partial(su_torn, clusters),
                c=partial(su_worker_kill, clusters),
                d=partial(su_ps_kill, clusters),
                d_inc=partial(su_ps_inc_kill, clusters),
                e=partial(su_group, clusters))
    lines, errors = {}, {}

    def run(name, fn):
        try:
            lines[name] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[name] = e

    threads = [threading.Thread(target=run, args=item, daemon=True)
               for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SU_DONE_S + 2 * SU_WAIT_S)
    for name in jobs:
        if name in lines:
            _log(f"[supervision] {lines[name]} | card: {card}")
    if errors or len(lines) != len(jobs):
        name = next(iter(errors), "?")
        raise AssertionError(f"supervision: parts failed: "
                             f"{sorted(errors) or 'timed out'}") \
            from errors.get(name)
    for name, c in clusters.ctxs.items():
        if c.crashed:
            raise AssertionError(f"supervision: {name} crashed: "
                                 f"{c.crashed}")
    _log("[supervision] (d) a restarted PS Idle after the kill was seen, "
         "restored from: " + ", ".join(
             f"{k} {v:.3f} s" for k, v in clusters.idle_s.items())
         + f" | card: {card}")
    return assert_no_kernel_launched("supervision", card)



# --- online: the train -> serve loop -----------------------------------------
# (a) bench_online's stack (bench.py:5330-5600) at its smoke depth: 3
# freshness rounds (the full depth, 10 rounds at TTL 8 s, takes 40-80 s)
ON_ROUNDS = 3
ON_TTL_S = 4.0
ON_SCAN_S = 0.15
ON_SLOTS = 4
ON_DENSE = 13  # bench.py's NUM_DENSE
ON_PROBE_ROWS = 8
ON_CACHE_ROWS = 500_000
ON_P99_BLOCKS = 3  # paired interleaved predict blocks, printed only
ON_P99_PER_BLOCK = 30
# (b) seq_rec trained over processes and served from the infer tier
ON_B_ROUNDS = 3
ON_B_STEPS = 4  # trainer steps a round
ON_B_PROBE_S = 20.0  # a round's probe must change within this
ON_B_CACHE_ROWS = 200_000
ON_B_SETTLE_S = 60.0  # both consumers past the last packet within this


class OnlineClusters(ServiceClusters):
    """(b)'s two ``ServiceCtx(n_workers=1, n_ps=2)`` clusters at the
    seq_rec widths, entered on threads while the kernels build: the
    training cluster's PS dump incremental-update packets into one
    directory (``enable_incremental_update``, a buffer of the fewest
    distinct signs one step sends a replica, so every update RPC dumps a
    packet and none stays buffered), and the infer cluster
    (``job_type: Infer``) hot-loads them into its PS. :meth:`stop` takes
    both down."""

    def __init__(self):
        import tempfile

        import numpy as np

        from persia_tpu_torch.hashing import sign_to_shard
        from persia_tpu_torch.service.helper import ServiceCtx
        from persia_tpu_torch.utils import dump_yaml

        self._tmp = tempfile.TemporaryDirectory()
        self.inc_dir = os.path.join(self._tmp.name, "inc")
        self.batches = online_batches()
        self.buffer_size = min(
            int(np.bincount(sign_to_shard(signs, N_PS),
                            minlength=N_PS).min())
            for signs in (seq_signs([b]) for b in self.batches))
        self.ctxs = []
        for name, extra in (("train", {}),
                            ("infer", {"common_config": {
                                "job_type": "Infer"}})):
            path = os.path.join(self._tmp.name, f"{name}.yml")
            dump_yaml({**extra, "embedding_parameter_server_config": {
                "capacity": 2_000_000, "num_hashmap_internal_shards": 8,
                "enable_incremental_update": True,
                "incremental_buffer_size": self.buffer_size,
                "incremental_dir": self.inc_dir}}, path)
            self.ctxs.append(ServiceCtx(
                build_schema(), n_workers=1, n_ps=N_PS,
                global_config_path=path, startup_timeout=SV_START_S,
                env={"LOG_LEVEL": "WARNING"}))
        self.train, self.infer = self.ctxs
        self._start()


def seq_signs(batches):
    """The distinct signs of ``batches`` (the PS keys: the seq_rec schema
    has no prefix or hash stack)."""
    import numpy as np

    return np.unique(np.concatenate([f.signs for b in batches
                                     for f in b.id_type_features]))


def online_batches():
    """(b)'s training batches: ``ON_B_ROUNDS * ON_B_STEPS`` of seq_rec."""
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    return list(seqrec_batches(
        ON_B_ROUNDS * ON_B_STEPS * TRAIN_BATCH, TRAIN_BATCH,
        seed=TRAIN_SEED + 16,
        spec=SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)))


def on_request(rows: int, seed: int, lo: int = 1, hi: int = 20_000):
    """bench.py's ``_online_request``: ``rows`` single-id rows over the
    four slots and 13 dense features, made from ``seed``."""
    import numpy as np

    from persia_tpu_torch.data.batch import IDTypeFeatureWithSingleID, \
        NonIDTypeFeature, PersiaBatch

    rng = np.random.default_rng(seed)
    signs = rng.integers(lo, hi, size=(rows, ON_SLOTS)).astype(np.uint64)
    return PersiaBatch(
        [IDTypeFeatureWithSingleID(f"slot_{s}",
                                   np.ascontiguousarray(signs[:, s]))
         for s in range(ON_SLOTS)],
        non_id_type_features=[NonIDTypeFeature(
            rng.normal(size=(rows, ON_DENSE)).astype(np.float32))],
        requires_grad=False)


def pctl(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(values, q))


def online_freshness(torch, card: str) -> str:
    """(a) bench_online's freshness A/B on the port: 2 ``PsService`` over
    sockets with dumpers armed (buffer 1 << 30, flushed by the bench), an
    in-process worker, ``DLRM(embedding_dim=16)`` on the card, a live
    training thread; a TTL-only server (4 s) against a subscriber server
    (TTL 3600 s, scans every 0.15 s). Gates: the subscriber's end-to-end
    lag p99 at least 5x smaller; a subscriber scan adds no PS RPC; no
    kernel. The paired p99 inflation is printed beside the bench's 3%
    contract."""
    import tempfile

    import numpy as np

    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.inc_update import IncrementalUpdateDumper
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.ps.native import make_holder
    from persia_tpu_torch.serving import InferenceClient, InferenceServer
    from persia_tpu_torch.service.ps_service import PsClient, PsService
    from persia_tpu_torch.weights import init_params
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    reset_launch_counts()
    tmp = tempfile.TemporaryDirectory()
    inc_dir = os.path.join(tmp.name, "inc")
    schema = EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{s}" for s in range(ON_SLOTS)], dim=DIM))
    holders = [make_holder(2_000_000, 8) for _ in range(N_PS)]
    dumpers = [IncrementalUpdateDumper(h, inc_dir, buffer_size=1 << 30,
                                       replica_index=i)
               for i, h in enumerate(holders)]
    services = [PsService(h, inc_dumper=d) for h, d in zip(holders, dumpers)]
    servers, clients = {}, {}
    stop = threading.Event()
    trainer = flusher = None
    try:
        for s in services:
            s.server.serve_background()
        worker = EmbeddingWorker(schema, [
            PsClient(s.addr, circuit_breaker=False) for s in services])
        worker.configure_parameter_servers(
            "bounded_uniform", {"lower": -0.01, "upper": 0.01}, 1.0, 1e9)
        worker.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
        model = init_params(DLRM(ON_DENSE, ON_SLOTS, embedding_dim=DIM,
                                 device="cuda"), SEED).eval()
        # the probe's signs are disjoint from the noise's: a noise update
        # never moves the probe's prediction
        probe = on_request(ON_PROBE_ROWS, 1, lo=1_000_000, hi=1_001_000)
        noise = [on_request(32, 100 + i) for i in range(8)]
        for b in [probe] + noise:
            worker.lookup_direct(b.id_type_features, training=True)
        errors = []

        def train(b):
            ref, out = worker.lookup_direct_training(b.id_type_features)
            worker.update_gradients(ref, {
                k: np.ones_like(v.embeddings) for k, v in out.items()})

        def train_loop():
            rng = np.random.default_rng(7)
            while not stop.is_set():
                try:
                    train(noise[int(rng.integers(len(noise)))])
                except Exception as e:  # noqa: BLE001 — raised below
                    errors.append(e)
                    return
                time.sleep(0.002)

        def flush_all():
            for d in dumpers:
                d.flush()

        trainer = threading.Thread(target=train_loop, daemon=True)
        trainer.start()
        for arm, ttl in (("ttl", ON_TTL_S), ("online", 3600.0)):
            servers[arm] = InferenceServer(model, schema, worker,
                                           device="cuda",
                                           cache_rows=ON_CACHE_ROWS,
                                           cache_ttl_sec=ttl)
        sub = servers["online"].attach_delta_subscriber(
            inc_dir, scan_interval_sec=ON_SCAN_S)
        for arm, server in servers.items():
            server.serve_background()
            clients[arm] = InferenceClient(server.addr)
        blob = probe.to_bytes()
        lags = {}
        for arm, cl in clients.items():
            lags[arm] = []
            for _ in range(ON_ROUNDS):
                before = cl.predict_bytes(blob).tobytes()
                train(probe)
                flush_all()
                t_flush = time.monotonic()
                deadline = t_flush + 3 * ON_TTL_S + 30
                while cl.predict_bytes(blob).tobytes() == before:
                    if time.monotonic() > deadline:
                        raise AssertionError(
                            f"online (a) {arm}: the probe's update was not "
                            f"servable within {deadline - t_flush:.0f} s")
                    time.sleep(0.02)
                lags[arm].append(time.monotonic() - t_flush)
        p99 = {arm: pctl(v, 99) for arm, v in lags.items()}
        speedup = p99["ttl"] / max(p99["online"], 1e-9)
        # the paired p99 inflation, a background flush keeping the
        # subscriber applying
        def flush_loop():
            while not stop.wait(0.4):
                flush_all()

        flusher = threading.Thread(target=flush_loop, daemon=True)
        flusher.start()
        lat_blobs = [b.to_bytes() for b in noise[:4]]
        for cl in clients.values():
            for b in lat_blobs:
                cl.predict_bytes(b)
        samples = {arm: [] for arm in clients}
        for _ in range(ON_P99_BLOCKS):
            for arm, cl in clients.items():
                for i in range(ON_P99_PER_BLOCK):
                    t0 = time.perf_counter()
                    cl.predict_bytes(lat_blobs[i % len(lat_blobs)])
                    samples[arm].append(time.perf_counter() - t0)
        stop.set()
        trainer.join(timeout=10)
        flusher.join(timeout=10)
        if errors:
            raise errors[0]
        lat99 = {arm: pctl(v, 99) * 1e3 for arm, v in samples.items()}
        inflation = lat99["online"] / lat99["ttl"] - 1.0
        # the wire at rest: with the scanner thread stopped, a fresh
        # packet, then a scan of it, moves no PS request count (the
        # packets are read from disk)
        sub.stop()
        train(probe)
        flush_all()
        served0 = [s.server.health()["served_rpcs"] for s in services]
        scanned = sub.scan_once()
        served1 = [s.server.health()["served_rpcs"] for s in services]
        health = sub.health()
    finally:
        stop.set()
        for t in (trainer, flusher):
            if t is not None:
                t.join(timeout=10)
        for cl in clients.values():
            cl.close()
        for server in servers.values():
            server.stop()
        for s in services:
            s.stop()
        tmp.cleanup()
    launches = assert_no_kernel_launched("online", card)
    line = (f"(a) bench_online, {ON_ROUNDS} freshness rounds: "
            f"sign-to-servable lag TTL-only (TTL {ON_TTL_S} s) p50 "
            f"{pctl(lags['ttl'], 50):.3f} s p99 {p99['ttl']:.3f} s, "
            f"subscriber (scan {ON_SCAN_S} s) p50 "
            f"{pctl(lags['online'], 50):.3f} s p99 {p99['online']:.3f} s: "
            f"{speedup:.2f}x fresher (gate 5x); subscriber packets "
            f"{health['packets_applied']}, rows applied "
            f"{health['rows_applied']} skipped {health['rows_skipped']} "
            f"filtered {health['rows_filtered']}, throttled "
            f"{health['throttled_sec']} s; paired predict p99 TTL-only "
            f"{lat99['ttl']:.3f} ms, subscriber {lat99['online']:.3f} ms, "
            f"inflation {inflation:+.2%} (the bench's contract <= 3%, "
            f"printed only; {ON_P99_BLOCKS} x {ON_P99_PER_BLOCK} a side); "
            f"a scan of {scanned} rows moved the PS request counts "
            f"{served0} -> {served1}")
    if speedup < 5.0 or not health["packets_applied"] \
            or not health["rows_applied"] or served1 != served0 \
            or not scanned:
        raise AssertionError(f"online (a): {line}")
    return line, launches


def online_seq_rec(torch, card: str, clusters: OnlineClusters):
    """(b) seq_rec trained over the training cluster's processes on the
    card (K2-K4 a step) while an ``InferenceServer`` over the infer
    cluster's worker, with the trainer's start weights frozen and its
    hot-row cache subscribed to the packets, serves a probe a round: the
    round's first batch, cached (as zero rows: the infer PS is empty)
    before any step. Gates: each round's probe changes within
    ``ON_B_PROBE_S``; K2-K4 once a trainer step and K2 on serving.
    Returns the settle check (see :func:`online_settle`) and the launch
    counts."""
    import numpy as np

    from persia_tpu_torch.data.batch import PersiaBatch
    from persia_tpu_torch.serving import InferenceClient, InferenceServer
    from persia_tpu_torch.workloads.generator import SeqRecSpec

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    schema = build_schema()
    start = build_tower(spec.num_dense, "flash").state_dict()
    ctx = train_ctx(torch, schema, build_tower(spec.num_dense, "flash",
                                               state_dict=start),
                    worker=clusters.train.remote_worker())
    server = InferenceServer(
        build_tower(spec.num_dense, "flash", state_dict=start).eval(),
        schema, worker_addrs=clusters.infer.worker_addrs, device="cuda",
        cache_rows=ON_B_CACHE_ROWS, cache_ttl_sec=3600.0)
    sub = server.attach_delta_subscriber(clusters.inc_dir,
                                         scan_interval_sec=ON_SCAN_S)
    server.serve_background()
    client = InferenceClient(server.addr)
    probes = []
    for r in range(ON_B_ROUNDS):
        p = PersiaBatch.from_bytes(
            clusters.batches[r * ON_B_STEPS].to_bytes())
        p.requires_grad = False
        probes.append(p.to_bytes())
    serve = {n: 0 for n in kernel_launches()}
    trained = dict(serve)

    def count(into, before):
        for n, c in kernel_launches().items():
            into[n] += c - before[n]

    reset_launch_counts()
    lags = []
    try:
        before = kernel_launches()
        for p in probes:  # every probe's rows resident from the start
            client.predict_bytes(p)
        torch.cuda.synchronize()
        count(serve, before)
        with ctx:
            for r in range(ON_B_ROUNDS):
                before = kernel_launches()
                old = client.predict_bytes(probes[r]).tobytes()
                count(serve, before)
                before = kernel_launches()
                for b in clusters.batches[r * ON_B_STEPS:
                                          (r + 1) * ON_B_STEPS]:
                    ctx.train_step(b)
                torch.cuda.synchronize()
                count(trained, before)
                # the last step's update RPCs returned: its packets exist
                t_done = time.monotonic()
                before = kernel_launches()
                while client.predict_bytes(probes[r]).tobytes() == old:
                    if time.monotonic() - t_done > ON_B_PROBE_S:
                        raise AssertionError(
                            f"online (b): round {r}'s probe did not change "
                            f"within {ON_B_PROBE_S} s")
                    time.sleep(0.01)
                lags.append(time.monotonic() - t_done)
                torch.cuda.synchronize()
                count(serve, before)
        signs = seq_signs(clusters.batches)
    except BaseException:
        client.close()
        server.stop()
        raise
    ctx.worker.close()
    steps = ON_B_ROUNDS * ON_B_STEPS
    flash = [trained[n] for n in FLASH_KERNELS]
    line = (f"(b) seq_rec over processes, {ON_B_ROUNDS} rounds of "
            f"{ON_B_STEPS} steps of batch {TRAIN_BATCH} (packet buffer "
            f"{clusters.buffer_size} signs): the probe (a round's first "
            f"batch, {TRAIN_BATCH} rows) changed {pctl(lags, 50):.3f} s "
            f"(p50) / {pctl(lags, 99):.3f} s (p99) after the round's last "
            f"step, each {', '.join(f'{x:.3f}' for x in lags)} s; launches "
            f"in {steps} trainer steps {trained}, on serving {serve}")
    if flash != [steps] * 3 or serve[FLASH_KERNELS[0]] <= 0 \
            or any(serve[n] for n in FLASH_KERNELS[1:]) \
            or trained["embedding_bag"] or trained["probe_copy"] \
            or serve["embedding_bag"] or serve["probe_copy"]:
        client.close()
        server.stop()
        raise AssertionError(f"online (b): {line}")
    launches = {n: trained[n] + serve[n] for n in trained}
    return (line, (server, client, sub, signs)), launches


def online_settle(card: str, clusters: OnlineClusters, server, client,
                  sub, signs) -> str:
    """(b)'s end: once both consumers have scanned past the last packet,
    every touched row read from the infer PS (``get_entries`` on its
    owning replica) is bit-equal to the training PS's, and every resident
    cache row of a touched sign equals that row's embedding slice."""
    import numpy as np

    from persia_tpu_torch.hashing import sign_to_shard
    from persia_tpu_torch.inc_update import ready_packets
    from persia_tpu_torch.service.ps_service import PsClient

    t0 = time.monotonic()
    train = [PsClient(a) for a in clusters.train.ps_addrs]
    infer = [PsClient(a) for a in clusters.infer.ps_addrs]
    try:
        n_packets = len(list(ready_packets(clusters.inc_dir, set())))
        while (sub.packets_applied < n_packets or any(
                c.health()["inc_update_packets_applied"] < n_packets
                for c in infer)):
            if time.monotonic() - t0 > ON_B_SETTLE_S:
                raise AssertionError(
                    f"online (b): the consumers did not reach "
                    f"{n_packets} packets in {ON_B_SETTLE_S} s: subscriber "
                    f"{sub.packets_applied}, infer PS " + str([
                        c.health()["inc_update_packets_applied"]
                        for c in infer]))
            time.sleep(0.1)
        waited = time.monotonic() - t0
        owner = sign_to_shard(signs, N_PS)
        width = 2 * DIM  # [embedding | Adagrad state]
        rows_differ = missing = 0
        want = {}
        for r in range(N_PS):
            mine = signs[owner == r]
            tf, tv = train[r].get_entries(mine, width)
            jf, jv = infer[r].get_entries(mine, width)
            missing += int((tf != 1).sum() + (jf != 1).sum())
            rows_differ += int((tv.view(np.uint32) != jv.view(np.uint32))
                               .any(axis=-1).sum())
            want.update(zip(mine.tolist(), tv[:, :DIM]))
        resident = [(s, row) for (d, s), (row, _exp, _ver)
                    in list(server.cache._od.items()) if s in want]
        cache_differ = sum(row.tobytes() != want[s].tobytes()
                           for s, row in resident)
        health = sub.health()
    finally:
        for c in train + infer:
            c.client.close()
        client.close()
        server.stop()
    line = (f"(b) settled {waited:.3f} s after the rounds: {n_packets} "
            f"packets, the subscriber applied {health['rows_applied']} rows "
            f"(skipped {health['rows_skipped']}, throttled "
            f"{health['throttled_sec']} s); {len(signs)} touched rows on the "
            f"infer PS against the training PS: missing {missing}, differ "
            f"in any bit {rows_differ}; {len(resident)} resident cache rows "
            f"against the embedding slice: differ {cache_differ}")
    if missing or rows_differ or cache_differ or not resident:
        raise AssertionError(f"online (b): {line}")
    return line


def online_phase(torch, card: str, clusters: OnlineClusters) -> dict:
    """(a) and (b) (``online_freshness``, ``online_seq_rec``); (b)'s
    settle check runs after (a), by when the infer PS's loader (a scan
    every 10 s) has passed the last packet. (c) is ``supervision``'s.
    Returns each kernel's launches over the phase."""
    up = clusters.wait()
    _log(f"[online] the training and infer clusters up {up:.1f}s after "
         f"their start (beside the kernel build): train PS "
         f"{clusters.train.ps_addrs}, infer PS {clusters.infer.ps_addrs} "
         f"| card: {card}")
    t0 = time.perf_counter()
    (b_line, settle_args), launches = online_seq_rec(torch, card, clusters)
    _log(f"[online] {b_line} | card: {card}")
    t1 = time.perf_counter()
    _log(f"[time] online (b) {t1 - t0:.1f}s")
    try:
        a_line, a_launches = online_freshness(torch, card)
    except BaseException:
        server, client, _sub, _signs = settle_args
        client.close()
        server.stop()
        raise
    _log(f"[online] {a_line} | card: {card}")
    t2 = time.perf_counter()
    _log(f"[time] online (a) {t2 - t1:.1f}s")
    _log(f"[online] {online_settle(card, clusters, *settle_args)} "
         f"| card: {card}")
    _log(f"[time] online (b) settle {time.perf_counter() - t2:.1f}s")
    for c in clusters.ctxs:
        if c.crashed:
            raise AssertionError(f"online: a child crashed: {c.crashed}")
    return {n: launches[n] + a_launches[n] for n in launches}


# --- reshard: live resharding of the PS tier ---------------------------------

RS_DIM = 8  # (a): bench_reshard's widths
RS_FEATS = 2
RS_BATCH = 256
RS_SIGN_SPACE = 1 << 20
RS_QUIET_S = 0.4  # (a): quiet traffic before, between and after the moves
RS_DRAIN_S = 0.25  # the double-read window the controller waits out
RS_P99_X = 25.0  # (a): the bench's p99 inflation gate ...
RS_P99_FLOOR_S = 1.0  # ... above this p99 during the migration
RS_SKEW_WARM = 12  # (a): sketch-building batches, then the A/B trace
RS_SKEW_TRACE = 24
RS_STEPS = 16  # (b): synchronous steps of each run
RS_FROM = 4  # (b): the controller starts before this step


class ReshardClusters(ServiceClusters):
    """(b)'s two ``ServiceCtx(n_workers=1, n_ps=2)`` clusters at the
    seq_rec widths, entered on threads while the kernels build: one to be
    resharded 2→3 under the trainer, one unbroken (the reference); and the
    resharded cluster's third ``PsService`` process, which registers with
    no coordinator (the migration hands its address to the worker).
    :meth:`stop` takes them all down."""

    def __init__(self):
        import subprocess
        import tempfile

        from persia_tpu_torch.service.helper import ServiceCtx
        from persia_tpu_torch.utils import dump_yaml

        self._tmp = tempfile.TemporaryDirectory()
        path = os.path.join(self._tmp.name, "global.yml")
        dump_yaml({"embedding_parameter_server_config": {
            "capacity": 2_000_000, "num_hashmap_internal_shards": 8}}, path)
        self.ctxs = [ServiceCtx(build_schema(), n_workers=1, n_ps=N_PS,
                                global_config_path=path,
                                startup_timeout=SV_START_S,
                                env={"LOG_LEVEL": "WARNING"})
                     for _ in range(2)]
        self.rs, self.ref = self.ctxs
        self.extra_addr_file = os.path.join(self._tmp.name, "ps2.addr")
        env = {**os.environ, "LOG_LEVEL": "WARNING",
               "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        self.extra_ps = subprocess.Popen(
            [sys.executable, "-m", "persia_tpu_torch.service.ps_service",
             "--port", "0", "--replica-index", str(N_PS), "--replica-size",
             str(N_PS + 1), "--coordinator", "", "--global-config", path,
             "--http-port", "-1", "--addr-file", self.extra_addr_file],
            env=env)
        self._start()

    def extra_addr(self) -> str:
        from persia_tpu_torch.utils import wait_addr_file

        return wait_addr_file(self.extra_addr_file, SV_START_S,
                              self.extra_ps)

    def stop(self):
        self.extra_ps.terminate()
        try:
            self.extra_ps.wait(timeout=10)
        except Exception:  # noqa: BLE001 — then it is killed
            self.extra_ps.kill()
            self.extra_ps.wait(timeout=10)
        super().stop()


def rs_rows(holder) -> dict:
    """sign -> (dim, row) of an in-process per-entry PS holder."""
    return {int(s): e for shard in holder._shards for s, e in shard.items()}


def rs_applied(holders, table) -> float:
    """Minus the sum of every row's value at the owner ``table`` routes
    it to (donors keep stale copies of moved rows, which do not count):
    with zero init, unit gradients and SGD at lr 1, the updates applied."""
    import numpy as np

    applied = 0.0
    for i, h in enumerate(holders):
        rows = rs_rows(h)
        if not rows:
            continue
        owners = table.replica_of(np.fromiter(rows, np.uint64, len(rows)))
        applied += sum(-float(v[:d].sum()) / RS_DIM
                       for (d, v), o in zip(rows.values(), owners) if o == i)
    return applied


def reshard_dance(card: str) -> str:
    """(a) bench_reshard at its smoke depth on the port's services: the
    live 2→4→3 under two trainer threads (the counting identity exact at
    the new owners across both cutovers; the worker-cycle p99 during the
    migrations within 25x of the quiet p99 above a 1 s floor), the skew
    A/B under Zipf(1.05) (the hotness-planned table's max-replica share,
    measured server-side, below hash-even's), and a uniform-table
    checkpoint byte-identical to the legacy dump. Returns the report."""
    import filecmp
    import tempfile

    import numpy as np

    from persia_tpu_torch import hotness, knobs
    from persia_tpu_torch.checkpoint import dump_sharded
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.data.batch import IDTypeFeature
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.reshard import ReshardController
    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service.ps_service import PsClient, PsService
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    schema = EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{i}" for i in range(RS_FEATS)], dim=RS_DIM))

    def feature(name, signs):
        return IDTypeFeature(name, [np.asarray(signs, dtype=np.uint64)])

    def stack(n, hotness_on=False):
        holders, services, clients = [], [], []
        for _ in range(n):
            h = EmbeddingHolder(capacity=2_000_000, hotness=hotness_on)
            svc = PsService(h, port=0)
            svc.server.serve_background()
            c = PsClient(svc.addr, circuit_breaker=False)
            c.configure("bounded_uniform", {"lower": 0.0, "upper": 0.0},
                        admit_probability=1.0, weight_bound=1e9,
                        enable_weight_bound=False)
            c.register_optimizer({"type": "sgd", "lr": 1.0, "wd": 0.0})
            holders.append(h)
            services.append(svc)
            clients.append(c)
        return holders, services, clients

    # the live 2→4→3 under traffic; the controllers' counters are the
    # process's, so (a)'s are read as deltas
    from persia_tpu_torch.metrics import default_registry

    reg = default_registry()
    counted0 = [reg.counter(n).value for n in (
        "reshard_moved_rows_total", "reshard_replayed_rows_total")]
    holders, services, clients = stack(4)
    table = RoutingTable.uniform(2)
    worker = EmbeddingWorker(schema, clients[:2], routing=table)
    ships, samples, errors = [0], [], []
    lock = threading.Lock()
    stop = threading.Event()

    def train(seed):
        # every sign occurrence adds exactly -1 to its row
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            raw = [rng.integers(0, RS_SIGN_SPACE, RS_BATCH, dtype=np.uint64)
                   for _ in range(RS_FEATS)]
            t0 = time.perf_counter()
            try:
                ref, out = worker.lookup_direct_training(
                    [feature(f"slot_{i}", r) for i, r in enumerate(raw)])
                worker.update_gradients(ref, {
                    k: np.ones_like(v.embeddings) for k, v in out.items()})
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)
                return
            dt = time.perf_counter() - t0
            with lock:
                ships[0] += RS_FEATS * RS_BATCH
                samples.append((t0, dt))

    threads = [threading.Thread(target=train, args=(s,), daemon=True)
               for s in range(2)]
    for t in threads:
        t.start()
    windows = []
    ctrl = ReshardController(clients[:2], table, workers=[worker],
                             replay_settle_rows=64, drain_sec=RS_DRAIN_S)
    try:
        time.sleep(RS_QUIET_S)
        w0 = time.perf_counter()
        t4 = ctrl.reshard_to(4, new_ps_clients=clients)
        windows.append((w0, time.perf_counter()))
        time.sleep(RS_QUIET_S)
        w0 = time.perf_counter()
        t3 = ctrl.reshard_to(3)
        windows.append((w0, time.perf_counter()))
        time.sleep(RS_QUIET_S)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    if errors:
        raise AssertionError(f"reshard (a): a trainer thread died "
                             f"mid-reshard: {errors[0]!r}")
    if any(t.is_alive() for t in threads):
        raise AssertionError("reshard (a): a trainer thread wedged across "
                             "the reshard")
    ctrl.finalize(drain_sec=0.0)
    if not (worker.routing_epoch == t3.epoch == t4.epoch + 1
            and t3.num_replicas == 3):
        raise AssertionError(f"reshard (a): epochs {t4.epoch}, {t3.epoch}, "
                             f"worker {worker.routing_epoch}")
    applied = rs_applied(holders, t3)
    lost = ships[0] - applied

    def p99(vals):
        return float(np.percentile(np.asarray(vals), 99)) if vals else 0.0

    during = [d for t0, d in samples
              if any(a <= t0 <= b for a, b in windows)]
    quiet = [d for t0, d in samples
             if not any(a - 0.1 <= t0 <= b + 0.1 for a, b in windows)]
    p99_quiet, p99_during = p99(quiet), p99(during)
    inflation = p99_during / p99_quiet if p99_quiet > 0 else 0.0
    moved, replayed = (int(ctrl._c_moved.value - counted0[0]),
                       int(ctrl._c_replayed.value - counted0[1]))
    worker.close()
    for svc in services:
        svc.stop()
    dance = (f"2→4→3 ships={ships[0]} applied={applied:.1f} "
             f"lost={lost:.3f}; moved rows {moved}, replayed rows "
             f"{replayed}; worker-cycle p99 quiet "
             f"{p99_quiet * 1e3:.2f} ms ({len(quiet)} cycles) vs during the "
             f"migrations {p99_during * 1e3:.2f} ms ({len(during)} cycles): "
             f"{inflation:.2f}x (gate {RS_P99_X}x above "
             f"{RS_P99_FLOOR_S}s); migrations "
             + ", ".join(f"{b - a:.3f}s" for a, b in windows))
    if abs(lost) > 1e-3:
        raise AssertionError(f"reshard (a): lost updates across the live "
                             f"2→4→3: {dance}")
    if p99_during > RS_P99_FLOOR_S and inflation > RS_P99_X:
        raise AssertionError(f"reshard (a): worker p99 inflated: {dance}")

    # the skew A/B: a zipf(1.05)-ranked hot set in every batch over a
    # uniform cold tail, through 4 replicas under hash-even routing and
    # under the placement planned from the fleet's own merged sketches;
    # load is counted server-side (signs each replica served)
    holders, services, clients = stack(4, hotness_on=True)
    spr = int(knobs.get("PERSIA_ROUTING_SLOTS_PER_REPLICA"))
    even = RoutingTable(1, np.arange(4 * spr, dtype=np.int32) % 4, 4)
    worker = EmbeddingWorker(schema, clients, routing=even)
    rng = np.random.default_rng(11)
    hot_n = 128
    hot_p = np.arange(1, hot_n + 1, dtype=np.float64) ** -1.05
    hot_p /= hot_p.sum()
    with np.errstate(over="ignore"):
        hot_pool = (np.arange(1, hot_n + 1, dtype=np.uint64)
                    * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(1)

    def zipf_feats():
        n_hot = int(RS_BATCH * 0.7)
        signs = np.concatenate([
            rng.choice(hot_pool, size=n_hot, p=hot_p),
            rng.integers(1 << 30, 1 << 40, RS_BATCH - n_hot,
                         dtype=np.uint64)])
        return [feature(f"slot_{i}", signs) for i in range(RS_FEATS)]

    for _ in range(RS_SKEW_WARM):
        worker.lookup_direct(zipf_feats(), training=False)
    snap = hotness.merge_snapshots([c.hotness() for c in clients])
    plan = hotness.placement_plan(snap, 4, current_table=even)
    balanced = even.derive(np.asarray(plan["assignment"], np.int32), 4,
                           weights=np.asarray(plan["slot_weights"]))
    trace = [zipf_feats() for _ in range(RS_SKEW_TRACE)]

    def measured_shares(tbl):
        worker.apply_routing(tbl)
        worker.close_routing_window()
        before = [c.hotness().get("total", 0) for c in clients]
        for feats in trace:
            worker.lookup_direct(feats, training=False)
        after = [c.hotness().get("total", 0) for c in clients]
        served = np.array(after, np.float64) - np.array(before, np.float64)
        return served / max(served.sum(), 1.0)

    even_max = float(measured_shares(
        even.derive(even.replica_of_slot, 4)).max())
    bal_max = float(measured_shares(
        balanced.derive(balanced.replica_of_slot, 4)).max())
    worker.close()
    for svc in services:
        svc.stop()
    skew = (f"skew A/B under Zipf(1.05): max-replica share {even_max:.4f} "
            f"hash-even vs {bal_max:.4f} hotness-balanced "
            f"({even_max / bal_max:.3f}x; planned "
            f"{plan['max_replica_share']} vs "
            f"{plan['hash_even_max_share']}, {plan['moved_slots']} slots "
            f"moved)")
    if not bal_max < even_max:
        raise AssertionError(f"reshard (a): the balanced placement did not "
                             f"beat hash-even: {skew}")

    # a uniform table's dump is the legacy dump byte for byte
    with tempfile.TemporaryDirectory() as tmp:
        hs = [EmbeddingHolder(capacity=10_000) for _ in range(2)]
        t2 = RoutingTable.uniform(2)
        signs = np.unique(rng.integers(0, 1 << 40, 500, dtype=np.uint64))
        for sign, owner in zip(signs, t2.replica_of(signs)):
            hs[owner].set_entry(int(sign), RS_DIM,
                                np.arange(2 * RS_DIM, dtype=np.float32))
        a, b = os.path.join(tmp, "legacy"), os.path.join(tmp, "routed")
        dump_sharded(hs, a)
        dump_sharded(hs, b, routing=t2)
        names = sorted(os.listdir(a))
        identical = names == sorted(os.listdir(b)) and all(
            filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                        shallow=False) for n in names)
    if not identical:
        raise AssertionError("reshard (a): a uniform-table checkpoint is "
                             "not byte-identical to the legacy dump")
    return (f"{dance}; {skew}; the uniform-table checkpoint byte-identical "
            f"to the legacy dump ({len(names)} files)")


def reshard_seq_rec(torch, card: str, clusters: ReshardClusters):
    """(b) seq_rec at the training phase's widths over the resharded
    cluster, a ``ReshardController`` taking its PS tier 2→3 on a thread
    from step 4 while the trainer steps on (writes meeting the freeze
    bounce and settle), against the same steps on the unbroken cluster.
    Gates: losses, dense state with Adam's, and every touched row (read
    from its owner under the final table) equal bit for bit; K2-K4 once a
    step, K1 and K5 never; the worker's, each PS's and the controller's
    epochs equal; a snapshot's manifest carries that epoch. Returns (the
    report, the resharded run's launches)."""
    import tempfile

    import numpy as np

    from persia_tpu_torch.reshard import ReshardController
    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service.coordinator import CoordinatorClient
    from persia_tpu_torch.service.ps_service import PsClient
    from persia_tpu_torch.snapshot import load_manifest
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    schema = build_schema()
    batches = list(seqrec_batches(RS_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                                  seed=TRAIN_SEED + 17, spec=spec))
    signs = np.unique(np.concatenate([f.signs for b in batches
                                      for f in b.id_type_features]))
    start = build_tower(spec.num_dense, "flash").state_dict()

    def run(svc, on_step=None):
        ctx = train_ctx(torch, schema, build_tower(
            spec.num_dense, "flash", state_dict=start),
            worker=svc.remote_worker())
        losses = []
        with ctx:
            reset_launch_counts()
            t0 = time.perf_counter()
            for step, b in enumerate(batches):
                if on_step is not None:
                    on_step(step, ctx)
                losses.append(ctx.train_step(b)[0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_launches()
        losses = torch.stack(losses).float().cpu().tolist()
        if not np.isfinite(losses).all():
            raise AssertionError("reshard (b): a loss is not finite")
        return ctx, losses, dense_state(ctx), launches, wall

    ref_ctx, ref_losses, ref_dense, _, ref_wall = run(clusters.ref)
    ref_clients = [PsClient(a) for a in clusters.ref.ps_addrs]
    found = np.zeros(len(signs), np.int64)
    ref_rows = np.zeros((len(signs), 2 * DIM), np.float32)
    for c in ref_clients:
        f, v = c.get_entries(signs, 2 * DIM)
        found += f
        ref_rows[f] = v[f]
    ref_ctx.worker.close()

    from persia_tpu_torch.metrics import default_registry

    reg = default_registry()
    counted0 = [reg.counter(n).value for n in (
        "reshard_moved_rows_total", "reshard_replayed_rows_total")]
    rs = clusters.rs
    clients = [PsClient(a, circuit_breaker=False)
               for a in [*rs.ps_addrs, clusters.extra_addr()]]
    box = {}

    def on_step(step, ctx):
        if step == 0:
            # the new replica gets the init, admission and optimizer the
            # context armed the first two with
            ec = ctx.embedding_config
            lower, upper = ec.emb_initialization
            clients[-1].configure(
                "bounded_uniform", {"lower": lower, "upper": upper},
                ec.admit_probability, ec.weight_bound,
                enable_weight_bound=True)
            clients[-1].register_optimizer(
                ctx.embedding_optimizer.config,
                feature_index_prefix_bit=schema.feature_index_prefix_bit)
        if step != RS_FROM:
            return
        ctrl = box["ctrl"] = ReshardController(
            clients[:N_PS], RoutingTable.uniform(N_PS), workers=[ctx.worker],
            coordinator=CoordinatorClient(rs.coordinator_addr),
            drain_sec=RS_DRAIN_S)

        def migrate():
            try:
                t0 = time.perf_counter()
                box["table"] = ctrl.reshard_to(N_PS + 1,
                                               new_ps_clients=clients)
                box["migrate_s"] = time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 — raised below
                box["error"] = e

        box["thread"] = threading.Thread(target=migrate, daemon=True)
        box["thread"].start()

    ctx, losses, dense, launches, wall = run(rs, on_step)
    box["thread"].join(timeout=120)
    if "error" in box or box["thread"].is_alive():
        raise AssertionError(f"reshard (b): the migration failed: "
                             f"{box.get('error')!r}")
    ctrl, table = box["ctrl"], box["table"]
    ctrl.finalize()
    rows = np.zeros((len(signs), 2 * DIM), np.float32)
    owner = table.replica_of(signs)
    for r, c in enumerate(clients):
        sel = np.nonzero(owner == r)[0]
        f, v = c.get_entries(signs[sel], 2 * DIM)
        if not f.all():
            raise AssertionError(f"reshard (b): {int((~f).sum())} touched "
                                 f"rows absent at their owner {r}")
        rows[sel] = v
    with tempfile.TemporaryDirectory() as tmp:
        with ctx:
            manifest = load_manifest(ctx.snapshot(tmp))
    ctx.worker.close()
    loss_diff = sum(a != b for a, b in zip(losses, ref_losses))
    dense_diff = first_difference(ref_dense, dense)
    row_diff = int((rows.view(np.uint32) != ref_rows.view(np.uint32))
                   .any(axis=-1).sum())
    ps_epochs = [c.reshard_status()["routing_epoch"] for c in clients]
    health = [t for t in rs.fleet_targets()
              if t["role"] == "embedding-worker"]
    worker_epochs = [obs_get(t["http_addr"], "/healthz")["routing_epoch"]
                     for t in health]
    epochs = {"controller": table.epoch, "worker broadcast":
              ctx.worker.routing_epoch, "worker health": worker_epochs,
              "PS": ps_epochs, "manifest": manifest["routing_epoch"],
              "manifest table": (manifest.get("routing") or {}).get("epoch")}
    line = (f"(b) seq_rec {RS_STEPS} synchronous steps of {TRAIN_BATCH} "
            f"over the services, 2→3 from step {RS_FROM} (migration "
            f"{box['migrate_s']:.3f}s, moved rows "
            f"{int(ctrl._c_moved.value - counted0[0])}, replayed rows "
            f"{int(ctrl._c_replayed.value - counted0[1])}) against the "
            f"unbroken cluster: "
            f"losses that differ {loss_diff}, dense state "
            f"{dense_diff or 'bit-equal'}; {len(signs)} touched rows from "
            f"their owners under epoch {table.epoch} ({np.bincount(owner, minlength=3).tolist()} a replica), rows that differ in "
            f"any bit {row_diff}; epochs {epochs}; wall {wall:.2f}s "
            f"resharded vs {ref_wall:.2f}s unbroken; launches "
            + " ".join(f"{n}={c}" for n, c in launches.items()))
    flash = [launches[n] for n in FLASH_KERNELS]
    if flash != [RS_STEPS] * 3 or launches["embedding_bag"] \
            or launches["probe_copy"]:
        raise AssertionError(f"reshard (b): K2-K4 must launch once a step "
                             f"and K1, K5 never: {line}")
    if loss_diff or dense_diff or row_diff or not (found == 1).all():
        raise AssertionError(f"reshard (b): the resharded run differs from "
                             f"the unbroken one: {line}")
    want = table.epoch
    if not (want == N_PS and epochs["worker broadcast"] == want
            and worker_epochs == [want] and ps_epochs == [want] * 3
            and epochs["manifest"] == want
            and epochs["manifest table"] == want):
        raise AssertionError(f"reshard (b): the epochs disagree: {line}")
    return line, launches


def reshard_phase(torch, card: str, clusters: ReshardClusters) -> dict:
    """(b) on the clusters started in setup, then (a) in process, which
    launches no kernel. Returns (b)'s launches."""
    up = clusters.wait()
    _log(f"[reshard] the resharded and the unbroken clusters up "
         f"{up:.1f}s after their start (beside the kernel build), and a "
         f"third PS at {clusters.extra_addr()} | card: {card}")
    t0 = time.perf_counter()
    b_line, launches = reshard_seq_rec(torch, card, clusters)
    _log(f"[reshard] {b_line} | card: {card}")
    t1 = time.perf_counter()
    _log(f"[time] reshard (b) {t1 - t0:.1f}s")
    reset_launch_counts()
    a_line = reshard_dance(card)
    _log(f"[reshard] (a) {a_line} | card: {card}")
    assert_no_kernel_launched("reshard (a)", card)
    _log(f"[time] reshard (a) {time.perf_counter() - t1:.1f}s")
    for c in clusters.ctxs:
        if c.crashed:
            raise AssertionError(f"reshard: a child crashed: {c.crashed}")
    if clusters.extra_ps.poll() is not None:
        raise AssertionError("reshard: the third PS process exited")
    return launches


FL_SLOTS = 26  # (a): bench_fleet's 26 slots of dims 8/16/32/64
FL_DIM = 16
FL_BATCH = 512
FL_STEPS = 5  # (a): bench.py's max(steps, 5): 4 paired rounds
FL_SCRAPE_S = 0.75
FL_SCRAPE_TIMEOUT_S = 0.5
FL_INFLATION_GATE = 1.03  # reported beside, not enforced (see fl_bench)
FL_B_STEPS = 20  # (b): synchronous steps of each run
FL_B_STALL_AT = 10  # (b): PS 1 stopped between steps 10 and 11
FL_B_SCRAPE_S = 0.5
# (b): a GET's socket timeout, so that a stopped replica reads down within
# two scrape intervals (the next round plus one timeout)
FL_B_SCRAPE_TIMEOUT_S = 0.35
FL_C_REQUESTS = 64  # (c): serialized replies held bit-equal
FL_D_STEPS = 10  # (d): synchronous steps of each tier
FL_D_CAPACITY = 2_000_000
FL_D_SHARDS = 8


def fl_native_schema():
    """seq_rec's slots with the clicks slot summed: the C++ worker has no
    last-k pooling (``ServiceCtx(native_worker=True)`` refuses it)."""
    from persia_tpu_torch.config import EmbeddingSchema, SlotConfig
    from persia_tpu_torch.workloads.generator import SEQ_CLICKS_SLOT

    slots = dict(build_schema().slots_config)
    slots[SEQ_CLICKS_SLOT] = SlotConfig(name=SEQ_CLICKS_SLOT, dim=DIM)
    return EmbeddingSchema(slots_config=slots)


def fl_cli_schema():
    """The serving CLI's schema: seq_rec's summed slots (the zoo's DLRM
    pools no sequence), served by (b)'s worker."""
    from persia_tpu_torch.config import EmbeddingSchema
    from persia_tpu_torch.workloads.generator import SEQ_HISTORY_SLOT

    return EmbeddingSchema(slots_config={
        n: s for n, s in build_schema().slots_config.items()
        if n != SEQ_HISTORY_SLOT})


def fl_cli_requests(seed: int, n: int):
    """``n`` requests of ``REQUEST_ROWS`` rows of seq_rec traffic without
    the history slot."""
    from persia_tpu_torch.data.batch import PersiaBatch
    from persia_tpu_torch.workloads.generator import SEQ_HISTORY_SLOT, \
        SeqRecSpec, seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    return [PersiaBatch([f for f in b.id_type_features
                         if f.name != SEQ_HISTORY_SLOT],
                        non_id_type_features=b.non_id_type_features,
                        requires_grad=False)
            for b in seqrec_batches(n * REQUEST_ROWS, REQUEST_ROWS,
                                    seed=seed, spec=spec)]


class FleetClusters(ServiceClusters):
    """The fleet phase's processes, started right after setup, while the
    first three phases run: (a)'s two PS processes with sidecars (tracing on); (b)'s
    watched and reference seq_rec clusters (every service with its
    sidecar), the watched one's serving CLI (``python -m
    persia_tpu_torch.serving`` on the card, spawned once that cluster is
    up, and probed once for its first reply); (d)'s Python-service and
    all-native tiers. :meth:`stop` takes them all down."""

    def __init__(self):
        import subprocess
        import tempfile

        from persia_tpu_torch import checkpoint as ckpt
        from persia_tpu_torch.serving import _model_zoo
        from persia_tpu_torch.service.helper import ServiceCtx, \
            _schema_to_yaml_dict
        from persia_tpu_torch.utils import dump_yaml
        from persia_tpu_torch.weights import init_params
        from persia_tpu_torch.workloads.generator import SeqRecSpec

        self._tmp = tempfile.TemporaryDirectory()
        tmp = self._tmp.name
        self.pm_dir = os.path.join(tmp, "postmortems")
        path = os.path.join(tmp, "global.yml")
        dump_yaml({"embedding_parameter_server_config": {
            "capacity": 2_000_000, "num_hashmap_internal_shards": 8}}, path)
        env = {"LOG_LEVEL": "WARNING"}
        self.watched, self.ref = (ServiceCtx(
            build_schema(), n_workers=1, n_ps=N_PS, global_config_path=path,
            http_all=True, startup_timeout=SV_START_S, env=env)
            for _ in range(2))
        self.py_tier = ServiceCtx(fl_native_schema(), n_workers=1, n_ps=N_PS,
                                  global_config_path=path,
                                  startup_timeout=SV_START_S, env=env)
        self.native_tier = ServiceCtx(
            fl_native_schema(), n_workers=1, n_ps=N_PS, native_ps=True,
            native_worker=True, ps_capacity=FL_D_CAPACITY,
            ps_num_shards=FL_D_SHARDS, startup_timeout=SV_START_S, env=env)
        self.ctxs = [self.watched, self.ref, self.py_tier, self.native_tier]
        # (c): the CLI's schema file and a dense.pt of seeded weights
        self.cli_schema_path = os.path.join(tmp, "cli_schema.yml")
        dump_yaml(_schema_to_yaml_dict(fl_cli_schema()),
                  self.cli_schema_path)
        self.num_dense = SeqRecSpec().num_dense
        self.ckpt_dir = os.path.join(tmp, "ckpt")
        os.makedirs(self.ckpt_dir)
        donor = init_params(_model_zoo()["dlrm"](
            self.num_dense, fl_cli_schema(), device="cpu"), SEED + 5)
        with open(os.path.join(self.ckpt_dir, ckpt.DENSE_FILE), "wb") as f:
            f.write(ckpt.dense_state_bytes((donor, None)))
        self.cli = None
        self.cli_first = {}
        # (a): bench_fleet's PS processes (tracing on, untraced dials)
        penv = {**os.environ, "LOG_LEVEL": "WARNING", "PERSIA_TRACING": "1",
                "PERSIA_PS_SHARD_PARALLEL": "1",
                "PERSIA_PS_LEGACY_FRAMES": "0",
                "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        self.a_procs, self.a_files = [], []
        for i in range(N_PS):
            files = (os.path.join(tmp, f"a_ps{i}.addr"),
                     os.path.join(tmp, f"a_ps{i}.http"))
            self.a_files.append(files)
            self.a_procs.append(subprocess.Popen(
                [sys.executable, "-m", "persia_tpu_torch.service.ps_service",
                 "--port", "0", "--replica-index", str(i), "--replica-size",
                 str(N_PS), "--coordinator", "", "--addr-file", files[0],
                 "--concurrent-streams", "16", "--http-port", "0",
                 "--http-addr-file", files[1]], env=penv))
        self._start()

    def _enter(self, ctx):
        super()._enter(ctx)
        if ctx is self.watched and ctx.coordinator_addr is not None \
                and not self._errors:
            try:
                self._start_cli()
            except BaseException as e:  # raised by wait()
                self._errors.append(e)

    def _start_cli(self):
        """Spawn the serving CLI against the watched cluster's worker and
        coordinator, then send it one request of signs no later request
        uses, for its first reply."""
        import subprocess

        from persia_tpu_torch.serving import InferenceClient
        from persia_tpu_torch.service.coordinator import ROLE_INFERENCE

        svc = self.watched
        t0 = time.monotonic()
        self.cli = subprocess.Popen(
            [sys.executable, "-m", "persia_tpu_torch.serving", "--model",
             "dlrm", "--dense-checkpoint", self.ckpt_dir,
             "--embedding-config", self.cli_schema_path, "--num-dense",
             str(self.num_dense), "--host", "127.0.0.1", "--port", "0",
             "--coordinator", svc.coordinator_addr, "--worker-addrs",
             svc.worker_addrs[0], "--max-batch-rows", "256",
             "--cache-rows", "100000", "--http-port", "0", "--device",
             "cuda"],
            env={**os.environ, "LOG_LEVEL": "WARNING",
                 "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
        coord = svc.coordinator_client()
        deadline = t0 + SV_START_S
        while not coord.list(ROLE_INFERENCE):
            if self.cli.poll() is not None:
                raise RuntimeError(f"the serving CLI exited "
                                   f"rc={self.cli.returncode}")
            if time.monotonic() > deadline:
                raise TimeoutError("the serving CLI never registered")
            time.sleep(0.05)
        t_reg = time.monotonic()
        (addr,) = coord.list(ROLE_INFERENCE)
        probe = fl_cli_requests(SEED + 911, 1)[0]
        for f in probe.id_type_features:  # signs above every seq_rec id
            f.signs = f.signs + (1 << 40)
        cl = InferenceClient(addr)
        pred = cl.predict(probe)
        cl.close()
        self.cli_first = {"addr": addr, "registered_s": t_reg - t0,
                          "first_reply_s": time.monotonic() - t0,
                          "probe": pred}

    def a_addrs(self):
        """(a)'s PS (RPC, sidecar) addresses."""
        from persia_tpu_torch.utils import wait_addr_file

        return [(wait_addr_file(a, SV_START_S, p),
                 wait_addr_file(h, SV_START_S, p))
                for p, (a, h) in zip(self.a_procs, self.a_files)]

    def stop(self):
        import signal

        procs = [*self.a_procs, *([self.cli] if self.cli else [])]
        for p in procs:
            try:
                p.send_signal(signal.SIGCONT)
            except OSError:
                pass
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001 — then it is killed
                p.kill()
                p.wait(timeout=10)
        super().stop()


def fl_bench(card: str, addrs, pids, pm_dir: str) -> str:
    """(a) ``bench.py``'s ``bench_fleet`` at its smoke depth over the
    port's worker and the two ``PsService`` processes at ``addrs`` ((RPC,
    sidecar) pairs; ``pids`` their processes), every sidecar scraped by a
    ``FleetMonitor`` with the default rules: wire neutrality (no PS
    request in a scrape-only window, exact), the paired interleaved cycle
    inflation (one full re-measure when over 3%; printed beside the
    bench's 3% contract, not enforced), a SIGSTOPped PS tripping
    ``target_down`` within 2 scrape intervals with a postmortem bundle, and the federated views (``/fleet/metrics``
    labeled, ``/fleet/status`` all up without skew, one trace_id across
    the trainer and both PS in ``/fleet/trace``). Run in a process of its
    own (:func:`fl_bench_process`), as the bench runs. Returns the
    report."""
    import signal
    import statistics

    import numpy as np

    from persia_tpu_torch import tracing
    from persia_tpu_torch.config import EmbeddingSchema, SlotConfig
    from persia_tpu_torch.data.batch import IDTypeFeatureWithSingleID
    from persia_tpu_torch.fleet import FleetMonitor
    from persia_tpu_torch.metrics import parse_exposition
    from persia_tpu_torch.obs_http import ObservabilityServer
    from persia_tpu_torch.service.ps_service import PsClient
    from persia_tpu_torch.slos import SloEngine, default_rules
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    dims = (FL_DIM // 2, FL_DIM, 2 * FL_DIM, 4 * FL_DIM)
    schema = EmbeddingSchema(slots_config={
        f"slot_{s}": SlotConfig(name=f"slot_{s}", dim=dims[s % len(dims)])
        for s in range(FL_SLOTS)})
    rng = np.random.default_rng(0)

    def batch():
        return [IDTypeFeatureWithSingleID(
            f"slot_{s}", rng.integers(0, 1 << 40, size=FL_BATCH,
                                      dtype=np.uint64))
            for s in range(FL_SLOTS)]

    clients = [PsClient(a) for a, _ in addrs]
    worker = EmbeddingWorker(schema, clients, streaming=True)
    worker.configure_parameter_servers(
        "bounded_uniform", {"lower": -0.01, "upper": 0.01}, 1.0, 10.0)
    worker.register_optimizer({
        "type": "adagrad", "lr": 0.02, "initialization": 0.1,
        "g_square_momentum": 1.0, "vectorwise_shared": False})
    tracing.set_service_name("trainer")
    sidecar = ObservabilityServer(service="trainer").start()
    targets = [{"service": f"ps{i}", "http_addr": h, "role": "ps",
                "replica": i} for i, (_, h) in enumerate(addrs)]
    targets.append({"service": "trainer", "http_addr": sidecar.addr,
                    "role": "trainer", "replica": 0})
    monitor = FleetMonitor(
        targets=targets, scrape_interval=FL_SCRAPE_S,
        scrape_timeout=FL_SCRAPE_TIMEOUT_S,
        flight_interval=FL_SCRAPE_S * 4, first_scrape_delay=FL_SCRAPE_S,
        slo_engine=SloEngine(default_rules()), postmortem_dir=pm_dir)

    def cycle(b):
        ref = worker.put_batch(b)
        lk = worker.lookup(ref)
        worker.update_gradients(ref,
                                {k: v.embeddings for k, v in lk.items()})

    try:
        for _ in range(3):
            cycle(batch())
        hot = batch()
        cycle(hot)
        # 1. wire neutrality: a scrape-only window adds no request; each
        # health read is counted before itself, so exactly one a replica
        served0 = [c.health()["served_rpcs"] for c in clients]
        monitor.start()
        deadline = time.monotonic() + max(FL_SCRAPE_S * 5, 4.0)
        while monitor.rounds < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        monitor.stop()
        if monitor.rounds < 1:
            raise AssertionError("fleet (a): the monitor never completed "
                                 "a scrape")
        served1 = [c.health()["served_rpcs"] for c in clients]
        extra = [b - a - 1 for a, b in zip(served0, served1)]
        if any(extra):
            raise AssertionError(f"fleet (a): scraping put {extra} extra "
                                 f"requests on the RPC plane")
        neutral_rounds = monitor.rounds

        # 2. the paired interleaved cycle inflation
        t0 = time.perf_counter()
        for _ in range(3):
            cycle(hot)
        est = (time.perf_counter() - t0) / 3
        block = max(4, int(2.5 * FL_SCRAPE_S / est))

        def inflation(rounds):
            per = {"off": [], "on": []}
            ratios = []
            for r in range(rounds):
                times = {}
                for phase in (("off", "on") if r % 2 == 0
                              else ("on", "off")):
                    if phase == "on":
                        monitor.start()
                    t0 = time.perf_counter()
                    for _ in range(block):
                        cycle(hot)
                    times[phase] = (time.perf_counter() - t0) / block
                    if phase == "on":
                        monitor.stop()
                    per[phase].append(times[phase])
                ratios.append(times["on"] / times["off"])
            return (statistics.median(ratios),
                    statistics.median(per["off"]) * 1e3,
                    statistics.median(per["on"]) * 1e3)

        rounds = max(4, FL_STEPS // 4)
        first = ratio, off_ms, on_ms = inflation(rounds)
        remeasured = None
        if ratio > FL_INFLATION_GATE:
            remeasured = inflation(rounds)
            if remeasured[0] < ratio:
                ratio, off_ms, on_ms = remeasured
        # reported beside the bench's 3% contract, not enforced: on the
        # card's shared 8-core host the paired medians spread from -5.5%
        # to +27% between runs (PERF.md §6, PR 18)
        infl = (f"{(ratio - 1) * 100:+.3f}% (contract +3%: "
                + ("met" if ratio <= FL_INFLATION_GATE else "missed")
                + ", reported, not enforced)")

        # 3. SIGSTOP a PS: target_down within 2 scrape intervals
        r0 = monitor.rounds
        monitor.start()
        deadline = time.monotonic() + max(FL_SCRAPE_S * 4, 3.0)
        while monitor.rounds == r0 and time.monotonic() < deadline:
            time.sleep(0.02)
        victim = f"ps{N_PS - 1}"
        n0 = len(monitor.engine.breach_events())
        t_fault = time.monotonic()
        os.kill(pids[-1], signal.SIGSTOP)
        breach = None
        try:
            deadline = (time.monotonic() + FL_SCRAPE_S * 2
                        + FL_SCRAPE_TIMEOUT_S * 3 + 5)
            while time.monotonic() < deadline and breach is None:
                breach = next((e for e in
                               monitor.engine.breach_events()[n0:]
                               if e["rule"] == "target_down"
                               and e["service"] == victim), None)
                time.sleep(0.02)
        finally:
            os.kill(pids[-1], signal.SIGCONT)
        monitor.stop()
        if breach is None:
            raise AssertionError(f"fleet (a): the stopped {victim} never "
                                 f"tripped target_down")
        latency = breach["t"] - t_fault
        bundles = [p for p in monitor.recorder.captures if victim in p]
        if latency > 2 * FL_SCRAPE_S or not bundles:
            raise AssertionError(
                f"fleet (a): target_down after {latency:.3f}s (budget "
                f"{2 * FL_SCRAPE_S}s), bundles {bundles}")
        monitor.start()
        deadline = time.monotonic() + 10
        while (time.monotonic() < deadline
               and monitor.fleet_status()["n_up"] != len(targets)):
            time.sleep(0.1)
        monitor.stop()

        # 4. the federated views
        if monitor.scrape_once() != len(targets):
            raise AssertionError("fleet (a): not every target up after "
                                 "the victim resumed")
        samples, _ = parse_exposition(monitor.fleet_metrics())
        labeled = {(lb.get("service"), lb.get("replica"))
                   for _, lb, _ in samples if "service" in lb}
        status = monitor.fleet_status()
        if not ({(f"ps{i}", str(i)) for i in range(N_PS)} <= labeled
                and status["n_up"] == len(targets)
                and not status["version_skew"]):
            raise AssertionError(f"fleet (a): federated views: labels "
                                 f"{sorted(labeled)}, status {status}")
        tracing.enable_tracing(True)
        try:
            for c in clients:
                c.client.close()  # redial with the trace probe
            cycle(batch())
            tracing.default_collector().clear()
            with tracing.span("trainer/step", root=True) as root:
                cycle(batch())
        finally:
            tracing.enable_tracing(False)
        monitor.scrape_once()
        spans = monitor.fleet_trace(trace_id=f"{root.trace_id:016x}",
                                    fmt="raw")["spans"]
        services = {sp["service"] for sp in spans}
        if not {"trainer", *(f"ps{i}" for i in range(N_PS))} <= services:
            raise AssertionError(f"fleet (a): one trace_id spans only "
                                 f"{sorted(services)}")
        return (f"(a) bench_fleet, batch {FL_BATCH} x {FL_SLOTS} slots, "
                f"{N_PS} PS processes, scrape every {FL_SCRAPE_S}s: wire "
                f"neutrality 0 extra requests over {neutral_rounds} rounds; "
                f"cycle {off_ms:.3f} ms scraper off, {on_ms:.3f} ms on, "
                f"inflation {infl}, the median of {rounds} paired rounds "
                f"of {block} cycles (first set "
                f"{(first[0] - 1) * 100:+.3f}%"
                + (f", re-measured {(remeasured[0] - 1) * 100:+.3f}%"
                   if remeasured else "")
                + f"); SIGSTOP {victim} -> target_down in "
                f"{latency:.3f}s (budget {2 * FL_SCRAPE_S}s), bundle "
                f"{os.path.basename(bundles[-1])}; /fleet/metrics "
                f"{len(samples)} series, /fleet/status {status['n_up']}/"
                f"{len(targets)} up, no skew; /fleet/trace {len(spans)} "
                f"spans on one trace_id from {sorted(services)}")
    finally:
        tracing.enable_tracing(False)
        monitor.stop()
        sidecar.stop()
        worker.close()
        for c in clients:
            c.client.close()


def fl_bench_process(card: str, clusters: FleetClusters) -> str:
    """(a) in a child process (``chip_smoke.py fleet_bench <spec>``), as
    ``bench.py --mode fleet`` runs: the monitor and the worker share a
    process holding nothing else, not this one's registry of every
    earlier phase and its clusters' threads. Returns its report; raises
    its failure."""
    import subprocess

    spec = os.path.join(clusters.pm_dir, "a.json")
    os.makedirs(clusters.pm_dir, exist_ok=True)
    with open(spec, "w") as f:
        json.dump({"card": card, "addrs": clusters.a_addrs(),
                   "pids": [p.pid for p in clusters.a_procs],
                   "pm_dir": os.path.join(clusters.pm_dir, "a"),
                   "out": spec + ".out"}, f)
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "fleet_bench", spec], timeout=600, check=False)
    with open(spec + ".out") as f:
        out = json.load(f)
    if out.get("error"):
        raise AssertionError(out["error"])
    return out["line"]


def fleet_bench_main(spec_path: str) -> int:
    """The child of :func:`fl_bench_process`: run (a), write its report
    or its failure. It never loads torch, so it launches no kernel."""
    with open(spec_path) as f:
        spec = json.load(f)
    try:
        out = {"line": fl_bench(spec["card"], spec["addrs"], spec["pids"],
                                spec["pm_dir"])}
        if "torch" in sys.modules:  # then no kernel could launch here
            raise AssertionError("fleet (a): the bench's process loaded "
                                 "torch")
    except Exception as e:  # noqa: BLE001 — the parent raises it
        traceback.print_exc()
        out = {"error": f"{type(e).__name__}: {e}"}
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0 if "line" in out else 1


def fl_rows(svc, signs, dim: int):
    """Every row of ``signs`` read from ``svc``'s PS replicas (each must
    hold it exactly once)."""
    import numpy as np

    from persia_tpu_torch.service.ps_service import PsClient

    found = np.zeros(len(signs), np.int64)
    rows = np.zeros((len(signs), dim), np.float32)
    for a in svc.ps_addrs:
        c = PsClient(a)
        f, v = c.get_entries(signs, dim)
        c.client.close()
        found += f
        rows[f] = v[f]
    if not (found == 1).all():
        raise AssertionError(f"fleet: {int((found != 1).sum())} touched "
                             f"rows not held exactly once")
    return rows


def fl_train(torch, schema, svc, batches, start, on_step=None):
    """seq_rec's ``TrainCtx`` on the card over ``svc``'s processes from
    the weights ``start``: (losses, dense state, launches, seconds of the
    steps). ``on_step(step)`` runs before a step and returns the seconds
    it spent (not counted)."""
    import numpy as np

    from persia_tpu_torch.workloads.generator import SeqRecSpec

    ctx = train_ctx(torch, schema, build_tower(
        SeqRecSpec().num_dense, "flash", state_dict=start),
        worker=svc.remote_worker())
    losses, paused = [], 0.0
    with ctx:
        reset_launch_counts()
        t0 = time.perf_counter()
        for step, b in enumerate(batches):
            if on_step is not None:
                torch.cuda.synchronize()
                paused += on_step(step)
            losses.append(ctx.train_step(b)[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - paused
        launches = kernel_launches()
    losses = torch.stack(losses).float().cpu().tolist()
    if not np.isfinite(losses).all():
        raise AssertionError("fleet: a loss is not finite")
    ctx.worker.close()
    return losses, dense_state(ctx), launches, wall


def fl_compare(tag: str, a, b, rows_a, rows_b) -> str:
    """Losses, dense state and rows of two runs; raises where any bit
    differs."""
    loss_diff = sum(x != y for x, y in zip(a[0], b[0]))
    dense_diff = first_difference(a[1], b[1])
    row_diff = int((rows_a.view("<u4") != rows_b.view("<u4"))
                   .any(axis=-1).sum())
    line = (f"losses that differ {loss_diff}, dense state "
            f"{dense_diff or 'bit-equal'}, {len(rows_a)} touched rows of "
            f"which differ in any bit {row_diff}")
    if loss_diff or dense_diff or row_diff:
        raise AssertionError(f"fleet {tag}: {line}")
    return line


def fl_seq_rec(torch, card: str, clusters: FleetClusters):
    """(b) seq_rec at the training phase's widths, 20 synchronous steps
    over the watched cluster under ``svc.fleet_monitor`` (the default
    rules, a scrape every 0.5 s, the trainer's own sidecar added), PS 1
    SIGSTOPped for 4 scrape intervals between steps 10 and 11, against
    the same steps over the reference cluster with no monitor. Gates: no
    rule fires before the stall; ``target_down`` on ps1 within 2
    intervals with a bundle, cleared after SIGCONT; ``fleet_status``
    lists the trainer, the worker and both PS up without skew;
    ``fleet_history`` has a rate of ``ps_lookup_rows_total`` above 0;
    losses, dense state and every touched row bit-equal to the reference;
    K2-K4 once a step, K1 and K5 never. Returns (the report, the watched
    run's launches, the running monitor and the trainer's sidecar)."""
    import signal

    from persia_tpu_torch.obs_http import ObservabilityServer
    from persia_tpu_torch.slos import SloEngine, default_rules
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    schema = build_schema()
    batches = list(seqrec_batches(FL_B_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                                  seed=TRAIN_SEED + 23, spec=spec))
    signs = seq_signs(batches)
    start = build_tower(spec.num_dense, "flash").state_dict()
    ref = fl_train(torch, schema, clusters.ref, batches, start)
    ref_rows = fl_rows(clusters.ref, signs, 2 * DIM)

    svc = clusters.watched
    sidecar = ObservabilityServer(service="trainer").start()
    monitor = svc.fleet_monitor(
        slo_engine=SloEngine(default_rules()),
        postmortem_dir=os.path.join(clusters.pm_dir, "b"),
        scrape_interval=FL_B_SCRAPE_S, scrape_timeout=FL_B_SCRAPE_TIMEOUT_S)
    monitor.add_target("trainer", sidecar.addr, role="trainer")
    stall = {}
    victim = "ps1"

    def on_step(step) -> float:
        if step == 0:
            monitor.start()
            return 0.0
        if step != FL_B_STALL_AT:
            return 0.0
        t0 = time.monotonic()
        stall["before"] = monitor.engine.breach_events()
        stall["rounds_before"] = monitor.rounds
        proc = svc.ps_proc(1)
        n0 = len(stall["before"])
        stall["t_fault"] = time.monotonic()
        proc.send_signal(signal.SIGSTOP)
        try:
            time.sleep(4 * FL_B_SCRAPE_S)
            stall["breach"] = next(
                (e for e in monitor.engine.breach_events()[n0:]
                 if e["rule"] == "target_down" and e["service"] == victim),
                None)
        finally:
            proc.send_signal(signal.SIGCONT)
        t_cont = time.monotonic()
        deadline = t_cont + 10
        while time.monotonic() < deadline:
            if not [a for a in monitor.alerts(firing_only=True)
                    if a["rule"] == "target_down"]:
                stall["cleared_s"] = time.monotonic() - t_cont
                break
            time.sleep(0.05)
        return time.monotonic() - t0

    try:
        run = fl_train(torch, schema, svc, batches, start, on_step)
        monitor.scrape_once()
        status = monitor.fleet_status()
        history = monitor.fleet_history("ps_lookup_rows_total",
                                        window_sec=120.0)
    except BaseException:
        monitor.stop()
        sidecar.stop()
        raise
    launches = run[2]
    rows = fl_rows(svc, signs, 2 * DIM)
    same = fl_compare("(b)", ref, run, ref_rows, rows)
    before = [(e["rule"], e["service"]) for e in stall.get("before", [])]
    breach = stall.get("breach")
    latency = breach["t"] - stall["t_fault"] if breach else None
    bundles = [p for p in monitor.recorder.captures if victim in p]
    rows_up = {t["service"]: t["up"] for t in status["targets"]}
    want = {"trainer", "worker0", "ps0", "ps1"}
    line = (f"(b) seq_rec {FL_B_STEPS} synchronous steps of {TRAIN_BATCH} "
            f"under the monitor (scrape {FL_B_SCRAPE_S}s, "
            f"{len(monitor.engine.rules)} default rules, "
            f"{monitor.rounds} rounds): breaches before the stall "
            f"{before}; SIGSTOP {victim} -> target_down in "
            + (f"{latency:.3f}s" if latency is not None else "never")
            + f" (budget {2 * FL_B_SCRAPE_S}s), cleared "
            f"{stall.get('cleared_s', float('nan')):.3f}s after SIGCONT, "
            f"bundles {len(bundles)}; status {rows_up}, version_skew "
            f"{status['version_skew']}; ps_lookup_rows_total rate "
            f"{history['rate']}/s; against the unmonitored cluster: {same}; "
            f"samples/s {FL_B_STEPS * TRAIN_BATCH / run[3]:.1f} watched "
            f"(the stall left out) vs {FL_B_STEPS * TRAIN_BATCH / ref[3]:.1f}"
            f" unwatched; launches "
            + " ".join(f"{n}={c}" for n, c in launches.items()))
    flash = [launches[n] for n in FLASH_KERNELS]
    ok = (not before and latency is not None
          and latency <= 2 * FL_B_SCRAPE_S and bundles
          and "cleared_s" in stall and want <= set(rows_up)
          and all(rows_up[s] for s in want)
          and not status["version_skew"]
          and (history["rate"] or 0) > 0
          and flash == [FL_B_STEPS] * 3 and not launches["embedding_bag"]
          and not launches["probe_copy"])
    if not ok:
        monitor.stop()
        sidecar.stop()
        raise AssertionError(f"fleet (b): {line}")
    return line, launches, monitor, sidecar


def fl_serving_cli(torch, card: str, clusters: FleetClusters,
                   monitor) -> str:
    """(c) the serving CLI started after setup (``--model dlrm`` on a
    ``dense.pt`` of seeded weights, (b)'s worker, ``--max-batch-rows
    256 --cache-rows 100000``): 64 serialized ``InferenceClient`` replies
    bit-equal to an in-process ``InferenceServer`` built from the same
    ``dense.pt`` over the same worker; the monitor discovers its sidecar
    and lists it up; no kernel launches. Returns the report."""
    import numpy as np

    from persia_tpu_torch.serving import InferenceClient, InferenceServer, \
        load_zoo_model

    first = clusters.cli_first
    if not np.isfinite(first["probe"]).all():
        raise AssertionError("fleet (c): the CLI's first reply is not "
                             "finite")
    requests = fl_cli_requests(SEED + 31, FL_C_REQUESTS)
    model = load_zoo_model("dlrm", clusters.ckpt_dir, clusters.num_dense,
                           fl_cli_schema(), "cuda")
    local = InferenceServer(model, fl_cli_schema(),
                            worker_addrs=clusters.watched.worker_addrs,
                            device="cuda", max_batch_rows=256,
                            cache_rows=100_000)
    local.serve_background()
    remote_cl = InferenceClient(first["addr"])
    local_cl = InferenceClient(local.addr)
    reset_launch_counts()
    try:
        differ = 0
        for b in requests:
            got, want = remote_cl.predict(b), local_cl.predict(b)
            if not (np.isfinite(got).all() and got.shape == want.shape):
                raise AssertionError(f"fleet (c): a reply of shape "
                                     f"{got.shape} is not finite")
            differ += int(not np.array_equal(got.view(np.uint32),
                                             want.view(np.uint32)))
        torch.cuda.synchronize()
        launches = kernel_launches()
        served = remote_cl.stats()["requests"]
    finally:
        remote_cl.close()
        local_cl.close()
        local.stop()
    monitor.discover()
    monitor.scrape_once()
    status = {t["service"]: t for t in monitor.fleet_status()["targets"]}
    serving = status.get("serving0")
    line = (f"(c) serving CLI (dlrm, dense.pt, (b)'s worker): registered "
            f"{first['registered_s']:.3f}s and first reply "
            f"{first['first_reply_s']:.3f}s after its spawn; "
            f"{FL_C_REQUESTS} serialized replies of {REQUEST_ROWS} rows, "
            f"{differ} differ in any bit from the in-process server's; "
            f"its /healthz row in fleet_status: "
            + (f"up={serving['up']} ready={serving['ready']} version "
               f"{serving['version']}" if serving else "absent")
            + f"; it served {served} requests (the probe included); "
            f"launches " + " ".join(f"{n}={c}" for n, c in launches.items()))
    if differ or not serving or not serving["up"] or any(launches.values()):
        raise AssertionError(f"fleet (c): {line}")
    return line


def fl_native(torch, card: str, clusters: FleetClusters) -> str:
    """(d) seq_rec's slots (clicks summed), 10 synchronous steps over
    ``ServiceCtx(native_ps=True, native_worker=True, ps_capacity=
    2_000_000, ps_num_shards=8)`` against the Python services on the same
    batches and weights: losses, dense state and every touched row
    bit-equal; the samples/s of each tier. Returns the report."""
    from persia_tpu_torch.service.native_bin import zstd_mode
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    schema = fl_native_schema()
    batches = list(seqrec_batches(FL_D_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                                  seed=TRAIN_SEED + 29, spec=spec))
    signs = seq_signs(batches)
    start = build_tower(spec.num_dense, "flash").state_dict()
    py = fl_train(torch, schema, clusters.py_tier, batches, start)
    cc = fl_train(torch, schema, clusters.native_tier, batches, start)
    same = fl_compare("(d)", py, cc, fl_rows(clusters.py_tier, signs,
                                             2 * DIM),
                      fl_rows(clusters.native_tier, signs, 2 * DIM))
    flash = [cc[2][n] for n in FLASH_KERNELS]
    line = (f"(d) seq_rec (clicks summed) {FL_D_STEPS} synchronous steps "
            f"over the all-native tier (persia-embedding-ps / -worker, "
            f"zstd {zstd_mode()}) against the Python services: {same}; "
            f"samples/s native {FL_D_STEPS * TRAIN_BATCH / cc[3]:.1f}, "
            f"Python {FL_D_STEPS * TRAIN_BATCH / py[3]:.1f}; launches "
            + " ".join(f"{n}={c}" for n, c in cc[2].items()))
    if flash != [FL_D_STEPS] * 3:
        raise AssertionError(f"fleet (d): {line}")
    return line


def fleet_phase(torch, card: str, clusters: FleetClusters) -> dict:
    """(b) and (c) on the watched cluster (the monitor of (b) discovers
    (c)'s CLI), (d), then (a) in a child process, which touches no card.
    Returns (b)'s launches."""
    up = clusters.wait()
    _log(f"[fleet] clusters, (a)'s PS and the serving CLI up {up:.1f}s "
         f"after their start (beside the first three phases) | card: "
         f"{card}")
    t0 = time.perf_counter()
    b_line, launches, monitor, sidecar = fl_seq_rec(torch, card, clusters)
    _log(f"[fleet] {b_line} | card: {card}")
    t1 = time.perf_counter()
    _log(f"[time] fleet (b) {t1 - t0:.1f}s")
    try:
        c_line = fl_serving_cli(torch, card, clusters, monitor)
    finally:
        monitor.stop()
        sidecar.stop()
    _log(f"[fleet] {c_line} | card: {card}")
    t2 = time.perf_counter()
    _log(f"[time] fleet (c) {t2 - t1:.1f}s")
    _log(f"[fleet] {fl_native(torch, card, clusters)} | card: {card}")
    t3 = time.perf_counter()
    _log(f"[time] fleet (d) {t3 - t2:.1f}s")
    _log(f"[fleet] {fl_bench_process(card, clusters)} | card: {card}")
    _log(f"[time] fleet (a) {time.perf_counter() - t3:.1f}s")
    for c in clusters.ctxs:
        if c.crashed:
            raise AssertionError(f"fleet: a child crashed: {c.crashed}")
    return launches


OR_SAMPLES = 49152  # (a): tests/test_flagship_e2e.py's samples, all loaders
OR_BATCH = 256
OR_VOCAB = 500  # (a): a slot's sign space, small so that ids repeat
OR_EVAL = 4096  # (a): held-out samples (seed 99) on the leader
OR_AUC_BAR = 0.60  # (a): tests/test_flagship_e2e.py's bar
OR_JOB_S = 300  # (a): the job's deadline
OR_SCRAPE_S = 0.25  # (b), (c): bench_autopilot's scrape interval
OR_WINDOW_S = 2.0  # (b), (c): the scale rules' sustained() window
OR_CAL_S = 1.2  # (b), (c): the calibration's scrapes
OR_CAL_FROM = 2  # (b): the pilots' thread starts before this step
OR_AFTER_STEPS = 20  # (b): steps trained after the scale-out executed
OR_MAX_STEPS = 400  # (b): no scale-out by then fails the phase
OR_C_INFLATION_X = 25.0  # (c): bench_autopilot's p99 gate above its floor
OR_C_FLOOR_S = 1.0


def or_job_spec(gc_path: str) -> dict:
    """``examples/criteo/job.yml`` read by the port's YAML reader and cut
    for one card: 2 PS (8), 1 embedding worker (2), 2 data loaders, 1
    nnWorker of ``gpu: {count: 1}`` in place of the TPU block, the port's
    entry scripts, ``PERSIA_MESH`` 2,1 (4,1) with
    ``PERSIA_TRAINER_PROCESSES`` 2, a global config (the PS's capacity),
    and no metrics gateway (a pushgateway image, not a local process)."""
    from persia_tpu_torch.utils import load_yaml

    root = os.path.dirname(os.path.abspath(__file__))
    spec = load_yaml(os.path.join(root, "examples", "criteo", "job.yml"))
    spec["metrics"] = {"enabled": False}
    spec["globalConfigPath"] = gc_path
    roles = spec["roles"]
    roles["embeddingParameterServer"]["replicas"] = 2
    roles["embeddingWorker"]["replicas"] = 1
    nn = roles["nnWorker"]
    del nn["tpu"]
    nn["gpu"] = {"count": 1}
    nn["entry"] = "persia_tpu_torch/examples/criteo/train.py"
    nn["env"] = {"PERSIA_MESH": "2,1", "PERSIA_TRAINER_PROCESSES": "2"}
    roles["dataloader"]["replicas"] = 2
    roles["dataloader"]["entry"] = "persia_tpu_torch/examples/criteo/send_data.py"
    return spec


class LauncherJob:
    """(a): every pod of the port's ``gen_manifests(or_job_spec())`` as a
    local process from the checkout's root, its rendered ``command``
    (``python`` being this interpreter) and ``env`` over this process's.
    The coordinator pod binds 127.0.0.1 on port 0 and hands its address
    over by an addr file (``--addr-file``), which replaces the rendered
    ``PERSIA_COORDINATOR_ADDR`` of every other pod; the PS pods bind port
    0. The service pods start at construction (they load no torch);
    :meth:`start_roles` starts the data loaders and the nnWorker pod (the
    launcher and its trainer group, the card's processes), each with the
    job's arguments appended (an entry holds a script, not its flags)."""

    LOADER_ARGS = ["--learnable", "--samples", str(OR_SAMPLES),
                   "--batch-size", str(OR_BATCH), "--vocab", str(OR_VOCAB)]

    def __init__(self, tmp: str):
        from persia_tpu_torch.k8s_utils import gen_manifests
        from persia_tpu_torch.utils import dump_yaml, wait_addr_file

        self.root = os.path.dirname(os.path.abspath(__file__))
        self.tmp = tmp
        gc = os.path.join(tmp, "job_global.yml")
        dump_yaml({"embedding_parameter_server_config": {
            "capacity": 2_000_000, "num_hashmap_internal_shards": 8}}, gc)
        self.result_dir = os.path.join(tmp, "job_results")
        self.pods = [m for m in gen_manifests(or_job_spec(gc))
                     if m["kind"] == "Pod"]
        self.procs = {}  # pod name -> Popen
        coord = next(p for p in self.pods if self._role(p) == "coordinator")
        addr_file = os.path.join(tmp, "job_coordinator.addr")
        try:
            self._spawn(coord, ["--host", "127.0.0.1", "--port", "0",
                                "--addr-file", addr_file])
            self.coordinator_addr = wait_addr_file(
                addr_file, SV_START_S, self.procs[coord["metadata"]["name"]])
            for p in self.pods:
                role = self._role(p)
                if role == "embeddingParameterServer":
                    self._spawn(p, ["--port", "0"])
                elif role == "embeddingWorker":
                    self._spawn(p, [])
        except BaseException:
            self.stop()
            raise

    @staticmethod
    def _role(pod) -> str:
        return pod["metadata"]["labels"]["persia-role"]

    def _spawn(self, pod, extra):
        import subprocess

        (c,) = pod["spec"]["containers"]
        cmd = [sys.executable if a == "python" else a for a in c["command"]]
        env = {e["name"]: e["value"] for e in c.get("env", [])}
        if "PERSIA_COORDINATOR_ADDR" in env:
            env["PERSIA_COORDINATOR_ADDR"] = self.coordinator_addr
        # a session of its own: stop() signals the pod's whole process
        # group, the launcher's trainer ranks with it
        self.procs[pod["metadata"]["name"]] = subprocess.Popen(
            cmd + extra, cwd=self.root, start_new_session=True,
            env={**os.environ, **env, "PYTHONPATH": self.root,
                 "LOG_LEVEL": "WARNING"})

    def start_roles(self):
        """The data loaders and the nnWorker's trainer group."""
        for p in self.pods:
            role = self._role(p)
            if role == "dataloader":
                self._spawn(p, self.LOADER_ARGS)
            elif role == "nnWorker":
                self._spawn(p, [
                    "--learnable", "--batch-size", str(OR_BATCH), "--vocab",
                    str(OR_VOCAB), "--test-samples", str(OR_EVAL), "--lr",
                    "0.1", "--sparse-lr", "0.3", "--num-workers", "2",
                    "--device", "cuda", "--result-dir", self.result_dir])

    def finishing(self):
        return {n: p for n, p in self.procs.items()
                if "-dataloader-" in n or "-nnworker-" in n}

    def wait(self):
        """Waits until every loader and the trainer group exited; raises
        on a non-zero exit, a service pod's death or the deadline."""
        deadline = time.perf_counter() + OR_JOB_S
        fin = self.finishing()
        while True:
            bad = {n: p.returncode for n, p in self.procs.items()
                   if p.poll() not in (None, 0)}
            if bad:
                raise AssertionError(f"orchestration (a): a pod exited "
                                     f"non-zero: {bad}")
            if all(p.poll() == 0 for p in fin.values()):
                break
            if time.perf_counter() > deadline:
                raise AssertionError("orchestration (a): the job did not "
                                     f"end within {OR_JOB_S}s")
            time.sleep(0.1)
        alive = [n for n, p in self.procs.items() if n not in fin
                 and p.poll() is not None]
        if alive:
            raise AssertionError(f"orchestration (a): service pods exited "
                                 f"early: {alive}")

    def stop(self):
        import signal

        for sig in (signal.SIGTERM, signal.SIGKILL):
            for p in self.procs.values():
                try:
                    os.killpg(p.pid, sig)
                except OSError:  # the group is gone
                    pass
            deadline = time.monotonic() + 10
            for p in self.procs.values():
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except Exception:  # noqa: BLE001 — then it is killed
                    pass


class OrchestrationClusters(ServiceClusters):
    """The orchestration phase's processes, started once (c) has ended:
    (b)'s watched seq_rec cluster (every service with its sidecar) and
    its third PS process (no coordinator: the migration hands its
    address to the worker), the unbroken reference cluster, and (a)'s
    service pods (:class:`LauncherJob`). :meth:`stop` takes them all
    down."""

    def __init__(self):
        import subprocess
        import tempfile

        from persia_tpu_torch.service.helper import ServiceCtx
        from persia_tpu_torch.utils import dump_yaml

        self._tmp = tempfile.TemporaryDirectory()
        tmp = self._tmp.name
        path = os.path.join(tmp, "global.yml")
        dump_yaml({"embedding_parameter_server_config": {
            "capacity": 2_000_000, "num_hashmap_internal_shards": 8}}, path)
        env = {"LOG_LEVEL": "WARNING"}
        self.watched, self.ref = (ServiceCtx(
            build_schema(), n_workers=1, n_ps=N_PS, global_config_path=path,
            http_all=http, startup_timeout=SV_START_S, env=env)
            for http in (True, False))
        self.ctxs = [self.watched, self.ref]
        self.pm_dir = os.path.join(tmp, "postmortems")
        self.extra_addr_file = os.path.join(tmp, "ps2.addr")
        self.extra_ps = subprocess.Popen(
            [sys.executable, "-m", "persia_tpu_torch.service.ps_service",
             "--port", "0", "--replica-index", str(N_PS), "--replica-size",
             str(N_PS + 1), "--coordinator", "", "--global-config", path,
             "--http-port", "-1", "--addr-file", self.extra_addr_file],
            env={**os.environ, **env,
                 "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))})
        self.job = None
        self._start()
        try:
            self.job = LauncherJob(tmp)
        except BaseException:
            self.stop()
            raise

    def extra_addr(self) -> str:
        from persia_tpu_torch.utils import wait_addr_file

        return wait_addr_file(self.extra_addr_file, SV_START_S,
                              self.extra_ps)

    def stop(self):
        if self.job is not None:
            self.job.stop()
        self.extra_ps.terminate()
        try:
            self.extra_ps.wait(timeout=10)
        except Exception:  # noqa: BLE001 — then it is killed
            self.extra_ps.kill()
            self.extra_ps.wait(timeout=10)
        super().stop()


def or_job_check(card: str, job: LauncherJob) -> str:
    """(a)'s gates over the trainer group's result files: both ranks on
    the card over gloo, their dense parameters equal by digest, the ranks'
    shares of the batches at least the samples the loaders sent, the
    leader's held-out AUC above the bar, no K1-K5 launch in either rank
    (hybrid DLRM)."""
    ranks = []
    for i in range(2):
        with open(os.path.join(job.result_dir, f"rank{i}.json")) as f:
            ranks.append(json.load(f))
    lead = ranks[0]
    trained = sum(r["rows_trained"] for r in ranks)
    launches = [sum(r["launches"].values()) for r in ranks]
    line = (f"(a) the launcher's job from the port's manifests "
            f"({len(job.pods)} pods: coordinator, 2 PS, 1 worker, 2 data "
            f"loaders, 1 nnWorker of a 2-rank group on {lead['backend']}): "
            f"{lead['steps']} steps of {OR_BATCH}, {trained} samples trained "
            f"by the ranks together (the loaders sent {OR_SAMPLES}), "
            f"{lead['samples_per_s']:.1f} samples/s on the leader over its "
            f"loop ({lead['wall_s']:.2f}s), ranks up {ranks[0]['startup_s']:.2f}"
            f" / {ranks[1]['startup_s']:.2f}s after main; held-out AUC "
            f"on {OR_EVAL} samples {lead['auc']:.4f} (bar {OR_AUC_BAR}); "
            f"digests {'equal' if ranks[0]['digest'] == ranks[1]['digest'] else 'DIFFER'}; "
            f"K1-K5 launches {[r['launches'] for r in ranks]} | card: {card}")
    if [r["leader"] for r in ranks] != [True, False] or any(
            not r["device"].startswith("cuda") for r in ranks):
        raise AssertionError(f"orchestration (a): the ranks are not the "
                             f"group on the card: {ranks}")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError(f"orchestration (a): the ranks' dense "
                             f"parameters differ: {line}")
    if trained < OR_SAMPLES or ranks[0]["steps"] != ranks[1]["steps"]:
        raise AssertionError(f"orchestration (a): the trainers counted "
                             f"fewer samples than the loaders sent: {line}")
    if not lead["auc"] > OR_AUC_BAR:
        raise AssertionError(f"orchestration (a): AUC not above "
                             f"{OR_AUC_BAR}: {line}")
    if any(launches):
        raise AssertionError(f"orchestration (a): a kernel launched on the "
                             f"hybrid DLRM path: {line}")
    return line


def or_pilots(monitor, operator, job: str, m_rows: float, jdir: str,
              verify_sec: float, table_fn, rebalance: bool):
    """The shadow (recommend) and the enforce pilot over one monitor and
    operator, thresholds at fractions of the calibrated fleet row rate
    ``m_rows`` (``bench.py``'s ``bench_autopilot``)."""
    from persia_tpu_torch.autopilot import (Autopilot, PsScalePolicy,
                                            RebalancePolicy)

    def policies():
        out = [PsScalePolicy(job, scale_out_at=0.30 * m_rows,
                             scale_in_below=(0.15 if rebalance else 0.05)
                             * m_rows, window_sec=OR_WINDOW_S,
                             min_replicas=2, max_replicas=3,
                             verify_sec=verify_sec)]
        if rebalance:
            out.append(RebalancePolicy(job, share_threshold=0.60,
                                       hold_sec=1.0, min_gain=0.05,
                                       window_sec=1.5, verify_sec=2.0))
        return out

    kw = dict(cooldown_sec=6.0, max_actions_per_hour=6, table_fn=table_fn)
    shadow = Autopilot(monitor, operator, job, policies=policies(),
                       mode="recommend", **kw)
    pilot = Autopilot(monitor, operator, job, policies=policies(),
                      mode="enforce", journal_dir=jdir, **kw)
    return shadow, pilot


def or_job_operator(job: str, driver):
    from persia_tpu_torch.k8s_operator import FakeKubeApi, Operator

    spec = {"jobName": job, "image": "persia-tpu-runtime:chip",
            "embeddingConfigPath": "/config/embedding_config.yml",
            "roles": {"embeddingParameterServer": {"replicas": 2},
                      "embeddingWorker": {"replicas": 1},
                      "nnWorker": {"replicas": 1, "entry": "train.py"}}}
    op = Operator(FakeKubeApi(), [spec], interval=60.0,
                  reshard_driver=driver)
    op.reconcile_all()
    return op


def or_evidence_gate(tag: str, decisions, n: int):
    """Every journaled decision re-read from disk carries its history
    excerpt, and a scale decision its firing rules."""
    if len(decisions) != n:
        raise AssertionError(f"{tag}: {len(decisions)} journaled decisions "
                             f"for {n} executed actions")
    for d in decisions:
        ev = d.get("evidence", {})
        if not ev.get("history"):
            raise AssertionError(f"{tag}: decision {d['decision_seq']} "
                                 f"({d['kind']}) carries no history")
        if d["kind"] in ("scale_out", "scale_in") \
                and not ev.get("firing_rules"):
            raise AssertionError(f"{tag}: decision {d['decision_seq']} "
                                 f"({d['kind']}) carries no firing rule")


def or_seq_rec(torch, card: str, clusters: OrchestrationClusters):
    """(b) seq_rec at the training phase's widths over the watched cluster
    while an enforce-mode ``Autopilot`` with ``PsScalePolicy`` and a
    shadow recommend-mode one tick over its ``FleetMonitor`` at the same
    instants, on a thread: the scale-out threshold is 0.30 of the fleet's
    ``ps_lookup_row_rate`` over the first scrapes, so that the sustained
    load scales the tier 2→3 mid-run, executed through
    ``Operator(FakeKubeApi(), reshard_driver=...)`` by a
    ``ReshardController`` while the trainer steps on; then
    ``OR_AFTER_STEPS`` more steps, and the same batches on the unbroken
    cluster. Gates: exactly that action executes; the shadow decides the
    same (policy, kind, action); the journal re-reads with the decision
    and its evidence; losses, dense state with Adam's and every touched
    row (from its owner) bit-equal to the unbroken run; K2-K4 once a step,
    K1 and K5 never. Returns (the report, the launches)."""
    import tempfile

    import numpy as np

    from persia_tpu_torch.autopilot import ActionJournal
    from persia_tpu_torch.reshard import ReshardController
    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service.coordinator import CoordinatorClient
    from persia_tpu_torch.service.ps_service import PsClient
    from persia_tpu_torch.slos import SloEngine, default_rules
    from persia_tpu_torch.workloads.generator import SeqRecSpec, \
        seqrec_batches

    spec = SeqRecSpec(item_vocab=ITEM_VOCAB, t_hist=T_HIST)
    schema = build_schema()
    stream = seqrec_batches(OR_MAX_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                            seed=TRAIN_SEED + 23, spec=spec)
    batches = []  # the stream as the watched run consumed it
    start = build_tower(spec.num_dense, "flash").state_dict()
    svc = clusters.watched
    clients = [PsClient(a, circuit_breaker=False)
               for a in [*svc.ps_addrs, clusters.extra_addr()]]
    os.makedirs(clusters.pm_dir, exist_ok=True)
    jdir = tempfile.mkdtemp(dir=clusters.pm_dir, prefix="journal_b_")
    monitor = svc.fleet_monitor(
        scrape_interval=OR_SCRAPE_S, scrape_timeout=1.0,
        slo_engine=SloEngine(default_rules()),
        postmortem_dir=os.path.join(clusters.pm_dir, "b"))
    box = {"table": RoutingTable.uniform(N_PS), "rec": [], "enf": [],
           "ticks": 0, "windows": []}
    stop = threading.Event()

    def driver(job_name, old, new, phase, drv_spec):
        if phase != "scale_out" or (old, new) != (N_PS, N_PS + 1):
            raise AssertionError(f"orchestration (b): unexpected reshard "
                                 f"{phase} {old}->{new}")
        t0 = time.perf_counter()
        box["table"] = box["ctrl"].reshard_to(new,
                                              new_ps_clients=clients[:new])
        box["migrate_s"] = time.perf_counter() - t0

    operator = or_job_operator("seqrec", driver)

    def executed(pilot):
        return [r["action_kind"] for r in pilot.journal.tail(256)
                if r["kind"] == "executed"]

    def drive():
        try:
            # the trainer is past its first steps: calibrate over at least
            # OR_CAL_S of scrapes, until a second of them saw rows
            t_cal = time.monotonic()
            m_rows = None
            while time.monotonic() - t_cal < OR_CAL_S or not m_rows:
                if time.monotonic() - t_cal > 10 * OR_CAL_S:
                    raise RuntimeError("calibration saw no "
                                       "ps_lookup_row_rate")
                time.sleep(OR_SCRAPE_S)
                monitor.scrape_once()
                m_rows = monitor.history.avg_over(
                    "ps_lookup_row_rate", 1.0, r"^ps", time.monotonic())
            box["m_rows"] = m_rows
            shadow, pilot = box["pilots"] = or_pilots(
                monitor, operator, "seqrec", m_rows, jdir, 60.0,
                lambda: box["table"], rebalance=False)
            while not stop.is_set():
                time.sleep(OR_SCRAPE_S)
                monitor.scrape_once()
                now = time.monotonic()
                alerts = monitor.engine.evaluate(now)
                # the shadow first: it reads the world as enforcement
                # will, the instant before enforcement changes it
                box["rec"].extend(shadow.tick(now, alerts))
                t0 = time.perf_counter()
                enf = pilot.tick(now, alerts)
                if enf:
                    box["windows"].append((t0, time.perf_counter()))
                    box["step_at_action"] = box.get("step", 0)
                box["enf"].extend(enf)
                box["ticks"] += 1
                if executed(pilot) and "step_executed" not in box:
                    box["step_executed"] = box.get("step", 0)
        except BaseException as e:  # noqa: BLE001 — raised below
            box["error"] = e

    def run(cluster, on_step=None):
        ctx = train_ctx(torch, schema, build_tower(
            spec.num_dense, "flash", state_dict=start),
            worker=cluster.remote_worker())
        losses = []
        with ctx:
            reset_launch_counts()
            t0 = time.perf_counter()
            step = 0
            while True:
                if on_step is not None:
                    b = on_step(step, ctx)
                    if b is None:
                        break
                elif step == len(batches):
                    break
                else:
                    b = batches[step]
                losses.append(ctx.train_step(b)[0])
                step += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_launches()
        losses = torch.stack(losses).float().cpu().tolist()
        if not np.isfinite(losses).all():
            raise AssertionError("orchestration (b): a loss is not finite")
        return ctx, losses, dense_state(ctx), launches, wall

    def on_step(step, ctx):
        box["step"] = step
        if step == 0:
            # the new replica gets the init, admission and optimizer the
            # context armed the first two with
            ec = ctx.embedding_config
            lower, upper = ec.emb_initialization
            clients[-1].configure(
                "bounded_uniform", {"lower": lower, "upper": upper},
                ec.admit_probability, ec.weight_bound,
                enable_weight_bound=True)
            clients[-1].register_optimizer(
                ctx.embedding_optimizer.config,
                feature_index_prefix_bit=schema.feature_index_prefix_bit)
            box["ctrl"] = ReshardController(
                clients[:N_PS], RoutingTable.uniform(N_PS),
                workers=[ctx.worker],
                coordinator=CoordinatorClient(svc.coordinator_addr),
                drain_sec=RS_DRAIN_S)
        if step == OR_CAL_FROM:
            box["thread"] = threading.Thread(target=drive, daemon=True)
            box["thread"].start()
        if "error" in box:
            raise box["error"]
        done = box.get("step_executed")
        if (done is not None and step >= done + OR_AFTER_STEPS) \
                or step == OR_MAX_STEPS:
            return None
        batches.append(next(stream))
        return batches[-1]

    try:
        ctx, losses, dense, launches, wall = run(svc, on_step)
    finally:
        stop.set()
        if "thread" in box:
            box["thread"].join(timeout=120)
    if "error" in box:
        raise box["error"]
    if "step_executed" not in box:
        raise AssertionError(
            f"orchestration (b): no scale-out executed in {OR_MAX_STEPS} "
            f"steps (calibrated {box.get('m_rows')} rows/s)")
    ctrl, table = box["ctrl"], box["table"]
    ctrl.finalize()
    steps = len(batches)
    signs = np.unique(np.concatenate([f.signs for b in batches
                                      for f in b.id_type_features]))
    rows = np.zeros((len(signs), 2 * DIM), np.float32)
    owner = table.replica_of(signs)
    for r, c in enumerate(clients):
        sel = np.nonzero(owner == r)[0]
        f, v = c.get_entries(signs[sel], 2 * DIM)
        if not f.all():
            raise AssertionError(f"orchestration (b): {int((~f).sum())} "
                                 f"touched rows absent at their owner {r}")
        rows[sel] = v
    ctx.worker.close()
    ref_ctx, ref_losses, ref_dense, _, ref_wall = run(clusters.ref)
    found = np.zeros(len(signs), np.int64)
    ref_rows = np.zeros((len(signs), 2 * DIM), np.float32)
    for a in clusters.ref.ps_addrs:
        f, v = PsClient(a).get_entries(signs, 2 * DIM)
        found += f
        ref_rows[f] = v[f]
    ref_ctx.worker.close()
    monitor.stop()

    shadow, pilot = box["pilots"]
    journal = ActionJournal(jdir).records()
    by_kind = {}
    for r in journal:
        by_kind.setdefault(r["kind"], []).append(r)
    executed_kinds = [r["action_kind"] for r in by_kind.get("executed", [])]
    decisions = [r["decision"] for r in by_kind.get("decision", [])]

    def key(ds):
        return [(d["policy"], d["kind"], d["action"]) for d in ds]

    loss_diff = sum(a != b for a, b in zip(losses, ref_losses))
    dense_diff = first_difference(ref_dense, dense)
    row_diff = int((rows.view(np.uint32) != ref_rows.view(np.uint32))
                   .any(axis=-1).sum())
    events = [{k: v for k, v in e.items() if k != "time"}
              for e in operator.reshard_events()]
    line = (f"(b) seq_rec {steps} synchronous steps of {TRAIN_BATCH} over "
            f"the watched cluster: calibrated fleet ps_lookup_row_rate "
            f"{box['m_rows']:.1f} rows/s (scale-out above "
            f"{0.30 * box['m_rows']:.1f} sustained {OR_WINDOW_S}s), "
            f"{box['ticks']} ticks a pilot; executed {executed_kinds} at "
            f"step {box.get('step_at_action')} (migration "
            f"{box.get('migrate_s', 0.0):.3f}s inside the tick, "
            f"{box['windows'][0][1] - box['windows'][0][0]:.3f}s), "
            f"operator {events}; recommend {key(box['rec'])} enforce "
            f"{key(box['enf'])}; journal {[r['kind'] for r in journal]}; "
            f"against the unbroken cluster: losses that differ {loss_diff}, "
            f"dense state {dense_diff or 'bit-equal'}, {len(signs)} touched "
            f"rows ({np.bincount(owner, minlength=3).tolist()} a replica "
            f"under epoch {table.epoch}), rows that differ in any bit "
            f"{row_diff}; wall {wall:.2f}s watched vs {ref_wall:.2f}s "
            f"unbroken; launches "
            + " ".join(f"{n}={c}" for n, c in launches.items()))
    flash = [launches[n] for n in FLASH_KERNELS]
    if flash != [steps] * 3 or launches["embedding_bag"] \
            or launches["probe_copy"]:
        raise AssertionError(f"orchestration (b): K2-K4 must launch once a "
                             f"step and K1, K5 never: {line}")
    if executed_kinds != ["scale_out"] or operator.ps_replicas("seqrec") \
            != N_PS + 1 or [e["status"] for e in events] != ["done"] \
            or by_kind.get("action_failed"):
        raise AssertionError(f"orchestration (b): not exactly the one "
                             f"scale-out 2→3: {line}")
    if key(box["rec"]) != key(box["enf"]) or key(box["enf"]) != [
            ("ps_scale", "scale_out", {"job": "seqrec", "replicas": 3})]:
        raise AssertionError(f"orchestration (b): recommend and enforce "
                             f"decided differently: {line}")
    or_evidence_gate("orchestration (b)", decisions, 1)
    if loss_diff or dense_diff or row_diff or not (found == 1).all():
        raise AssertionError(f"orchestration (b): the autopiloted run "
                             f"differs from the unbroken one: {line}")
    return line, launches


def or_autopilot_bench(card: str, pm_dir: str) -> str:
    """(c) ``bench.py``'s ``bench_autopilot`` at its smoke depth on the
    port: 4 in-process ``PsService`` replicas (the per-entry holder,
    hotness on, the counting optimizer), each behind a sidecar that
    serves only its own series, scraped by a ``FleetMonitor`` every
    0.25 s; two paced trainer threads; an enforce and a shadow recommend
    ``Autopilot`` (``PsScalePolicy`` and ``RebalancePolicy``, thresholds
    from the calibrated row rate) acting through ``Operator(FakeKubeApi(),
    reshard_driver=...)`` over a live ``ReshardController``. The script:
    quiet (no action), surge (scale_out 2→3), hot-key skew (rebalance),
    calm (scale_in 3→2), settle (three outcomes). Gates: zero lost updates
    (the counting identity at the final owners), exactly [scale_out,
    rebalance, scale_in] executed and each verified improved, the fleet
    back at 2, recommend == enforce, every decision re-read from disk
    with its evidence, and the worker p99 during the actions within 25x
    of the quiet p99 above a 1 s floor. Run in a process of its own that
    loads no torch (``chip_smoke.py autopilot_bench <spec>``). Returns the
    report."""
    import numpy as np

    from persia_tpu_torch.autopilot import ActionJournal
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.data.batch import IDTypeFeature
    from persia_tpu_torch.fleet import FleetMonitor
    from persia_tpu_torch.metrics import default_registry
    from persia_tpu_torch.obs_http import ObservabilityServer
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.reshard import ReshardController
    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service.ps_service import PsClient, PsService
    from persia_tpu_torch.slos import SloEngine, default_rules
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    dim, n_feats, n_threads, bs, sign_space = RS_DIM, 2, 2, 256, 1 << 20
    job = "bench"
    schema = EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{i}" for i in range(n_feats)], dim=dim))

    def feature(name, signs):
        return IDTypeFeature(name, [np.asarray(signs, dtype=np.uint64)])

    class OneServer:
        """The process registry's exposition cut to one PS server's
        labeled series: the replicas share this process, and each
        sidecar must serve only its own (what separate processes serve),
        or the fleet sums would count every replica four times."""

        def __init__(self, base, label):
            self._base, self._needle = base, f'server="{label}"'

        def histogram(self, *a, **kw):
            return self._base.histogram(*a, **kw)

        def render(self):
            keep = [ln for ln in self._base.render().splitlines()
                    if ln.startswith("#") or self._needle in ln]
            return "\n".join(keep) + "\n"

    holders, services, clients, sidecars = [], [], [], []
    for i in range(4):
        h = EmbeddingHolder(capacity=2_000_000, hotness=True)
        svc = PsService(h, port=0)
        svc.server.serve_background()
        c = PsClient(svc.addr, circuit_breaker=False)
        c.configure("bounded_uniform", {"lower": 0.0, "upper": 0.0},
                    admit_probability=1.0, weight_bound=1e9,
                    enable_weight_bound=False)
        c.register_optimizer({"type": "sgd", "lr": 1.0, "wd": 0.0})
        side = ObservabilityServer(
            port=0, registry=OneServer(default_registry(),
                                       svc.addr.rsplit(":", 1)[1]),
            health_fn=svc._health, service=f"ps{i}",
            refresh_fn=svc._refresh_mem_gauges,
            hotness_fn=svc._hotness_snapshot).start()
        holders.append(h)
        services.append(svc)
        clients.append(c)
        sidecars.append(side)

    table = RoutingTable.uniform(2)
    worker = EmbeddingWorker(schema, clients[:2], routing=table)
    controller = ReshardController(clients[:2], table, workers=[worker],
                                   replay_settle_rows=64, drain_sec=0.25)
    last_table = [table]
    jdir = os.path.join(pm_dir, "journal_c")
    monitor = FleetMonitor(
        targets=[{"service": f"ps{i}", "http_addr": s.addr, "role": "ps",
                  "replica": i} for i, s in enumerate(sidecars)],
        scrape_interval=OR_SCRAPE_S, scrape_timeout=1.0, flight_interval=4.0,
        slo_engine=SloEngine(default_rules()),
        postmortem_dir=os.path.join(pm_dir, "c"))

    def reshard_driver(job_name, old, new, phase, spec):
        if phase == "resume":
            return
        if phase == "rebalance":
            plan = monitor.hotness_plan(old, current_table=last_table[0])
            last_table[0] = controller.reshard_to(
                old, slot_weights=np.asarray(plan["slot_weights"],
                                             np.float64))
        elif phase == "scale_out":
            last_table[0] = controller.reshard_to(
                new, new_ps_clients=clients[:new])
        else:
            last_table[0] = controller.reshard_to(new)

    operator = or_job_operator(job, reshard_driver)
    ships, samples, errors = [0], [], []
    s_lock = threading.Lock()
    stop = threading.Event()
    # the pace: a cycle every period a thread (0: flat out), thread i's
    # cycles at epoch + (i / n_threads + k) * period
    mode_box, period_box, epoch_box = ["uniform"], [0.0], [0.0]
    hot_box = [np.zeros(0, dtype=np.uint64)]

    def mk_feats(rng):
        if mode_box[0] == "skew" and len(hot_box[0]):
            n_hot = int(bs * 0.75)
            return [np.concatenate([
                rng.choice(hot_box[0], size=n_hot),
                rng.integers(0, sign_space, bs - n_hot, dtype=np.uint64)])
                for _ in range(n_feats)]
        return [rng.integers(0, sign_space, bs, dtype=np.uint64)
                for _ in range(n_feats)]

    def train(seed):
        """Trainer thread ``seed``: cycles on its own slots of the pace,
        spread over the period with the other thread's, so that a paced
        load reaches the scrapes as evenly as the pace allows. (Sleeping
        the rest of the period after each cycle lets the two threads'
        phases lock: at 5% of a slow host's rate both cycles then land in
        one scrape interval each period, and that spike, above the
        scale-in threshold, keeps the calm from being sustained.)"""
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            raw = mk_feats(rng)
            t0 = time.perf_counter()
            try:
                ref, out = worker.lookup_direct_training(
                    [feature(f"slot_{i}", r) for i, r in enumerate(raw)])
                worker.update_gradients(ref, {
                    k: np.ones_like(v.embeddings) for k, v in out.items()})
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)
                return
            dt = time.perf_counter() - t0
            with s_lock:
                ships[0] += n_feats * bs
                samples.append((t0, dt))
            p = period_box[0]
            if p > 0:
                first = epoch_box[0] + seed * p / n_threads
                now = time.perf_counter()
                k = max(math.floor((now - first) / p) + 1, 0)
                time.sleep(max(first + k * p - now, 0.0))

    threads = [threading.Thread(target=train, args=(s,), daemon=True)
               for s in range(n_threads)]
    for t in threads:
        t.start()
    enf_decisions, rec_decisions, windows, marks = [], [], [], {}
    t_start = time.monotonic()
    try:
        t_cal = time.monotonic()
        ships0 = ships[0]
        while time.monotonic() - t_cal < OR_CAL_S:
            time.sleep(OR_SCRAPE_S)
            monitor.scrape_once()
        m_cycles = max((ships[0] - ships0) / (n_feats * bs)
                       / (time.monotonic() - t_cal), 1.0)
        m_rows = monitor.history.avg_over(
            "ps_lookup_row_rate", 1.0, r"^ps", time.monotonic())
        if not m_rows or m_rows <= 0:
            raise RuntimeError("calibration saw no ps_lookup_row_rate")
        shadow, pilot = or_pilots(monitor, operator, job, m_rows, jdir, 2.0,
                                  lambda: last_table[0], rebalance=True)

        def executed_kinds():
            return [r["action_kind"] for r in pilot.journal.tail(256)
                    if r["kind"] == "executed"]

        def drive(frac, traffic, done_fn, max_sec, label):
            mode_box[0] = traffic
            epoch_box[0] = time.perf_counter()
            period_box[0] = n_threads / (frac * m_cycles)
            t_end = time.monotonic() + max_sec
            while time.monotonic() < t_end:
                time.sleep(OR_SCRAPE_S)
                if errors:
                    raise RuntimeError(f"a trainer thread died during "
                                       f"{label}: {errors[0]!r}")
                monitor.scrape_once()
                now = time.monotonic()
                alerts = monitor.engine.evaluate(now)
                rec_decisions.extend(shadow.tick(now, alerts))
                t0 = time.perf_counter()
                enf = pilot.tick(now, alerts)
                if enf:
                    windows.append((t0, time.perf_counter()))
                enf_decisions.extend(enf)
                if done_fn is not None and done_fn():
                    marks[label] = time.monotonic() - t_start
                    return
            if done_fn is not None:
                rate = monitor.history.avg_over(
                    "ps_lookup_row_rate", 1.0, r"^ps", time.monotonic())
                raise AssertionError(
                    f"orchestration (c): the script never reached {label} "
                    f"within {max_sec:.0f}s (executed {executed_kinds()}; "
                    f"calibrated {m_cycles:.1f} cycles/s, {m_rows:.1f} "
                    f"rows/s; the fleet's last second {rate} rows/s)")
            marks[label] = time.monotonic() - t_start

        drive(0.10, "uniform", None, 2.6, "warmup")
        if executed_kinds():
            raise AssertionError(f"orchestration (c): the pilot acted during "
                                 f"the quiet warm-up: {executed_kinds()}")
        drive(0.55, "uniform", lambda: "scale_out" in executed_kinds(),
              15.0, "scale_out")
        cand = np.random.default_rng(7).integers(0, sign_space, 8192,
                                                 dtype=np.uint64)
        hot_box[0] = cand[last_table[0].replica_of(cand) == 0][:512]
        drive(0.25, "skew", lambda: "rebalance" in executed_kinds(), 18.0,
              "rebalance")
        hot_box[0] = np.zeros(0, dtype=np.uint64)
        drive(0.05, "uniform", lambda: "scale_in" in executed_kinds(), 15.0,
              "scale_in")
        drive(0.05, "uniform", lambda: len(
            [r for r in pilot.journal.tail(256) if r["kind"] == "outcome"])
            >= 3, 10.0, "outcomes")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    try:
        if errors:
            raise RuntimeError(f"a trainer thread died: {errors[0]!r}")
        controller.finalize(drain_sec=0.0)
        final = last_table[0]
        applied = rs_applied(holders, final)  # dim 8 is RS_DIM
        lost = ships[0] - applied

        def p99(vals):
            return float(np.percentile(np.asarray(vals), 99)) if vals \
                else 0.0

        during = [d for t0, d in samples
                  if any(a <= t0 <= b for a, b in windows)]
        quiet = [d for t0, d in samples
                 if not any(a - 0.1 <= t0 <= b + 0.1 for a, b in windows)]
        p99_q, p99_d = p99(quiet), p99(during)
        inflation = p99_d / p99_q if p99_q > 0 else 0.0
        journal = ActionJournal(jdir).records()
        by_kind = {}
        for r in journal:
            by_kind.setdefault(r["kind"], []).append(r)
        executed = [r["action_kind"] for r in by_kind.get("executed", [])]
        improved = [r for r in by_kind.get("outcome", [])
                    if r.get("improved")]

        def key(ds):
            return [(d["policy"], d["kind"], d["action"]) for d in ds]

        line = (f"(c) bench_autopilot at its smoke depth (4 in-process PS, 2 "
                f"paced trainer threads, dim {dim}, {n_feats} slots, batch "
                f"{bs}): calibrated {m_cycles:.1f} cycles/s, {m_rows:.1f} "
                f"rows/s; executed {executed} at "
                + ", ".join(f"{k} {v:.1f}s" for k, v in marks.items())
                + f"; {len(improved)} outcomes improved, "
                f"{len(by_kind.get('regressed', []))} regressed, "
                f"{len(by_kind.get('action_failed', []))} failed; replicas "
                f"{operator.ps_replicas(job)}; ships {ships[0]} applied "
                f"{applied:.0f} lost {lost:.3f}; worker p99 quiet "
                f"{p99_q * 1e3:.2f}ms during actions {p99_d * 1e3:.2f}ms "
                f"({len(during)} cycles), inflation {inflation:.2f}x (gate "
                f"{OR_C_INFLATION_X}x above a {OR_C_FLOOR_S}s floor); "
                f"recommend == enforce over {len(enf_decisions)} decisions: "
                f"{key(rec_decisions) == key(enf_decisions)}; journal "
                + str({k: len(v) for k, v in by_kind.items()}))
        if abs(lost) > 1e-3:
            raise AssertionError(f"orchestration (c): lost updates: {line}")
        if executed != ["scale_out", "rebalance", "scale_in"]:
            raise AssertionError(f"orchestration (c): executed {executed}, "
                                 f"not the script: {line}")
        if len(improved) < 3 or by_kind.get("regressed") \
                or by_kind.get("action_failed") \
                or operator.ps_replicas(job) != 2:
            raise AssertionError(f"orchestration (c): verification not "
                                 f"green: {line}")
        if key(rec_decisions) != key(enf_decisions):
            raise AssertionError(f"orchestration (c): recommend and enforce "
                                 f"diverge: {line}")
        or_evidence_gate("orchestration (c)",
                         [r["decision"] for r in by_kind.get("decision", [])],
                         3)
        if p99_d > OR_C_FLOOR_S and inflation > OR_C_INFLATION_X:
            raise AssertionError(f"orchestration (c): worker p99 inflated "
                                 f"through the actions: {line}")
        return line + f" | card: {card}"
    finally:
        monitor.stop()
        worker.close()
        for s in services:
            s.stop()
        for side in sidecars:
            side.stop()


class AutopilotBenchProcess:
    """(c) in a child process (``chip_smoke.py autopilot_bench <spec>``),
    as ``bench.py --mode autopilot`` runs: its four replicas, monitor,
    pilots and trainer threads share a process holding nothing else."""

    def __init__(self, card: str, pm_dir: str):
        import subprocess

        os.makedirs(pm_dir, exist_ok=True)
        self.spec = os.path.join(pm_dir, "c.json")
        with open(self.spec, "w") as f:
            json.dump({"card": card, "pm_dir": pm_dir,
                       "out": self.spec + ".out"}, f)
        self.proc = subprocess.Popen([sys.executable,
                                      os.path.abspath(__file__),
                                      "autopilot_bench", self.spec])

    def result(self) -> str:
        """Its report; raises its failure."""
        self.proc.wait(timeout=600)
        with open(self.spec + ".out") as f:
            out = json.load(f)
        if out.get("error"):
            raise AssertionError(out["error"])
        return out["line"]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


def autopilot_bench_main(spec_path: str) -> int:
    """The child of :func:`or_autopilot_process`: run (c), write its report
    or its failure. It never loads torch, so it launches no kernel."""
    with open(spec_path) as f:
        spec = json.load(f)
    try:
        out = {"line": or_autopilot_bench(spec["card"], spec["pm_dir"])}
        if "torch" in sys.modules:
            raise AssertionError("orchestration (c): the bench's process "
                                 "loaded torch")
    except Exception as e:  # noqa: BLE001 — the parent raises it
        traceback.print_exc()
        out = {"error": f"{type(e).__name__}: {e}"}
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0 if "line" in out else 1


def orchestration_phase(torch, card: str) -> dict:
    """(c)'s child first, alone: its thresholds are fractions of a rate it
    calibrates at its start, and its script needs that rate to hold after
    (its surge missed the band beside (a) and (b) once, and beside the
    start-up of their processes on a slow host once more). Then (a)'s and
    (b)'s processes start, (a)'s trainer group and data loaders start and
    (b) runs in this process while (a) trains; (a)'s gates are read once
    it ends. Returns (b)'s launches."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as pm_dir:
        bench = AutopilotBenchProcess(card, pm_dir)
        clusters = None
        try:
            c_line = bench.result()
            _log(f"[orchestration] {c_line}")
            t1 = time.perf_counter()
            _log(f"[time] orchestration (c) {t1 - t0:.1f}s")
            clusters = OrchestrationClusters()
            job = clusters.job
            job.start_roles()
            up = clusters.wait()
            _log(f"[orchestration] (b)'s watched and unbroken clusters up "
                 f"{up:.1f}s after their start, a third PS at "
                 f"{clusters.extra_addr()}; (a)'s service pods up, "
                 f"coordinator {job.coordinator_addr} | card: {card}")
            b_line, launches = or_seq_rec(torch, card, clusters)
            _log(f"[orchestration] {b_line} | card: {card}")
            t2 = time.perf_counter()
            _log(f"[time] orchestration (b) {t2 - t1:.1f}s")
            job.wait()
            _log(f"[orchestration] {or_job_check(card, job)}")
            _log(f"[time] orchestration (a) {time.perf_counter() - t1:.1f}s "
                 f"from its roles' spawn, {time.perf_counter() - t2:.1f}s "
                 f"after (b)")
            for c in clusters.ctxs:
                if c.crashed:
                    raise AssertionError(f"orchestration: a child crashed: "
                                         f"{c.crashed}")
            if clusters.extra_ps.poll() is not None:
                raise AssertionError("orchestration: the third PS process "
                                     "exited")
        finally:
            bench.stop()
            if clusters is not None:
                clusters.stop()
    return launches


def obs_get(addr: str, path: str):
    """A sidecar's ``/metrics`` as (samples, families), or its JSON
    document at ``path``."""
    import urllib.request

    from persia_tpu_torch.metrics import parse_exposition

    with urllib.request.urlopen(f"http://{addr}{path}", timeout=10) as r:
        body = r.read().decode()
    return parse_exposition(body) if path == "/metrics" else json.loads(body)


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
    procs = clusters = su_clusters = on_clusters = rs_clusters = None
    fl_clusters = tsv_files = None
    try:
        # first: its child writes criteo_tsv's files while the setup builds
        tsv_files = CriteoTsvFiles()
        clock = _PhaseClock()
        card = card_line()
        _log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
             f"python {sys.version.split()[0]}")
        _log(f"[setup] card: {card}")
        procs = MultiRankProcs()
        # the TPU kernels' ports, and R1 (the row-wise Adagrad, no TPU
        # counterpart), which device mode's optimizer launches
        sources = sorted({s.split("/")[-1][:-3] for s, _ in
                          KERNEL_INFO.values()} | {"rowwise_adagrad"})
        t0 = time.perf_counter()
        # the kernels (nvcc) build on a thread while this one builds the
        # native PS library (g++) and then starts the service clusters,
        # whose processes load that library
        built = {}
        kernel_build = threading.Thread(target=lambda: built.update(
            paths=_build.build(sources)))
        kernel_build.start()
        from persia_tpu_torch.ps import native
        try:
            native.load_native_lib()
            native_s = time.perf_counter() - t0
            clusters = ServiceClusters()
            su_clusters = SupervisionClusters()
            on_clusters = OnlineClusters()
            rs_clusters = ReshardClusters()
        finally:
            kernel_build.join()
        if "paths" not in built:
            raise RuntimeError("the kernel build failed (its error is "
                               "above)")
        paths = built["paths"]
        _log(f"[setup] built {sources} in {time.perf_counter() - t0:.1f}s "
             f"and the native PS library {native.native_lib_path().name} "
             f"beside them in {native_s:.1f}s; its SIMD path "
             f"{native.native_simd_path()}, os.cpu_count()={os.cpu_count()}")
        report_build(paths, sources)
        clock("setup")
        # after setup's own work, so that its ~20 processes (the CLI's
        # torch and CUDA start among them) come up during the first three
        # phases, which mostly wait, and not against the build's reports
        fl_clusters = FleetClusters()
        # first, so that its clusters are down before anything is timed
        su_launches = supervision_phase(torch, card, su_clusters)
        su_clusters.stop()
        su_clusters = None
        clock("supervision")
        # second, for the same reason: its clusters are down before the
        # timed phases
        online_launches = online_phase(torch, card, on_clusters)
        on_clusters.stop()
        on_clusters = None
        clock("online")
        # third, for the same reason
        reshard_launches = reshard_phase(torch, card, rs_clusters)
        rs_clusters.stop()
        rs_clusters = None
        clock("reshard")
        # fourth, for the same reason
        fleet_launches = fleet_phase(torch, card, fl_clusters)
        fl_clusters.stop()
        fl_clusters = None
        clock("fleet")
        floor = launch_path_phase(torch, card)
        clock("launch_path")
        records = kernel_phase(torch, card)
        records.update(sparse_kernel_phase(torch, card))
        clock("kernel")
        # early, while this process holds little: the ranks share its
        # card and cores
        torch.cuda.empty_cache()
        for name, n in multi_rank_phase(torch, card, procs).items():
            records[name].update(n)
        clock("multi_rank")
        in_process_rate = serving_phase(torch, card)
        clock("serving")
        rpc_launches = serving_rpc_phase(torch, card, in_process_rate)
        clock("serving_rpc")
        for name, n in training_phase(torch, card).items():
            records[name]["launches"] = n
        clock("training")
        for name, n in pipelined_phase(torch, card).items():
            records[name]["launches_pipelined"] = n
        clock("pipelined")
        dlrm_hybrid_phase(torch, card)
        clock("dlrm_hybrid")
        services_launches = services_phase(torch, card, clusters,
                                           in_process_rate)
        clock("services")
        cached_launches = dlrm_cached_phase(torch, card)
        clock("dlrm_cached")
        zoo_phase(torch, card)
        clock("zoo")
        adult_income_phase(torch, card)
        clock("adult_income")
        criteo_towers_phase(torch, card)
        clock("criteo_towers")
        tsv_launches = criteo_tsv_phase(torch, card, tsv_files)
        tsv_files.stop()
        tsv_files = None
        clock("criteo_tsv")
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
        # its processes start with it: the earlier phases run without them
        orchestration_launches = orchestration_phase(torch, card)
        clock("orchestration")
        for name, n in orchestration_launches.items():
            records[name]["launches_orchestration"] = n
        for name, n in cached_launches.items():
            records[name]["launches_dlrm_cached"] = n
        for name, n in rpc_launches.items():
            records[name]["launches_serving_rpc"] = n
        for name, n in services_launches.items():
            records[name]["launches_services"] = n
        for name, n in su_launches.items():
            records[name]["launches_supervision"] = n
        for name, n in online_launches.items():
            records[name]["launches_online"] = n
        for name, n in reshard_launches.items():
            records[name]["launches_reshard"] = n
        for name, n in fleet_launches.items():
            records[name]["launches_fleet"] = n
        for name, n in tsv_launches.items():
            records[name]["launches_criteo_tsv"] = n
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
        if clusters is not None:
            clusters.stop()
        if su_clusters is not None:
            su_clusters.stop()
        if on_clusters is not None:
            on_clusters.stop()
        if rs_clusters is not None:
            rs_clusters.stop()
        if fl_clusters is not None:
            fl_clusters.stop()
        if tsv_files is not None:
            tsv_files.stop()
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["criteo_tsv_files"]:  # criteo_tsv's files
        sys.exit(criteo_tsv_files_main(sys.argv[2]))
    elif sys.argv[1:2] == ["fleet_bench"]:  # the fleet phase's (a)
        sys.exit(fleet_bench_main(sys.argv[2]))
    elif sys.argv[1:2] == ["autopilot_bench"]:  # the orchestration's (c)
        sys.exit(autopilot_bench_main(sys.argv[2]))
    elif len(sys.argv) > 1:  # a rank of the multi_rank phase
        _ranks_module().rank_main(RANK_BODIES)
    else:
        sys.exit(main())
