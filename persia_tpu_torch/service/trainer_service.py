"""The supervised trainer driver (``persia_tpu/service/trainer_service.py``).

``ServiceCtx(supervise_trainer=True)`` starts this driver and starts it
again after it dies. It runs the counting workload (zero-init rows, sgd
lr=1 and unit gradients, so that every sign's row is ``-count``
elementwise), takes a job snapshot every ``--snapshot-interval`` steps
through :func:`persia_tpu_torch.snapshot.snapshot_job`, and on start
resumes from the newest COMPLETE snapshot: the PS stores roll back to it
(the load wipes later updates) and the batch stream replays from its
cursor. Every batch is a pure function of ``(seed, step)``, so the replay
applies the wiped updates exactly once again and the counting identity
stays exact across any number of kills.

``--die-at`` SIGKILLs this process at a named point, once across its
incarnations (a marker file under the snapshot directory, written just
before the kill, holds the kill's ``time.monotonic()``):

* ``mid_step``: between the lookup and the gradient update;
* ``mid_snapshot``: inside ``snapshot_job``, after the payloads and
  before the manifest (a torn snapshot the resume refuses and falls back
  past);
* ``between_snapshots``: at a step boundary away from the cadence.

Having trained ``--steps``, the driver writes ``--result-file``
atomically and exits 0, which the supervisor takes as done.

``--device`` (default ``cuda``) is where the dense rider runs; the
driver brings the device up at start, so a driver asked for CUDA on a
host without a card raises there instead of running on the CPU.

A trainer group (``--process-index`` / ``--process-count``): N drivers
over ONE worker / PS tier, each taking the global batches ``i % N ==
index`` (``ResumableDataset``'s sharding), with its own lookups and
updates, its shipments labeled ``p<index>``. With ``--mesh`` the group
meets in a ``torch.distributed`` world through the coordinator's KV
store: process 0 binds a ``TCPStore`` on port 0 and publishes the bound
``host:port`` under ``--rendezvous-key``, the others ``wait_kv`` it.
The backend is gloo on the CPU and on a card that the ranks share
(NCCL refuses two ranks on one device), NCCL when each rank has a card
of its own. ``--dense-sync-every K`` then runs the dense rider every K
local steps: a ``DNN`` trained by ``make_packed_train_step_ddp`` with
the int8 error-feedback reduction on ``--device``.
``--device-step-ms`` models the dense step's time on the device as a
sleep between lookup and update.

A group's crash safety is its cursors only: each process writes
``cursor_p<i>.json`` and a restarted one resumes its own shard, but the
PS does not roll back, so replayed tail steps apply twice (at least
once). The exact counting identity across kills holds for one process.

Run: ``python -m persia_tpu_torch.service.trainer_service --coordinator
<addr> [--snapshot-dir <dir>] [--device cpu]``
"""

import argparse
import json
import logging
import os
import signal
import time

import numpy as np

from persia_tpu_torch import knobs, obs_http, tracing
from persia_tpu_torch import snapshot as _snapshot
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.data.dataloader import ResumableDataset
from persia_tpu_torch.service.coordinator import (
    ROLE_TRAINER,
    ROLE_WORKER,
    CoordinatorClient,
)
from persia_tpu_torch.service.worker_service import RemoteEmbeddingWorker
from persia_tpu_torch.storage import PersiaPath

_logger = logging.getLogger(__name__)

# the counting arm: zero-init + sgd lr=1 + unit gradients -> row == -count
ARM_INIT = ("bounded_uniform", {"lower": 0.0, "upper": 0.0}, 1.0, 1e9, False)
ARM_OPT = {"type": "sgd", "lr": 1.0, "wd": 0.0}

DIE_POINTS = ("none", "mid_step", "mid_snapshot", "between_snapshots")

# the rider's widths: non-id features of width 5, two summed slots of 8,
# two rows a process (the JAX rider's 2 x local_device_count with one
# device a process)
RIDER_DENSE = 5
RIDER_SLOTS = (8, 8)
RIDER_ROWS = 2
RIDER_LR = 0.1


def sign_pool(pool_size: int) -> np.ndarray:
    """The fixed sign universe every incarnation draws from (the chaos
    harness regenerates the expected per-sign counts from it)."""
    return np.unique(np.random.default_rng(7).integers(
        0, 1 << 40, pool_size, dtype=np.uint64))


def batch_draws(pool: np.ndarray, seed: int, step: int,
                batch_size: int, n_feats: int):
    """Batch ``step`` of the stream, a pure function of (seed, step)."""
    rng = np.random.default_rng([seed, step])
    return [rng.choice(pool, size=batch_size) for _ in range(n_feats)]


def _die_now():
    # SIGKILL, not sys.exit: an unclean death the supervisor must detect
    os.kill(os.getpid(), signal.SIGKILL)


def _backend_for(device, process_count: int) -> str:
    """gloo on the CPU and when ranks share a card; NCCL when every rank
    has a card of its own."""
    import torch

    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= process_count else "gloo"


def mesh_up(coord: CoordinatorClient, process_index: int,
            process_count: int, device, rendezvous_key: str,
            rendezvous_host: str = "127.0.0.1", mesh_shape=None):
    """A trainer group's ``torch.distributed`` world and its mesh (every
    rank on the data axis unless ``mesh_shape`` says otherwise), met
    through the coordinator's KV store: process 0 binds a ``TCPStore`` on
    port 0 and publishes the bound ``host:port`` under
    ``rendezvous_key`` (no free-port probe to race); the others wait for
    it. Returns ``(mesh, backend)``."""
    import datetime

    import torch.distributed as dist

    from persia_tpu_torch.distributed import DistributedOption

    timeout = knobs.get("PERSIA_TRAINER_RENDEZVOUS_TIMEOUT_SEC")
    world, rank = process_count, process_index
    if rank == 0:
        store = dist.TCPStore(rendezvous_host, 0, world,
                              is_master=True, wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=timeout))
        addr = f"{rendezvous_host}:{store.port}"
        if world > 1:
            coord.kv_put(rendezvous_key, addr.encode())
    else:
        addr = coord.wait_kv(rendezvous_key, timeout=timeout).decode()
        host, port = addr.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world, is_master=False,
                              timeout=datetime.timedelta(seconds=timeout))
    backend = _backend_for(device, world)
    mesh = DistributedOption(mesh_shape=mesh_shape, backend=backend,
                             device=device, store=store, world_size=world,
                             rank=rank, timeout=timeout).initialize()
    _logger.info("trainer mesh up: process %d/%d via %s (%s)", rank, world,
                 addr, backend)
    return mesh, backend


def _dense_rider(mesh, process_count: int, seed: int, model=None):
    """A small dense tower riding the sparse stream: each call is one
    data-parallel step over the group's mesh with the int8-EF reduction.
    ``model`` (a ``DNN(5, [8, 8])`` on the mesh's device) defaults to one
    drawn from ``seed`` on the CPU. Returns ``sync(round_no, pid) ->
    loss``; inputs are a pure function of ``(seed, round_no, pid)``, each
    process contributing its own rows."""
    import torch

    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.parallel.mesh import mesh_device
    from persia_tpu_torch.parallel.train import (
        init_ef_state,
        make_packed_train_step_ddp,
    )

    device = mesh_device(mesh)
    if model is None:
        # drawn on the CPU, so that every device starts from one weight set
        torch.manual_seed(seed)
        model = DNN(RIDER_DENSE, RIDER_SLOTS, device="cpu").to(device)
    opt = torch.optim.SGD(model.parameters(), lr=RIDER_LR)
    step_fn = make_packed_train_step_ddp(model, opt, list(RIDER_SLOTS), mesh,
                                         grad_reduce_dtype="int8_ef")
    holder = {"ef": init_ef_state(model, mesh)}
    width = sum(RIDER_SLOTS)

    def sync(round_no: int, pid: int) -> float:
        rng = np.random.default_rng([seed, round_no, pid])
        non_id = torch.from_numpy(
            rng.normal(size=(RIDER_ROWS, RIDER_DENSE)).astype(np.float32))
        emb = torch.from_numpy(
            rng.normal(size=(RIDER_ROWS, width)).astype(np.float32)
        ).to(torch.bfloat16)
        label = torch.from_numpy(
            rng.integers(0, 2, size=(RIDER_ROWS, 1)).astype(np.float32))
        loss, _g, _p, holder["ef"] = step_fn(
            [non_id.to(device)], emb.to(device), label.to(device),
            holder["ef"])
        return float(loss)

    sync.model = model
    return sync


def _param_digest(model) -> str:
    """sha256 of every floating tensor of ``model``'s state, in order: two
    ranks whose digests match hold bit-equal dense parameters."""
    import hashlib

    h = hashlib.sha256()
    for t in model.state_dict().values():
        if t.is_floating_point():
            h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _bring_up(device_name: str):
    """The trainer's device, with its context made (a CUDA driver without
    a card raises here)."""
    import torch

    from persia_tpu_torch.device import resolve_device

    device = resolve_device(device_name)
    torch.zeros(1, device=device).add_(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return device


def main(argv=None):
    t_main = time.monotonic()
    p = argparse.ArgumentParser(
        description="persia_tpu_torch supervised trainer driver")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--snapshot-dir", default=None)
    p.add_argument("--snapshot-interval", type=int,
                   default=knobs.get("PERSIA_SNAPSHOT_INTERVAL_STEPS"))
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--n-feats", type=int, default=2)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--pool-size", type=int, default=8192)
    p.add_argument("--die-at", choices=DIE_POINTS, default="none")
    p.add_argument("--die-step", type=int, default=-1)
    p.add_argument("--result-file", default=None)
    p.add_argument("--step-delay", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="the dense rider's device (cuda, or cpu when asked)")
    # --- trainer group ----------------------------------------------------
    p.add_argument("--process-index", type=int,
                   default=knobs.get("PERSIA_PROCESS_INDEX"))
    p.add_argument("--process-count", type=int,
                   default=knobs.get("PERSIA_PROCESS_COUNT"))
    p.add_argument("--workload", default="counting",
                   help="'counting' (the identity arm) or a zoo scenario "
                        "(dlrm/seqrec/multitask): the same lookup/update "
                        "plane with a production slot layout")
    p.add_argument("--device-step-ms", type=float, default=0.0,
                   help="the dense step's modeled device time between "
                        "lookup and update (0 = RPC-only loop)")
    p.add_argument("--mesh", action="store_true",
                   help="meet the group in a torch.distributed world over "
                        "the coordinator's KV store")
    p.add_argument("--dense-sync-every", type=int, default=0,
                   help="run the int8-EF dense rider every K local steps "
                        "(needs --mesh)")
    p.add_argument("--rendezvous-key",
                   default=knobs.get("PERSIA_TRAINER_RENDEZVOUS_KEY"))
    p.add_argument("--rendezvous-host", default="127.0.0.1")
    obs_http.add_http_args(p)
    args = p.parse_args(argv)
    if not 0 <= args.process_index < args.process_count:
        p.error(f"--process-index {args.process_index} outside group of "
                f"{args.process_count}")
    multi = args.process_count > 1
    if args.dense_sync_every and not args.mesh:
        p.error("--dense-sync-every needs --mesh")
    if args.dense_sync_every and args.steps % args.process_count:
        # the rider is a collective: every process must reach the same
        # number of rounds or the group deadlocks
        p.error("--dense-sync-every needs --steps divisible by "
                "--process-count")
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO").upper())

    device = _bring_up(args.device)
    t_device = time.monotonic()

    tracing.set_service_name("trainer")
    status = {"model_manager_status": "Initializing", "step": 0,
              "resumed_from": None, "process_index": args.process_index,
              "process_count": args.process_count, "mesh_shape": None,
              "ships": 0, "workload": args.workload,
              "device": str(device)}

    # gauges labeled by process: each member of a group is a series
    from persia_tpu_torch import metrics as _metrics

    lbl = {"process": f"p{args.process_index}"}
    g_step = _metrics.default_registry().gauge(
        "trainer_step", labels=lbl,
        help_text="local train steps completed by this trainer process")
    g_ships = _metrics.default_registry().gauge(
        "trainer_ships_total", labels=lbl,
        help_text="gradient shipments sent by this trainer process")

    def health_fn():
        return dict(status, service="trainer")

    http = obs_http.maybe_start("127.0.0.1", obs_http.port_from_args(args),
                                health_fn)
    obs_http.write_addr_file_from_args(http, args)

    coord = CoordinatorClient(args.coordinator)

    mesh = None
    if args.mesh:
        mesh, backend = mesh_up(coord, args.process_index,
                                args.process_count, device,
                                args.rendezvous_key, args.rendezvous_host)
        status["mesh_shape"] = "x".join(str(d) for d in mesh.mesh.shape)
        status["backend"] = backend

    # the trainer registers like every other tier, one row a process;
    # the sidecar's address doubles as its display address
    trainer_addr = http.addr if http is not None else f"pid:{os.getpid()}"
    coord.register(ROLE_TRAINER, args.process_index, trainer_addr,
                   http_addr=http.addr if http is not None else None)

    addrs = coord.wait_members(ROLE_WORKER, args.num_workers, timeout=120)
    worker = RemoteEmbeddingWorker(addrs)
    if multi:
        worker.process_label = f"p{args.process_index}"
    # arm before the readiness wait (a PS serves once it has an optimizer);
    # configure and register are idempotent, so every group member arms
    worker.configure_parameter_servers(*ARM_INIT)
    worker.register_optimizer(ARM_OPT)
    worker.wait_for_serving(timeout=120)

    pool = sign_pool(args.pool_size)
    die_step = args.die_step
    die_marker = None
    die_at = args.die_at
    if args.snapshot_dir and die_at != "none":
        die_marker = os.path.join(args.snapshot_dir,
                                  f".die_{die_at}_{die_step}")
        if os.path.exists(die_marker):
            die_at = "none"  # this kill fired in an earlier incarnation

    def arm_kill():
        # the marker before the kill: a death mid-write costs at most one
        # more kill, never a loop of them
        if die_marker:
            os.makedirs(args.snapshot_dir, exist_ok=True)
            PersiaPath(die_marker).write_bytes_atomic(
                repr(time.monotonic()).encode())

    # --- resume -----------------------------------------------------------
    # one process: the whole job rolls back to the newest complete
    # snapshot and replays; a group: each process resumes its own shard
    # cursor, with no PS rollback (at least once)
    start = 0
    cursor_file = None
    if args.snapshot_dir and multi:
        cursor_file = os.path.join(args.snapshot_dir,
                                   f"cursor_p{args.process_index}.json")
        if os.path.exists(cursor_file):
            with open(cursor_file) as f:
                cur = json.load(f)
            start = int(cur.get("consumed", 0))
            status["resumed_from"] = os.path.basename(cursor_file)
            _logger.info("resumed shard %d/%d from %s at local step %d",
                         args.process_index, args.process_count,
                         cursor_file, start)
    elif args.snapshot_dir:
        found = _snapshot.latest_snapshot(args.snapshot_dir)
        if found is not None:
            snap, _ = found
            status["model_manager_status"] = "Loading"
            manifest = _snapshot.restore_job(snap, worker)
            cur = manifest.get("cursor") or {}
            start = int(cur.get("consumed", 0))
            status["resumed_from"] = os.path.basename(snap)
            _logger.info("resumed from %s at step %d", snap, start)

    # --- the workload: one global stream of --steps batches, shared out
    # round-robin by ResumableDataset
    if args.workload == "counting":
        def factory(seed):
            for k in range(args.steps):
                draws = batch_draws(pool, seed, k, args.batch_size,
                                    args.n_feats)
                yield [IDTypeFeature(f"slot_{i}", [d])
                       for i, d in enumerate(draws)]

        def feats_of(item):
            return item
    else:
        from persia_tpu_torch.workloads.registry import get_scenario

        scenario = get_scenario(args.workload, smoke=True, seed=args.seed)

        def factory(seed):
            return scenario.batches(args.steps * args.batch_size,
                                    args.batch_size, seed=seed)

        def feats_of(item):
            return item.id_type_features

    ds = ResumableDataset(factory, seed=args.seed, start=start,
                          process_index=args.process_index,
                          process_count=args.process_count)

    dense_sync = None
    dense_syncs, dense_loss, dense_losses, dense_digests = 0, None, [], []
    if args.dense_sync_every:
        dense_sync = _dense_rider(mesh, args.process_count, args.seed)

    status["model_manager_status"] = "Training"
    device_step = args.device_step_ms / 1000.0
    ships = 0
    step = start  # this shard's local step
    t_first_step = None
    t_loop = time.monotonic()
    for item in ds:
        feats = feats_of(item)
        if die_at == "between_snapshots" and step == die_step:
            arm_kill()
            _die_now()
        # nested spans: a postmortem's trace needs a parent -> child
        # chain, and the RPC client records none of its own
        with tracing.span("trainer/step", root=True):
            with tracing.span("trainer/lookup"):
                ref, out = worker.lookup_direct_training(feats)
            if die_at == "mid_step" and step == die_step:
                arm_kill()
                _die_now()
            if device_step:
                time.sleep(device_step)
            with tracing.span("trainer/update"):
                worker.update_gradients(ref, {
                    k: np.ones_like(v.embeddings) for k, v in out.items()})
        ships += 1
        step += 1
        if t_first_step is None:
            t_first_step = time.monotonic()
        status["step"] = step
        status["ships"] = ships
        g_step.set(step)
        g_ships.set(ships)
        if (dense_sync is not None
                and (step - start) % args.dense_sync_every == 0):
            with tracing.span("trainer/dense_sync"):
                dense_loss = dense_sync(dense_syncs, args.process_index)
            dense_losses.append(dense_loss)
            dense_digests.append(_param_digest(dense_sync.model))
            dense_syncs += 1
            status["dense_loss"] = dense_loss
        if args.snapshot_dir and step % args.snapshot_interval == 0:
            if multi:
                PersiaPath(cursor_file).write_bytes_atomic(
                    json.dumps(ds.cursor(trained=step - start)).encode())
            else:
                pre = None
                if die_at == "mid_snapshot" and step >= max(die_step, 1):
                    def pre(_snap):  # noqa: E306
                        arm_kill()
                        _die_now()
                status["model_manager_status"] = "Dumping"
                _snapshot.snapshot_job(
                    args.snapshot_dir, worker,
                    cursor=ds.cursor(trained=step - start), step=step,
                    pre_manifest=pre)
                status["model_manager_status"] = "Training"
        if args.step_delay:
            time.sleep(args.step_delay)
    elapsed = time.monotonic() - t_loop

    # the last snapshot or cursor makes the whole run durable
    if args.snapshot_dir:
        if multi:
            PersiaPath(cursor_file).write_bytes_atomic(
                json.dumps(ds.cursor(trained=step - start)).encode())
        else:
            _snapshot.snapshot_job(args.snapshot_dir, worker,
                                   cursor=ds.cursor(trained=step - start),
                                   step=step)

    group_ships = None
    if mesh is not None and multi:
        import torch

        from persia_tpu_torch.parallel import collectives as coll
        from persia_tpu_torch.parallel.mesh import DATA_AXIS, axis_group

        # every shard's shipments, gathered over the group
        mine = torch.tensor([float(ships)], device=device)
        group_ships = int(coll.all_gather(
            mine, axis_group(mesh, DATA_AXIS), 0).sum().item())

    status["model_manager_status"] = "Done"
    if args.result_file:
        # a group shares its argv, so each process writes its own
        # suffixed file; one process writes the bare path
        result_file = (f"{args.result_file}.p{args.process_index}"
                       if multi else args.result_file)
        PersiaPath(result_file).write_bytes_atomic(json.dumps({
            "steps": step, "seed": args.seed, "pool_size": args.pool_size,
            "batch_size": args.batch_size, "n_feats": args.n_feats,
            "resumed_from": status["resumed_from"],
            "process_index": args.process_index,
            "process_count": args.process_count,
            "workload": args.workload,
            "elapsed_sec": elapsed,
            "samples": (step - start) * args.batch_size,
            "ships": ships,
            "group_ships": group_ships,
            "device_step_ms": args.device_step_ms,
            "mesh_shape": status["mesh_shape"],
            "dense_syncs": dense_syncs,
            "dense_loss": dense_loss,
            "dense_losses": dense_losses,
            "dense_digests": dense_digests,
            "device": str(device),
            "backend": status.get("backend"),
            # time.monotonic() stamps (one clock for every process of the
            # host): this incarnation's main(), its device up, its first
            # step
            "t_main": t_main,
            "t_device": t_device,
            "t_first_step": t_first_step,
        }).encode())
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
