"""Cluster in a box: the service tier as local processes
(``persia_tpu/service/helper.py``).

:class:`ServiceCtx` starts a coordinator, then the PS and worker
processes (``python -m persia_tpu_torch.service.<role>``, each binding
port 0 and registering with the coordinator, or with ``native_ps`` /
``native_worker`` the C++ binaries ``persia-embedding-ps`` /
``persia-embedding-worker``, which the port builds from ``native/src/``
at first use: :mod:`persia_tpu_torch.service.native_bin`), waits for
their registration, and watches them: when one dies, the group goes down
and ``crashed`` names it, unless its role is supervised, in which case it
is started again (``supervise_ps``, ``supervise_workers``,
``supervise_trainer`` with a group of ``n_trainers`` trainer drivers).
``postmortem_dir`` arms the flight recorder: the supervised processes'
``/flight`` snapshots are polled, and a dead one leaves a postmortem
bundle. :meth:`ServiceCtx.fleet_monitor` builds a
:class:`~persia_tpu_torch.fleet.FleetMonitor` over the cluster's
coordinator. Leaving the context stops every process.
"""

import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

from persia_tpu_torch.config import EmbeddingSchema
from persia_tpu_torch.service.coordinator import (
    ROLE_PS,
    ROLE_WORKER,
    CoordinatorClient,
)
from persia_tpu_torch.utils import dump_yaml, wait_addr_file

_logger = logging.getLogger(__name__)

# the checkout's root, which the children import the package from
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _schema_to_yaml_dict(schema: EmbeddingSchema) -> dict:
    """A schema as its YAML document; prefixes are assigned again, in
    the same order, by the reader."""
    return {
        "feature_index_prefix_bit": schema.feature_index_prefix_bit,
        "feature_groups": {g: list(slots)
                           for g, slots in schema.feature_groups.items()},
        "slots_config": {
            name: {
                "dim": s.dim,
                "sample_fixed_size": s.sample_fixed_size,
                "embedding_summation": s.embedding_summation,
                "sqrt_scaling": s.sqrt_scaling,
                "pooling": s.pooling,
                "hash_stack_config": {
                    "hash_stack_rounds": s.hash_stack_config.hash_stack_rounds,
                    "embedding_size": s.hash_stack_config.embedding_size,
                },
            }
            for name, s in schema.slots_config.items()
        },
    }


class ServiceCtx:
    """Run a coordinator, ``n_ps`` PS and ``n_workers`` worker processes;
    join as a client::

        with ServiceCtx(schema, n_workers=1, n_ps=2) as svc:
            worker = svc.remote_worker()  # RemoteEmbeddingWorker

    ``global_config_path`` is passed to every PS and worker; ``env``
    overlays their environment. Each runs the observability sidecar that
    ``PERSIA_HTTP_PORT`` says (0, the default: an ephemeral port; -1:
    none), published with its registration; ``http_all`` starts it
    whatever the knob says.

    Supervision. By default a child that exits with an error takes the
    group down. With ``supervise_ps`` the monitor restarts a PS replica
    that exits, or whose sidecar misses ``ps_probe_failures`` probes in a
    row while its process lives (wedged), under the same replica index,
    restoring its shard from ``ps_restore_dir`` (``replica_<i>.psd`` of
    the last ``dump_sharded``) and replaying its incremental-update packets
    from ``ps_inc_dir`` over it (``--replay-inc-dir``; the training PS
    dump them there under ``enable_incremental_update``) before it
    registers; the workers re-resolve it through the coordinator. With
    ``supervise_workers`` a dead worker replica is started again under
    its index and recovers once the coordinator shows a new address
    there. With ``supervise_trainer``,
    ``trainer_args`` start ``n_trainers`` copies of
    ``persia_tpu_torch.service.trainer_service`` (``--coordinator`` and
    ``--snapshot-dir snapshot_dir`` appended; ``--process-index`` /
    ``--process-count`` for a group; ``trainer_env`` overlays their
    environment); one that dies is started again and resumes from the
    newest complete snapshot or its shard cursor, and exit 0 is done.
    Each recovery is recorded (``ps_recoveries``, ``worker_recoveries``,
    ``trainer_recoveries``) with its ``time.monotonic()`` stamps. A role
    past its ``*_max_restarts`` tears the group down at its next death.
    ``postmortem_dir`` arms the flight recorder over the supervised
    processes (polled every ``flight_interval`` seconds).

    Native binaries. ``native_ps`` runs each PS replica as
    ``persia-embedding-ps --capacity ps_capacity --num-shards
    ps_num_shards`` (the global config's PS section is not read there);
    ``native_worker`` each worker as ``persia-embedding-worker``, with the
    global config's ``forward_buffer_size`` and
    ``buffered_data_expired_sec`` as flags. Neither has a sidecar, and
    neither can be supervised (``supervise_ps`` / ``supervise_workers``
    raise with them). The C++ worker sums every summed slot, so a schema
    with mean or last-k pooling is refused with ``native_worker``."""

    def __init__(self, schema: EmbeddingSchema, n_workers: int = 1,
                 n_ps: int = 1, global_config_path: Optional[str] = None,
                 env: Optional[dict] = None, startup_timeout: float = 120.0,
                 native_ps: bool = False, native_worker: bool = False,
                 ps_capacity: int = 1_000_000_000, ps_num_shards: int = 16,
                 supervise_ps: bool = False,
                 ps_restore_dir: Optional[str] = None,
                 ps_inc_dir: Optional[str] = None,
                 ps_probe_interval: float = 0.5,
                 ps_probe_failures: int = 4, ps_max_restarts: int = 5,
                 postmortem_dir: Optional[str] = None,
                 flight_interval: float = 1.0, http_all: bool = False,
                 supervise_workers: bool = False,
                 worker_max_restarts: int = 5,
                 supervise_trainer: bool = False,
                 trainer_args: Optional[List[str]] = None,
                 trainer_max_restarts: int = 5,
                 snapshot_dir: Optional[str] = None, n_trainers: int = 1,
                 trainer_env: Optional[dict] = None):
        if supervise_ps and native_ps:
            raise ValueError("supervise_ps drives the Python PS binary "
                             "(--replay-inc-dir); native_ps has its own "
                             "k8s-level restart story")
        if supervise_workers and native_worker:
            raise ValueError("supervise_workers drives the Python worker "
                             "binary; native workers restart at the k8s "
                             "level")
        if n_trainers < 1:
            raise ValueError(f"n_trainers must be >= 1, got {n_trainers}")
        pooled = sorted(name for name, s in schema.slots_config.items()
                        if s.pooling != "sum")
        if native_worker and pooled:
            # the C++ worker sums every summed slot (worker_core.h); it
            # would serve these slots' rows summed, not as configured
            raise ValueError(
                f"native_worker has no mean or last-k pooling, and slots "
                f"{pooled} ask for it; run the Python worker tier")
        self.schema = schema
        self.n_workers = n_workers
        self.n_ps = n_ps
        self.native_ps = native_ps
        self.native_worker = native_worker
        self.ps_capacity = ps_capacity
        self.ps_num_shards = ps_num_shards
        self._binaries: dict = {}  # name -> path, built at start
        self.global_config_path = global_config_path
        self.extra_env = env or {}
        self.startup_timeout = startup_timeout
        self.http_all = http_all
        self.procs: List[subprocess.Popen] = []
        self.coordinator_addr: Optional[str] = None
        self.worker_addrs: List[str] = []
        self.ps_addrs: List[str] = []
        self.crashed: List[str] = []
        self._tmpdir: Optional[tempfile.TemporaryDirectory] = None
        self._monitor: Optional[threading.Thread] = None
        self._closing = False
        # the PS supervisor: incarnations, sidecars, probe misses, restarts
        self.supervise_ps = supervise_ps
        self.ps_restore_dir = ps_restore_dir
        self.ps_inc_dir = ps_inc_dir
        self.ps_probe_interval = ps_probe_interval
        self.ps_probe_failures = ps_probe_failures
        self.ps_max_restarts = ps_max_restarts
        self.ps_recoveries: List[dict] = []
        self._ps_incarnation: dict = {}
        self._ps_http_addr: dict = {}
        self._ps_http_file: dict = {}
        self._ps_probe_fails: dict = {}
        self._ps_restarts: dict = {}
        self._last_probe = 0.0
        # the flight recorder: the last /flight snapshots of each
        # supervised process, so that a SIGKILLed one leaves a bundle
        self.flight_recorder = None
        if postmortem_dir is not None:
            from persia_tpu_torch.fleet import FlightRecorder

            self.flight_recorder = FlightRecorder(postmortem_dir)
        self.flight_interval = flight_interval
        self._ps_last_flight: dict = {}
        # workers and trainers
        self.supervise_workers = supervise_workers
        self.worker_max_restarts = worker_max_restarts
        self.supervise_trainer = supervise_trainer
        self.trainer_args = list(trainer_args or [])
        self.trainer_max_restarts = trainer_max_restarts
        self.snapshot_dir = snapshot_dir
        self.n_trainers = n_trainers
        self.trainer_env = dict(trainer_env or {})
        self.worker_recoveries: List[dict] = []
        self.trainer_recoveries: List[dict] = []
        self.trainer_done = False
        self.trainer_rc: Optional[int] = None
        self._worker_restarts: dict = {}
        self._worker_incarnation: dict = {}
        self._worker_args: dict = {}
        self._trainer_restarts: dict = {}  # process index -> restarts
        self._trainer_incarnation: dict = {}
        self._trainer_exit: dict = {}  # process index -> 0 once done
        # flight polling of the non-PS supervised processes: name -> addr
        # file, the addresses read from them, the last poll's time
        self._flight_files: dict = {}
        self._flight_addr: dict = {}
        self._flight_last: dict = {}

    def _spawn(self, args: List[str], name: str, replica_index: int,
               replica_size: int,
               env_extra: Optional[dict] = None) -> subprocess.Popen:
        return self._spawn_raw([sys.executable, *args], name, replica_index,
                               replica_size, env_extra=env_extra)

    def _spawn_raw(self, cmd: List[str], name: str, replica_index: int,
                   replica_size: int,
                   env_extra: Optional[dict] = None) -> subprocess.Popen:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH",
                                                              "")
        env["REPLICA_INDEX"] = str(replica_index)
        env["REPLICA_SIZE"] = str(replica_size)
        if self.coordinator_addr:
            env["PERSIA_COORDINATOR_ADDR"] = self.coordinator_addr
        env.update({k: str(v) for k, v in self.extra_env.items()})
        if env_extra:
            env.update({k: str(v) for k, v in env_extra.items()})
        proc = subprocess.Popen(cmd, env=env)
        proc._persia_name = name  # type: ignore[attr-defined]
        self.procs.append(proc)
        return proc

    def _role_args(self, role: str, i: int, size: int) -> List[str]:
        args = ["-m", f"persia_tpu_torch.service.{role}",
                "--replica-index", str(i), "--replica-size", str(size),
                "--coordinator", self.coordinator_addr]
        if self.global_config_path:
            args += ["--global-config", self.global_config_path]
        return args

    def __enter__(self) -> "ServiceCtx":
        self._tmpdir = tempfile.TemporaryDirectory(prefix="persia_svc_")
        try:
            self._start()
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def _start(self):
        wanted = [name for on, name in (
            (self.native_ps, "persia-embedding-ps"),
            (self.native_worker, "persia-embedding-worker")) if on]
        if wanted:
            from persia_tpu_torch.service.native_bin import ensure_binaries

            self._binaries = ensure_binaries(wanted)
        schema_path = os.path.join(self._tmpdir.name, "embedding_config.yml")
        dump_yaml(_schema_to_yaml_dict(self.schema), schema_path)
        # the coordinator binds port 0 and publishes the address it got
        addr_file = os.path.join(self._tmpdir.name, "coordinator.addr")
        coord_proc = self._spawn(
            ["-m", "persia_tpu_torch.service.coordinator", "--port", "0",
             "--addr-file", addr_file], "coordinator", 0, 1)
        self.coordinator_addr = wait_addr_file(addr_file,
                                               self.startup_timeout,
                                               coord_proc)
        coord = CoordinatorClient(self.coordinator_addr)
        for i in range(self.n_ps):
            if self.native_ps:
                self._spawn_native_ps(i)
            else:
                self._spawn_ps(i)
        for i in range(self.n_workers):
            if self.native_worker:
                self._spawn_native_worker(i, schema_path)
            else:
                self._spawn_worker(i, schema_path)
        self.ps_addrs = self._wait_members(coord, ROLE_PS, self.n_ps)
        self.worker_addrs = self._wait_members(coord, ROLE_WORKER,
                                               self.n_workers)
        if self.supervise_trainer:
            for i in range(self.n_trainers):
                self._spawn_trainer(i)
        self._monitor = threading.Thread(target=self._watch, daemon=True,
                                         name="service-ctx-monitor")
        self._monitor.start()
        _logger.info("cluster up: coordinator=%s ps=%s workers=%s",
                     self.coordinator_addr, self.ps_addrs,
                     self.worker_addrs)

    def _wait_members(self, coord: CoordinatorClient, role: str,
                      count: int) -> List[str]:
        """The addresses once ``count`` replicas of ``role`` registered;
        raises as soon as a child has exited."""
        deadline = time.monotonic() + self.startup_timeout
        while True:
            addrs = coord.list(role)
            if len(addrs) >= count:
                return addrs
            dead = [f"{p._persia_name} rc={p.returncode}" for p in self.procs
                    if p.poll() is not None]
            if dead:
                raise RuntimeError(f"service processes exited during "
                                   f"start-up: {dead}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"waited {self.startup_timeout}s for "
                                   f"{count} x {role}, have {addrs}")
            time.sleep(0.05)

    # --- spawning ---------------------------------------------------------

    def _spawn_native_ps(self, i: int) -> subprocess.Popen:
        return self._spawn_raw(
            [self._binaries["persia-embedding-ps"], "--replica-index",
             str(i), "--capacity", str(self.ps_capacity), "--num-shards",
             str(self.ps_num_shards), "--coordinator",
             self.coordinator_addr], f"ps-{i}", i, self.n_ps)

    def _spawn_native_worker(self, i: int,
                             schema_path: str) -> subprocess.Popen:
        """The C++ worker takes the worker section of the global config as
        flags, so both tiers honour the same config."""
        cmd = [self._binaries["persia-embedding-worker"], "--replica-index",
               str(i), "--embedding-config", schema_path, "--coordinator",
               self.coordinator_addr, "--num-ps", str(self.n_ps)]
        if self.global_config_path:
            from persia_tpu_torch.config import GlobalConfig

            gc = GlobalConfig.load(self.global_config_path).embedding_worker
            cmd += ["--forward-buffer-size", str(gc.forward_buffer_size),
                    "--buffered-data-expired-sec",
                    str(gc.buffered_data_expired_sec)]
        return self._spawn_raw(cmd, f"worker-{i}", i, self.n_workers)

    def _spawn_worker(self, i: int, schema_path: str) -> subprocess.Popen:
        """Start worker replica ``i``; its arguments are kept for a
        respawn."""
        args = self._role_args("worker_service", i, self.n_workers) + [
            "--embedding-config", schema_path, "--num-ps", str(self.n_ps)]
        self._worker_args[i] = list(args)
        return self._spawn_worker_from_args(i, args)

    def _spawn_worker_from_args(self, i: int, base_args: List[str]
                                ) -> subprocess.Popen:
        """(Re)start worker replica ``i``; a supervised one publishes its
        sidecar through an addr file the flight poll reads."""
        args = list(base_args)
        if self.supervise_workers:
            inc = self._worker_incarnation[i] = (
                self._worker_incarnation.get(i, 0) + 1)
            http_file = os.path.join(self._tmpdir.name,
                                     f"worker_{i}_{inc}.http")
            self._arm_flight(f"worker{i}", http_file)
            args += ["--http-port", "0", "--http-addr-file", http_file]
        elif self.http_all:
            args += ["--http-port", "0"]
        proc = self._spawn(args, f"worker-{i}", i, self.n_workers)
        proc._persia_worker = i  # type: ignore[attr-defined]
        return proc

    def _spawn_trainer(self, i: int = 0) -> subprocess.Popen:
        """(Re)start trainer driver ``i`` of the group. The driver owns
        its resume: the newest complete snapshot under --snapshot-dir, or
        in a group its own shard cursor. Each has its flight channel
        (``trainer``, or ``trainer<i>`` in a group)."""
        inc = self._trainer_incarnation[i] = (
            self._trainer_incarnation.get(i, 0) + 1)
        args = ["-m", "persia_tpu_torch.service.trainer_service",
                "--coordinator", self.coordinator_addr, *self.trainer_args]
        if self.n_trainers > 1:
            args += ["--process-index", str(i),
                     "--process-count", str(self.n_trainers)]
        if self.snapshot_dir:
            args += ["--snapshot-dir", self.snapshot_dir]
        flight = "trainer" if self.n_trainers == 1 else f"trainer{i}"
        stem = (f"trainer_{inc}" if self.n_trainers == 1
                else f"trainer_{i}_{inc}")
        http_file = os.path.join(self._tmpdir.name, f"{stem}.http")
        self._arm_flight(flight, http_file)
        args += ["--http-port", "0", "--http-addr-file", http_file]
        proc = self._spawn(args, flight, i, self.n_trainers,
                           env_extra=self.trainer_env or None)
        proc._persia_trainer = True  # type: ignore[attr-defined]
        proc._persia_trainer_idx = i  # type: ignore[attr-defined]
        return proc

    def _arm_flight(self, name: str, http_file: str):
        self._flight_files[name] = http_file
        self._flight_addr.pop(name, None)

    def _spawn_ps(self, i: int, restore: bool = False) -> subprocess.Popen:
        """(Re)start PS replica ``i``. A supervised one always runs its
        sidecar (the supervisor's probe); a ``restore`` start loads the
        replica's shard of ``ps_restore_dir`` and replays its packets of
        ``ps_inc_dir`` before it registers."""
        args = self._role_args("ps_service", i, self.n_ps)
        if self.supervise_ps:
            inc = self._ps_incarnation[i] = self._ps_incarnation.get(i, 0) + 1
            http_file = os.path.join(self._tmpdir.name, f"ps_{i}_{inc}.http")
            self._ps_http_file[i] = http_file
            self._ps_http_addr.pop(i, None)
            self._ps_probe_fails[i] = 0
            args += ["--http-port", "0", "--http-addr-file", http_file]
        elif self.http_all:
            args += ["--http-port", "0"]
        if restore:
            if self.ps_restore_dir:
                ckpt = os.path.join(self.ps_restore_dir,
                                    f"replica_{i}.psd")
                if os.path.exists(ckpt):
                    args += ["--initial-checkpoint", ckpt]
            if self.ps_inc_dir:
                args += ["--replay-inc-dir", self.ps_inc_dir]
        proc = self._spawn(args, f"ps-{i}", i, self.n_ps)
        proc._persia_replica = i  # type: ignore[attr-defined]
        proc._persia_supervised = self.supervise_ps  # type: ignore
        return proc

    # --- the monitor ------------------------------------------------------

    def _watch(self):
        """The crash monitor: a child that exits with an error takes the
        group down, unless its role is supervised and has restarts left;
        then it is recovered. Also probes the supervised PS sidecars and
        polls the flight snapshots."""
        while not self._closing:
            for p in list(self.procs):
                if getattr(p, "_persia_handled", False):
                    continue
                rc = p.poll()
                if rc is None or self._closing:
                    continue
                name = getattr(p, "_persia_name", "?")
                if getattr(p, "_persia_trainer", False):
                    ti = getattr(p, "_persia_trainer_idx", 0)
                    if rc == 0:
                        # this driver finished its run; the job is done
                        # when the whole group is
                        p._persia_handled = True  # type: ignore
                        self._trainer_exit[ti] = 0
                        if len(self._trainer_exit) == self.n_trainers:
                            self.trainer_done = True
                            self.trainer_rc = 0
                        continue
                    if (self._trainer_restarts.get(ti, 0)
                            < self.trainer_max_restarts):
                        self._recover_trainer(p, rc)
                        continue
                    self.trainer_rc = rc
                elif rc == 0:
                    continue
                elif (getattr(p, "_persia_supervised", False)
                        and self._restarts_left(p._persia_replica)):
                    self._recover_ps(p, f"exited rc={rc}")
                    continue
                elif (self.supervise_workers
                        and getattr(p, "_persia_worker", None) is not None
                        and self._worker_restarts.get(
                            p._persia_worker, 0) < self.worker_max_restarts):
                    self._recover_worker(p, rc)
                    continue
                self.crashed.append(f"{name} rc={rc}")
                _logger.error("service %s exited (rc=%d); tearing down",
                              name, rc)
                self._terminate_all()
                return
            if self.supervise_ps and not self._closing:
                self._probe_ps_sidecars()
            if self._flight_files and not self._closing:
                self._poll_flights()
            time.sleep(0.2)

    def _restarts_left(self, i: int) -> bool:
        return self._ps_restarts.get(i, 0) < self.ps_max_restarts

    def _ps_sidecar_addr(self, i: int) -> Optional[str]:
        addr = self._ps_http_addr.get(i)
        if addr is None:
            path = self._ps_http_file.get(i)
            if path and os.path.exists(path):
                with open(path) as f:
                    addr = f.read().strip()
                if addr:
                    self._ps_http_addr[i] = addr
        return addr

    def _probe_ps_sidecars(self):
        """Liveness through the sidecar: a PS whose process lives but
        whose sidecar misses ``ps_probe_failures`` probes in a row is
        wedged, and is killed and recovered like a crash. A restoring
        replica answers ``/healthz`` (not ready), so a restore is never
        taken for a wedge."""
        from persia_tpu_torch.fleet import _http_get

        now = time.monotonic()
        if now - self._last_probe < self.ps_probe_interval:
            return
        self._last_probe = now
        for p in list(self.procs):
            if (not getattr(p, "_persia_supervised", False)
                    or getattr(p, "_persia_handled", False)
                    or p.poll() is not None):
                continue
            i = p._persia_replica
            addr = self._ps_sidecar_addr(i)
            if addr is None:
                continue  # still starting; startup_timeout governs
            try:
                _http_get(f"http://{addr}/healthz", 1.0)
                self._ps_probe_fails[i] = 0
                self._maybe_fetch_flight(i, addr)
            except Exception:  # noqa: BLE001 — any miss counts
                self._ps_probe_fails[i] = self._ps_probe_fails.get(i, 0) + 1
                if self._ps_probe_fails[i] >= self.ps_probe_failures:
                    if not self._restarts_left(i):
                        continue  # its next death tears the group down
                    _logger.error(
                        "PS %d sidecar unresponsive (%d probes in a row); "
                        "killing the wedged replica", i,
                        self._ps_probe_fails[i])
                    p.kill()
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        continue  # not dead yet; the next sweep retries
                    self._recover_ps(p, "sidecar unresponsive")

    def _maybe_fetch_flight(self, i: int, addr: str):
        """Poll replica ``i``'s ``/flight`` into the recorder when due; a
        failed fetch is not a liveness miss (``/healthz`` answered)."""
        if self.flight_recorder is None:
            return
        now = time.monotonic()
        last = self._ps_last_flight.get(i)
        if last is not None and now - last < self.flight_interval:
            return
        from persia_tpu_torch.fleet import _http_get

        try:
            doc = json.loads(_http_get(f"http://{addr}/flight", 2.0))
            self._ps_last_flight[i] = now
            self.flight_recorder.observe(f"ps{i}", doc)
        except Exception as e:  # noqa: BLE001
            _logger.debug("flight fetch for ps%d failed: %s", i, e)

    def _poll_flights(self):
        """Flight polling of the supervised trainers and workers: each
        sidecar's last ``/flight`` snapshot is kept, so that a SIGKILLed
        process leaves its last observable state to the bundle."""
        if self.flight_recorder is None:
            return
        from persia_tpu_torch.fleet import _http_get

        now = time.monotonic()
        for name, path in list(self._flight_files.items()):
            last = self._flight_last.get(name)
            if last is not None and now - last < self.flight_interval:
                continue
            addr = self._flight_addr.get(name)
            if addr is None:
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    addr = f.read().strip()
                if not addr:
                    continue
                self._flight_addr[name] = addr
            try:
                doc = json.loads(_http_get(f"http://{addr}/flight", 2.0))
                self._flight_last[name] = now
                self.flight_recorder.observe(name, doc)
            except Exception as e:  # noqa: BLE001
                _logger.debug("flight fetch for %s failed: %s", name, e)

    def _capture_postmortem(self, name: str, reason: str,
                            extra: Optional[dict] = None) -> Optional[str]:
        if self.flight_recorder is None:
            return None
        try:
            return self.flight_recorder.capture(name, reason,
                                                extra=extra or {})
        except Exception:  # noqa: BLE001 — a bundle never blocks recovery
            _logger.exception("postmortem capture for %s failed", name)
            return None

    # --- recovery ---------------------------------------------------------

    def _recover_trainer(self, proc: subprocess.Popen, rc: int):
        """Start dead trainer driver ``i`` again; the replacement resumes
        on its own. Records the event with the bundle of its last flight
        snapshot."""
        i = getattr(proc, "_persia_trainer_idx", 0)
        proc._persia_handled = True  # type: ignore[attr-defined]
        self._trainer_restarts[i] = self._trainer_restarts.get(i, 0) + 1
        flight = "trainer" if self.n_trainers == 1 else f"trainer{i}"
        event = {"reason": f"exited rc={rc}", "process": i,
                 "t_detected": time.monotonic(),
                 "restart_no": self._trainer_restarts[i]}
        _logger.error("supervised trainer %d died (rc=%s); restarting "
                      "(%d/%d)", i, rc, self._trainer_restarts[i],
                      self.trainer_max_restarts)
        bundle = self._capture_postmortem(
            flight, f"crash:rc={rc}",
            extra={"restart_no": self._trainer_restarts[i]})
        if bundle:
            event["postmortem"] = bundle
        self._spawn_trainer(i)
        event["t_respawned"] = time.monotonic()
        self.trainer_recoveries.append(event)

    def _recover_worker(self, proc: subprocess.Popen, rc: int):
        """Start dead worker replica ``i`` again under its index. Workers
        hold nothing past their forward buffer (in-flight batches are the
        declared ambiguity); the replacement registers under the same
        index, replacing the dead address, and clients re-resolve through
        the coordinator. Recovered: the coordinator shows a NEW address at
        the index."""
        i = proc._persia_worker
        proc._persia_handled = True  # type: ignore[attr-defined]
        self._worker_restarts[i] = self._worker_restarts.get(i, 0) + 1
        old_addr = (self.worker_addrs[i]
                    if i < len(self.worker_addrs) else None)
        event = {"replica": i, "reason": f"exited rc={rc}",
                 "t_detected": time.monotonic(),
                 "restart_no": self._worker_restarts[i]}
        _logger.error("supervised worker %d died (rc=%s); restarting "
                      "(%d/%d)", i, rc, self._worker_restarts[i],
                      self.worker_max_restarts)
        bundle = self._capture_postmortem(
            f"worker{i}", f"crash:rc={rc}",
            extra={"restart_no": self._worker_restarts[i]})
        if bundle:
            event["postmortem"] = bundle
        proc2 = self._spawn_worker_from_args(i, self._worker_args[i])
        event["t_respawned"] = time.monotonic()
        coord = CoordinatorClient(self.coordinator_addr)
        deadline = time.monotonic() + self.startup_timeout
        new_addr = None
        while time.monotonic() < deadline and not self._closing:
            if proc2.poll() is not None:
                event["failed"] = f"respawn exited rc={proc2.poll()}"
                self.worker_recoveries.append(event)
                return
            try:
                addrs = coord.list(ROLE_WORKER)
            except (ConnectionError, OSError):
                addrs = []
            if i < len(addrs) and addrs[i] != old_addr:
                new_addr = addrs[i]
                break
            time.sleep(0.05)
        if new_addr is None:
            event["failed"] = "replacement never re-registered"
            self.worker_recoveries.append(event)
            _logger.error("worker %d recovery FAILED: the replacement never "
                          "registered within %.0fs", i, self.startup_timeout)
            return
        if i < len(self.worker_addrs):
            self.worker_addrs[i] = new_addr
        event["addr"] = new_addr
        event["t_recovered"] = time.monotonic()
        event["recovery_sec"] = round(
            event["t_recovered"] - event["t_detected"], 3)
        self.worker_recoveries.append(event)
        _logger.warning("worker %d recovered in %.2fs at %s", i,
                        event["recovery_sec"], new_addr)

    def _recover_ps(self, proc: subprocess.Popen, reason: str):
        """Start dead PS replica ``i`` again from its checkpoint shard and
        record the event. Recovered: the replacement wrote its sidecar
        addr file (after the restore) and reports ``Idle``. Re-arming the
        optimizer stays with the workers, on their next call."""
        from persia_tpu_torch.fleet import _http_get

        i = proc._persia_replica
        t_detected = time.monotonic()
        proc._persia_handled = True  # type: ignore[attr-defined]
        self._ps_restarts[i] = self._ps_restarts.get(i, 0) + 1
        event = {"replica": i, "reason": reason, "t_detected": t_detected,
                 "restart_no": self._ps_restarts[i]}
        _logger.error("supervised PS %d down (%s); restarting (%d/%d)", i,
                      reason, self._ps_restarts[i], self.ps_max_restarts)
        bundle = self._capture_postmortem(
            f"ps{i}", f"crash:{reason}",
            extra={"restart_no": self._ps_restarts[i]})
        if bundle:
            event["postmortem"] = bundle
        new_proc = self._spawn_ps(i, restore=True)
        event["t_respawned"] = time.monotonic()
        deadline = time.monotonic() + self.startup_timeout
        addr = None
        while time.monotonic() < deadline and not self._closing:
            if new_proc.poll() is not None:
                # the restore died: counted; the next sweep restarts it
                # again or tears the group down
                event["failed"] = f"respawn exited rc={new_proc.poll()}"
                self.ps_recoveries.append(event)
                return
            sidecar = self._ps_sidecar_addr(i)
            if sidecar is not None:
                try:
                    doc = json.loads(_http_get(f"http://{sidecar}/healthz",
                                               1.0))
                    if doc.get("model_manager_status") == "Idle":
                        addr = doc.get("rpc_addr")
                        break
                except Exception:  # noqa: BLE001 — still coming up
                    pass
            time.sleep(0.05)
        event["addr"] = addr
        if addr is None:
            # never Idle within the deadline: a failed recovery, not a
            # slow one (ps_addrs must not point at it)
            event["failed"] = "replacement never reached Idle"
            self.ps_recoveries.append(event)
            _logger.error("PS %d recovery FAILED: the replacement never "
                          "reached Idle within %.0fs", i,
                          self.startup_timeout)
            return
        event["t_recovered"] = time.monotonic()
        event["recovery_sec"] = round(event["t_recovered"] - t_detected, 3)
        if i < len(self.ps_addrs):
            self.ps_addrs[i] = addr
        self.ps_recoveries.append(event)
        _logger.warning("PS %d recovered in %.2fs at %s", i,
                        event["recovery_sec"], addr)

    # --- the live processes and waits -------------------------------------

    def _live(self, attr: str, value) -> Optional[subprocess.Popen]:
        for p in reversed(self.procs):
            if (getattr(p, attr, None) == value
                    and not getattr(p, "_persia_handled", False)
                    and p.poll() is None):
                return p
        return None

    def trainer_proc(self, i: int = 0) -> Optional[subprocess.Popen]:
        """The live process of trainer driver ``i`` (after a recovery, the
        replacement)."""
        return self._live("_persia_trainer_idx", i)

    def worker_proc(self, i: int) -> Optional[subprocess.Popen]:
        """The live process serving worker replica ``i``."""
        return self._live("_persia_worker", i)

    def ps_proc(self, i: int) -> Optional[subprocess.Popen]:
        """The live process serving PS replica ``i``."""
        return self._live("_persia_replica", i)

    def wait_trainer_done(self, timeout: float = 300.0) -> int:
        """Block until the trainer group finished its run (exit 0),
        through any number of recoveries, or supervision gave up; returns
        the final exit code."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.trainer_done:
                return 0
            if self.trainer_rc not in (None, 0):
                return self.trainer_rc
            if self.crashed:
                raise RuntimeError(f"cluster crashed: {self.crashed}")
            time.sleep(0.05)
        raise TimeoutError(
            f"trainer group not done after {timeout}s (done="
            f"{sorted(self._trainer_exit)}/{self.n_trainers}, "
            f"restarts={dict(self._trainer_restarts)})")

    @staticmethod
    def _wait_recoveries(events: List[dict], n: int, timeout: float,
                         what: str) -> List[dict]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            done = [e for e in events
                    if "t_recovered" in e or "failed" in e]
            if len(done) >= n:
                return done
            time.sleep(0.05)
        raise TimeoutError(f"waited {timeout}s for {n} {what} recoveries, "
                           f"have {events}")

    def wait_worker_recoveries(self, n: int, timeout: float = 60.0
                               ) -> List[dict]:
        return self._wait_recoveries(self.worker_recoveries, n, timeout,
                                     "worker")

    def wait_ps_recoveries(self, n: int, timeout: float = 60.0) -> List[dict]:
        """Block until ``n`` PS recoveries completed (or failed)."""
        return self._wait_recoveries(self.ps_recoveries, n, timeout, "PS")

    def remote_worker(self):
        from persia_tpu_torch.service.worker_service import (
            RemoteEmbeddingWorker,
        )

        w = RemoteEmbeddingWorker(self.worker_addrs)
        w.schema = self.schema
        return w

    def fleet_targets(self) -> List[dict]:
        """Every observability sidecar of the cluster (the services
        publish theirs when they register)."""
        from persia_tpu_torch.service_discovery import get_fleet_targets

        return get_fleet_targets(self.coordinator_addr)

    def fleet_monitor(self, **kw):
        """A :class:`~persia_tpu_torch.fleet.FleetMonitor` over this
        cluster's coordinator, built and not started (``kw`` goes to its
        constructor)."""
        from persia_tpu_torch.fleet import FleetMonitor

        return FleetMonitor(coordinator_addr=self.coordinator_addr, **kw)

    def coordinator_client(self) -> CoordinatorClient:
        return CoordinatorClient(self.coordinator_addr)

    def _terminate_all(self):
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._closing = True
        # the monitor first: a recovery in progress could otherwise start
        # a process after the others were stopped
        if self._monitor is not None:
            self._monitor.join(timeout=15)
        self._terminate_all()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
        return False
