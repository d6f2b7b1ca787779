"""Cluster in a box: the service tier as local processes
(``persia_tpu/service/helper.py``).

:class:`ServiceCtx` starts a coordinator, then the PS and worker
processes (``python -m persia_tpu_torch.service.<role>``, each binding
port 0 and registering with the coordinator), waits for their
registration, and watches them: when one dies, the group goes down and
``crashed`` names it. Leaving the context stops every process.

Not ported: the native C++ PS and worker binaries (``native_ps=``,
``native_worker=``), the supervision of a role (``supervise_ps=``,
``supervise_workers=``, ``supervise_trainer=``), the flight recorder
(``postmortem_dir=``) and the trainer group; each raises naming the
ROADMAP.md item it waits for.
"""

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

_ITEM_9B = "ROADMAP.md queue A item 9b"


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
    whatever the knob says."""

    def __init__(self, schema: EmbeddingSchema, n_workers: int = 1,
                 n_ps: int = 1, global_config_path: Optional[str] = None,
                 env: Optional[dict] = None, startup_timeout: float = 120.0,
                 native_ps: bool = False, native_worker: bool = False,
                 supervise_ps: bool = False,
                 supervise_workers: bool = False,
                 supervise_trainer: bool = False,
                 postmortem_dir: Optional[str] = None,
                 http_all: bool = False):
        refused = [(native_ps, "native_ps", "a loader of the port's own "
                    "for the C++ persia-embedding-ps binary"),
                   (native_worker, "native_worker", "a loader of the port's "
                    "own for the C++ worker binary"),
                   (supervise_ps, "supervise_ps", "the PS supervisor, with "
                    "item 6b's incremental-update replay"),
                   (supervise_workers, "supervise_workers",
                    "the worker supervisor"),
                   (supervise_trainer, "supervise_trainer",
                    "service/trainer_service.py and the trainer group"),
                   (postmortem_dir is not None, "postmortem_dir",
                    "the flight recorder")]
        for on, name, what in refused:
            if on:
                raise NotImplementedError(
                    f"ServiceCtx({name}=...) is not ported yet: it needs "
                    f"{what}; it waits for {_ITEM_9B}")
        self.schema = schema
        self.n_workers = n_workers
        self.n_ps = n_ps
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

    def _spawn(self, args: List[str], name: str, replica_index: int,
               replica_size: int) -> subprocess.Popen:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH",
                                                              "")
        env["REPLICA_INDEX"] = str(replica_index)
        env["REPLICA_SIZE"] = str(replica_size)
        if self.coordinator_addr:
            env["PERSIA_COORDINATOR_ADDR"] = self.coordinator_addr
        env.update({k: str(v) for k, v in self.extra_env.items()})
        proc = subprocess.Popen([sys.executable, *args], env=env)
        proc._persia_name = name  # type: ignore[attr-defined]
        self.procs.append(proc)
        return proc

    def _role_args(self, role: str, i: int, size: int) -> List[str]:
        args = ["-m", f"persia_tpu_torch.service.{role}",
                "--replica-index", str(i), "--replica-size", str(size),
                "--coordinator", self.coordinator_addr]
        if self.http_all:
            args += ["--http-port", "0"]
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
            self._spawn(self._role_args("ps_service", i, self.n_ps),
                        f"ps-{i}", i, self.n_ps)
        for i in range(self.n_workers):
            self._spawn(self._role_args("worker_service", i, self.n_workers)
                        + ["--embedding-config", schema_path,
                           "--num-ps", str(self.n_ps)],
                        f"worker-{i}", i, self.n_workers)
        self.ps_addrs = self._wait_members(coord, ROLE_PS, self.n_ps)
        self.worker_addrs = self._wait_members(coord, ROLE_WORKER,
                                               self.n_workers)
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

    def _watch(self):
        """The crash monitor: a child that exits with an error takes the
        group down."""
        while not self._closing:
            for p in list(self.procs):
                rc = p.poll()
                if rc is None or rc == 0 or self._closing:
                    continue
                name = getattr(p, "_persia_name", "?")
                self.crashed.append(f"{name} rc={rc}")
                _logger.error("service %s exited (rc=%d); tearing down",
                              name, rc)
                self._terminate_all()
                return
            time.sleep(0.2)

    def remote_worker(self):
        from persia_tpu_torch.service.worker_service import (
            RemoteEmbeddingWorker,
        )

        w = RemoteEmbeddingWorker(self.worker_addrs)
        w.schema = self.schema
        return w

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
        self._terminate_all()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
        return False
