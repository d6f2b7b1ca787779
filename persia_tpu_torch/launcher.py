"""The role entry point CLI (``persia_tpu/launcher.py``).

Each subcommand runs one process of a role, with environment fallbacks so
that k8s manifests stay declarative (:mod:`persia_tpu_torch.k8s_utils`
renders every pod's command as one of these):

    python -m persia_tpu_torch.launcher coordinator --port 23333
    python -m persia_tpu_torch.launcher data-loader [script.py]   (PERSIA_DATALOADER_ENTRY)
    python -m persia_tpu_torch.launcher nn-worker [script.py]     (PERSIA_NN_WORKER_ENTRY)
    python -m persia_tpu_torch.launcher embedding-worker --embedding-config ...
    python -m persia_tpu_torch.launcher embedding-parameter-server ...

The service roles run the port's coordinator, worker and PS mains in this
process, with their own flags (the JAX package's); none of them loads
torch. ``data-loader`` runs its script as a child.

``nn-worker`` runs a trainer group: ``PERSIA_TRAINER_PROCESSES`` copies
of its script, each with ``PERSIA_PROCESS_INDEX`` /
``PERSIA_PROCESS_COUNT``, polled together; the first to exit non-zero
has the others terminated, and its code is the launcher's. With one
process the script runs once.

A difference from the JAX launcher: there, scale-out within a host is
an in-process ``jax`` mesh over the host's chips (one single-controller
process a host), and a group member is a host. Here every member of the
group is a rank of one ``torch.distributed`` world, one process a rank,
so a group of N is N ranks, which the entry script brings up (the port's
``examples/criteo/train.py --mesh`` meets them through the coordinator's
KV store).
"""

import argparse
import logging
import sys
import time

from persia_tpu_torch import knobs
from persia_tpu_torch.utils import run_command

_logger = logging.getLogger("persia_tpu_torch.launcher")

ROLES = ("coordinator", "data-loader", "nn-worker", "embedding-worker",
         "embedding-parameter-server")


def _entry_command(entry_env: str, argv):
    script = argv[0] if argv else knobs.get(entry_env)
    if not script:
        raise SystemExit(f"no script given and {entry_env} not set")
    return [sys.executable, script, *argv[1:]]


def _run_script(entry_env: str, argv):
    cmd = _entry_command(entry_env, argv)
    _logger.info("launching %s", " ".join(cmd))
    proc = run_command(cmd)
    raise SystemExit(proc.wait())


def _run_trainer_group(argv):
    """The nn-worker role: ``PERSIA_TRAINER_PROCESSES`` ranks of the entry
    script, each with ``PERSIA_PROCESS_INDEX`` / ``PERSIA_PROCESS_COUNT``.
    Exits with the first non-zero child code: one dead rank wedges the
    others at their next collective, so the whole group is restarted by
    whatever supervises the launcher."""
    n = knobs.get("PERSIA_TRAINER_PROCESSES")
    if n <= 1:
        _run_script("PERSIA_NN_WORKER_ENTRY", argv)
        return
    cmd = _entry_command("PERSIA_NN_WORKER_ENTRY", argv)
    procs = []
    for i in range(n):
        _logger.info("launching trainer %d/%d: %s", i, n, " ".join(cmd))
        procs.append(run_command(cmd, env={
            "PERSIA_PROCESS_INDEX": i, "PERSIA_PROCESS_COUNT": n}))
    # polled, not waited on in turn: a wait() on a rank wedged at a
    # collective would hide its peer's crash for ever
    rc = None
    while rc is None:
        rcs = [proc.poll() for proc in procs]
        bad = [(i, r) for i, r in enumerate(rcs) if r not in (None, 0)]
        if bad:
            i, rc = bad[0]
            _logger.error("trainer %d exited rc=%d; terminating group",
                          i, rc)
        elif all(r == 0 for r in rcs):
            rc = 0
        else:
            time.sleep(0.2)
    if rc != 0:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
    raise SystemExit(rc)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="persia-torch-launcher")
    p.add_argument("role", choices=ROLES)
    args, rest = p.parse_known_args(argv)

    if args.role == "coordinator":
        from persia_tpu_torch.service import coordinator

        sys.argv = ["coordinator", *rest]
        coordinator.main()
    elif args.role == "embedding-worker":
        from persia_tpu_torch.service import worker_service

        sys.argv = ["worker_service", *rest]
        worker_service.main()
    elif args.role == "embedding-parameter-server":
        from persia_tpu_torch.service import ps_service

        sys.argv = ["ps_service", *rest]
        ps_service.main()
    elif args.role == "data-loader":
        _run_script("PERSIA_DATALOADER_ENTRY", rest)
    elif args.role == "nn-worker":
        _run_trainer_group(rest)


if __name__ == "__main__":
    main()
