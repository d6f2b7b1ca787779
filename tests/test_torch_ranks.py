"""Start a group of rank processes with torchrun's environment, and hold
them to a deadline; and the tests of that helper.

The multi-process tests (``test_torch_ddp.py``,
``test_torch_context_parallel.py``) and ``chip_smoke.py``'s ``multi_rank``
phase start their ranks through this module; a training job of the port
launches with ``torchrun`` and needs none of it.

Each rank runs ``python *argv`` with ``MASTER_ADDR`` / ``MASTER_PORT`` /
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set, which
:meth:`persia_tpu_torch.distributed.DistributedOption.initialize` reads.
A rank that exits non-zero, or a group that outlives its deadline, kills
every rank of the group and raises with each rank's output, so that a
dead peer fails its caller in seconds instead of hanging it.

:func:`start_ranks` / :func:`collect` / :func:`rank_main` are one small
protocol over it: the caller pickles the inputs into a work directory,
each rank runs a named body of a script on them and pickles its result
there, and the caller reads the results rank by rank. The rank processes
import this module as ``test_torch_ranks`` (the script's directory is
``tests/``), and it imports nothing but the standard library at import
time, so a rank's imports are its body's.
"""

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence


class RankFailure(RuntimeError):
    pass


class RankGroup:
    """``world`` processes of ``python *argv``; :meth:`wait` returns their
    outputs (stdout and stderr together), rank by rank."""

    def __init__(self, argv: Sequence[str], world: int,
                 env: Optional[Dict[str, str]] = None):
        self.argv, self.world = list(argv), world
        self.env = dict(os.environ if env is None else env)
        self.procs: List[subprocess.Popen] = []
        self._logs = []

    def start(self) -> "RankGroup":
        from persia_tpu_torch.distributed import free_port

        port = str(free_port())
        for rank in range(self.world):
            env = dict(self.env, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       RANK=str(rank), WORLD_SIZE=str(self.world),
                       LOCAL_RANK=str(rank))
            log = tempfile.TemporaryFile(mode="w+")
            self._logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, *self.argv], env=env,
                stdout=log, stderr=subprocess.STDOUT, text=True))
        return self

    def outputs(self) -> List[str]:
        out = []
        for log in self._logs:
            log.seek(0)
            out.append(log.read())
        return out

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def poll(self) -> Optional[bool]:
        """True when every rank exited 0, None while one runs; a rank that
        failed kills the group and raises."""
        codes = [p.poll() for p in self.procs]
        if any(c not in (None, 0) for c in codes):
            self.kill()
            self._raise("a rank failed")
        return True if all(c == 0 for c in codes) else None

    def _raise(self, why: str):
        codes = [p.returncode for p in self.procs]
        raise RankFailure(f"{why} (exit codes {codes}):\n" + "\n".join(
            f"--- rank {r} ---\n{o[-6000:]}"
            for r, o in enumerate(self.outputs())))

    def wait(self, deadline_s: float) -> List[str]:
        end = time.monotonic() + deadline_s
        try:
            while not self.poll():
                if time.monotonic() > end:
                    self.kill()
                    self._raise(f"the group outlived its {deadline_s:.0f} s "
                                f"deadline")
                time.sleep(0.05)
            return self.outputs()
        finally:
            self.kill()
            for log in self._logs:
                log.close()


def start_ranks(script: str, body: str, world: int, inputs: Any,
                workdir, env: Optional[Dict[str, str]] = None) -> RankGroup:
    """Pickle ``inputs`` into ``workdir`` and start ``world`` ranks of
    ``python script body workdir`` (the script calls :func:`rank_main`)."""
    workdir = Path(workdir)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return RankGroup([str(script), body, str(workdir)], world, env).start()


def collect(group: RankGroup, workdir, deadline_s: float) -> List[Any]:
    """Wait for the group; each rank's pickled result, by rank."""
    group.wait(deadline_s)
    out = []
    for rank in range(group.world):
        with open(Path(workdir) / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def rank_main(bodies: Dict[str, Callable[[Any], Any]]):
    """In a rank process started by :func:`start_ranks`: run the body
    named by ``sys.argv[1]`` on the pickled inputs and pickle its result
    as this rank's."""
    body, workdir = sys.argv[1], Path(sys.argv[2])
    with open(workdir / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    result = bodies[body](inputs)
    with open(workdir / f"rank{os.environ['RANK']}.pkl", "wb") as f:
        pickle.dump(result, f)


# --- tests of the helper ---------------------------------------------------


def _echo(inputs):
    return {k: os.environ[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                       "MASTER_ADDR")} | {"x": inputs["x"]}


def _fail_on_rank_1(inputs):
    if os.environ["RANK"] == "1":
        raise RuntimeError("rank 1 gives up")
    time.sleep(inputs["hold_s"])


def _hang(inputs):
    time.sleep(inputs["hold_s"])


BODIES = {"echo": _echo, "fail": _fail_on_rank_1, "hang": _hang}


def test_collect_returns_each_rank_result_by_rank(tmp_path):
    group = start_ranks(__file__, "echo", 3, {"x": [1, 2]}, tmp_path)
    got = collect(group, tmp_path, deadline_s=60)
    assert [r["RANK"] for r in got] == ["0", "1", "2"]
    assert [r["LOCAL_RANK"] for r in got] == ["0", "1", "2"]
    assert {r["WORLD_SIZE"] for r in got} == {"3"}
    assert {r["MASTER_ADDR"] for r in got} == {"127.0.0.1"}
    assert all(r["x"] == [1, 2] for r in got)


def test_a_failing_rank_kills_the_group_and_raises(tmp_path):
    """Rank 0 would sleep for a minute: the group ends when rank 1 dies,
    with rank 1's traceback in the error."""
    import pytest

    t = time.monotonic()
    group = start_ranks(__file__, "fail", 2, {"hold_s": 60}, tmp_path)
    with pytest.raises(RankFailure, match="a rank failed") as e:
        collect(group, tmp_path, deadline_s=60)
    assert time.monotonic() - t < 30
    assert "rank 1 gives up" in str(e.value)
    assert all(p.poll() is not None for p in group.procs)


def test_a_group_past_its_deadline_is_killed(tmp_path):
    import pytest

    t = time.monotonic()
    group = start_ranks(__file__, "hang", 2, {"hold_s": 60}, tmp_path)
    with pytest.raises(RankFailure, match="deadline"):
        collect(group, tmp_path, deadline_s=3)
    assert time.monotonic() - t < 30
    assert all(p.poll() is not None for p in group.procs)


if __name__ == "__main__":
    rank_main(BODIES)
