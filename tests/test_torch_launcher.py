"""The port's launcher (``persia_tpu_torch/launcher.py``) against the JAX
launcher, on the CPU.

Each role reaches the port's main with its argv; the nn-worker role's
trainer group hands each member ``PERSIA_PROCESS_INDEX`` /
``PERSIA_PROCESS_COUNT``, terminates the rest at the first failure and
exits with its code, and runs its script once for a group of one; a
missing entry script raises ``SystemExit`` naming the knob. Parity: with
``run_command`` monkeypatched in both packages, the same argv and
environment make the same child command lines and child environments
(tolerance: equality). The four-role deployment of
``tests/test_service_e2e.py`` runs on the port's ``adult_income`` scripts
as processes, and a subprocess shows that the orchestration modules and
the entry scripts load no ``jax`` and nothing of ``persia_tpu``.
"""

import os
import pathlib
import subprocess
import sys
import tempfile

import pytest

from persia_tpu_torch import launcher as tlauncher

REPO = pathlib.Path(__file__).resolve().parent.parent
AI = REPO / "persia_tpu_torch" / "examples" / "adult_income"


class FakeProc:
    """A child whose ``poll`` answers from a script of return codes (the
    last one repeats); ``terminate`` ends it with -15."""

    def __init__(self, rcs):
        self.rcs = list(rcs)
        self.terminated = False

    def poll(self):
        if self.terminated:
            return -15
        return self.rcs.pop(0) if len(self.rcs) > 1 else self.rcs[0]

    def wait(self):
        rc = self.poll()
        return 0 if rc is None else rc

    def terminate(self):
        self.terminated = True


def _recorder(rcs_by_call=None):
    calls = []

    def run_command(cmd, env=None):
        calls.append((list(cmd), dict(env or {})))
        rcs = (rcs_by_call or {}).get(len(calls) - 1, [0])
        return FakeProc(rcs)

    return calls, run_command


def test_help_lists_every_role():
    out = subprocess.run(
        [sys.executable, "-m", "persia_tpu_torch.launcher", "--help"],
        capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=60)
    assert out.returncode == 0, out.stderr
    for role in tlauncher.ROLES:
        assert role in out.stdout


@pytest.mark.parametrize("role,module", [
    ("coordinator", "persia_tpu_torch.service.coordinator"),
    ("embedding-worker", "persia_tpu_torch.service.worker_service"),
    ("embedding-parameter-server", "persia_tpu_torch.service.ps_service"),
])
def test_service_role_reaches_its_main(role, module, monkeypatch):
    import importlib

    mod = importlib.import_module(module)
    seen = []
    monkeypatch.setattr(mod, "main", lambda: seen.append(list(sys.argv)))
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    tlauncher.main([role, "--port", "0", "--global-config", "g.yml"])
    assert seen == [[module.rsplit(".", 1)[1], "--port", "0",
                     "--global-config", "g.yml"]]


def test_data_loader_runs_its_script(monkeypatch):
    calls, run = _recorder({0: [7]})
    monkeypatch.setattr(tlauncher, "run_command", run)
    with pytest.raises(SystemExit) as e:
        tlauncher.main(["data-loader", "loader.py", "--samples", "8"])
    assert e.value.code == 7
    assert calls == [([sys.executable, "loader.py", "--samples", "8"], {})]
    # the knob names the script when the argv does not
    calls.clear()
    monkeypatch.setenv("PERSIA_DATALOADER_ENTRY", "from_env.py")
    with pytest.raises(SystemExit):
        tlauncher.main(["data-loader"])
    assert calls[0][0] == [sys.executable, "from_env.py"]


def test_trainer_group_env_and_success(monkeypatch):
    calls, run = _recorder({0: [None, 0], 1: [None, None, 0], 2: [0]})
    monkeypatch.setattr(tlauncher, "run_command", run)
    monkeypatch.setattr(tlauncher.time, "sleep", lambda s: None)
    monkeypatch.setenv("PERSIA_TRAINER_PROCESSES", "3")
    with pytest.raises(SystemExit) as e:
        tlauncher.main(["nn-worker", "train.py", "--mesh", "3,1"])
    assert e.value.code == 0
    assert calls == [([sys.executable, "train.py", "--mesh", "3,1"],
                      {"PERSIA_PROCESS_INDEX": i, "PERSIA_PROCESS_COUNT": 3})
                     for i in range(3)]


def test_trainer_group_first_failure_terminates_the_rest(monkeypatch):
    # member 1 dies with 5 on the second poll; members 0 and 2 hang
    procs = []
    calls, run = _recorder({0: [None], 1: [None, 5], 2: [None]})

    def run_keep(cmd, env=None):
        procs.append(run(cmd, env))
        return procs[-1]

    monkeypatch.setattr(tlauncher, "run_command", run_keep)
    monkeypatch.setattr(tlauncher.time, "sleep", lambda s: None)
    monkeypatch.setenv("PERSIA_TRAINER_PROCESSES", "3")
    with pytest.raises(SystemExit) as e:
        tlauncher.main(["nn-worker", "train.py"])
    assert e.value.code == 5
    assert [p.terminated for p in procs] == [True, False, True]


def test_trainer_group_of_one_runs_the_script_once(monkeypatch):
    calls, run = _recorder({0: [3], 1: [0]})
    monkeypatch.setattr(tlauncher, "run_command", run)
    monkeypatch.delenv("PERSIA_TRAINER_PROCESSES", raising=False)
    with pytest.raises(SystemExit) as e:
        tlauncher.main(["nn-worker", "train.py", "--epochs", "1"])
    assert e.value.code == 3
    monkeypatch.setenv("PERSIA_NN_WORKER_ENTRY", "entry.py")
    with pytest.raises(SystemExit) as e:
        tlauncher.main(["nn-worker"])
    assert e.value.code == 0
    assert calls == [([sys.executable, "train.py", "--epochs", "1"], {}),
                     ([sys.executable, "entry.py"], {})]


@pytest.mark.parametrize("role,knob,group", [
    ("data-loader", "PERSIA_DATALOADER_ENTRY", "1"),
    ("nn-worker", "PERSIA_NN_WORKER_ENTRY", "1"),
    ("nn-worker", "PERSIA_NN_WORKER_ENTRY", "2"),
])
def test_missing_entry_names_the_knob(role, knob, group, monkeypatch):
    monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("PERSIA_TRAINER_PROCESSES", group)
    monkeypatch.setattr(tlauncher, "run_command", _recorder()[1])
    with pytest.raises(SystemExit, match=knob):
        tlauncher.main([role])


@pytest.mark.parametrize("argv,env", [
    (["nn-worker", "train.py", "--mesh", "2,1"],
     {"PERSIA_TRAINER_PROCESSES": "2"}),
    (["nn-worker", "train.py"], {"PERSIA_TRAINER_PROCESSES": "4"}),
    (["nn-worker"], {"PERSIA_TRAINER_PROCESSES": "1",
                     "PERSIA_NN_WORKER_ENTRY": "entry.py"}),
    (["nn-worker"], {"PERSIA_TRAINER_PROCESSES": "2",
                     "PERSIA_NN_WORKER_ENTRY": "entry.py"}),
    (["data-loader", "send.py", "--samples", "16"], {}),
    (["data-loader"], {"PERSIA_DATALOADER_ENTRY": "send.py"}),
])
def test_child_commands_match_jax(argv, env, monkeypatch):
    """The same argv and env through both launchers: the same child
    command lines and child env (``run_command`` recorded in both)."""
    from persia_tpu import launcher as jlauncher

    for k in ("PERSIA_TRAINER_PROCESSES", "PERSIA_NN_WORKER_ENTRY",
              "PERSIA_DATALOADER_ENTRY"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    for mod in (tlauncher, jlauncher):
        calls, run = _recorder()
        monkeypatch.setattr(mod, "run_command", run)
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        with pytest.raises(SystemExit) as e:
            mod.main(list(argv))
        got.append((calls, e.value.code))
    assert got[0] == got[1]
    assert got[0][0]  # a child was started


def test_run_command_and_helpers_match_jax(monkeypatch):
    """``run_command``'s merged, stringified environment; ``setup_seed``
    draws; ``find_free_port``'s range."""
    import random

    import numpy as np

    from persia_tpu import utils as jutils

    from persia_tpu_torch import utils as tutils

    envs = []

    class P:
        def __init__(self, cmd, env=None):
            envs.append((cmd, env))

    monkeypatch.setattr(subprocess, "Popen", P)
    monkeypatch.setenv("PERSIA_X_BASE", "b")
    for u in (tutils, jutils):
        u.run_command(["a", "b"], env={"N": 3, "S": "s"})
    assert envs[0] == envs[1]
    assert envs[0][1]["N"] == "3" and envs[0][1]["PERSIA_X_BASE"] == "b"
    draws = []
    for u in (tutils, jutils):
        u.setup_seed(11)
        draws.append((random.random(), float(np.random.random()),
                      os.environ["PYTHONHASHSEED"]))
    assert draws[0] == draws[1]
    import torch

    tutils.setup_seed(11)
    a = torch.rand(3)
    tutils.setup_seed(11)
    assert torch.equal(a, torch.rand(3))
    port = tutils.find_free_port(20000, 20100)
    assert 20000 <= port <= 20100


def test_four_role_deployment_on_the_port_scripts(tmp_path):
    """``tests/test_service_e2e.py``'s DEPLOY.md topology on the port: a
    ``ServiceCtx`` cluster, the adult-income ``nn_worker.py`` under the
    launcher's nn-worker role (on the CPU) and ``data_loader.py`` under
    its data-loader role, all over the coordinator; both exit 0."""
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.service.helper import ServiceCtx
    from persia_tpu_torch.utils import dump_yaml

    schema = EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{s}" for s in range(8)], dim=8))
    gc = str(tmp_path / "global.yml")
    dump_yaml({"embedding_parameter_server_config": {
        "capacity": 100_000, "num_hashmap_internal_shards": 4}}, gc)
    with ServiceCtx(schema, n_workers=1, n_ps=1,
                    global_config_path=gc) as svc:
        env = {**os.environ, "PYTHONPATH": str(REPO),
               "PERSIA_COORDINATOR_ADDR": svc.coordinator_addr,
               "RANK": "0", "WORLD_SIZE": "1", "REPLICA_INDEX": "0",
               "REPLICA_SIZE": "1"}
        trainer = subprocess.Popen(
            [sys.executable, "-m", "persia_tpu_torch.launcher", "nn-worker",
             str(AI / "nn_worker.py"), "--device", "cpu"], env=env,
            cwd=REPO)
        loader = subprocess.Popen(
            [sys.executable, "-m", "persia_tpu_torch.launcher",
             "data-loader", str(AI / "data_loader.py"),
             "--samples", "1536", "--batch-size", "256"], env=env,
            cwd=REPO)
        try:
            assert loader.wait(timeout=120) == 0
            assert trainer.wait(timeout=120) == 0
        finally:
            for p in (trainer, loader):
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert not svc.crashed


def test_adult_income_data_generator_matches_jax():
    """The port's copy of the generator draws the JAX example's bytes."""
    sys.path.insert(0, str(REPO / "examples" / "adult_income"))
    try:
        import data_generator as jgen
    finally:
        sys.path.pop(0)
    from persia_tpu_torch.examples.adult_income import data_generator as tgen

    for a, b in zip(tgen.batches(700, 256, seed=3),
                    jgen.batches(700, 256, seed=3)):
        assert a.to_bytes() == b.to_bytes()


def test_orchestration_and_entry_scripts_load_no_jax():
    """A fresh interpreter imports the launcher, ``k8s_utils``,
    ``k8s_operator``, ``autopilot`` and every entry script of the port's
    examples, and runs the launcher's ``--help``: no ``jax`` and no
    ``persia_tpu`` module loads (nor ``yaml``: the port writes its own
    YAML). The four orchestration modules load no torch either."""
    code = (
        "import sys\n"
        "import persia_tpu_torch.launcher, persia_tpu_torch.k8s_utils\n"
        "import persia_tpu_torch.k8s_operator, persia_tpu_torch.autopilot\n"
        "light = sorted(m for m in sys.modules if m == 'torch')\n"
        "import persia_tpu_torch.examples.criteo.train\n"
        "import persia_tpu_torch.examples.criteo.send_data\n"
        "import persia_tpu_torch.examples.criteo.criteo_data\n"
        "import persia_tpu_torch.examples.adult_income.nn_worker\n"
        "import persia_tpu_torch.examples.adult_income.data_loader\n"
        "import persia_tpu_torch.examples.adult_income.data_generator\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'persia_tpu', 'yaml'))\n"
        "print(repr((light, bad)))\n")
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            cwd=d, env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == repr(([], []))
    for mod in ("launcher", "k8s_utils", "k8s_operator"):
        out = subprocess.run(
            [sys.executable, "-m", f"persia_tpu_torch.{mod}", "--help"],
            capture_output=True, text=True, cwd=REPO,
            env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=60)
        assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("script,args", [
    (REPO / "persia_tpu_torch" / "examples" / "criteo" / "train.py",
     ["--mesh", "2,1"]),
    (REPO / "persia_tpu_torch" / "examples" / "criteo" / "train.py",
     ["--local", "--samples", "512", "--batch-size", "256"]),
    (AI / "nn_worker.py", []),
])
def test_entry_scripts_default_to_the_card(script, args):
    """No fallback hides the device: without ``--device cpu`` the trainers
    ask for CUDA and raise on a host without a card, before they reach
    the coordinator."""
    # a coordinator nobody answers: the device is checked before it
    env = {**os.environ, "PERSIA_COORDINATOR_ADDR": "127.0.0.1:1",
           "RANK": "0", "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, str(script), *args],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=REPO)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
