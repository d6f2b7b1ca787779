"""``python -m persia_tpu_torch.serving`` (``persia_tpu/serving.py``
``main`` on the port): the CLI as a process on ``--device cpu`` over a
worker service, registered with a coordinator together with its sidecar,
replies bit-equal to an in-process ``InferenceServer`` built from the
same ``dense.pt`` over the same worker; a JAX ``dense.msgpack`` refused by
name; the card as the default device."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from persia_tpu_torch import checkpoint as ckpt
from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
from persia_tpu_torch.data.batch import (
    IDTypeFeatureWithSingleID,
    NonIDTypeFeature,
    PersiaBatch,
)
from persia_tpu_torch.ps.native import make_holder
from persia_tpu_torch.serving import (
    InferenceClient,
    InferenceServer,
    _model_zoo,
    load_zoo_model,
    main,
)
from persia_tpu_torch.service.coordinator import (
    ROLE_INFERENCE,
    Coordinator,
    CoordinatorClient,
)
from persia_tpu_torch.service.helper import _schema_to_yaml_dict
from persia_tpu_torch.service.ps_service import PsClient, PsService
from persia_tpu_torch.service.worker_service import WorkerService
from persia_tpu_torch.utils import dump_yaml
from persia_tpu_torch.weights import init_params
from persia_tpu_torch.worker.worker import EmbeddingWorker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLOTS, DIM, N_DENSE, ROWS, N_REQ = 6, 8, 13, 16, 12


def _request(seed: int) -> PersiaBatch:
    rng = np.random.default_rng(seed)
    return PersiaBatch(
        [IDTypeFeatureWithSingleID(
            f"slot_{s}", rng.integers(1, 2000, size=ROWS).astype(np.uint64))
         for s in range(N_SLOTS)],
        non_id_type_features=[NonIDTypeFeature(
            rng.normal(size=(ROWS, N_DENSE)).astype(np.float32))],
        requires_grad=False)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """A coordinator, two PS services and a worker service on threads,
    the rows of every request admitted, a schema file and a seeded DLRM's
    ``dense.pt``."""
    tmp = tmp_path_factory.mktemp("serving_cli")
    schema = EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{s}" for s in range(N_SLOTS)], dim=DIM))
    schema_path = os.fspath(tmp / "schema.yml")
    dump_yaml(_schema_to_yaml_dict(schema), schema_path)
    coord = Coordinator()
    coord.server.serve_background()
    ps = [PsService(make_holder(100_000, 2)) for _ in range(2)]
    for s in ps:
        s.server.serve_background()
    worker = EmbeddingWorker(schema, [PsClient(s.addr) for s in ps])
    worker.configure_parameter_servers(
        "bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0)
    worker.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
    requests = [_request(i) for i in range(N_REQ)]
    for b in requests:
        worker.lookup_direct(b.id_type_features, training=True)
    ws = WorkerService(worker)
    ws.server.serve_background()
    donor = init_params(_model_zoo()["dlrm"](N_DENSE, schema, device="cpu"),
                        5)
    ckpt_dir = tmp / "ckpt"
    ckpt_dir.mkdir()
    (ckpt_dir / ckpt.DENSE_FILE).write_bytes(
        ckpt.dense_state_bytes((donor, None)))
    yield {"schema": schema, "schema_path": schema_path,
           "coord": coord.addr, "worker_addr": ws.addr,
           "ckpt_dir": os.fspath(ckpt_dir), "requests": requests,
           "tmp": tmp}
    ws.stop()
    worker.close()
    for s in ps:
        s.stop()
    coord.server.stop()


@pytest.fixture
def deterministic_torch():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _argv(stack, *extra):
    return ["--model", "dlrm", "--embedding-config", stack["schema_path"],
            "--num-dense", str(N_DENSE), *extra]


def test_cli_process_registers_and_equals_in_process(stack,
                                                     deterministic_torch):
    """The CLI on ``--device cpu`` registers as ``inference-server`` with
    its sidecar; 12 serialized replies through ``InferenceClient`` equal
    an in-process server's from the same ``dense.pt`` and worker, bit for
    bit."""
    env = {**os.environ, "PYTHONPATH": REPO, "LOG_LEVEL": "WARNING"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "persia_tpu_torch.serving",
         *_argv(stack, "--dense-checkpoint", stack["ckpt_dir"], "--device",
                "cpu", "--host", "127.0.0.1", "--port", "0",
                "--coordinator", stack["coord"], "--worker-addrs",
                stack["worker_addr"], "--replica-index", "3",
                "--http-port", "0")],
        env=env, cwd=stack["tmp"])
    coord = CoordinatorClient(stack["coord"])
    local = None
    try:
        deadline = time.monotonic() + 120
        while not coord.list(ROLE_INFERENCE):
            assert proc.poll() is None, "the serving CLI exited"
            assert time.monotonic() < deadline, "never registered"
            time.sleep(0.1)
        (member,) = [m for m in coord.topology()
                     if m["role"] == ROLE_INFERENCE]
        assert member["replica"] == 3 and member["http_addr"]
        model = load_zoo_model("dlrm", stack["ckpt_dir"], N_DENSE,
                               stack["schema"], "cpu")
        local = InferenceServer(model, stack["schema"],
                                worker_addrs=[stack["worker_addr"]],
                                device="cpu")
        remote_cl = InferenceClient(member["addr"])
        local_cl = InferenceClient(local.addr)
        local.serve_background()
        n_equal = 0
        for b in stack["requests"]:
            got, want = remote_cl.predict(b), local_cl.predict(b)
            assert got.shape == (ROWS, 1) and np.isfinite(got).all()
            np.testing.assert_array_equal(got, want)
            n_equal += 1
        assert n_equal == N_REQ
        assert remote_cl.stats()["requests"] == N_REQ
        remote_cl.close()
        local_cl.close()
    finally:
        if local is not None:
            local.stop()
        proc.terminate()
        proc.wait(timeout=10)


def test_cli_refuses_a_jax_dense_file_by_name(stack, tmp_path):
    """A ``dense.msgpack`` (the JAX package's flax state) is refused by
    name, named as a file or as the only dense file of a directory."""
    jax_only = tmp_path / "jax_ckpt"
    jax_only.mkdir()
    (jax_only / ckpt.JAX_DENSE_FILE).write_bytes(b"\x80")
    for path in (jax_only / ckpt.JAX_DENSE_FILE, jax_only):
        with pytest.raises(ValueError, match="dense.msgpack"):
            main(_argv(stack, "--dense-checkpoint", os.fspath(path),
                       "--device", "cpu"))


def test_cli_defaults_to_the_card(stack):
    """Without ``--device`` the CLI builds its tower on the card, and on a
    host without one it raises before it serves."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        main(_argv(stack, "--dense-checkpoint", stack["ckpt_dir"],
                   "--worker-addrs", stack["worker_addr"]))
