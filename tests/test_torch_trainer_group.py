"""Whole-job supervision of the port on the CPU (the other tiers and the
trainer group): ``bench.py``'s worker chaos cell and the JAX test of a
supervised PS killed and restored (``tests/test_faults.py:488``, from a
checkpoint only; with its incremental-update packets replayed it is
``tests/test_torch_inc_update.py``'s) at a small
size, the two-trainer group of ``tests/test_multihost_group.py:127``
with the port's dense rider on gloo (``--mesh --dense-sync-every 2
--device cpu``), the rider held against the JAX ``_dense_rider`` from
the same parameters, and ``get_fleet_targets`` against the JAX
function on one coordinator.

The rider's tolerance: round 0 (the same weights and inputs, one bf16
forward) within 1e-6; every round's loss within rtol = atol = 0.08 and
every parameter within 0.08 of the model's largest, the int8-EF DDP
gate of ``tests/test_models_parallel.py:235-255``. The tower computes in
bf16, where the two packages' gradients can differ by a bf16 ulp (2**-8
relative), and the int8 codes and error feedback carry that into the
next rounds (1.2e-2 relative at round 5 measured).
"""

import json
import math
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from persia_tpu_torch.checkpoint import iter_psd_entries
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.service import trainer_service as ts
from persia_tpu_torch.service.helper import ServiceCtx
from persia_tpu_torch.service.ps_service import PsClient
from persia_tpu_torch.service.worker_service import RemoteEmbeddingWorker
from test_torch_supervision import (
    BATCH,
    DONE_S,
    N_FEATS,
    POOL,
    SEED,
    applied_counts,
    arm,
    chaos_schema,
    expected_counts,
    global_config,
    validate_postmortem,
)

RIDER_ATOL_0 = 1e-6
RIDER_TOL = 0.08


# --- a supervised worker killed under a driving loop -------------------------


def test_supervised_worker_kill_loses_only_the_declared_ambiguity(tmp_path,
                                                                  request):
    """``bench.py``'s ``_chaos_job_worker_cell``: a driving loop keeps a
    ledger of acked and confirmed (staleness 0 seen after them) updates;
    the worker process is SIGKILLed and respawned under its index. Gates:
    no confirmed update lost (per sign), the loss bounded by the declared
    ambiguity, over-application bounded by the failed cycles, the bundle
    holding the worker's health doc."""
    from persia_tpu_torch import tracing

    pool = ts.sign_pool(POOL)
    # traced from this end, so that the worker's spans chain to its PS
    # calls (on before any dial)
    tracing.enable_tracing(True)
    request.addfinalizer(lambda: tracing.enable_tracing(False))
    with ServiceCtx(chaos_schema(), n_workers=1, n_ps=2,
                    global_config_path=global_config(tmp_path),
                    supervise_workers=True,
                    postmortem_dir=os.fspath(tmp_path / "postmortems"),
                    flight_interval=0.3,
                    env={"PERSIA_TRACING": "1",
                         "LOG_LEVEL": "WARNING"}) as svc:

        def mk_worker():
            w = RemoteEmbeddingWorker(list(svc.worker_addrs))
            arm(w)
            return w

        box = [mk_worker()]
        lock = threading.Lock()
        stop = threading.Event()
        expected = np.zeros(len(pool), np.int64)
        confirmed = np.zeros(len(pool), np.int64)
        acked, settled = [0], [0]
        pending, failures, errors = [], [], []

        def train():
            rng = np.random.default_rng(5)
            while not stop.is_set():
                draws = [rng.choice(pool, size=BATCH) for _ in range(N_FEATS)]
                feats = [IDTypeFeature(f"slot_{i}", [d])
                         for i, d in enumerate(draws)]
                idx = np.searchsorted(pool, np.concatenate(draws))
                # the cycle and its ledger under the lock the killer
                # takes: a kill never lands between an ack and its record
                with lock:
                    if stop.is_set():
                        return
                    w = box[0]
                    try:
                        ref, out = w.lookup_direct_training(feats)
                        w.update_gradients(ref, {
                            k: np.ones_like(v.embeddings)
                            for k, v in out.items()})
                    except Exception:  # noqa: BLE001 — a failed cycle
                        failures.append(N_FEATS * BATCH)
                        box[0] = None
                    else:
                        acked[0] += N_FEATS * BATCH
                        np.add.at(expected, idx, 1)
                        pending.append((N_FEATS * BATCH, idx))
                        try:
                            if w.staleness == 0:
                                for e, pidx in pending:
                                    settled[0] += e
                                    np.add.at(confirmed, pidx, 1)
                                pending.clear()
                        except Exception:  # noqa: BLE001 — stays pending
                            pass
                if box[0] is None:
                    time.sleep(0.25)
                    try:
                        box[0] = mk_worker()
                    except Exception as e:  # noqa: BLE001 — retried
                        errors.append(repr(e))
                time.sleep(0.01)

        t = threading.Thread(target=train, daemon=True)
        t.start()
        time.sleep(1.2)  # flight polls (0.3 s) land before the kill
        with lock:
            acked_k, settled_k = acked[0], settled[0]
            confirmed_k = confirmed.copy()
            svc.worker_proc(0).kill()
        (event,) = svc.wait_worker_recoveries(1, timeout=60)
        assert "failed" not in event, event
        # train past the recovery: cycles land on the replacement
        acked_r = acked[0]
        deadline = time.monotonic() + 30
        while acked[0] < acked_r + 3 * N_FEATS * BATCH:
            assert time.monotonic() < deadline, (
                "no cycle landed after the recovery", errors[-3:])
            time.sleep(0.05)
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive()
        w = box[0] or mk_worker()
        deadline = time.monotonic() + 30
        while w.staleness != 0:
            assert time.monotonic() < deadline, "the replacement never drained"
            time.sleep(0.1)
        got = applied_counts(w, pool)
        fail_elems = int(sum(failures))
        declared = (acked_k - settled_k) + fail_elems
        assert not np.any(confirmed_k - got > 1e-3), \
            "an update confirmed before the kill was lost"
        lost = float(expected.sum()) - float(got.sum())
        assert lost <= declared + 1e-3, (lost, declared)
        assert -lost <= fail_elems + 1e-3, (lost, fail_elems)
        assert len(failures) <= 60, len(failures)
        validate_postmortem(event["postmortem"],
                            health_key="forward_buffer_depth")
        assert event["addr"] == svc.worker_addrs[0]
        w.close()
        assert not svc.crashed


# --- a supervised PS killed after a checkpoint -------------------------------


def test_supervised_ps_kill_restores_the_checkpoint(tmp_path, request):
    """A supervised PS replica killed after a checkpoint (and no update
    after it): the replacement restores ``replica_1.psd``, reaches
    ``Idle`` at a new address, and its rows equal the checkpoint's; the
    flight recorder leaves a bundle from the killed replica's last
    ``/flight`` snapshot."""
    from persia_tpu_torch import tracing

    ckpt = os.fspath(tmp_path / "ckpt")
    rng = np.random.default_rng(0)
    tracing.enable_tracing(True)
    request.addfinalizer(lambda: tracing.enable_tracing(False))
    with ServiceCtx(chaos_schema(), n_workers=1, n_ps=2,
                    global_config_path=global_config(tmp_path),
                    supervise_ps=True, ps_restore_dir=ckpt,
                    ps_probe_interval=0.25,
                    postmortem_dir=os.fspath(tmp_path / "postmortems"),
                    flight_interval=0.3,
                    env={"PERSIA_TRACING": "1",
                         "LOG_LEVEL": "WARNING"}) as svc:
        w = svc.remote_worker()
        w.configure_parameter_servers(
            "bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0)
        w.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
        for _ in range(8):
            feats = [IDTypeFeature(f"slot_{i}", [rng.integers(
                0, 4096, size=16, dtype=np.uint64)]) for i in range(N_FEATS)]
            ref, out = w.lookup_direct_training(feats)
            w.update_gradients(ref, {k: np.ones_like(v.embeddings)
                                     for k, v in out.items()})
        w.dump(ckpt)
        deadline = time.monotonic() + 15
        while not (svc.flight_recorder.last("ps1") or {}).get("spans"):
            assert time.monotonic() < deadline, "no flight with spans"
            time.sleep(0.05)
        old_addr = svc.ps_addrs[1]
        t_kill = time.monotonic()
        svc.ps_proc(1).kill()
        (event,) = svc.wait_ps_recoveries(1, timeout=60)
        assert "failed" not in event, event
        assert 0 <= event["t_detected"] - t_kill < 10.0
        assert event["addr"] == svc.ps_addrs[1] != old_addr
        bundle = event["postmortem"]
        with open(os.path.join(bundle, "health.json")) as f:
            assert json.load(f)["model_manager_status"] == "Idle"
        with open(os.path.join(bundle, "trace.json")) as f:
            xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
        ids = {e["args"]["span_id"] for e in xs}
        assert xs and all(not e["args"].get("parent_id")
                          or e["args"]["parent_id"] in ids for e in xs)
        assert os.path.getsize(os.path.join(bundle, "metrics.prom")) > 0
        with open(os.path.join(bundle, "reason.json")) as f:
            assert json.load(f)["service"] == "ps1"
        want = {sign: vec for sign, _d, vec in iter_psd_entries(
            os.path.join(ckpt, "replica_1.psd"))}
        assert want
        client = PsClient(svc.ps_addrs[1])
        assert len(client) == len(want)
        for sign, vec in want.items():
            got = client.get_entry(sign)
            assert got is not None, f"row {sign} lost in the recovery"
            np.testing.assert_array_equal(got[1][:len(vec)], vec)
        client.client.close()
        w.close()
        assert not svc.crashed


# --- the trainer group with the dense rider ----------------------------------


def test_two_trainer_group_with_the_rider_on_gloo(tmp_path):
    """Two supervised trainer drivers over one tier meet in a gloo world
    through the coordinator's KV store and run the int8-EF rider every 2
    local steps: each trains its round-robin half (labeled shipments on
    the worker), the per-sign counts summed over the group match the one
    stream exactly, every rider loss is finite and equal on both ranks,
    and the two ranks' dense parameters are bit-equal after each sync."""
    steps, bs = 8, 32
    result_file = os.fspath(tmp_path / "result.json")
    trainer_args = [
        "--num-workers", "1", "--steps", str(steps),
        "--batch-size", str(bs), "--n-feats", str(N_FEATS),
        "--seed", str(SEED), "--pool-size", str(POOL),
        "--result-file", result_file, "--device", "cpu",
        "--mesh", "--dense-sync-every", "2"]
    with ServiceCtx(chaos_schema(), n_workers=1, n_ps=2,
                    global_config_path=global_config(tmp_path),
                    supervise_trainer=True, trainer_args=trainer_args,
                    n_trainers=2, trainer_max_restarts=0, http_all=True,
                    trainer_env={"OMP_NUM_THREADS": "1"},
                    env={"LOG_LEVEL": "WARNING"}) as svc:
        assert svc.wait_trainer_done(timeout=DONE_S) == 0
        ship_counts = None
        for t in svc.fleet_targets():
            if t["role"] == "embedding-worker":
                with urllib.request.urlopen(
                        f"http://{t['http_addr']}/healthz", timeout=5) as r:
                    ship_counts = json.loads(r.read()).get("ship_counts")
        assert ship_counts == {"p0": steps // 2, "p1": steps // 2}
        pool = ts.sign_pool(POOL)
        np.testing.assert_array_equal(
            applied_counts(svc.remote_worker(), pool),
            expected_counts(pool, SEED, steps, bs, N_FEATS))
        assert not svc.crashed
    results = []
    for i in range(2):
        with open(f"{result_file}.p{i}") as f:
            results.append(json.load(f))
    assert not os.path.exists(result_file)
    assert [r["process_index"] for r in results] == [0, 1]
    assert all(r["process_count"] == 2 and r["mesh_shape"] == "2x1"
               and r["backend"] == "gloo" for r in results)
    assert sum(r["ships"] for r in results) == steps
    assert all(r["group_ships"] == steps for r in results)
    a, b = results
    assert a["dense_syncs"] == b["dense_syncs"] == steps // 2 // 2
    assert all(math.isfinite(x) for x in a["dense_losses"])
    assert a["dense_losses"] == b["dense_losses"]
    assert a["dense_digests"] == b["dense_digests"]
    assert len(set(a["dense_digests"])) == len(a["dense_digests"])


def test_rider_matches_the_jax_rider(monkeypatch):
    """The port's rider on a world of one (gloo, CPU) against the JAX
    ``_dense_rider`` on a one-device CPU mesh from the same parameters
    (the JAX rider's own init, carried across by ``weights.py``)."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch.distributed as dist

    from persia_tpu.models import DNN as JDNN
    from persia_tpu.parallel.mesh import make_mesh
    from persia_tpu.parallel.train import create_train_state
    from persia_tpu.service import trainer_service as jts
    from persia_tpu_torch.distributed import DistributedOption
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.weights import (
        flax_params,
        load_flax_params,
        numpy_tree,
    )

    rounds = 4
    # the JAX rider sizes its rows by the process's devices: one here
    monkeypatch.setattr(jax, "local_device_count", lambda *a, **k: 1)
    mesh = make_mesh((1, 1), devices=jax.devices()[:1])
    state = create_train_state(
        JDNN(), optax.sgd(ts.RIDER_LR), jax.random.key(SEED),
        [jnp.zeros((ts.RIDER_ROWS, ts.RIDER_DENSE))],
        [jnp.zeros((ts.RIDER_ROWS, d)) for d in ts.RIDER_SLOTS])
    jsync = jts._dense_rider(jax, mesh, 1, SEED)
    want = [jsync(r, 0) for r in range(rounds)]
    (holder,) = [c.cell_contents for c in jsync.__closure__
                 if isinstance(c.cell_contents, dict)
                 and "state" in c.cell_contents]
    want_params = numpy_tree(holder["state"].params)
    assert not dist.is_initialized()
    tmesh = DistributedOption(device="cpu", timeout=60).initialize()
    try:
        model = load_flax_params(
            DNN(ts.RIDER_DENSE, ts.RIDER_SLOTS, device="cpu"),
            numpy_tree(state.params), numpy_tree(state.batch_stats))
        sync = ts._dense_rider(tmesh, 1, SEED, model=model)
        got = [sync(r, 0) for r in range(rounds)]
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got[0], want[0], rtol=RIDER_ATOL_0,
                               atol=RIDER_ATOL_0)
    np.testing.assert_allclose(got, want, rtol=RIDER_TOL, atol=RIDER_TOL)
    got_params, _ = flax_params(model)
    largest = max(np.abs(v).max() for v in
                  jax.tree_util.tree_leaves(want_params))

    def close(a, b, where):
        if isinstance(a, dict):
            for k in a:
                close(a[k], b[k], f"{where}/{k}")
            return
        assert np.abs(np.asarray(a) - b).max() <= RIDER_TOL * largest, where

    close(want_params, got_params, "")


# --- discovery ---------------------------------------------------------------


def test_fleet_targets_equal_jax_on_one_coordinator(monkeypatch):
    from persia_tpu.service_discovery import (
        get_embedding_worker_services as jworkers,
    )
    from persia_tpu.service_discovery import get_fleet_targets as jtargets
    from persia_tpu_torch.service.coordinator import (
        ROLE_PS,
        ROLE_TRAINER,
        ROLE_WORKER,
        Coordinator,
        CoordinatorClient,
    )
    from persia_tpu_torch.service_discovery import (
        get_embedding_worker_services,
        get_fleet_targets,
    )

    coord = Coordinator()
    coord.server.serve_background()
    try:
        c = CoordinatorClient(coord.addr)
        c.register(ROLE_PS, 0, "h:1", http_addr="h:11")
        c.register(ROLE_PS, 1, "h:2")
        c.register(ROLE_WORKER, 0, "h:3", http_addr="h:13")
        c.register(ROLE_TRAINER, 0, "h:14", http_addr="h:14")
        static = "serving0=h:20, h:21,dup=h:13"
        for kw in ({}, {"static": static}, {"static": ""}):
            assert get_fleet_targets(coord.addr, **kw) == \
                jtargets(coord.addr, **kw), kw
        monkeypatch.setenv("PERSIA_FLEET_TARGETS", static)
        got = get_fleet_targets(coord.addr)
        assert got == jtargets(coord.addr)
        assert [t["service"] for t in got] == [
            "serving0", "svc1", "dup", "ps0", "trainer0"]
        monkeypatch.delenv("EMBEDDING_WORKER_SERVICE", raising=False)
        assert get_embedding_worker_services(coord.addr) == \
            jworkers(coord.addr) == ["h:3"]
        monkeypatch.setenv("EMBEDDING_WORKER_SERVICE", "a:1, b:2")
        assert get_embedding_worker_services() == jworkers() == ["a:1",
                                                                "b:2"]
        c.client.close()
    finally:
        coord.server.stop()


@pytest.mark.gpu
def test_rider_on_the_card_matches_its_cpu_run():
    """The rider on a world of one over NCCL on the card against the same
    rider on the CPU (gloo), from the same seed: every round within the
    rider's tolerance."""
    import datetime

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m gpu)")
    from persia_tpu_torch.distributed import DistributedOption

    losses = {}
    for device, backend in (("cpu", "gloo"), ("cuda", "nccl")):
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                              wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=60))
        mesh = DistributedOption(backend=backend, device=device, store=store,
                                 world_size=1, rank=0,
                                 timeout=60).initialize()
        try:
            sync = ts._dense_rider(mesh, 1, SEED)
            losses[device] = [sync(r, 0) for r in range(6)]
        finally:
            dist.destroy_process_group()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                               rtol=RIDER_TOL, atol=RIDER_TOL)
