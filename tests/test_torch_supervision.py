"""Whole-job supervision of the port on the CPU (trainer kills): the
trainer driver's stream (``sign_pool`` / ``batch_draws``) bit for bit
against the JAX driver's, the flight recorder's bundle file for file
against the JAX recorder's, ``snapshot_job``'s ``pre_manifest`` /
``extra`` / ``ps_clients`` against the JAX manifest, the driver's
refusals, and ``bench.py``'s trainer chaos cells at a small size:
``ServiceCtx(supervise_trainer=True)`` over processes, the driver
SIGKILLed at each die point (``--device cpu``), then the torn-manifest
fallback through the public snapshot API.

Each chaos cell's gates are ``bench.py``'s ``_chaos_job_trainer_cell``:
exit 0, exactly one recovery for the one kill, a postmortem bundle with a
parent -> child span chain, a resume from a snapshot (``snap_000000``
behind the torn ``snap_000001`` for ``mid_snapshot``), the counting
identity ``applied == count`` exact for every sign, and at most
``PERSIA_SNAPSHOT_KEEP`` complete snapshots. Every wait has a deadline.
"""

import json
import os

import numpy as np
import pytest

from persia_tpu_torch import knobs
from persia_tpu_torch import snapshot as snap_mod
from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.service import trainer_service as ts
from persia_tpu_torch.service.helper import ServiceCtx
from persia_tpu_torch.utils import dump_yaml

DIM, N_FEATS, SEED = 8, 2, 3
POOL, STEPS, BATCH, INTERVAL = 1024, 12, 32, 4
STEP_DELAY = 0.15  # lets the flight polls (every 0.3 s) land before a kill
DONE_S = 120  # deadline of a supervised run


def chaos_schema():
    return EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{i}" for i in range(N_FEATS)], dim=DIM))


def global_config(tmp_path) -> str:
    """A PS of 100,000 rows in 4 shards (the default is 1e9 rows)."""
    path = os.fspath(tmp_path / "global.yml")
    dump_yaml({"embedding_parameter_server_config": {
        "capacity": 100_000, "num_hashmap_internal_shards": 4}}, path)
    return path


def expected_counts(pool, seed, steps, bs, n_feats, start=0):
    """Each sign's updates over steps [start, steps) of the stream."""
    expected = np.zeros(len(pool), np.int64)
    for k in range(start, steps):
        draws = ts.batch_draws(pool, seed, k, bs, n_feats)
        np.add.at(expected, np.searchsorted(pool, np.concatenate(draws)), 1)
    return expected


def applied_counts(worker, pool):
    return -worker.lookup_signs(pool, DIM).sum(axis=1) / DIM


def validate_postmortem(bundle, health_key="model_manager_status") -> int:
    """``bench.py``'s ``_validate_postmortem``: a trace with a parent ->
    child chain on one trace id and no orphan parent, the final health
    doc with ``health_key``, a parseable exposition. Returns the spans."""
    from persia_tpu_torch.metrics import parse_exposition

    with open(os.path.join(bundle, "trace.json")) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    assert xs, f"postmortem trace in {bundle} is empty"
    ids = {e["args"]["span_id"] for e in xs}
    assert all(not e["args"].get("parent_id") or e["args"]["parent_id"] in ids
               for e in xs), "orphan parents in the postmortem trace"
    children = [e for e in xs if e["args"].get("parent_id")]
    assert children, "no parent -> child chain in the postmortem trace"
    tid = children[0]["args"]["trace_id"]
    assert len([e for e in xs if e["args"]["trace_id"] == tid]) >= 2
    with open(os.path.join(bundle, "health.json")) as f:
        assert health_key in json.load(f)
    with open(os.path.join(bundle, "metrics.prom")) as f:
        samples, _ = parse_exposition(f.read())
    assert samples, "the last metrics snapshot is empty"
    return len(xs)


def arm(worker):
    worker.configure_parameter_servers(*ts.ARM_INIT)
    worker.register_optimizer(ts.ARM_OPT)


# --- the driver's stream and refusals ----------------------------------------


@pytest.mark.parametrize("pool_size", [1024, 2048, 8192])
def test_sign_pool_and_batch_draws_equal_jax(pool_size):
    from persia_tpu.service import trainer_service as jts

    pool = ts.sign_pool(pool_size)
    jpool = jts.sign_pool(pool_size)
    assert pool.dtype == jpool.dtype and np.array_equal(pool, jpool)
    for seed, step in ((3, 0), (3, 7), (11, 19)):
        got = ts.batch_draws(pool, seed, step, 64, 2)
        want = jts.batch_draws(jpool, seed, step, 64, 2)
        assert all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(got, want))
    assert ts.ARM_INIT == jts.ARM_INIT and ts.ARM_OPT == jts.ARM_OPT
    assert ts.DIE_POINTS == jts.DIE_POINTS


def test_driver_refusals():
    """CUDA without a card raises before anything is contacted (no
    silent CPU run); the rider needs --mesh and a step count the group
    divides, as in the JAX driver."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            ts.main(["--coordinator", "127.0.0.1:1", "--device", "cuda"])
    for argv in (["--dense-sync-every", "2"],
                 ["--mesh", "--dense-sync-every", "2", "--steps", "5",
                  "--process-count", "2"],
                 ["--process-index", "2", "--process-count", "2"]):
        with pytest.raises(SystemExit):
            ts.main(["--coordinator", "127.0.0.1:1", "--device", "cpu",
                     *argv])


# --- the flight recorder -----------------------------------------------------


def _flight_doc():
    """A sidecar's /flight document with a span chain, a span whose
    parent lives in another process, metrics, faults and environment."""
    span = {"service": "trainer", "pid": 4242, "tid": 7, "tags": {}}
    spans = [
        dict(span, name="trainer/step", trace_id="a1", span_id="s1",
             parent_id=None, start_ns=1_000, dur_ns=9_000),
        dict(span, name="trainer/lookup", trace_id="a1", span_id="s2",
             parent_id="s1", start_ns=2_000, dur_ns=3_000,
             tags={"rows": 64}),
        dict(span, name="rpc/update", trace_id="b2", span_id="s3",
             parent_id="remote9", start_ns=6_000, dur_ns=1_000),
    ]
    return {"t_wall": 1234.5, "service": "trainer", "pid": 4242,
            "version": "0.1.0",
            "health": {"model_manager_status": "Training", "step": 6},
            "metrics": "# TYPE trainer_step gauge\n"
                       "trainer_step{process=\"p0\"} 6\n",
            "spans": spans, "spans_dropped_total": 2,
            "faults": [{"site": "rpc.client.send", "action": "reset"}],
            "env": {"PERSIA_TRACING": "1"}}


def test_flight_recorder_bundle_equals_jax(tmp_path):
    from persia_tpu.fleet import FlightRecorder as JaxRecorder
    from persia_tpu_torch.fleet import FlightRecorder

    bundles = []
    for cls, name in ((FlightRecorder, "port"), (JaxRecorder, "jax")):
        rec = cls(os.fspath(tmp_path / name), per_service=2)
        assert rec.capture("trainer", "crash:rc=-9") is None  # unobserved
        rec.observe("trainer", {"spans": []})
        rec.observe("trainer", _flight_doc())
        rec.observe("worker0", {"spans": []})
        assert rec.last("trainer") == _flight_doc()
        bundles.append(rec.capture("trainer", "crash:rc=-9",
                                   extra={"restart_no": 1}))
        assert rec.captures == bundles[-1:]
    port, jax_ = bundles
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_)) == sorted([
        "flight.json", "health.json", "trace.json", "faults.json",
        "env.json", "reason.json", "metrics.prom"])
    assert os.path.basename(port).rsplit("_", 2)[0] == \
        os.path.basename(jax_).rsplit("_", 2)[0] == "postmortem_trainer"
    for name in sorted(os.listdir(port)):
        with open(os.path.join(port, name)) as a, \
                open(os.path.join(jax_, name)) as b:
            got, want = a.read(), b.read()
        if name == "reason.json":
            got, want = json.loads(got), json.loads(want)
            # the capture's own wall time is the one field that differs
            assert abs(got.pop("captured_at") - want.pop("captured_at")) < 60
        assert got == want, name
    with open(os.path.join(port, "trace.json")) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    promoted = [e for e in xs if e["name"] == "rpc/update"][0]["args"]
    assert promoted["parent_id"] is None
    assert promoted["remote_parent"] == "remote9"


# --- snapshot_job's hook and manifest ----------------------------------------


class _HealthClient:
    """A PS client as the watermark sees one: a health document."""

    def __init__(self, version):
        self.version = version

    def health(self):
        return {"update_version": self.version, "routing_epoch": None}


def _snapshot_workers():
    from persia_tpu.config import EmbeddingSchema as JSchema
    from persia_tpu.config import uniform_slots as juniform
    from persia_tpu.ps.store import EmbeddingHolder as JHolder
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    jw = JWorker(JSchema(slots_config=juniform(["slot_0"], dim=DIM)),
                 [JHolder(10_000, 2) for _ in range(2)])
    w = EmbeddingWorker(chaos_schema(),
                        [EmbeddingHolder(10_000, 2) for _ in range(2)])
    for x in (jw, w):
        arm(x)
    return jw, w


def _train(worker, signs):
    ref, out = worker.lookup_direct_training(
        [IDTypeFeature("slot_0", [np.asarray(signs, np.uint64)])])
    worker.update_gradients(ref, {k: np.ones_like(v.embeddings)
                                  for k, v in out.items()})


def test_snapshot_pre_manifest_extra_and_ps_clients(tmp_path):
    """``pre_manifest`` runs with every payload on disk and no manifest;
    ``extra`` joins the manifest; ``ps_clients`` give the watermarks. The
    manifest's keys and values equal the JAX package's (but the routing
    epoch the JAX worker stamps). A death inside the hook leaves a torn
    snapshot that is refused, and the resume falls back past it."""
    from persia_tpu import snapshot as jsnap

    jw, w = _snapshot_workers()
    clients = [_HealthClient(5), _HealthClient(9)]
    seen = {}
    manifests = []
    for mod, worker, name in ((snap_mod, w, "port"), (jsnap, jw, "jax")):
        _train(worker, [1, 2, 2])

        def hook(snap, name=name):
            seen[name] = sorted(os.listdir(snap))

        snap = mod.snapshot_job(
            os.fspath(tmp_path / name), worker, ps_clients=clients,
            cursor={"seed": 3, "consumed": 4}, step=4,
            extra={"job": "chaos", "incarnation": 2}, pre_manifest=hook)
        manifests.append(mod.load_manifest(snap))
    assert seen["port"] == seen["jax"]
    assert "manifest.json" not in seen["port"] and "cursor.json" in \
        seen["port"]
    port, jax_ = manifests
    assert set(port) == set(jax_)
    for k in sorted(set(port) - {"created", "files", "routing_epoch"}):
        assert port[k] == jax_[k], k
    assert set(port["files"]) == set(jax_["files"])
    assert port["job"] == "chaos" and port["incarnation"] == 2
    assert port["ps_watermarks"] == [
        {"update_version": 5, "routing_epoch": None},
        {"update_version": 9, "routing_epoch": None}]

    # a death inside the hook: the payloads are written, the manifest
    # never is
    class Died(Exception):
        pass

    def die(_snap):
        raise Died

    _train(w, [2, 7])
    with pytest.raises(Died):
        snap_mod.snapshot_job(os.fspath(tmp_path / "port"), w,
                              cursor={"seed": 3, "consumed": 8}, step=8,
                              pre_manifest=die)
    torn = os.fspath(tmp_path / "port" / "snap_000001")
    assert os.path.isdir(torn) and "cursor.json" in os.listdir(torn)
    with pytest.raises(snap_mod.SnapshotError):
        snap_mod.load_manifest(torn)
    found = snap_mod.latest_snapshot(os.fspath(tmp_path / "port"))
    assert os.path.basename(found[0]) == "snap_000000"
    snap_mod.restore_job(found[0], w)
    got = -w.lookup_signs(np.asarray([1, 2, 7], np.uint64), DIM).sum(1) / DIM
    np.testing.assert_array_equal(got, [1.0, 2.0, 0.0])


# --- chaos cells: the supervised trainer killed ------------------------------


@pytest.mark.parametrize("kind", ["mid_step", "mid_snapshot",
                                  "between_snapshots"])
def test_supervised_trainer_survives_a_kill(kind, tmp_path):
    """``bench.py``'s ``_chaos_job_trainer_cell`` at a small size on
    ``--device cpu``."""
    die_step = 2 * INTERVAL if kind == "mid_snapshot" else INTERVAL + 2
    snap_dir = os.fspath(tmp_path / "snapshots")
    result_file = os.fspath(tmp_path / "result.json")
    trainer_args = [
        "--num-workers", "1", "--steps", str(STEPS),
        "--batch-size", str(BATCH), "--n-feats", str(N_FEATS),
        "--seed", str(SEED), "--pool-size", str(POOL),
        "--snapshot-interval", str(INTERVAL),
        "--die-at", kind, "--die-step", str(die_step),
        "--result-file", result_file, "--step-delay", str(STEP_DELAY),
        "--device", "cpu"]
    with ServiceCtx(chaos_schema(), n_workers=1, n_ps=2,
                    global_config_path=global_config(tmp_path),
                    supervise_trainer=True, trainer_args=trainer_args,
                    snapshot_dir=snap_dir,
                    postmortem_dir=os.fspath(tmp_path / "postmortems"),
                    flight_interval=0.3,
                    env={"PERSIA_TRACING": "1",
                         "LOG_LEVEL": "WARNING"}) as svc:
        assert svc.wait_trainer_done(timeout=DONE_S) == 0
        events = list(svc.trainer_recoveries)
        assert len(events) == 1, events  # one kill, one recovery
        assert validate_postmortem(events[0]["postmortem"]) >= 2
        with open(os.path.join(snap_dir, f".die_{kind}_{die_step}")) as f:
            t_kill = float(f.read())
        assert t_kill <= events[0]["t_detected"] <= events[0]["t_respawned"]
        with open(result_file) as f:
            result = json.load(f)
        assert result["steps"] == STEPS
        assert result["device"] == "cpu"
        assert result["resumed_from"] == "snap_000000", result
        assert events[0]["t_respawned"] < result["t_first_step"]
        pool = ts.sign_pool(POOL)
        np.testing.assert_array_equal(
            applied_counts(svc.remote_worker(), pool),
            expected_counts(pool, SEED, STEPS, BATCH, N_FEATS))
        complete = []
        for p in snap_mod.list_snapshots(snap_dir):
            try:
                snap_mod.load_manifest(p)
                complete.append(p)
            except snap_mod.SnapshotError:
                pass
        assert 1 <= len(complete) <= knobs.get("PERSIA_SNAPSHOT_KEEP")
        assert not svc.crashed


def test_torn_manifest_falls_back(tmp_path):
    """``bench.py``'s ``_chaos_job_torn_cell``: a manifest-listed payload
    of the newest snapshot is torn and a manifest-less directory is newer
    still; verification refuses the first, the fallback skips both, and
    restoring it rolls the PS processes back to its exact cut."""
    pool = ts.sign_pool(POOL)
    seed = 11
    snap_dir = os.fspath(tmp_path / "snapshots")
    with ServiceCtx(chaos_schema(), n_workers=1, n_ps=2,
                    global_config_path=global_config(tmp_path),
                    env={"LOG_LEVEL": "WARNING"}) as svc:
        w = svc.remote_worker()
        arm(w)

        def train(k0, k1):
            for k in range(k0, k1):
                feats = [IDTypeFeature(f"slot_{i}", [d]) for i, d in
                         enumerate(ts.batch_draws(pool, seed, k, BATCH,
                                                  N_FEATS))]
                ref, out = w.lookup_direct_training(feats)
                w.update_gradients(ref, {k2: np.ones_like(v.embeddings)
                                         for k2, v in out.items()})

        train(0, 4)
        snap1 = snap_mod.snapshot_job(
            snap_dir, w, cursor={"seed": seed, "consumed": 4}, step=4)
        train(4, 8)
        snap2 = snap_mod.snapshot_job(
            snap_dir, w, cursor={"seed": seed, "consumed": 8}, step=8)
        victim = sorted(snap_mod.load_manifest(snap2)["files"])[0]
        with open(os.path.join(snap2, victim), "wb") as f:
            f.write(b"torn")
        with pytest.raises(snap_mod.SnapshotError):
            snap_mod.load_manifest(snap2)
        os.makedirs(os.path.join(snap_dir, "snap_000099"))
        found = snap_mod.latest_snapshot(snap_dir)
        assert found is not None and found[0] == snap1
        snap_mod.restore_job(found[0], w)
        np.testing.assert_array_equal(
            applied_counts(w, pool),
            expected_counts(pool, seed, 4, BATCH, N_FEATS))
        w.close()
        assert not svc.crashed
