"""The port's job snapshots (``persia_tpu_torch.snapshot``) on the CPU:
every case of the JAX package's ``tests/test_snapshot.py`` run against
the port (manifest completeness, torn refusal with fallback, retention,
resolve and restore, the fsynced manifest), the manifest's keys against
the JAX manifest's, and ``TrainCtx(resume_from=)``: a seq_rec run
snapshotted halfway and resumed by a fresh stack equals the unbroken run
bit for bit (losses, dense parameters, PS rows), synchronous and through
the reproducible ``DataLoader``, with the spill tier armed and the PS
capacity cut below the rows the run touches.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from persia_tpu_torch import snapshot as snap_mod
from persia_tpu_torch import storage as tstorage
from persia_tpu_torch.checkpoint import iter_psd_entries
from persia_tpu_torch.config import EmbeddingSchema, SlotConfig
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.data.dataloader import DataLoader, ResumableDataset
from persia_tpu_torch.ps.native import make_holder
from persia_tpu_torch.ps.spill import SpillStore
from persia_tpu_torch.ps.store import EmbeddingHolder
from persia_tpu_torch.snapshot import (
    SnapshotError,
    gc_snapshots,
    latest_snapshot,
    list_snapshots,
    load_manifest,
    resolve_snapshot,
    restore_job,
    snapshot_job,
)
from persia_tpu_torch.worker.worker import EmbeddingWorker
from test_torch_pipeline import (
    HEADS,
    NUM_DENSE,
    SLOTS,
    _batches,
    _seq_schema,
)

DIM = 4


def _counting_worker(n_ps=2):
    """Zero init, SGD lr 1 and unit gradients: a row's value is minus the
    times it was trained, so equality checks are exact."""
    schema = EmbeddingSchema(slots_config={
        "clicks": SlotConfig(name="clicks", dim=DIM),
    })
    clients = [EmbeddingHolder(capacity=10_000, num_internal_shards=2)
               for _ in range(n_ps)]
    w = EmbeddingWorker(schema, clients)
    w.configure_parameter_servers(
        "bounded_uniform", {"lower": 0.0, "upper": 0.0}, 1.0, 1e9)
    w.register_optimizer({"type": "sgd", "lr": 1.0, "wd": 0.0})
    return w


def _train(worker, signs):
    ref, out = worker.lookup_direct_training(
        [IDTypeFeature("clicks", [np.asarray(signs, np.uint64)])])
    worker.update_gradients(ref, {
        k: np.ones_like(v.embeddings) for k, v in out.items()})


def _counts(worker, signs):
    rows = worker.lookup_signs(np.asarray(signs, np.uint64), DIM)
    return -rows.sum(axis=1) / DIM


def test_snapshot_complete_round_trip(tmp_path):
    w = _counting_worker()
    _train(w, [3, 5, 5, 9])
    cursor = {"seed": 7, "consumed": 1}
    snap = snapshot_job(str(tmp_path), w, cursor=cursor, step=1)
    assert os.path.basename(snap) == "snap_000000"
    manifest = load_manifest(snap)
    assert manifest["step"] == 1
    assert manifest["cursor"] == cursor
    assert manifest["num_shards"] == 2
    assert "manifest.json" not in manifest["files"]
    assert "cursor.json" in manifest["files"]
    assert snap_mod.load_cursor(snap) == cursor
    _train(w, [3, 3, 11])
    got = restore_job(snap, w)
    assert got["seq"] == manifest["seq"]
    np.testing.assert_allclose(_counts(w, [3, 5, 9, 11]),
                               [1.0, 2.0, 1.0, 0.0], atol=1e-6)


def test_manifest_keys_equal_the_jax_manifest(tmp_path):
    from persia_tpu import snapshot as jsnap
    from persia_tpu.config import EmbeddingSchema as JSchema
    from persia_tpu.config import SlotConfig as JSlot
    from persia_tpu.ps.store import EmbeddingHolder as JHolder
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    jw = JWorker(JSchema(slots_config={"clicks": JSlot(name="clicks",
                                                       dim=DIM)}),
                 [JHolder(10_000, 2) for _ in range(2)])
    jw.configure_parameter_servers(
        "bounded_uniform", {"lower": 0.0, "upper": 0.0}, 1.0, 1e9)
    jw.register_optimizer({"type": "sgd", "lr": 1.0, "wd": 0.0})
    w = _counting_worker()
    cursor = {"seed": 1, "consumed": 2}
    jm = load_manifest(jsnap.snapshot_job(str(tmp_path / "jax"), jw,
                                          cursor=cursor, step=2))
    tm = load_manifest(snapshot_job(str(tmp_path / "port"), w,
                                    cursor=cursor, step=2))
    assert set(tm) == set(jm)
    assert set(tm["files"]) == set(jm["files"])
    for k in ("version", "seq", "step", "cursor", "num_shards", "routing",
              "ps_watermarks", "inc_watermark"):
        assert tm[k] == jm[k], k
    # the JAX worker stamps its routing epoch; the port has no live
    # routing
    assert tm["routing_epoch"] is None
    with pytest.raises(NotImplementedError, match="item 6"):
        snapshot_job(str(tmp_path / "inc"), w, inc_dir=str(tmp_path))
    assert not os.path.exists(tmp_path / "inc")


def test_torn_snapshot_refused_and_fallback(tmp_path):
    w = _counting_worker()
    _train(w, [1, 2])
    good = snapshot_job(str(tmp_path), w, cursor={"seed": 1, "consumed": 1},
                        step=1)
    _train(w, [2, 4])
    torn = snapshot_job(str(tmp_path), w, cursor={"seed": 1, "consumed": 2},
                        step=2)
    victim = sorted(load_manifest(torn)["files"])[0]
    with open(os.path.join(torn, victim), "wb") as f:
        f.write(b"torn")
    with pytest.raises(SnapshotError, match="torn write|checksum"):
        load_manifest(torn)
    os.makedirs(os.path.join(str(tmp_path), "snap_000099"))
    found = latest_snapshot(str(tmp_path))
    assert found is not None
    path, manifest = found
    assert path == good
    assert manifest["step"] == 1


def test_latest_snapshot_cold_start_and_missing_dir(tmp_path):
    assert latest_snapshot(str(tmp_path / "nope")) is None
    assert latest_snapshot(str(tmp_path)) is None
    with pytest.raises(SnapshotError, match="no complete snapshot"):
        resolve_snapshot(str(tmp_path))


def test_manifest_missing_file_refused(tmp_path):
    w = _counting_worker()
    _train(w, [1])
    snap = snapshot_job(str(tmp_path), w, cursor={"seed": 0, "consumed": 0})
    victim = sorted(load_manifest(snap)["files"])[0]
    os.remove(os.path.join(snap, victim))
    with pytest.raises(SnapshotError, match="missing"):
        load_manifest(snap)


def test_gc_retention_keeps_newest_completes(tmp_path):
    w = _counting_worker()
    for k in range(5):
        _train(w, [k + 1])
        snapshot_job(str(tmp_path), w, cursor={"seed": 0, "consumed": k},
                     step=k, keep=2)
    names = [os.path.basename(p) for p in list_snapshots(str(tmp_path))]
    assert names == ["snap_000003", "snap_000004"]
    nxt = snapshot_job(str(tmp_path), w, cursor={"seed": 0, "consumed": 5},
                       keep=2)
    assert os.path.basename(nxt) == "snap_000005"


def test_gc_keep_follows_the_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("PERSIA_SNAPSHOT_KEEP", "1")
    w = _counting_worker()
    for k in range(3):
        snapshot_job(str(tmp_path), w, cursor={"seed": 0, "consumed": k})
    names = [os.path.basename(p) for p in list_snapshots(str(tmp_path))]
    assert names == ["snap_000002"]


def test_gc_spares_torn_newer_than_newest_complete(tmp_path):
    w = _counting_worker()
    _train(w, [1])
    os.makedirs(os.path.join(str(tmp_path), "snap_000000"))
    with open(os.path.join(str(tmp_path), "snap_000000", "junk"), "wb") as f:
        f.write(b"x")
    snapshot_job(str(tmp_path), w, cursor={"seed": 0, "consumed": 0},
                 keep=3)
    names = [os.path.basename(p) for p in list_snapshots(str(tmp_path))]
    assert names == ["snap_000001"]
    in_progress = os.path.join(str(tmp_path), "snap_000002")
    os.makedirs(in_progress)
    assert gc_snapshots(str(tmp_path), keep=3) == []
    assert os.path.isdir(in_progress)


def test_resolve_snapshot_parent_vs_direct(tmp_path):
    w = _counting_worker()
    _train(w, [1])
    first = snapshot_job(str(tmp_path), w, cursor={"seed": 0, "consumed": 1})
    _train(w, [2])
    second = snapshot_job(str(tmp_path), w, cursor={"seed": 0, "consumed": 2})
    assert resolve_snapshot(str(tmp_path))[0] == second
    assert resolve_snapshot(first)[1]["cursor"]["consumed"] == 1


def test_manifest_tamper_detected(tmp_path):
    w = _counting_worker()
    _train(w, [1])
    snap = snapshot_job(str(tmp_path), w, cursor={"seed": 0, "consumed": 0})
    victim = sorted(load_manifest(snap)["files"])[0]
    path = os.path.join(snap, victim)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:  # same size, other bytes
        f.seek(max(0, size - 1))
        last = f.read(1)
        f.seek(max(0, size - 1))
        f.write(bytes([last[0] ^ 0xFF]))
    with pytest.raises(SnapshotError, match="checksum"):
        load_manifest(snap)


def test_restore_onto_wider_fleet(tmp_path):
    w2 = _counting_worker(n_ps=2)
    _train(w2, [3, 5, 5, 9])
    snap = snapshot_job(str(tmp_path), w2, cursor={"seed": 0, "consumed": 1})
    w3 = _counting_worker(n_ps=3)
    restore_job(snap, w3)
    np.testing.assert_allclose(_counts(w3, [3, 5, 9]), [1.0, 2.0, 1.0],
                               atol=1e-6)


def test_snapshot_manifest_is_fsynced_atomic(tmp_path, monkeypatch):
    synced = []
    real = os.fsync
    monkeypatch.setattr(tstorage.os, "fsync",
                        lambda fd: (synced.append(fd), real(fd)))
    w = _counting_worker()
    _train(w, [1])
    snap = snapshot_job(str(tmp_path), w, cursor={"seed": 0, "consumed": 0})
    assert len(synced) >= 2
    assert not os.path.exists(os.path.join(snap, "manifest.json.tmp"))
    load_manifest(snap)


# --- TrainCtx(resume_from=) -------------------------------------------------

N = 5  # steps before the snapshot; the run is 2 N steps
SEED = 9
# the run touches ~700 rows over both replicas; 160 rows a replica keep
# under half of them resident
CAPACITY = 160


@pytest.fixture
def deterministic_torch():
    """The gradient of the tower's raw-slot gather (``index_put_`` with
    accumulate on a CPU tensor) sums repeated rows in a thread-dependent
    order unless deterministic algorithms are on; the bit-for-bit gates
    need them."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _seq_ctx(holders=None, resume_from=None, seed=3):
    """A seeded f32 seq tower (flash attention, f32 wire) over two PS
    replicas, by default fresh arena holders."""
    from persia_tpu_torch import config as tcfg
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import SequenceTower

    model = SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                          attn_impl="flash", device="cpu",
                          compute_dtype=torch.float32)
    schema = _seq_schema(tcfg)
    worker = EmbeddingWorker(schema, holders or [
        make_holder(100_000, 4, backend="arena") for _ in range(2)])
    return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                    Adagrad(lr=1e-2), schema, worker, seed=seed,
                    embedding_config=EmbeddingConfig(
                        emb_initialization=(-0.05, 0.05)),
                    global_config=tcfg.GlobalConfig(tcfg.CommonConfig("f32")),
                    device="cpu", resume_from=resume_from)


def _stack(tmp_path, tag, backend, resume_from=None):
    """A fresh stack: new spill-armed holders with the capacity cut, in
    spill directories of their own, a fresh model and optimizer."""
    holders = [make_holder(CAPACITY, 4, backend=backend, hotness=True,
                           spill_dir=str(tmp_path / f"{tag}_spill_{i}"))
               for i in range(2)]
    return _seq_ctx(holders, resume_from=resume_from)


def _factory(n):
    return lambda seed: itertools.islice(_batches(2 * N, seed=seed), n)


def _ps_map(ctx, tmp_path, tag):
    """(replica, sign) -> logical row bytes over resident and spilled
    rows, from a dump of each replica."""
    out = {}
    for r, h in enumerate(ctx.worker.ps_clients):
        path = str(tmp_path / f"{tag}_{r}.psd")
        h.dump_file(path)
        for sign, _dim, vec in iter_psd_entries(path):
            assert (r, sign) not in out
            out[(r, sign)] = vec.tobytes()
    return out


def _train_steps(ctx, dataset, pipelined):
    if not pipelined:
        return [float(ctx.train_step(b)[0]) for b in dataset]
    loader = DataLoader(dataset, num_workers=2, reproducible=True,
                        embedding_staleness=1)
    losses = [float(ctx.train_step(lb)[0]) for lb in loader]
    loader._engine.shutdown()
    return losses


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["synchronous", "pipelined"])
@pytest.mark.parametrize("backend", ["native", "arena"])
def test_resumed_run_equals_the_unbroken_run(backend, pipelined, tmp_path,
                                             deterministic_torch,
                                             monkeypatch):
    # small packets, so spilled rows reach the disk and fault back in
    # from there
    monkeypatch.setattr(SpillStore, "PACKET_BYTES", 4096)
    straight = _stack(tmp_path, "a", backend)
    with straight:
        losses_a = _train_steps(
            straight, ResumableDataset(_factory(2 * N), seed=SEED),
            pipelined)
    assert len(losses_a) == 2 * N

    first = _stack(tmp_path, "b", backend)
    ds = ResumableDataset(_factory(N), seed=SEED)
    with first:
        losses_b = _train_steps(first, ds, pipelined)
        snap = first.snapshot(str(tmp_path / "snaps"), cursor=ds.cursor(N))
    first.worker.close()
    assert losses_b == losses_a[:N]
    manifest = load_manifest(snap)
    assert manifest["step"] == N and manifest["cursor"] == {
        "seed": SEED, "consumed": N}
    assert "dense.pt" in manifest["files"]

    resumed = _stack(tmp_path, "c", backend,
                     resume_from=str(tmp_path / "snaps"))
    assert resumed.resume_cursor == manifest["cursor"]
    with resumed:
        assert resumed._step_count == N
        ds2 = ResumableDataset.from_cursor(_factory(2 * N),
                                           resumed.resume_cursor)
        losses_c = _train_steps(resumed, ds2, pipelined)
    assert resumed._step_count == 2 * N
    assert losses_c == losses_a[N:]
    for (name, p), (_, q) in zip(straight.model.state_dict().items(),
                                 resumed.model.state_dict().items()):
        assert torch.equal(p, q), name
    want = _ps_map(straight, tmp_path, "a")
    assert _ps_map(resumed, tmp_path, "c") == want
    for ctx in (straight, resumed):
        stats = [h.spill_stats() for h in ctx.worker.ps_clients]
        assert all(s["spilled_rows_total"] > 0 for s in stats), stats
        assert all(s["spill_fault_ins_total"] > 0 for s in stats), stats
        assert all(s["spill_packets"] > 0 for s in stats), stats
        assert all(h.hotness_snapshot()["total"] > 0
                   for h in ctx.worker.ps_clients)
    # the rows the run touched outnumber what the replicas keep resident
    assert len(want) > 2 * 2 * CAPACITY


def test_resume_from_a_torn_or_absent_snapshot_fails_at_construction(
        tmp_path):
    with pytest.raises(SnapshotError, match="no complete snapshot"):
        _seq_ctx(resume_from=str(tmp_path))
    ctx = _seq_ctx()
    with ctx:
        ctx.train_step(next(iter(_batches(1))))
        snap = ctx.snapshot(str(tmp_path), cursor={"seed": 0,
                                                   "consumed": 1})
    os.remove(os.path.join(snap, "dense.pt"))
    with pytest.raises(SnapshotError, match="missing"):
        _seq_ctx(resume_from=snap)
