"""The port's incremental-update tier against the JAX package's, on the
CPU.

Host code throughout, so the tolerance is bit-equality:

- packets cross both ways: a JAX dumper's packets load through the
  port's loader into a port holder equal to the JAX loader into a JAX
  holder, and a port dumper writes the JAX dumper's bytes, which JAX's
  ``iter_psd_entries`` and loader read back; for fp32 (PSD v1) and fp16
  / bf16 (v2) rows, on the native, arena and per-entry holders;
- packet names, ``ready_packets`` order and the done-marker rule, the
  JAX ``tests/test_checkpoint.py:88`` round trip;
- the PS hooks: ``PsService(inc_dumper=)`` commits on every write path
  as the JAX service does, the health keys of ``inc_loader=``,
  ``restore(replay_inc_dir=)`` with and without a routing table;
- ``ServiceCtx(ps_inc_dir=)``: a supervised PS killed mid-training comes
  back with its checkpoint plus its packets, exactly (the JAX
  ``tests/test_faults.py:488``);
- ``snapshot_job(inc_dir=)``'s watermark against the JAX manifest's.
"""

import os
import re
import threading
import time

import numpy as np
import pytest

from persia_tpu_torch.checkpoint import iter_psd_entries
from persia_tpu_torch.inc_update import (
    DONE_MARKER,
    IncrementalUpdateDumper,
    IncrementalUpdateLoader,
    packet_files,
    ready_packets,
)
from persia_tpu_torch.ps.native import make_holder

DIM = 8
ADAGRAD = {"type": "adagrad", "lr": 0.05, "wd": 0.0,
           "g_square_momentum": 1.0, "initialization": 0.01, "eps": 1e-10,
           "vectorwise_shared": False}
INIT = ("bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0, True)
CASES = [pytest.param(b, d, id=f"{b}-{d}")
         for b in ("native", "arena") for d in ("fp32", "fp16", "bf16")] \
    + [pytest.param("python-legacy", "fp32", id="python-legacy-fp32")]


def _jax_holder(backend, row_dtype):
    from persia_tpu.ps import native as jnative

    return jnative.make_holder(100_000, 4, backend=backend,
                               row_dtype=row_dtype)


def _port_holder(backend, row_dtype):
    return make_holder(100_000, 4, backend=backend, row_dtype=row_dtype)


def _train(holder, seed, steps=3):
    """Arm ``holder`` and train it on seeded mixed-dim traffic; returns
    the signs touched."""
    holder.configure(*INIT)
    holder.register_optimizer(ADAGRAD)
    rng = np.random.default_rng(seed)
    touched = []
    for _ in range(steps):
        for lo, dim in ((1, DIM), (5000, 4)):
            signs = np.unique(rng.integers(lo, lo + 4999, 300,
                                           dtype=np.uint64))
            holder.lookup(signs, dim, True)
            holder.update_gradients(signs, rng.standard_normal(
                (len(signs), dim)).astype(np.float32), dim)
            touched.append(signs)
    return touched


def _rows(holder, signs):
    out = {}
    for s in signs:
        e = holder.get_entry(int(s))
        out[int(s)] = None if e is None else (e[0], e[1].tobytes())
    return out


def _inc_bytes(inc_dir):
    """Every packet's ``.inc`` files, in name order: (seq-and-replica
    part of the name, file bytes)."""
    out = []
    for name, pkt, _ in ready_packets(inc_dir, set()):
        for _src, path in packet_files(pkt):
            with open(path, "rb") as f:
                out.append(("_".join(name.split("_")[2:4]), f.read()))
    return out


def _dump(dumper_cls, holder, inc_dir, touched, replica=0):
    d = dumper_cls(holder, inc_dir, buffer_size=250, replica_index=replica)
    for signs in touched:
        d.commit(signs)
    d.flush()
    return d


# --- packets across the packages ---------------------------------------------


@pytest.mark.parametrize("backend,row_dtype", CASES)
def test_jax_packets_load_into_the_port(backend, row_dtype, tmp_path):
    from persia_tpu.inc_update import IncrementalUpdateDumper as JDumper
    from persia_tpu.inc_update import IncrementalUpdateLoader as JLoader

    jtrain = _jax_holder(backend, row_dtype)
    touched = _train(jtrain, 0)
    inc = os.fspath(tmp_path / "inc")
    _dump(JDumper, jtrain, inc, touched)
    signs = np.unique(np.concatenate(touched))
    mine, ref = _port_holder(backend, row_dtype), \
        _jax_holder(backend, row_dtype)
    n = IncrementalUpdateLoader(mine, inc).scan_once()
    # a sign in several packets counts once a packet
    assert n == JLoader(ref, inc).scan_once() >= len(signs)
    assert _rows(mine, signs) == _rows(ref, signs) == _rows(jtrain, signs)


@pytest.mark.parametrize("backend,row_dtype", CASES)
def test_port_packets_are_the_jax_dumpers_bytes(backend, row_dtype,
                                                tmp_path):
    """The two packages' holders trained alike hold the same rows, so
    their dumpers must write the same packet files, which JAX's
    ``iter_psd_entries`` and loader read back into the trained rows."""
    from persia_tpu.checkpoint import iter_psd_entries as jiter
    from persia_tpu.inc_update import IncrementalUpdateDumper as JDumper
    from persia_tpu.inc_update import IncrementalUpdateLoader as JLoader

    train, jtrain = _port_holder(backend, row_dtype), \
        _jax_holder(backend, row_dtype)
    touched = _train(train, 1)
    assert _train(jtrain, 1)
    signs = np.unique(np.concatenate(touched))
    assert _rows(train, signs) == _rows(jtrain, signs)
    mine, ref = os.fspath(tmp_path / "port"), os.fspath(tmp_path / "jax")
    _dump(IncrementalUpdateDumper, train, mine, touched, replica=1)
    _dump(JDumper, jtrain, ref, touched, replica=1)
    files = _inc_bytes(mine)
    assert len(files) > 1 and files == _inc_bytes(ref)
    version = int.from_bytes(files[0][1][4:8], "little")
    assert version == (1 if row_dtype == "fp32" else 2)
    for name, pkt, _ in ready_packets(mine, set()):
        for _src, path in packet_files(pkt):
            got = [(s, d, v.tobytes()) for s, d, v in jiter(path)]
            assert got == [(s, d, v.tobytes())
                           for s, d, v in iter_psd_entries(path)]
    loaded = _jax_holder(backend, row_dtype)
    assert JLoader(loaded, mine).scan_once() >= len(signs)
    assert _rows(loaded, signs) == _rows(train, signs)


# --- names, order, visibility ------------------------------------------------


def test_packet_names_order_and_done_marker(tmp_path):
    from persia_tpu.inc_update import packet_files as jfiles
    from persia_tpu.inc_update import ready_packets as jready

    h = _port_holder("arena", "fp32")
    touched = _train(h, 2, steps=1)
    inc = os.fspath(tmp_path)
    d = IncrementalUpdateDumper(h, inc, buffer_size=1, replica_index=3)
    for signs in touched:
        d.commit(signs)
    names = sorted(os.listdir(inc))
    assert len(names) == len(touched)
    pat = re.compile(rf"inc_\d{{14}}_(\d{{6}})_r3_p{os.getpid()}$")
    assert [int(pat.match(n).group(1)) for n in names] == [1, 2]
    assert all(packet_files(os.path.join(inc, n))
               == [(3, os.path.join(inc, n, "3.inc"))] for n in names)
    # debris no consumer may see: an unrenamed packet, a packet without
    # its marker, a directory that is no packet, a file of no replica
    os.makedirs(os.path.join(inc, "inc_00000000000000_000009_r0_p1.tmp"))
    os.makedirs(os.path.join(inc, "inc_00000000000000_000008_r0_p1"))
    os.makedirs(os.path.join(inc, "zz_" + names[0]))
    with open(os.path.join(inc, "zz_" + names[0], DONE_MARKER), "w") as f:
        f.write("{}")
    open(os.path.join(inc, names[0], "notes.inc"), "w").close()
    got = [(n, p, i) for n, p, i in ready_packets(inc, set())]
    assert [n for n, _, _ in got] == names
    assert got == list(jready(inc, set()))
    assert [n for n, _, _ in ready_packets(inc, {names[0]})] == names[1:]
    for _, p, info in got:
        assert packet_files(p) == jfiles(p)
        assert set(info) == {"count", "time"}
    assert list(ready_packets(os.fspath(tmp_path / "absent"), set())) == []


def test_concurrent_flushes_never_share_a_name(tmp_path):
    h = _port_holder("arena", "fp32")
    _train(h, 3, steps=1)
    d = IncrementalUpdateDumper(h, os.fspath(tmp_path), buffer_size=1)
    threads = [threading.Thread(target=lambda k=k: [
        d.commit(np.array([1 + k * 100 + i], np.uint64)) for i in range(25)])
        for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    names = list(ready_packets(os.fspath(tmp_path), set()))
    assert len(names) == 100
    assert sorted(int(n.split("_")[2]) for n, _, _ in names) \
        == list(range(1, 101))


def test_incremental_update_roundtrip(tmp_path):
    """``tests/test_checkpoint.py:88`` on the port."""
    from persia_tpu_torch.ps.store import EmbeddingHolder

    def holder():
        h = EmbeddingHolder(capacity=10_000, num_internal_shards=2)
        h.configure("bounded_uniform", {"lower": -0.1, "upper": 0.1})
        h.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})
        return h

    train_h = holder()
    signs = np.arange(1, 50, dtype=np.uint64)
    train_h.lookup(signs, 4, training=True)
    train_h.update_gradients(signs, np.ones((49, 4), np.float32), 4)
    dumper = IncrementalUpdateDumper(train_h, str(tmp_path / "inc"),
                                     buffer_size=10)
    dumper.commit(signs)  # past the buffer size: flushes itself
    dumper.flush()
    infer_h = holder()
    loader = IncrementalUpdateLoader(infer_h, str(tmp_path / "inc"))
    assert loader.scan_once() == 49
    for s in signs[:5]:
        np.testing.assert_array_equal(infer_h.get_entry(int(s))[1],
                                      train_h.get_entry(int(s))[1])
    assert loader.scan_once() == 0  # idempotent
    assert loader.packets_applied == 1
    assert loader.sec_since_last_apply < 5.0


def test_loader_replica_and_routing_filters_match_jax(tmp_path):
    from persia_tpu.inc_update import IncrementalUpdateLoader as JLoader
    from persia_tpu.routing import RoutingTable as JTable

    from persia_tpu_torch.routing import RoutingTable

    inc = os.fspath(tmp_path)
    for r in range(2):
        h = _port_holder("arena", "fp32")
        touched = _train(h, 10 + r, steps=1)
        _dump(IncrementalUpdateDumper, h, inc, touched, replica=r)
    for kw in ({"replica_index": 1}, {"replica_index": 0},
               {"replica_index": 2, "routing": 3}):
        jkw = dict(kw)
        if "routing" in kw:
            kw["routing"] = RoutingTable.uniform(3)
            jkw["routing"] = JTable.uniform(3)
        mine, ref = _port_holder("arena", "fp32"), _jax_holder("arena",
                                                               "fp32")
        n = IncrementalUpdateLoader(mine, inc, **kw).scan_once()
        assert n > 0 and n == JLoader(ref, inc, **jkw).scan_once()
        signs = np.arange(1, 10_000, dtype=np.uint64)
        assert _rows(mine, signs) == _rows(ref, signs)
    with pytest.raises(ValueError, match="replica_index"):
        IncrementalUpdateLoader(mine, inc, routing=RoutingTable.uniform(2))


def test_loader_thread_and_registry_series(tmp_path):
    from persia_tpu_torch.metrics import default_registry

    h = _port_holder("arena", "fp32")
    touched = _train(h, 4, steps=1)
    infer = _port_holder("arena", "fp32")
    loader = IncrementalUpdateLoader(infer, os.fspath(tmp_path),
                                     scan_interval_sec=0.05)
    before = default_registry().counter(
        "inc_update_packets_applied_total").value
    loader.start()
    try:
        _dump(IncrementalUpdateDumper, h, os.fspath(tmp_path), touched)
        deadline = time.monotonic() + 10
        while loader.packets_applied < 2:
            assert time.monotonic() < deadline
            time.sleep(0.02)
    finally:
        loader.stop()
    assert not loader._thread.is_alive()
    assert default_registry().counter(
        "inc_update_packets_applied_total").value - before == 2
    text = default_registry().render()
    for series in ("inc_update_last_delay_sec",
                   "inc_update_sec_since_last_apply",
                   "inc_update_freshness_lag_sec_bucket",
                   "inc_update_packet_entries_bucket",
                   "inc_update_entries_applied_total"):
        assert series in text


# --- the PS hooks ------------------------------------------------------------


def _drive_ps(client, dim, rng):
    """Every write path of a PS replica: gradient updates, one full-row
    set, a batched set."""
    signs = np.unique(rng.integers(1, 3000, 64, dtype=np.uint64))
    client.lookup(signs, dim, True)
    client.update_gradients(signs, rng.standard_normal(
        (len(signs), dim)).astype(np.float32), dim)
    client.set_entry(7, dim, np.arange(2 * dim, dtype=np.float32))
    more = np.arange(9000, 9010, dtype=np.uint64)
    client.set_entries(more, dim, np.ones((10, 2 * dim), np.float32))


def test_ps_service_commits_every_write_path_as_jax(tmp_path):
    from persia_tpu.inc_update import IncrementalUpdateDumper as JDumper
    from persia_tpu.service.ps_service import PsClient as JClient
    from persia_tpu.service.ps_service import PsService as JService

    from persia_tpu_torch.service.ps_service import PsClient, PsService

    out = {}
    for tag, svc_cls, cli_cls, dumper_cls, holder in (
            ("port", PsService, PsClient, IncrementalUpdateDumper,
             _port_holder("arena", "fp32")),
            ("jax", JService, JClient, JDumper,
             _jax_holder("arena", "fp32"))):
        inc = os.fspath(tmp_path / tag)
        dumper = dumper_cls(holder, inc, buffer_size=1, replica_index=0)
        svc = svc_cls(holder, inc_dumper=dumper)
        svc.server.serve_background()
        try:
            c = cli_cls(svc.addr)
            c.configure(*INIT)
            c.register_optimizer(ADAGRAD)
            _drive_ps(c, 4, np.random.default_rng(5))
            c.client.close()
        finally:
            svc.stop()
        out[tag] = _inc_bytes(inc)
    # a packet for each of the three writes (the lookup writes none)
    assert len(out["port"]) == 3 and out["port"] == out["jax"]


def test_ps_health_keys_with_a_loader_equal_jax(tmp_path):
    from persia_tpu.inc_update import IncrementalUpdateLoader as JLoader
    from persia_tpu.service.ps_service import PsService as JService

    from persia_tpu_torch.service.ps_service import PsService

    h = _port_holder("arena", "fp32")
    _dump(IncrementalUpdateDumper, h, os.fspath(tmp_path),
          _train(h, 6, steps=1))
    docs = {}
    for tag, svc_cls, loader_cls, holder in (
            ("port", PsService, IncrementalUpdateLoader,
             _port_holder("arena", "fp32")),
            ("jax", JService, JLoader, _jax_holder("arena", "fp32"))):
        loader = loader_cls(holder, os.fspath(tmp_path))
        loader.scan_once()
        svc = svc_cls(holder, inc_loader=loader)
        docs[tag] = svc._health()
        svc.stop()
    keys = ("inc_update_last_delay_sec", "inc_update_sec_since_last_apply",
            "inc_update_packets_applied")
    for tag in docs:
        assert all(k in docs[tag] for k in keys)
    assert docs["port"]["inc_update_packets_applied"] == \
        docs["jax"]["inc_update_packets_applied"] == 2


@pytest.mark.parametrize("routed", [False, True], ids=["replica", "routed"])
def test_restore_replays_packets_over_the_checkpoint(routed, tmp_path):
    """``restore(checkpoint, replay_inc_dir)`` against the JAX service's
    on the same files: the checkpoint, then the replica's packets (or,
    routed, every row the table sends it)."""
    from persia_tpu.routing import RoutingTable as JTable
    from persia_tpu.service.ps_service import PsService as JService

    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service.ps_service import PsService

    h = _port_holder("arena", "fp32")
    touched = _train(h, 7, steps=2)
    ckpt = os.fspath(tmp_path / "replica_1.psd")
    h.dump_file(ckpt)
    inc = os.fspath(tmp_path / "inc")
    more = _train(h, 8, steps=1)  # re-arms: the same optimizer
    _dump(IncrementalUpdateDumper, h, inc, more, replica=1)
    other = _port_holder("arena", "fp32")
    _dump(IncrementalUpdateDumper, other, inc, _train(other, 9, steps=1),
          replica=0)
    kw, jkw = {"replica_index": 1}, {"replica_index": 1}
    if routed:
        kw["routing"], jkw["routing"] = RoutingTable.uniform(3), \
            JTable.uniform(3)
    mine = PsService(_port_holder("arena", "fp32"))
    ref = JService(_jax_holder("arena", "fp32"))
    try:
        n = mine.restore(ckpt, inc, **kw)
        assert n > 0 and n == ref.restore(ckpt, inc, **jkw)
        assert mine.status == "Idle"
        signs = np.arange(1, 10_000, dtype=np.uint64)
        assert _rows(mine.holder, signs) == _rows(ref.holder, signs)
        if not routed:
            assert _rows(mine.holder, signs) == _rows(h, signs)
    finally:
        mine.stop()
        ref.stop()
    # a failed restore is kept in the status
    bad = PsService(_port_holder("arena", "fp32"))
    with pytest.raises(Exception):
        bad.restore(os.fspath(tmp_path / "absent.psd"), inc)
    assert bad.status.startswith("Failed")
    bad.stop()
    assert touched


# --- a supervised PS killed mid-training -------------------------------------


def test_supervised_ps_kill_restart_restores_checkpoint_plus_inc(tmp_path):
    """The JAX ``tests/test_faults.py:488`` on the port's processes: the
    supervisor restarts a killed replica with ``--initial-checkpoint``
    and ``--replay-inc-dir``, training goes on, and every row of the
    checkpoint and of the replica's packets, overlaid in replay order,
    reads back exactly from the restored store."""
    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.data.batch import IDTypeFeature
    from persia_tpu_torch.service.helper import ServiceCtx
    from persia_tpu_torch.service.ps_service import PsClient
    from persia_tpu_torch.utils import dump_yaml

    schema = EmbeddingSchema(slots_config=uniform_slots(
        ["slot_a", "slot_b"], dim=DIM))
    ckpt, inc = os.fspath(tmp_path / "ckpt"), os.fspath(tmp_path / "inc")
    gc = os.fspath(tmp_path / "gc.yml")
    dump_yaml({"embedding_parameter_server_config": {
        "capacity": 100_000, "num_hashmap_internal_shards": 2,
        "enable_incremental_update": True, "incremental_buffer_size": 48,
        "incremental_dir": inc}}, gc)
    rng = np.random.default_rng(0)
    with ServiceCtx(schema, n_workers=1, n_ps=2, global_config_path=gc,
                    supervise_ps=True, ps_restore_dir=ckpt, ps_inc_dir=inc,
                    ps_probe_interval=0.25,
                    env={"LOG_LEVEL": "WARNING"}) as svc:
        w = svc.remote_worker()
        w.configure_parameter_servers(
            "bounded_uniform", {"lower": -0.1, "upper": 0.1}, 1.0, 10.0)
        w.register_optimizer({"type": "sgd", "lr": 0.1, "wd": 0.0})

        def step(lo, hi):
            feats = [IDTypeFeature(n, [rng.integers(
                lo, hi, size=16, dtype=np.uint64)])
                for n in ("slot_a", "slot_b")]
            ref, lk = w.lookup_direct_training(feats)
            w.update_gradients(
                ref, {k: np.ones_like(v.embeddings) for k, v in lk.items()})

        for _ in range(8):
            step(0, 4096)  # durable rows
        w.dump(ckpt)
        for _ in range(4):
            step(0, 4096)  # packets past the checkpoint
        t_kill = time.monotonic()
        svc.ps_proc(1).kill()
        (event,) = svc.wait_ps_recoveries(1, timeout=60)
        assert "failed" not in event, event
        assert event["t_detected"] - t_kill < 10.0
        for _ in range(4):
            step(1 << 20, (1 << 20) + 4096)  # a disjoint range after it
        assert w.staleness == 0
        # the durable artifacts overlaid in replay order == the live store
        expected = {}
        for sign, _d, vec in iter_psd_entries(
                os.path.join(ckpt, "replica_1.psd")):
            if sign < (1 << 20):
                expected[sign] = vec
        replica_packets = 0
        for name in sorted(os.listdir(inc)):
            path = os.path.join(inc, name, "1.inc")
            if name.startswith("inc_") and os.path.exists(path):
                replica_packets += 1
                for sign, _d, vec in iter_psd_entries(path):
                    if sign < (1 << 20):
                        expected[sign] = vec
        assert expected and replica_packets > 1
        client = PsClient(svc.ps_addrs[1])
        for sign, vec in expected.items():
            got = client.get_entry(sign)
            assert got is not None, f"row {sign} lost in the recovery"
            assert got[1][:len(vec)].tobytes() == vec.tobytes(), sign
        client.client.close()
        w.close()
        assert not svc.crashed


# --- the snapshot's watermark ------------------------------------------------


def test_snapshot_inc_watermark_equals_jax(tmp_path):
    from persia_tpu import snapshot as jsnap
    from persia_tpu.config import EmbeddingSchema as JSchema
    from persia_tpu.config import SlotConfig as JSlot
    from persia_tpu.ps.store import EmbeddingHolder as JHolder
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    from persia_tpu_torch.config import EmbeddingSchema, SlotConfig
    from persia_tpu_torch.ps.store import EmbeddingHolder
    from persia_tpu_torch.snapshot import load_manifest, snapshot_job
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    inc = os.fspath(tmp_path / "inc")
    for r in range(2):
        h = _port_holder("arena", "fp32")
        _dump(IncrementalUpdateDumper, h, inc, _train(h, 20 + r, steps=1),
              replica=r)
    os.makedirs(os.path.join(inc, "inc_99999999999999_000001_r0_p1.tmp"))
    w = EmbeddingWorker(EmbeddingSchema(slots_config={
        "c": SlotConfig(name="c", dim=4)}), [EmbeddingHolder(100, 1)])
    jw = JWorker(JSchema(slots_config={"c": JSlot(name="c", dim=4)}),
                 [JHolder(100, 1)])
    for worker in (w, jw):
        worker.configure_parameter_servers(
            "bounded_uniform", {"lower": 0.0, "upper": 0.0}, 1.0, 1e9)
        worker.register_optimizer({"type": "sgd", "lr": 1.0, "wd": 0.0})
    tm = load_manifest(snapshot_job(os.fspath(tmp_path / "port"), w,
                                    inc_dir=inc))
    jm = load_manifest(jsnap.snapshot_job(os.fspath(tmp_path / "jax"), jw,
                                          inc_dir=inc))
    assert len(tm["inc_watermark"]) == 4
    assert tm["inc_watermark"] == jm["inc_watermark"]
    assert load_manifest(snapshot_job(os.fspath(tmp_path / "none"), w)
                         )["inc_watermark"] is None
    w.close()


def test_train_ctx_snapshot_carries_inc_dir(tmp_path):
    """``TrainCtx.snapshot(inc_dir=)`` hands the directory to
    ``snapshot_job``: the manifest's watermark names its packets."""
    import torch

    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.snapshot import load_manifest
    from persia_tpu_torch.worker.worker import EmbeddingWorker

    inc = os.fspath(tmp_path / "inc")
    h = _port_holder("arena", "fp32")
    _dump(IncrementalUpdateDumper, h, inc, _train(h, 30, steps=1))
    schema = EmbeddingSchema(slots_config=uniform_slots(["a", "b"], dim=4))
    model = DNN(1, [4, 4], device="cpu")
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters()),
                   Adagrad(lr=1e-2), schema,
                   EmbeddingWorker(schema, [_port_holder("arena", "fp32")]),
                   device="cpu")
    with ctx:
        snap = ctx.snapshot(os.fspath(tmp_path / "snaps"), inc_dir=inc)
    names = [n for n, _, _ in ready_packets(inc, set())]
    assert len(names) == 2
    assert load_manifest(snap)["inc_watermark"] == names
    ctx.worker.close()
