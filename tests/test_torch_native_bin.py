"""The native service binaries under the port: ``persia-embedding-ps``
and ``persia-embedding-worker``, built by
``persia_tpu_torch.service.native_bin`` from ``native/src/`` and run by
``ServiceCtx(native_ps=, native_worker=)``
(``tests/test_native_worker.py`` on the port).

Row initialization is a function of the sign, and the middleware kernels
and the store are the same C++ in both tiers, so two clusters that differ
only in the language of a tier give byte-equal lookups, rows after
updates, and a seq_rec run equal bit for bit. Also: the builder's cache
and two builds racing, and the zstd shim the binaries build against on a
host without zstd (a compressed frame is refused).
"""

import json
import os
import socket
import struct
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from persia_tpu_torch import _msgpack
from persia_tpu_torch import config as tcfg
from persia_tpu_torch.config import (
    EmbeddingSchema,
    HashStackConfig,
    SlotConfig,
    uniform_slots,
)
from persia_tpu_torch.data.batch import IDTypeFeature
from persia_tpu_torch.rpc import RpcError
from persia_tpu_torch.service import native_bin
from persia_tpu_torch.service.helper import ServiceCtx, _schema_to_yaml_dict
from persia_tpu_torch.service.ps_service import PsClient
from persia_tpu_torch.utils import dump_yaml, load_yaml
from persia_tpu_torch.workloads import generator as tgen

REPO = Path(__file__).resolve().parent.parent
CAP, SHARDS = 200_000, 4


@pytest.fixture
def deterministic_torch():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _rich_schema() -> EmbeddingSchema:
    """Summed slots, a raw (sequence) slot, sqrt scaling, hash-stack
    compression, a feature group with index-prefix namespacing."""
    return EmbeddingSchema(
        slots_config={
            "clicks": SlotConfig(name="clicks", dim=8),
            "ads": SlotConfig(name="ads", dim=8, sqrt_scaling=True),
            "history": SlotConfig(name="history", dim=4,
                                  embedding_summation=False,
                                  sample_fixed_size=5),
            "huge_vocab": SlotConfig(
                name="huge_vocab", dim=8,
                hash_stack_config=HashStackConfig(hash_stack_rounds=2,
                                                  embedding_size=1000)),
        },
        feature_index_prefix_bit=12,
        feature_groups={"engagement": ["clicks", "ads"]},
    )


def _batch(seed: int, bs: int = 32):
    rng = np.random.default_rng(seed)
    feats = []
    for name, hi in (("clicks", 5000), ("ads", 5000), ("history", 2000),
                     ("huge_vocab", 10 ** 9)):
        feats.append(IDTypeFeature(name, [
            rng.integers(0, hi, size=rng.integers(1, 8)).astype(np.uint64)
            for _ in range(bs)]))
    return feats


def _global_config(tmp, **worker):
    path = os.fspath(tmp / "global_config.yml")
    doc = {"embedding_parameter_server_config": {
        "capacity": CAP, "num_hashmap_internal_shards": SHARDS}}
    if worker:
        doc["embedding_worker_config"] = worker
    dump_yaml(doc, path)
    return path


@pytest.mark.parametrize("which", ["rich", "criteo"])
def test_schema_parity_with_python(which, tmp_path):
    """``--dump-schema`` resolves dims, flags and prefixes as the port's
    ``EmbeddingSchema`` does (the sorted-group prefix assignment)."""
    binary = native_bin.ensure_binaries()["persia-embedding-worker"]
    schema = _rich_schema() if which == "rich" else \
        EmbeddingSchema.from_dict(load_yaml(os.fspath(
            REPO / "examples" / "criteo" / "config" /
            "embedding_config.yml")))
    path = os.fspath(tmp_path / "schema.yml")
    dump_yaml(_schema_to_yaml_dict(schema), path)
    native = json.loads(subprocess.run(
        [binary, "--embedding-config", path, "--dump-schema"],
        capture_output=True, text=True, check=True).stdout)
    assert native["feature_index_prefix_bit"] == \
        schema.feature_index_prefix_bit
    assert set(native["slots"]) == set(schema.slots_config)
    for name, slot in schema.slots_config.items():
        ns = native["slots"][name]
        assert (ns["dim"], ns["sample_fixed_size"],
                ns["embedding_summation"], ns["sqrt_scaling"],
                ns["hash_stack_rounds"], ns["embedding_size"],
                ns["index_prefix"]) == (
            slot.dim, slot.sample_fixed_size, slot.embedding_summation,
            slot.sqrt_scaling, slot.hash_stack_config.hash_stack_rounds,
            slot.hash_stack_config.embedding_size, slot.index_prefix), name


@pytest.fixture(scope="module")
def twin_clusters():
    """Two fresh clusters over the C++ PS, differing only in the worker
    tier: the port's worker service and the C++ worker."""
    schema = _rich_schema()
    with ServiceCtx(schema, n_workers=1, n_ps=2, native_ps=True,
                    ps_capacity=CAP, ps_num_shards=SHARDS) as py_svc, \
            ServiceCtx(schema, n_workers=1, n_ps=2, native_ps=True,
                       native_worker=True, ps_capacity=CAP,
                       ps_num_shards=SHARDS) as cc_svc:
        py_w = py_svc.remote_worker()
        cc_w = cc_svc.remote_worker()
        for w in (py_w, cc_w):
            w.configure_parameter_servers(
                "normal", {"mean": 0.0, "standard_deviation": 0.02}, 1.0,
                10.0)
            w.register_optimizer({"type": "adagrad", "lr": 0.05})
        yield py_w, cc_w


def _assert_lookup_equal(py_res, cc_res):
    assert set(py_res) == set(cc_res)
    for name in py_res:
        p, c = py_res[name], cc_res[name]
        assert type(p) is type(c)
        np.testing.assert_array_equal(p.embeddings, c.embeddings,
                                      err_msg=name)
        if hasattr(p, "index"):
            np.testing.assert_array_equal(p.index, c.index, err_msg=name)
            np.testing.assert_array_equal(p.sample_id_num, c.sample_id_num,
                                          err_msg=name)


@pytest.mark.parametrize("seed", [1, 2])
def test_lookup_wire_parity(twin_clusters, seed):
    """Inference lookups byte-equal between the two worker tiers."""
    py_w, cc_w = twin_clusters
    feats = _batch(seed)
    _assert_lookup_equal(py_w.lookup_direct(feats, training=False),
                         cc_w.lookup_direct(feats, training=False))


def test_training_round_trip_parity(twin_clusters):
    """put_batch, lookup, update_gradients: the stores evolve alike,
    shown by byte-equal lookups after the updates."""
    py_w, cc_w = twin_clusters
    for step in range(3):
        feats = _batch(100 + step)
        py_ref, py_res = py_w.lookup_direct_training(feats)
        cc_ref, cc_res = cc_w.lookup_direct_training(feats)
        _assert_lookup_equal(py_res, cc_res)
        rng = np.random.default_rng(7 + step)
        grads = {f.name: rng.standard_normal(
            py_res[f.name].embeddings.shape).astype(np.float32)
            for f in feats}
        py_w.update_gradients(py_ref, grads, loss_scale=2.0)
        cc_w.update_gradients(cc_ref, grads, loss_scale=2.0)
    assert py_w.staleness == 0 and cc_w.staleness == 0
    feats = _batch(999)
    _assert_lookup_equal(py_w.lookup_direct(feats, training=False),
                         cc_w.lookup_direct(feats, training=False))


def test_native_worker_refuses_what_it_does_not_serve(twin_clusters):
    """What the C++ worker does not serve fails with the RPC's unknown
    method error, never a hang or a silent no-op: the serving cache's
    miss fetch and the routing broadcast."""
    from persia_tpu_torch.routing import RoutingTable
    from persia_tpu_torch.service.worker_service import PartialPublishError

    _, cc_w = twin_clusters
    with pytest.raises(RpcError, match="no such method lookup_signs"):
        cc_w.lookup_signs(np.arange(1, 5, dtype=np.uint64), 8)
    # the broadcast reports the replica's error, none applied
    with pytest.raises(PartialPublishError,
                       match="applied_any=False.*no such method "
                             "apply_routing"):
        cc_w.apply_routing(RoutingTable.uniform(2))
    with pytest.raises(RpcError,
                       match="no such method close_routing_window"):
        cc_w.close_routing_window()
    assert cc_w.staleness == 0  # the connection still serves


def test_native_worker_train_ctx():
    """``TrainCtx(device="cpu")`` over the all-native tier (C++ worker
    and PS): adult-income's DNN trains, every loss finite, nothing left
    in flight."""
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DNN

    schema = EmbeddingSchema(slots_config=uniform_slots(
        [f"slot_{s}" for s in range(tgen.ADULT_NUM_SLOTS)], dim=8))
    with ServiceCtx(schema, n_workers=2, n_ps=2, native_ps=True,
                    native_worker=True, ps_capacity=CAP,
                    ps_num_shards=SHARDS) as svc:
        w = svc.remote_worker()
        model = DNN(tgen.ADULT_NUM_DENSE, [8] * tgen.ADULT_NUM_SLOTS,
                    device="cpu")
        ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                       Adagrad(lr=1e-2), schema, w, device="cpu",
                       embedding_config=EmbeddingConfig(
                           emb_initialization=(-0.05, 0.05)))
        losses = []
        with ctx:
            for b in tgen.adult_income_batches(8 * 128, 128, seed=51):
                losses.append(float(ctx.train_step(b)[0]))
        assert len(losses) == 8 and np.isfinite(losses).all()
        assert losses[-1] < losses[0]
        assert w.staleness == 0


def test_native_worker_dump_load(twin_clusters, tmp_path):
    """The checkpoint fan-out through the C++ worker: the done marker
    and a shard a replica; the load reads them back."""
    _, cc_w = twin_clusters
    cc_w.dump(os.fspath(tmp_path))
    marker = json.loads((tmp_path / "embedding_dump_done").read_text())
    assert marker["num_shards"] == 2
    assert (tmp_path / "replica_0.psd").exists()
    assert (tmp_path / "replica_1.psd").exists()
    feats = _batch(5)
    before = cc_w.lookup_direct(feats, training=False)
    cc_w.load(os.fspath(tmp_path))
    _assert_lookup_equal(before, cc_w.lookup_direct(feats, training=False))


def test_native_worker_buffer_full_contract(tmp_path):
    """A forward buffer of 2 answers the third batch with
    ``ForwardBufferFull`` (the data loader's backpressure contract);
    ``ServiceCtx`` passes the global config's buffer size on."""
    schema = EmbeddingSchema(slots_config=uniform_slots(["s0"], dim=4))
    path = _global_config(tmp_path, forward_buffer_size=2)
    with ServiceCtx(schema, n_workers=1, n_ps=1, native_ps=True,
                    native_worker=True, ps_capacity=10_000,
                    ps_num_shards=2, global_config_path=path) as svc:
        w = svc.remote_worker()
        feats = [IDTypeFeature("s0", [np.array([1, 2], np.uint64)])]
        w.put_batch(feats)
        w.put_batch(feats)
        with pytest.raises(RpcError, match="ForwardBufferFull"):
            w.put_batch(feats)


# --- seq_rec over the native tier against the Python tier -----------------

DIM, HEADS, T_HIST, NUM_DENSE, BS = 16, 4, 16, 4, 16
SPEC = dict(item_vocab=2000, t_hist=T_HIST)
SLOTS = [(DIM, False), (DIM, False), (DIM, True), (DIM, False),
         (DIM, False)]


def _seq_schema(clicks_pooling="sum"):
    """seq_rec's slots; its clicks slot pools the last 4 clicks, which the
    C++ worker cannot, so the tiers are compared with it summed."""
    slots = uniform_slots(["user_geo", "user_device", "target_item"],
                          dim=DIM)
    slots["recent_items"] = SlotConfig(
        name="recent_items", dim=DIM, embedding_summation=False,
        sample_fixed_size=T_HIST)
    slots["recent_clicks"] = SlotConfig(name="recent_clicks", dim=DIM,
                                        pooling=clicks_pooling)
    return EmbeddingSchema(slots_config=slots)


def test_native_worker_refuses_pooling_it_has_not():
    """The C++ worker sums every summed slot: a schema with last-k or
    mean pooling is refused by name instead of being served summed (the
    JAX package's ``ServiceCtx`` takes it)."""
    for pooling in ("last4", "mean"):
        with pytest.raises(ValueError, match="recent_clicks"):
            ServiceCtx(_seq_schema(pooling), native_worker=True)
        ServiceCtx(_seq_schema(pooling), native_ps=True)  # taken


def _seq_run(worker, batches):
    """Losses, predictions and dense state of a seq_rec ``TrainCtx`` on
    the CPU over ``worker``, from seeded weights."""
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding import EmbeddingConfig
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import SequenceTower

    model = SequenceTower(NUM_DENSE, SLOTS, num_heads=HEADS,
                          attn_impl="flash", device="cpu",
                          compute_dtype=torch.float32)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                   Adagrad(lr=1e-2), _seq_schema(), worker, seed=3,
                   embedding_config=EmbeddingConfig(
                       emb_initialization=(-0.05, 0.05)),
                   global_config=tcfg.GlobalConfig(tcfg.CommonConfig("f32")),
                   device="cpu")
    out = []
    with ctx:
        for b in batches:
            loss, pred = ctx.train_step(b)
            out.append((float(loss), pred.detach().numpy().copy()))
    dense = {k: v.detach().numpy().copy()
             for k, v in model.state_dict().items()}
    opt = [t.detach().numpy().copy() for st in
           ctx.dense_optimizer.state_dict()["state"].values()
           for _, t in sorted(st.items()) if torch.is_tensor(t)]
    return out, dense, opt


def test_seq_rec_native_tier_equals_python_tier(deterministic_torch,
                                                tmp_path):
    """seq_rec, 4 synchronous steps over the all-native tier against the
    Python services on the same batches: losses, predictions, dense state
    with Adam's, and every touched PS row equal bit for bit."""
    batches = list(tgen.seqrec_batches(4 * BS, BS, seed=9,
                                       spec=tgen.SeqRecSpec(**SPEC)))
    signs = np.unique(np.concatenate([f.signs for b in batches
                                      for f in b.id_type_features]))
    schema = _seq_schema()
    runs = []
    with ServiceCtx(schema, n_workers=1, n_ps=2,
                    global_config_path=_global_config(tmp_path)) as py, \
            ServiceCtx(schema, n_workers=1, n_ps=2, native_ps=True,
                       native_worker=True, ps_capacity=CAP,
                       ps_num_shards=SHARDS) as cc:
        for svc in (py, cc):
            steps, dense, opt = _seq_run(svc.remote_worker(), batches)
            found = np.zeros(len(signs), np.int64)
            rows = np.zeros((len(signs), 2 * DIM), np.float32)
            for a in svc.ps_addrs:
                f, v = PsClient(a).get_entries(signs, 2 * DIM)
                found += f
                rows[f] = v[f]
            assert (found == 1).all()
            runs.append((steps, dense, opt, rows))
    (sa, da, oa, ra), (sb, db, ob, rb) = runs
    for (la, pa), (lb, pb) in zip(sa, sb):
        assert la == lb
        np.testing.assert_array_equal(pa, pb)
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    assert len(oa) == len(ob) > 0
    for a, b in zip(oa, ob):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ra.view(np.uint32), rb.view(np.uint32))


# --- the builder ----------------------------------------------------------


def test_builder_caches_by_source_and_never_writes_native_build():
    """A second resolve finds the built binary (same path, not rebuilt);
    the path names the zstd mode and a hash of the sources and flags, and
    lies under the port's ``_build/``."""
    paths = native_bin.ensure_binaries()
    again = native_bin.ensure_binaries()
    assert paths == again
    for name, p in paths.items():
        p = Path(p)
        assert p.parent == native_bin.BUILD_DIR
        assert p.name.startswith(f"{name}-{native_bin.zstd_mode()}-")
        assert os.access(p, os.X_OK)
    mtimes = {n: os.stat(p).st_mtime_ns for n, p in paths.items()}
    assert native_bin.binary_jobs() == []
    native_bin.ensure_binaries()
    assert {n: os.stat(p).st_mtime_ns for n, p in paths.items()} == mtimes
    assert native_bin.binary_path("persia-embedding-ps", "shim") != \
        native_bin.binary_path("persia-embedding-ps", "system")
    with pytest.raises(FileNotFoundError, match="no native binary"):
        native_bin.ensure_binaries(["persia-embedding-coordinator"])


_RACER = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    sys.path.insert(0, sys.argv[1])
    from persia_tpu_torch.ops import _build
    from persia_tpu_torch.service import native_bin as nb
    nb.NATIVE_SRC_DIR = Path(sys.argv[2])
    nb.BUILD_DIR = Path(sys.argv[3])
    nb.BINARIES = {"tiny": "tiny.cc"}
    _build.BUILD_DIR = nb.BUILD_DIR
    compiled = []
    real = nb.compile_all
    nb.compile_all = lambda jobs: (compiled.extend(j.name for j in jobs),
                                   real(jobs))[1]
    Path(sys.argv[4]).touch()
    while not Path(sys.argv[5]).exists():
        pass
    path = nb.ensure_binaries(["tiny"], "shim")["tiny"]
    print(json.dumps({"path": path, "compiled": compiled}))
""")


def test_two_builds_racing_compile_once(tmp_path):
    """Two processes resolving the same missing binary at once: one
    compiles under the file lock, the other waits and finds it built; both
    get one complete executable."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "tiny.cc").write_text(
        "#include <unistd.h>\nint main() { usleep(300000); return 7; }\n")
    build = tmp_path / "build"
    go = tmp_path / "go"
    procs = []
    for i in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RACER, os.fspath(REPO), os.fspath(src),
             os.fspath(build), os.fspath(tmp_path / f"ready{i}"),
             os.fspath(go)], stdout=subprocess.PIPE, text=True))
    deadline = time.monotonic() + 60
    while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
        assert time.monotonic() < deadline, "racers never started"
        time.sleep(0.01)
    go.touch()
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0
        outs.append(json.loads(out))
    assert outs[0]["path"] == outs[1]["path"]
    assert sorted(len(o["compiled"]) for o in outs) == [0, 1]
    assert subprocess.run([outs[0]["path"]]).returncode == 7
    assert [p.name for p in build.iterdir()
            if p.name.endswith(".tmp")] == []


def _frame(method: str, payload: bytes, compressed: bool) -> bytes:
    """One request frame of the RPC wire: u32 length, u8 flags (bit 0:
    zstd), u16 envelope length, the envelope, the payload."""
    env = _msgpack.packb([method])
    body = env + payload
    return struct.pack("<IBH", 3 + len(body), 1 if compressed else 0,
                       len(env)) + body


def _exchange(addr: str, frame: bytes) -> bytes:
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(frame)
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return out
            out += chunk
            if len(out) >= 7 and len(out) >= 4 + struct.unpack(
                    "<I", out[:4])[0]:
                return out


@pytest.mark.parametrize("zstd", ["system", "shim"])
def test_compressed_frames_by_zstd_mode(zstd):
    """The PS binary built against the host's zstd takes a compressed
    request; built against the port's shim it refuses one (the
    connection closes with no reply) and still takes a plain one. Both
    answer a plain ``len`` alike."""
    zstandard = pytest.importorskip("zstandard")
    if zstd == "system" and native_bin.zstd_mode() != "system":
        pytest.skip("this host has no zstd to build against")
    from persia_tpu_torch.service.coordinator import (
        ROLE_PS,
        Coordinator,
        CoordinatorClient,
    )

    binary = native_bin.ensure_binaries(["persia-embedding-ps"],
                                        zstd)["persia-embedding-ps"]
    coord = Coordinator()
    coord.server.serve_background()
    proc = subprocess.Popen([binary, "--capacity", "1000", "--num-shards",
                             "1", "--coordinator", coord.addr],
                            stderr=subprocess.DEVNULL)
    try:
        (addr,) = CoordinatorClient(coord.addr).wait_members(ROLE_PS, 1, 30)
        plain = _exchange(addr, _frame("len", b"", False))
        assert plain[4] == 0 and len(plain) > 7
        packed = zstandard.ZstdCompressor().compress(b"\x80" * 64)
        reply = _exchange(addr, _frame("len", packed, True))
        if zstd == "shim":
            assert reply == b""
        else:
            assert reply == plain
        assert _exchange(addr, _frame("len", b"", False)) == plain
    finally:
        proc.kill()
        proc.wait(timeout=10)
        coord.server.stop()
