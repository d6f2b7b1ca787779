"""Host-side parity of the PyTorch port against the JAX package: the
port keeps its own copies of the numpy-only modules (hashing, PTB2 wire,
PS rng and store, worker middleware, seqrec traffic, the knobs, the
storage layer, the HyperLogLog, the routing table and the hotness
sketches), and every result here must be bit-identical to the JAX
package's.

Also: the port and ``chip_smoke.py`` import nothing of JAX or of the JAX
package.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from persia_tpu_torch import config as tcfg
from persia_tpu_torch import hashing as thash
from persia_tpu_torch.data.batch import PersiaBatch as TBatch
from persia_tpu_torch.ps import rng as trng
from persia_tpu_torch.ps.store import EmbeddingHolder as THolder
from persia_tpu_torch.worker import middleware as tmw
from persia_tpu_torch.worker.worker import EmbeddingWorker as TWorker
from persia_tpu_torch.workloads import generator as tgen

REPO = Path(__file__).resolve().parent.parent

SPEC = dict(item_vocab=3000, t_hist=12)


def _slot_specs():
    """(name, kwargs) of a schema that reaches every transform: sum, mean,
    last4 and sqrt pooling, a raw slot that truncates, hashstack."""
    return [
        ("user_geo", dict(dim=8)),
        ("user_device", dict(dim=8, pooling="mean")),
        ("recent_items", dict(dim=8, embedding_summation=False,
                              sample_fixed_size=8)),
        ("recent_clicks", dict(dim=8, pooling="last4")),
        ("target_item", dict(dim=4, sqrt_scaling=True,
                             hash_stack_config="hs")),
    ]


def _schemas(prefix_bit=0):
    from persia_tpu import config as jcfg

    out = []
    for cfg in (jcfg, tcfg):
        slots = {}
        for name, kw in _slot_specs():
            kw = dict(kw)
            if kw.pop("hash_stack_config", None):
                kw["hash_stack_config"] = cfg.HashStackConfig(
                    hash_stack_rounds=2, embedding_size=500)
            slots[name] = cfg.SlotConfig(name=name, **kw)
        groups = {"profile": ["user_geo", "user_device"]} if prefix_bit \
            else {}
        out.append(cfg.EmbeddingSchema(
            slots_config=slots, feature_index_prefix_bit=prefix_bit,
            feature_groups=groups))
    return out


def _batches(n=64, bs=16, seed=3):
    from persia_tpu.workloads import generator as jgen

    jb = list(jgen.seqrec_batches(n, bs, seed=seed,
                                  spec=jgen.SeqRecSpec(**SPEC)))
    tb = list(tgen.seqrec_batches(n, bs, seed=seed,
                                  spec=tgen.SeqRecSpec(**SPEC)))
    return jb, tb


def test_seqrec_generator_and_ptb2_wire_are_byte_identical():
    from persia_tpu.data.batch import PersiaBatch as JBatch

    jb, tb = _batches()
    assert len(jb) == len(tb) == 4
    for j, t in zip(jb, tb):
        jbytes, tbytes = j.to_bytes(), t.to_bytes()
        assert jbytes == tbytes
        # across packages, both directions
        assert TBatch.from_bytes(jbytes).to_bytes() == jbytes
        assert JBatch.from_bytes(tbytes).to_bytes() == tbytes
    # flags and optional fields survive the crossing
    t = tb[0]
    t.batch_id, t.meta, t.requires_grad = None, b"", False
    j = JBatch.from_bytes(t.to_bytes())
    assert (j.batch_id, j.meta, j.requires_grad) == (None, b"", False)
    assert j.to_bytes() == t.to_bytes()


def test_hashing_and_rng_are_bit_exact():
    from persia_tpu import hashing as jhash
    from persia_tpu.ps import rng as jrng

    rng = np.random.default_rng(0)
    signs = np.concatenate([
        rng.integers(0, 2**63, size=2000, dtype=np.uint64) * np.uint64(2)
        + np.uint64(1),
        np.array([0, 1, 2**64 - 1, 2**63], dtype=np.uint64)])
    np.testing.assert_array_equal(thash.farmhash64_np(signs),
                                  jhash.farmhash64_np(signs))
    for r in (1, 2, 7):
        np.testing.assert_array_equal(thash.sign_to_shard(signs, r),
                                      jhash.sign_to_shard(signs, r))
        np.testing.assert_array_equal(trng.internal_shard_of(signs, r),
                                      jrng.internal_shard_of(signs, r))
    params = tcfg.InitializationConfig(shape=0.7, scale=2.0,
                                       lam=3.0).to_params()
    for method in ("bounded_uniform", "normal", "truncated_normal",
                   "bounded_gamma", "bounded_poisson", "zero"):
        few = signs[:50] if method in ("bounded_gamma",
                                        "bounded_poisson") else signs
        for dim in (5, 16):
            a = trng.initialize_entries(few, dim, method, params)
            b = jrng.initialize_entries(few, dim, method, params)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prefix_bit", [0, 8])
def test_preprocess_and_postprocess_are_bit_exact(prefix_bit):
    from persia_tpu.worker import middleware as jmw

    jschema, tschema = _schemas(prefix_bit)
    jb, tb = _batches()
    rng = np.random.default_rng(prefix_bit)
    for j, t in zip(jb, tb):
        jf = jmw.preprocess_batch(j.id_type_features, jschema)
        tf = tmw.preprocess_batch(t.id_type_features, tschema)
        for a, b in zip(jf, tf):
            assert a.name == b.name
            for field in ("distinct_signs", "elem_sample", "elem_col",
                          "elem_distinct", "sample_num_signs",
                          "raw_row_of_distinct"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
            slot = tschema.get_slot(b.name)
            emb = rng.normal(size=(b.num_distinct, slot.dim)).astype(
                np.float32)
            pa = jmw.postprocess_feature(a, jschema.get_slot(a.name), emb)
            pb = tmw.postprocess_feature(b, slot, emb)
            assert type(pa).__name__ == type(pb).__name__
            np.testing.assert_array_equal(pa.embeddings, pb.embeddings)
            if isinstance(pb, tmw.RawEmbedding):
                np.testing.assert_array_equal(pa.index, pb.index)
                np.testing.assert_array_equal(pa.sample_id_num,
                                              pb.sample_id_num)
        jg = jmw.shard_split(jf, jschema, 3)
        tg = tmw.shard_split(tf, tschema, 3)
        assert [(g.shard, g.dim) for g in jg] == [(g.shard, g.dim)
                                                  for g in tg]
        for a, b in zip(jg, tg):
            np.testing.assert_array_equal(a.signs, b.signs)
            np.testing.assert_array_equal(a.distinct_idx, b.distinct_idx)


def test_lookup_direct_is_bit_exact():
    """The same PS rows in both packages' holders: eval lookups through
    each worker agree bit for bit, misses read zeros."""
    from persia_tpu.ps.store import EmbeddingHolder as JHolder
    from persia_tpu.worker.worker import EmbeddingWorker as JWorker

    jschema, tschema = _schemas()
    jw = JWorker(jschema, [JHolder(1_000_000, 4) for _ in range(2)])
    tw = TWorker(tschema, [THolder(1_000_000, 4) for _ in range(2)])
    try:
        jb, tb = _batches()
        # dim-8 rows for every sign of the traffic; the dim-4 hashstack
        # slot's buckets stay absent (a miss must read zeros)
        signs = tgen.SeqRecSpec(**SPEC).all_signs()
        vecs = trng.initialize_entries(signs, 8, "bounded_uniform",
                                       {"lower": -0.1, "upper": 0.1})
        tw.set_rows(signs, vecs, 8)
        shards = thash.sign_to_shard(signs, 2)
        for r, holder in enumerate(jw.ps_clients):
            sel = shards == r
            holder.set_entries(signs[sel], 8, vecs[sel])
        for j, t in zip(jb, tb):
            ja = jw.lookup_direct(j.id_type_features, training=False)
            ta = tw.lookup_direct(t.id_type_features, training=False)
            assert list(ja) == list(ta)
            for name in ta:
                np.testing.assert_array_equal(ja[name].embeddings,
                                              ta[name].embeddings)
            assert not ta["target_item"].embeddings.any()
            assert ta["user_geo"].embeddings.any()
            distinct = np.unique(t.id_type_features[2].signs)
            np.testing.assert_array_equal(
                jw.lookup_signs(distinct, 8), tw.lookup_signs(distinct, 8))
    finally:
        jw.close()


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port (the model
    zoo and the workload registry among them) and chip_smoke (without
    running it), then builds and loads the port's
    native library and runs one worker lookup on the native store through
    the middleware's C++ kernels, and a step profiler window (the
    ``torch.profiler`` path of ``tracing.py``) writes its trace: no jax, flax, optax or persia_tpu
    module may load, and no file under ``native/build/`` or
    ``persia_tpu/native_bin/`` may be mapped or open. The serving wire
    speaks MessagePack through the port's own codec: ``msgpack`` must not
    load either, nor ``yaml`` (the port reads its own YAML subset). The
    children a ``ServiceCtx`` starts, ``python -m
    persia_tpu_torch.service.ps_service`` and ``worker_service``, run up
    to their registration (refused: no coordinator listens; the PS with
    its incremental-update dumper armed), and
    ``python -m persia_tpu_torch.service.trainer_service --help``, and
    load none of these either."""
    code = (
        "import importlib, os, pkgutil, sys\n"
        "import persia_tpu_torch\n"
        "for m in pkgutil.walk_packages(persia_tpu_torch.__path__, "
        "'persia_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from persia_tpu_torch.ps.native import make_holder, "
        "native_lib_path\n"
        "from persia_tpu_torch.worker import mw_native\n"
        "from persia_tpu_torch.worker.worker import EmbeddingWorker\n"
        "from persia_tpu_torch.workloads import generator as gen\n"
        "calls = []\n"
        "for name in ('dedup', 'shard_order', 'scatter_rows', "
        "'sum_post', 'scatter_add_rows'):\n"
        "    def wrap(*a, _f=getattr(mw_native, name), _n=name):\n"
        "        calls.append(_n)\n"
        "        return _f(*a)\n"
        "    setattr(mw_native, name, wrap)\n"
        "schema = chip_smoke.build_schema()\n"
        "w = EmbeddingWorker(schema, [make_holder(10000, 4) "
        "for _ in range(2)])\n"
        "w.configure_parameter_servers('bounded_uniform', "
        "{'lower': -0.1, 'upper': 0.1}, 1.0, 1.0)\n"
        "w.register_optimizer({'type': 'sgd', 'lr': 0.1})\n"
        "b = next(iter(gen.seqrec_batches(16, 16, seed=1, "
        "spec=gen.SeqRecSpec(item_vocab=500, t_hist=64))))\n"
        "out = w.lookup_direct(b.id_type_features, training=True)\n"
        "assert all(v.embeddings.any() for v in out.values())\n"
        "assert set(calls) == {'dedup', 'shard_order', 'scatter_rows', "
        "'sum_post', 'scatter_add_rows'}, calls\n"
        "w.close()\n"
        "import tempfile\n"
        "from persia_tpu_torch.tracing import StepProfiler\n"
        "prof = StepProfiler(tempfile.mkdtemp(), start_step=1, "
        "num_steps=1)\n"
        "prof.on_step(1)\n"
        "with prof.step_scope():\n"
        "    schema.slots_config\n"
        "prof.on_step(2)\n"
        "assert prof.trace_path and os.path.getsize(prof.trace_path), "
        "prof.trace_path\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert str(native_lib_path()) in maps\n"
        "fds = [os.path.realpath(f'/proc/self/fd/{fd}') "
        "for fd in os.listdir('/proc/self/fd')]\n"
        "root = os.path.dirname(os.path.dirname(persia_tpu_torch.__file__))\n"
        "for d in ('native/build', 'persia_tpu/native_bin'):\n"
        "    d = os.path.join(root, d)\n"
        "    assert d not in maps and not any(f.startswith(d) "
        "for f in fds), d\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'persia_tpu'))\n"
        "missing = [n for n in ('persia_tpu_torch.ps.arena', "
        "'persia_tpu_torch.ps.native', 'persia_tpu_torch.pipeline', "
        "'persia_tpu_torch.data.dataloader', 'persia_tpu_torch.ctx', "
        "'persia_tpu_torch.worker.worker', "
        "'persia_tpu_torch.worker.mw_native', "
        "'persia_tpu_torch.models.dnn', 'persia_tpu_torch.models.dcn', "
        "'persia_tpu_torch.models.deepfm', "
        "'persia_tpu_torch.models.wide_deep', "
        "'persia_tpu_torch.workloads.models', "
        "'persia_tpu_torch.workloads.registry', "
        "'persia_tpu_torch.knobs', 'persia_tpu_torch.storage', "
        "'persia_tpu_torch.hotness', 'persia_tpu_torch.routing', "
        "'persia_tpu_torch.checkpoint', 'persia_tpu_torch.snapshot', "
        "'persia_tpu_torch.ps.spill', 'persia_tpu_torch.worker.monitor', "
        "'persia_tpu_torch.distributed', 'persia_tpu_torch.parallel.mesh', "
        "'persia_tpu_torch.parallel.collectives', "
        "'persia_tpu_torch.parallel.ring_attention', "
        "'persia_tpu_torch.parallel.ulysses', "
        "'persia_tpu_torch.worker.device_cache', "
        "'persia_tpu_torch.parallel.cached_train', "
        "'persia_tpu_torch.parallel.cached_engine', "
        "'persia_tpu_torch._msgpack', 'persia_tpu_torch.rpc', "
        "'persia_tpu_torch.faults', 'persia_tpu_torch.tracing', "
        "'persia_tpu_torch.metrics', 'persia_tpu_torch.variants', "
        "'persia_tpu_torch.obs_http', 'persia_tpu_torch.serving', "
        "'persia_tpu_torch._yaml', 'persia_tpu_torch.wire_codec', "
        "'persia_tpu_torch.service.coordinator', "
        "'persia_tpu_torch.service.serialization', "
        "'persia_tpu_torch.service.ps_service', "
        "'persia_tpu_torch.service.worker_service', "
        "'persia_tpu_torch.service.helper', "
        "'persia_tpu_torch.service.trainer_service', "
        "'persia_tpu_torch.fleet', 'persia_tpu_torch.slos', "
        "'persia_tpu_torch.service.native_bin', "
        "'persia_tpu_torch.service_discovery', "
        "'persia_tpu_torch.inc_update', 'persia_tpu_torch.online', "
        "'persia_tpu_torch.service.dataflow', 'persia_tpu_torch.reshard') "
        "if n not in sys.modules]\n"
        "assert not missing, missing\n"
        "assert 'msgpack' not in sys.modules\n"
        "assert 'yaml' not in sys.modules\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('persia_tpu_torch.')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
    _check_service_children()


def _check_service_children():
    import socket
    import tempfile

    from persia_tpu_torch.config import EmbeddingSchema, uniform_slots
    from persia_tpu_torch.service.helper import _schema_to_yaml_dict
    from persia_tpu_torch.utils import dump_yaml

    with tempfile.TemporaryDirectory() as tmp, socket.socket() as s:
        schema_path = os.path.join(tmp, "schema.yml")
        dump_yaml(_schema_to_yaml_dict(EmbeddingSchema(
            slots_config=uniform_slots(["a", "b"], dim=8))), schema_path)
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"  # bound, never listening
        gc_path = os.path.join(tmp, "global.yml")
        dump_yaml({"embedding_parameter_server_config": {
            "capacity": 1000, "num_hashmap_internal_shards": 2,
            "enable_incremental_update": True,
            "incremental_dir": os.path.join(tmp, "inc")}}, gc_path)
        runs = {
            "ps_service": ["--http-port", "-1", "--coordinator", dead,
                           "--global-config", gc_path],
            "worker_service": ["--http-port", "-1", "--coordinator", dead,
                               "--ps-addrs", dead, "--embedding-config",
                               schema_path],
        }
        for role, argv in runs.items():
            code = (
                "import runpy, sys\n"
                f"sys.argv = ['x'] + {argv!r}\n"
                "try:\n"
                f"    runpy.run_module('persia_tpu_torch.service.{role}', "
                "run_name='__main__')\n"
                "except ConnectionError:\n"
                "    print('registration refused')\n"
                "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
                "('jax', 'jaxlib', 'flax', 'optax', 'persia_tpu', "
                "'msgpack', 'yaml'))\n"
                "assert not bad, bad\n"
                "assert 'persia_tpu_torch.ps.native' in sys.modules\n"
                "assert 'torch' not in sys.modules\n"
                f"assert {role!r} != 'ps_service' or "
                "'persia_tpu_torch.inc_update' in sys.modules\n"
                "print('clean')\n")
            out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                                 capture_output=True, text=True, timeout=120,
                                 env={**os.environ, "PYTHONPATH": str(REPO)})
            assert out.returncode == 0, (role, out.stderr[-2000:])
            assert out.stdout.split() == ["registration", "refused",
                                          "clean"], out.stdout
    code = (
        "import runpy, sys\n"
        "sys.argv = ['x', '--help']\n"
        "try:\n"
        "    runpy.run_module('persia_tpu_torch.service.trainer_service', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'persia_tpu', 'msgpack', "
        "'yaml'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--dense-sync-every" in out.stdout and "--device" in out.stdout
    assert out.stdout.split()[-1] == "clean", out.stdout


# --- knobs, storage, HyperLogLog, routing table, hotness sketches -----------


@pytest.mark.parametrize("raw", [None, "", "0", "1", "true", "YES", "no",
                                 "7"])
def test_knobs_parse_as_the_jax_registry(raw, monkeypatch):
    from persia_tpu import knobs as jknobs
    from persia_tpu_torch import knobs as tknobs

    # the serving wire's knobs are among them
    assert {"PERSIA_RPC_FORCE_BLOCK", "PERSIA_FAULTS", "PERSIA_FAULTS_SEED",
            "PERSIA_FAULTS_RPC", "PERSIA_TRACING",
            "PERSIA_VARIANT_SPLIT_BUCKETS", "PERSIA_VARIANT_ROUTE_FEATURE",
            "PERSIA_HTTP_PORT", "PERSIA_METRICS_GATEWAY_ADDR"} <= set(
                tknobs.REGISTRY)
    for name, knob in tknobs.REGISTRY.items():
        jk = jknobs.REGISTRY[name]
        assert (knob.type, knob.default) == (jk.type, jk.default), name
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        elif knob.type in ("int", "float") and raw not in ("", "7"):
            continue  # int() / float() of a word raises in both
        else:
            monkeypatch.setenv(name, raw)
        assert tknobs.get(name) == jknobs.get(name), (name, raw)
    with pytest.raises(KeyError, match="unregistered"):
        tknobs.get("PERSIA_NO_SUCH_KNOB")


def test_storage_copy_reads_and_writes_as_the_jax_one(tmp_path):
    from persia_tpu.storage import PersiaPath as JPath
    from persia_tpu_torch.storage import PersiaPath as TPath

    blob = bytes(range(256)) * 3
    for cls, d in ((JPath, tmp_path / "j"), (TPath, tmp_path / "t")):
        cls(str(d / "sub" / "a")).write_bytes(blob)
        cls(str(d / "b")).write_bytes_atomic(blob[::-1])
        cls(str(d / "c")).makedirs()
    for rel in ("sub/a", "b"):
        assert (tmp_path / "t" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes()
    t, j = TPath(str(tmp_path / "t" / "sub" / "a")), JPath(
        str(tmp_path / "j" / "sub" / "a"))
    assert t.read_range(100, 300) == j.read_range(100, 300)
    assert sorted(os.path.basename(p) for p in TPath(
        str(tmp_path / "t")).listdir()) == sorted(
        os.path.basename(p) for p in JPath(str(tmp_path / "j")).listdir())
    assert not t.is_hdfs and TPath("hdfs://nn/x").is_hdfs
    TPath(str(tmp_path / "t" / "sub")).remove()
    assert not TPath(str(tmp_path / "t" / "sub")).exists()


@pytest.mark.parametrize("p", [4, 10, 14])
def test_hyperloglog_is_bit_exact(p):
    from persia_tpu.worker.monitor import HyperLogLog as JHLL
    from persia_tpu_torch.worker.monitor import HyperLogLog as THLL

    rng = np.random.default_rng(p)
    j, t = JHLL(p), THLL(p)
    for n in (0, 10, 5000, 200_000):
        signs = rng.integers(0, 1 << 62, n, dtype=np.uint64)
        j.add_signs(signs)
        t.add_signs(signs)
        np.testing.assert_array_equal(t.registers, j.registers)
        assert t.estimate() == j.estimate()
    with pytest.raises(ValueError):
        THLL(3)


def test_routing_table_is_bit_exact():
    from persia_tpu.routing import RoutingTable as JTable
    from persia_tpu_torch.routing import RoutingTable as TTable

    signs = np.random.default_rng(1).integers(0, 1 << 63, 5000,
                                              dtype=np.uint64)
    for n in (1, 3, 4):
        j, t = JTable.uniform(n), TTable.uniform(n)
        assert t.to_doc() == j.to_doc()
        assert t.is_uniform_modulo and j.is_uniform_modulo
        np.testing.assert_array_equal(t.slot_of(signs), j.slot_of(signs))
        np.testing.assert_array_equal(t.replica_of(signs),
                                      j.replica_of(signs))
        np.testing.assert_array_equal(t.replica_of(signs),
                                      thash.sign_to_shard(signs, n))
        jd = j.derive((j.replica_of_slot + 1) % n, n)
        td = TTable.from_doc(jd.to_doc())
        assert td.to_doc() == jd.to_doc() and td != t
        assert td == TTable.from_doc(td.to_doc())
        assert td.is_uniform_modulo == jd.is_uniform_modulo
        np.testing.assert_array_equal(td.replica_of(signs),
                                      jd.replica_of(signs))
    assert TTable.uniform(2).num_slots == JTable.uniform(2).num_slots == 128
    with pytest.raises(ValueError, match="outside"):
        TTable(1, np.array([0, 2]), 2)


def test_hotness_sketches_are_bit_exact():
    from persia_tpu import hotness as jhot
    from persia_tpu_torch import hotness as thot

    rng = np.random.default_rng(2)
    js, ts = jhot.SpaceSaving(32), thot.SpaceSaving(32)
    jc, tc = jhot.CountMinSketch(128, 3), thot.CountMinSketch(128, 3)
    for _ in range(20):
        signs = (rng.zipf(1.2, 200) % 5000).astype(np.uint64)
        uniq, counts = np.unique(signs, return_counts=True)
        hashes = thash.farmhash64_np(uniq)
        est_j = jc.add_and_estimate(hashes, counts)
        est_t = tc.add_and_estimate(hashes, counts)
        np.testing.assert_array_equal(est_t, est_j)
        js.offer_many(uniq, counts, est_j)
        ts.offer_many(uniq, counts, est_t)
        assert ts.snapshot() == js.snapshot()
    np.testing.assert_array_equal(tc.rows, jc.rows)
    assert len(ts) == len(js) == 32
    # the device cache's admission queries: counts of tracked and
    # untracked signs, then the periodic halving
    probe = np.concatenate([js._signs[::3], np.arange(5000, 5040,
                                                      dtype=np.uint64)])
    for _ in range(3):
        got, want = ts.counts_of(probe), js.counts_of(probe)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want[-40:].any()
        js.decay()
        ts.decay()
        assert ts.snapshot() == js.snapshot()
    js.decay(0.3)
    ts.decay(0.3)
    assert ts.snapshot() == js.snapshot()
    assert len(ts.counts_of(np.empty(0, np.uint64))) == 0


def test_hotness_single_item_api_matches_jax():
    """``SpaceSaving.offer`` / ``count_of`` / ``min_count`` / ``counts`` and
    ``CountMinSketch.add`` / ``estimate`` on the same seeded stream."""
    from persia_tpu import hotness as jhot
    from persia_tpu_torch import hotness as thot

    rng = np.random.default_rng(4)
    js, ts = jhot.SpaceSaving(16), thot.SpaceSaving(16)
    jc, tc = jhot.CountMinSketch(64, 4), thot.CountMinSketch(64, 4)
    assert ts.min_count() == js.min_count() == 0
    stream = (rng.zipf(1.3, 600) % 300).astype(np.uint64)
    for i, sign in enumerate(stream.tolist()):
        inc = 1 + i % 3
        js.offer(sign, inc)
        ts.offer(sign, inc)
        if i % 50 == 0:
            assert ts.min_count() == js.min_count()
    assert ts.counts == js.counts and len(ts.counts) == 16
    assert ts.min_count() == js.min_count() > 0
    for sign in list(js.counts)[:8] + [10**6, 0]:
        assert ts.count_of(sign) == js.count_of(sign)
    assert ts.count_of(10**6) == 0
    hashes = thash.farmhash64_np(np.unique(stream))
    for part in np.array_split(hashes, 5):
        counts = rng.integers(1, 5, len(part))
        jc.add(part, counts)
        tc.add(part, counts)
        np.testing.assert_array_equal(tc.estimate(hashes),
                                      jc.estimate(hashes))
    np.testing.assert_array_equal(tc.rows, jc.rows)
    assert tc.estimate(hashes).min() >= 1


def test_knob_types_reach_str_and_float(monkeypatch):
    """The device cache's knobs: a str is returned as it is set, a float
    parses, an empty float is unset, as in the JAX registry."""
    from persia_tpu import knobs as jknobs
    from persia_tpu_torch import knobs as tknobs

    for name in ("PERSIA_TIER_ADMIT", "PERSIA_TIER_WINDOW_FRAC",
                 "PERSIA_TIER_SKETCH_TOPK", "PERSIA_MULTIHOST_CACHE"):
        assert name in tknobs.REGISTRY
    for name, raw in (("PERSIA_TIER_ADMIT", "Hotness"),
                      ("PERSIA_MULTIHOST_CACHE", " refuse"),
                      ("PERSIA_TIER_WINDOW_FRAC", "0.25"),
                      ("PERSIA_TIER_WINDOW_FRAC", "1e-1"),
                      ("PERSIA_TIER_WINDOW_FRAC", ""),
                      ("PERSIA_TIER_SKETCH_TOPK", "64")):
        monkeypatch.setenv(name, raw)
        assert tknobs.get(name) == jknobs.get(name), (name, raw)
        assert type(tknobs.get(name)) is type(jknobs.get(name))


def test_zipf_bench_batches_equal_make_zipf_batches():
    """``bench.py``'s ``make_zipf_batches`` (bench_cached's traffic),
    byte for byte, at the default vocabulary and at a small one."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_for_zipf",
                                                  REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for kw in ({}, dict(vocab=500, a=1.5)):
        want = bench.make_zipf_batches(3, 64, seed=4, **kw)
        got = list(tgen.zipf_bench_batches(3, 64, seed=4, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.to_bytes() == w.to_bytes()
        signs = np.stack([f.signs for f in got[0].id_type_features])
        assert signs.min() >= 1
